"""The port's roofline (counterpart of `repro.roofline`): the
three-term model over a `HardwareSpec` (`model`: `HW_H100`, the port's
card, beside the reference's `HW_V5E`), the collective bytes recorded
at `parallel.comm`'s calls (`collectives`) and the eager count of a
step's FLOPs, bytes and peak storage (`count`)."""
from repro_torch.roofline.collectives import (CollectiveStats,
                                              collective_stats, recording)
from repro_torch.roofline.model import (HW_H100, HW_V5E, HardwareSpec,
                                        RooflineReport, analyze, model_flops)

__all__ = ["CollectiveStats", "collective_stats", "recording",
           "HardwareSpec", "HW_H100", "HW_V5E", "RooflineReport", "analyze",
           "model_flops"]
