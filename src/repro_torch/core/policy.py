"""ArithmeticPolicy — the per-layer switchboard for the ARTEMIS ladder.

modes (paper Table IV columns):
  exact       fp32/bf16 reference                      (FP32)
  int8        int8 quant, exact int32 accumulation     (Q(8-bit))
  artemis     int8 + TCU floor-multiply + MOMCAP group (Q(8-bit) + SC)
              accumulation + readout quantization/noise + LUT nonlinearities
  artemis_mxu beyond-paper fast path: the ARTEMIS semantics approximated by
              two MXU int8 matmuls (value dot + sign dot bias correction)
              instead of per-product VPU emulation — see artemis_matmul.py.
"""
from __future__ import annotations

import dataclasses

MODES = ("exact", "int8", "artemis", "artemis_mxu")


@dataclasses.dataclass(frozen=True)
class ArithmeticPolicy:
    mode: str = "exact"
    # --- MOMCAP / readout (paper §III.A.2, §III.B) ---
    acc_depth: int = 20
    readout_bits: int | None = 8
    sigma_analog: float = 0.0
    # --- NSC LUTs (paper §III.C.2) ---
    lut_entries: int = 256
    lut_out_bits: int | None = 8
    # --- quantization ---
    act_quant_axis: tuple | None = None   # None -> per-tensor
    weight_quant_axis: tuple | None = None
    # --- training / integration ---
    ste: bool = True            # straight-through estimator for backprop
    apply_to_router: bool = False  # MoE router stays exact (Table-V-style
    # calibration shows routing logits are the most truncation-sensitive op)
    apply_to_state: bool = False   # SSM/RWKV recurrences stay >= bf16:
    # recurrent error accumulation violates the 20-acc independence premise
    # (DESIGN.md §Arch-applicability)
    rbar: float = 63.5          # E[(a*b) mod 128] for the MXU correction

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def is_quantized(self) -> bool:
        return self.mode != "exact"


EXACT = ArithmeticPolicy(mode="exact")
INT8 = ArithmeticPolicy(mode="int8")
ARTEMIS = ArithmeticPolicy(mode="artemis")
ARTEMIS_MXU = ArithmeticPolicy(mode="artemis_mxu")
