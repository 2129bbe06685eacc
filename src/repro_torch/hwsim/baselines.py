"""Published baseline anchors for Figs 9-11 (paper §IV.D).

The paper compares against CPU / GPU / TPU / FPGA_ACC [40] / TransPIM [9]
/ ReBERT [11] / HAIMA [10], using "power, latency, and energy values
reported for the selected accelerators" — i.e. published numbers, not
re-simulations. We anchor the same way: each platform is stored as its
paper-reported average factor vs ARTEMIS (speedup = ARTEMIS_speedup /
platform_speedup, both CPU-relative).

ARTEMIS-relative averages from §IV.D (speedup / energy / efficiency):
  CPU      1230x   1443.3x   1269.0x
  GPU       157x    700.4x    673.6x
  TPU       212x   1000.4x    950.2x
  FPGA_ACC 29.6x      8.8x      8.5x
  TransPIM  4.8x      3.5x      3.3x
  ReBERT   11.9x      1.8x      1.9x   (BERT-family models only)
  HAIMA     3.6x      6.2x      5.9x
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Baseline:
    name: str
    speedup_vs: float    # ARTEMIS speedup over this platform (avg)
    energy_vs: float     # ARTEMIS energy advantage (avg)
    efficiency_vs: float  # ARTEMIS GOPS/W advantage (avg)
    bert_only: bool = False


BASELINES = {
    "CPU": Baseline("CPU", 1230.0, 1443.3, 1269.0),
    "GPU": Baseline("GPU", 157.0, 700.4, 673.6),
    "TPU": Baseline("TPU", 212.0, 1000.4, 950.2),
    "FPGA_ACC": Baseline("FPGA_ACC", 29.6, 8.8, 8.5),
    "TransPIM": Baseline("TransPIM", 4.8, 3.5, 3.3),
    "ReBERT": Baseline("ReBERT", 11.9, 1.8, 1.9, bert_only=True),
    "HAIMA": Baseline("HAIMA", 3.6, 6.2, 5.9),
}

# the paper's headline claim (abstract): vs the best competitor in each
# metric, ARTEMIS achieves AT LEAST these factors
HEADLINE = {"speedup": 3.0, "energy": 1.8, "efficiency": 1.9}
