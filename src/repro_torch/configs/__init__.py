"""Config registry: 10 assigned architectures + 5 paper workloads.

Each `<arch>.py` exports:
  FULL   — the exact assigned configuration (ModelConfig)
  SMOKE  — a reduced same-family config for CPU tests (few layers, narrow)

`SHAPES` defines the per-arch input-shape cells (brief: train_4k,
prefill_32k, decode_32k, long_500k). `cells(arch)` yields the runnable
(arch, shape) pairs — long_500k only for sub-quadratic archs, per
DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "qwen3_14b",
    "deepseek_coder_33b",
    "qwen3_8b",
    "gemma_2b",
    "internvl2_1b",
    "musicgen_large",
    "zamba2_7b",
    "rwkv6_3b",
    "dbrx_132b",
    "qwen2_moe_a2_7b",
)

# paper Table II workloads (for the hwsim benchmarks)
PAPER_WORKLOADS = ("transformer_base", "bert_base", "albert_base",
                   "vit_base", "opt_350")

# archs with a sub-quadratic long-context path (run long_500k)
SUBQUADRATIC = ("zamba2_7b", "rwkv6_3b")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.SMOKE if smoke else mod.FULL


def list_archs() -> tuple[str, ...]:
    return ARCHS


def runnable_shapes(arch: str) -> tuple[str, ...]:
    """Shape cells that lower for this arch (others are documented skips)."""
    arch = canon(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        out.append("long_500k")
    return tuple(out)


def all_cells() -> list[tuple[str, str, str]]:
    """All 40 (arch, shape, status) cells; status 'run' or 'skip'."""
    cells = []
    for a in ARCHS:
        run = set(runnable_shapes(a))
        for s in SHAPES:
            cells.append((a, s, "run" if s in run else "skip"))
    return cells
