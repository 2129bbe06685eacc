"""Three-term roofline model over one rank's counted step (counterpart of
`repro.roofline.model`).

Per (arch x shape x mesh) cell:

  compute term    = FLOPs      / peak_FLOP/s
                    (int8 operations at the int8 rate, where the spec
                    has one: the counted FLOPs hold them, and
                    `cost["int8 ops"]` says how many they are)
  memory term     = bytes      / HBM_bw
  collective term = wire bytes / (link_bw x links)

The reference takes FLOPs and bytes from `compiled.cost_analysis()` of
the partitioned (per-device) program; the port takes them from one
rank's step counted eagerly on meta tensors (`roofline.count`), which
is per rank for the same reason. The row keeps the reference's key
names (`hlo_gflops`, `hlo_gbytes`): here they hold that eager count.
Collective bytes are the rank's operand bytes (`roofline.collectives`).
The dominant term is the bottleneck; MODEL_FLOPS / FLOPs measures how
much counted compute is useful (remat, tensor-parallel redundancy).

`HW_V5E` is the reference's spec, copied; `HW_H100` is the port's card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.roofline.collectives import CollectiveStats


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float      # per chip, FLOP/s (bf16)
    hbm_bw: float          # per chip, B/s
    ici_bw: float          # per link, B/s
    ici_links: int = 4     # v5e: 4 links per chip (2D torus x2 directions)
    hbm_gib: float = 16.0  # per chip HBM capacity
    # per chip, int8 OP/s; None prices int8 operations at peak_flops
    peak_int8_ops: float | None = None


# the reference's constants: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link
HW_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    ici_links=4,
)

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: dense bf16 and
# int8 on the tensor cores, HBM3, NVLink 4 (18 links of 25 GB/s each
# way, 450 GB/s), 80 GB of HBM
HW_H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=989.4e12,
    hbm_bw=3.35e12,
    ici_bw=25e9,
    ici_links=18,
    hbm_gib=80.0,
    peak_int8_ops=1979e12,
)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # one rank's counted FLOPs
    hlo_bytes: float           # one rank's counted HBM bytes
    coll_bytes: float          # per-device operand bytes
    coll_wire_bytes: float     # ring-weighted per-device
    model_flops: float         # 6·N_active·D useful flops
    peak_bytes_per_device: float  # counted peak of live storage
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower bound assuming perfect overlap: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_fraction(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        useful FLOPs / (chips · peak · step_time)."""
        if self.step_time <= 0:
            return 0.0
        return self.t_compute / self.step_time * self.useful_flop_fraction

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_mbytes": self.coll_bytes / 1e6,
            "model_gflops": self.model_flops / 1e9,
            "useful_flop_frac": self.useful_flop_fraction,
            "roofline_frac": self.roofline_fraction,
            "bytes_per_device_gib": self.peak_bytes_per_device / 2**30,
        }


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, coll: CollectiveStats, mflops: float,
            peak_bytes: float, hw: HardwareSpec = HW_H100) -> RooflineReport:
    """`cost` is one rank's {"flops", "bytes accessed"[, "int8 ops"]} and
    `coll` its collectives, so both are per chip already; `chips` only
    converts the whole model's useful FLOPs to a chip's share. "int8
    ops" are the part of "flops" whose operands are int8; the compute
    term prices them at `hw.peak_int8_ops`."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    int8 = float(cost.get("int8 ops", 0.0))
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts,
        coll_bytes=float(coll.raw_bytes),
        coll_wire_bytes=float(coll.wire_bytes),
        model_flops=mflops / chips, peak_bytes_per_device=peak_bytes)
    rep.t_compute = ((flops - int8) / hw.peak_flops
                     + int8 / (hw.peak_int8_ops or hw.peak_flops))
    rep.t_memory = byts / hw.hbm_bw
    # collective bytes are per-device; each chip drives ici_links links
    # concurrently
    rep.t_collective = rep.coll_wire_bytes / (hw.ici_bw * hw.ici_links)
    return rep


def model_flops(cfg: ModelConfig, n_tokens: int, kind: str,
                kv_len: int = 0) -> float:
    """Useful FLOPs: 6·N_active·D for training, 2·N_active·D for inference
    (+ attention score/value FLOPs, which 6ND omits)."""
    n_active = cfg.active_param_count()
    per_token = 2.0 * n_active
    # attention quadratic term (omitted by 2ND): 4·H·hd·context FLOPs per
    # token per layer (QK^T + PV, 2 FLOPs each), halved for causal prefill
    if cfg.family in ("dense", "moe"):
        h, hd = cfg.n_heads, cfg.resolved_head_dim
        context = kv_len if kind == "decode" else (kv_len or 1) / 2.0
        per_token += 4.0 * h * hd * context * cfg.n_layers
    mult = 3.0 if kind == "train" else 1.0   # fwd+bwd = 3x fwd
    return per_token * n_tokens * mult
