"""MOMCAP analog temporal accumulation, paper §III.A.2, §III.B, Fig 7
(counterpart of `repro.core.analog`).

Numerically:
  * exact integer sums of floor-products inside a group of `acc_depth`,
  * a quantizing readout (`readout_bits` levels over the group full
    scale),
  * signs handled by accumulating all-positive and all-negative products
    separately and subtracting in the NSC adder/subtractor (§III.C.1).

The analog noise of the readout (`sigma_analog > 0`) is not ported: the
reference draws it from jax PRNG keys, and every function here raises
NotImplementedError for it.

The module also carries the device-level RC charge model of Fig 7.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantization import SC_LEVELS, div_by


@dataclasses.dataclass(frozen=True)
class MomcapConfig:
    acc_depth: int = 20          # consecutive accumulations per MOMCAP
    readout_bits: int | None = 8  # None -> ideal (no readout quantization)
    sigma_analog: float = 0.0    # noise stddev, fraction of group full scale

    @property
    def full_scale(self) -> int:
        """Group full scale in product units (each product <= 127)."""
        return self.acc_depth * (SC_LEVELS - 1)


def _refuse_noise(cfg: MomcapConfig) -> None:
    if cfg.sigma_analog > 0.0:
        raise NotImplementedError(
            "analog readout noise (sigma_analog > 0) is not ported yet")


def readout_quantize(x: torch.Tensor, cfg: MomcapConfig) -> torch.Tensor:
    """A_to_B conversion of an accumulated analog value (paper §III.B).

    x: non-negative accumulated product sums, in product units
    (<= full_scale). clip(round(x / delta), 0, levels) * delta in f32,
    with delta = full_scale / levels rounded to f32 and a true division.
    """
    _refuse_noise(cfg)
    x = x.float()
    if cfg.readout_bits is None:
        return x
    levels = 2**cfg.readout_bits - 1
    delta = cfg.full_scale / levels
    return torch.clamp(torch.round(div_by(x, delta)), 0, levels) * delta


def grouped_signed_accumulate(products: torch.Tensor, signs: torch.Tensor,
                              cfg: MomcapConfig) -> torch.Tensor:
    """Accumulate signed floor-products along the LAST axis, ARTEMIS-style.

    products: integer/float magnitudes of SC products, shape (..., K).
    signs:    {-1, 0, +1}, same shape.
    Returns float32 (...,): the NSC-reduced signed sum of the per-group
    MOMCAP readouts.
    """
    _refuse_noise(cfg)
    g = cfg.acc_depth
    k = products.shape[-1]
    pad = (-k) % g
    if pad:
        products = torch.nn.functional.pad(products, (0, pad))
        signs = torch.nn.functional.pad(signs, (0, pad))
    ngroups = products.shape[-1] // g
    p = products.reshape(products.shape[:-1] + (ngroups, g)).float()
    s = signs.reshape(signs.shape[:-1] + (ngroups, g))
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    pos = torch.where(s > 0, p, zero).sum(dim=-1)
    neg = torch.where(s < 0, p, zero).sum(dim=-1)
    # NSC binary reduction of per-group readouts (exact digital adds)
    return (readout_quantize(pos, cfg) - readout_quantize(neg, cfg)).sum(
        dim=-1)


# ---------------------------------------------------------------------------
# Device-level RC model (Fig 7 reproduction).
# ---------------------------------------------------------------------------

V_SAT = 1.1          # volts — bit-line/core supply rail
# Charge per accumulation event, calibrated so the paper's 8 pF MOMCAP
# supports exactly 20 linear accumulations (paper §IV.B).
Q_STEP_FC = 22.0     # femto-coulombs per full 128-bit accumulation event
LINEARITY = 0.95     # a step counts as "linear" while dv >= 95% of dv0


def momcap_voltage_trace(c_pf: float, n_events: int) -> torch.Tensor:
    """Voltage staircase (f32) for n accumulation events on a c_pf
    MOMCAP: each event adds dv0 = Q/C, compressed by (1 - v/V_SAT) as
    the cap charges toward the rail."""
    dv0 = (Q_STEP_FC * 1e-15) / (c_pf * 1e-12)
    v = torch.zeros((), dtype=torch.float32)
    trace = []
    for _ in range(n_events):
        v = v + dv0 * (1.0 - div_by(v, V_SAT))
        trace.append(v)
    return torch.stack(trace) if trace else torch.zeros((0,))


def max_linear_accumulations(c_pf: float) -> int:
    """Number of accumulation steps before the increment falls below
    LINEARITY * dv0 (closed form of the geometric compression)."""
    dv0 = (Q_STEP_FC * 1e-15) / (c_pf * 1e-12)
    x = dv0 / V_SAT
    return int(math.floor(math.log(LINEARITY) / math.log(1.0 - x)))
