"""NSC reprogrammable-LUT nonlinearities, paper §III.C.2 (counterpart of
`repro.core.lut`).

Each NSC unit evaluates nonlinear functions (exp, ln for softmax; ReLU,
GELU, SiLU for FFNs) through 8-bit look-up tables. A real n-entry
table is emulated:

  * the table's input grid covers [lo, hi] (linear bins) or is
    log-spaced (`log_bins=True`, an exponent-indexed table);
  * stored outputs are optionally quantized to `out_bits` levels over
    the table's own output range (min/max over stored entries);
  * a lookup snaps the input to the nearest grid point and returns the
    stored (quantized) output.

The table is built on the grid of the input range it is given, which
may be computed from the input (per-tensor calibration). Every
operation runs in f32 in the reference's order, with true divisions
(`div_by`), and exp, log, tanh and the logistic are XLA's
(`repro_torch.xla_math`), so that a lookup lands on the reference's
grid point and returns the reference's stored value. The log grid's
power is taken in f64 and rounded to f32; XLA's may differ in a last
bit, which the stored-output quantization absorbs but at a tie.
"""
from __future__ import annotations

import math

import torch

from repro_torch import xla_math
from repro_torch.core.quantization import div_by


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(like.device)


def binned_apply(fn, x: torch.Tensor, lo, hi, n_in: int = 256,
                 out_bits: int | None = 8,
                 log_bins: bool = False) -> torch.Tensor:
    """Emulate an n_in-entry LUT of `fn` over [lo, hi] applied to x."""
    lo = _f32(lo, x)
    hi = _f32(hi, x)
    grid = div_by(torch.arange(n_in, dtype=torch.float32, device=x.device),
                  n_in - 1)
    if log_bins:
        # log-spaced grid over [lo, hi], lo > 0 (exponent-indexed table)
        ratio = torch.clamp_min(hi / torch.clamp_min(lo, 1e-8),
                                1.0 + 1e-6)
        xs_table = lo * (ratio.double() ** grid.double()).float()
        xq = torch.minimum(torch.maximum(x, lo), hi)
        pos = xla_math.log(xq / lo) / xla_math.log(ratio) * (n_in - 1)
    else:
        span = torch.clamp_min(hi - lo, 1e-8)
        xs_table = lo + grid * span
        pos = (x - lo) / span * (n_in - 1)
    idx = torch.clamp(torch.round(pos), 0, n_in - 1).to(torch.int64)

    ys_table = fn(xs_table)
    if out_bits is not None:
        # stored-output quantization over the table's own output range
        y_lo = ys_table.min()
        y_span = torch.clamp_min(ys_table.max() - y_lo, 1e-8)
        levels = 2**out_bits - 1
        yq = torch.round((ys_table - y_lo) / y_span * levels)
        ys_table = y_lo + div_by(yq, levels) * y_span
    return ys_table[idx]


def _dynamic_range(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m = torch.clamp_min(x.detach().abs().max(), 1e-6)
    return -m, m


_SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2.0 / math.pi),
                                     dtype=torch.float32))


def gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default (approximate=True), op for op:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x*x*x))))."""
    inner = _SQRT_2_OVER_PI * (v + 0.044715 * (v * v * v))
    return v * (0.5 * (1.0 + xla_math.tanh(inner)))


ACTIVATIONS = {
    "relu": torch.relu,
    # jax.nn.gelu approximates by default: torch's default erf GELU
    # differs by up to 0.045 on the table's grid
    "gelu": gelu_tanh,
    "silu": lambda v: v * xla_math.logistic(v),
    "gelu_tanh": gelu_tanh,
}


def lut_activation(x: torch.Tensor, kind: str, n_in: int = 256,
                   out_bits: int | None = 8) -> torch.Tensor:
    """LUT-emulated activation with per-tensor dynamic range
    calibration."""
    fn = ACTIVATIONS[kind]
    lo, hi = _dynamic_range(x)
    return binned_apply(fn, x, lo, hi, n_in=n_in, out_bits=out_bits)


# exp inputs below this contribute < 6e-6 to a softmax: clamping the LUT
# range here keeps the bins fine where exp actually resolves.
EXP_LUT_FLOOR = -12.0


def lut_exp(x: torch.Tensor, lo, n_in: int = 256,
            out_bits: int | None = 8) -> torch.Tensor:
    """exp LUT over [max(lo, FLOOR), 0]: softmax inputs are <= 0 after
    the y_max shift; anything below the floor quantizes to ~0 anyway."""
    lo = torch.clamp_min(_f32(lo, x), EXP_LUT_FLOOR)
    return binned_apply(xla_math.exp, x, lo, 0.0, n_in=n_in,
                        out_bits=out_bits)


def lut_ln(x: torch.Tensor, hi, n_in: int = 256,
           out_bits: int | None = 8) -> torch.Tensor:
    """ln LUT over [1, hi] with log-spaced (exponent-indexed) bins.

    Log spacing bounds the ln error by ln(hi)/(2*(n_in-1)) uniformly;
    linear bins would be coarse near x=1.
    """
    return binned_apply(xla_math.log, x, 1.0, hi, n_in=n_in,
                        out_bits=out_bits, log_bins=True)
