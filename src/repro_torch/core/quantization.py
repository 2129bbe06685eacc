"""Symmetric integer quantization (counterpart of
`repro.core.quantization`), the front door of the ARTEMIS ladder.

ARTEMIS (paper §IV.A) quantizes weights and activations to signed 8-bit
and represents each magnitude as a 128-level unary (TCU) stream plus a
sign bit. Everything downstream operates on the integer magnitudes made
here.

Numerics follow the reference op for op, in the input's dtype: the
absmax is floored at 1e-8, divided by qmax, and `x / scale` is rounded
half to even (`torch.round`, like `jnp.round`). Divisions by a constant
go through `div_by`: on CUDA, PyTorch turns a division by a Python
scalar into a multiplication by its reciprocal, which can differ from
the true quotient in the last bit.
"""
from __future__ import annotations

import torch

# 8-bit signed -> 128-bit unary magnitude + 1 sign bit  (paper §III.A.1)
SC_LEVELS = 128


def div_by(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true IEEE division in x's dtype, on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _absmax(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None:
        m = x.abs().amax().reshape([1] * x.dim())
    else:
        m = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(m, 1e-8)


def quant_scale(x: torch.Tensor, bits: int = 8, axis=None) -> torch.Tensor:
    """Symmetric scale so that round(x/scale) fits in `bits` signed bits.

    axis=None -> per-tensor; axis=int/tuple -> per-channel over that axis.
    """
    qmax = 2 ** (bits - 1) - 1
    return div_by(_absmax(x, axis), qmax)


def quantize(x: torch.Tensor, scale: torch.Tensor,
             bits: int = 8) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def fake_quant(x: torch.Tensor, bits: int = 8, axis=None) -> torch.Tensor:
    """Quantize-dequantize (the Q(8-bit) column of paper Table IV)."""
    s = quant_scale(x, bits, axis)
    return dequantize(quantize(x, s, bits), s)


def magnitude_sign(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a signed integer tensor into (magnitude in [0,127], sign in
    {-1,0,+1}), both int32."""
    q32 = q.to(torch.int32)
    return q32.abs(), torch.sign(q32)
