"""Deterministic stochastic (TCU) multiplication, paper §III.A.1
(counterpart of `repro.core.stochastic`).

Operand 1 is transition-coded unary (bit i set iff i < a); operand 2 is
spread evenly over the 128 positions (Bresenham: bit i set iff
floor((i+1)*b/128) > floor(i*b/128)). AND-ing the two streams counts
exactly floor(a*b/128) set bits, the closed form used throughout:

  sc_multiply(a, b) == floor(a * b / 128)   for a, b in [0, 127].
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import SC_LEVELS

SC_BITS = SC_LEVELS  # 128-bit streams


def tcu_encode(m: torch.Tensor) -> torch.Tensor:
    """B_to_TCU decoder: magnitude m in [0,128] -> (..., 128) bool stream."""
    positions = torch.arange(SC_BITS, dtype=torch.int32, device=m.device)
    return positions < m[..., None]


def spread_encode(m: torch.Tensor) -> torch.Tensor:
    """Bit-position correlation encoder: evenly spread m ones over 128
    bits."""
    i = torch.arange(SC_BITS, dtype=torch.int32, device=m.device)
    m = m[..., None].to(torch.int32)
    return ((i + 1) * m) // SC_BITS - (i * m) // SC_BITS > 0


def sc_multiply_bitstream(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-level emulation: popcount(tcu(a) & spread(b)). For validation."""
    anded = torch.logical_and(tcu_encode(a), spread_encode(b))
    return anded.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def sc_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed form of the deterministic TCU multiply: floor(a*b/128).

    a, b: integer magnitudes in [0, 127] (any broadcastable shapes).
    """
    return (a.to(torch.int32) * b.to(torch.int32)) // SC_BITS


def sc_multiply_float(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 variant of the closed form."""
    return torch.floor(a * b * (1.0 / SC_BITS))


def sc_truncation_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact truncation error of one SC multiply, in product units
    (1/128): (a*b mod 128)/128 in [0, 1)."""
    prod = a.to(torch.int32) * b.to(torch.int32)
    return (prod % SC_BITS).float() / SC_BITS
