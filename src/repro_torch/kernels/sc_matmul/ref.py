"""Plain PyTorch version of the sc_matmul kernel: the ARTEMIS MAC over
pre-quantized int8 operands (counterpart of
`repro.kernels.sc_matmul.ref.sc_matmul_ref`, with the group order of
`repro.core.artemis_matmul`).

It runs on the CPU and on CUDA tensors alike: the wrapper takes it for
CPU tensors, and the chip smoke holds the CUDA kernel against it on the
card. PyTorch has no int32 matrix product on CUDA, so the integer dots
are float64 products of the integer values: every product is at most
127*127 and every partial sum stays far below 2**53, so the f64 result
is the exact integer, in any summation order. The `artemis` pipeline is
elementwise, one MOMCAP group at a time.

The group scan `acc + readout(pos) - readout(neg)` is evaluated the way
XLA compiles the reference's scan body on the CPU: the two
`level * delta` products fused into their add and subtract,
acc = fma(-neg_level, delta, fma(pos_level, delta, acc)). PyTorch has
no fused multiply-add, so `_fma` forms it in float64: `level * delta` is
exact there, and so is its sum with acc while both span at most 53
bits (readout_bits <= 12 and |acc| < 2**24 product units, i.e. any K
this model has), and rounding that exact sum to f32 is the single
rounding of a true FMA, which the CUDA kernel uses.

Self-contained on purpose (torch only): `repro_torch.core` imports the
kernel package, so this module restates the readout of
`core.analog.readout_quantize` rather than importing it.
"""
from __future__ import annotations

import torch

SC_LEVELS = 128
MODES = ("int8", "artemis", "artemis_mxu")


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two integer matrices, as int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _readout_level(x: torch.Tensor, delta: torch.Tensor,
                   levels: int) -> torch.Tensor:
    """clip(round(x / delta), 0, levels) in f32, with a true division:
    `delta` is a 0-dim device tensor, not a Python scalar, which CUDA
    would turn into a multiplication by its reciprocal."""
    return torch.clamp(torch.round(x.float() / delta), 0, levels)


def readout_table(acc_depth: int, readout_bits: int | None,
                  device=None) -> torch.Tensor:
    """(acc_depth * 128 + 1,) f32: the readout level of every group sum
    a MOMCAP group of int8 products can reach (0 to acc_depth * 128,
    -128 included), by `_readout_level`; the sum itself for the ideal
    readout (None). The CUDA kernel looks each sum up here."""
    x = torch.arange(acc_depth * SC_LEVELS + 1, dtype=torch.float32,
                     device=device)
    if readout_bits is None:
        return x
    levels = 2**readout_bits - 1
    return _readout_level(x, _f32(acc_depth * (SC_LEVELS - 1) / levels, x),
                          levels)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding (see the module docstring)."""
    return (a.double() * b.double() + c.double()).float()


def sc_matmul_ref(aq: torch.Tensor, bq: torch.Tensor, *,
                  mode: str = "artemis", acc_depth: int = 20,
                  readout_bits: int | None = 8,
                  rbar: float = 63.5) -> torch.Tensor:
    """aq: (M, K) int8, bq: (K, N) int8. Returns (M, N): int32 integer
    dot units for mode="int8", f32 SC product units otherwise.

    artemis: per MOMCAP group of `acc_depth` consecutive k (K zero-padded
    to a whole group), the products floor(|a||b| / 128) of positive and
    of negative sign are summed exactly, each sum is read out, and
    acc = acc + pos_r - neg_r runs over the groups in order, in f32 (the
    readout products fused, see the module docstring).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "int8":
        return _int_dot(aq, bq)
    if mode == "artemis_mxu":
        value = _int_dot(aq, bq).float()
        signs = _int_dot(torch.sign(aq), torch.sign(bq)).float()
        return (value - rbar * signs) / SC_LEVELS

    a = aq.to(torch.int32)
    b = bq.to(torch.int32)
    ma, sa = a.abs(), torch.sign(a)
    mb, sb = b.abs(), torch.sign(b)
    g = acc_depth
    pad = (-a.shape[1]) % g
    if pad:
        ma = torch.nn.functional.pad(ma, (0, pad))
        sa = torch.nn.functional.pad(sa, (0, pad))
        mb = torch.nn.functional.pad(mb, (0, 0, 0, pad))
        sb = torch.nn.functional.pad(sb, (0, 0, 0, pad))
    if readout_bits is not None:
        levels = 2**readout_bits - 1
        delta = _f32(g * (SC_LEVELS - 1) / levels, a)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, ma.shape[1], g):
        sl = slice(k0, k0 + g)
        # one MOMCAP group: (M, g, N) floor products
        p = (ma[:, sl, None] * mb[None, sl, :]) // SC_LEVELS
        s = sa[:, sl, None] * sb[None, sl, :]
        pos = torch.where(s > 0, p, zero).sum(dim=1).float()
        neg = torch.where(s < 0, p, zero).sum(dim=1).float()
        if readout_bits is None:
            acc = acc + pos - neg
        else:
            acc = _fma(-_readout_level(neg, delta, levels), delta,
                       _fma(_readout_level(pos, delta, levels), delta, acc))
    return acc
