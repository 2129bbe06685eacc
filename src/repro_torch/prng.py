"""jax's threefry2x32 random numbers in PyTorch, bit for bit.

The serve sampler draws a request's Gumbel noise from
`fold_in(PRNGKey(seed), position)`, and the data pipeline its batches
from `fold_in` chains, `split` and `randint`; replaying a stream across
the two packages needs the same bits, so this module
computes what `jax.random` computes (jax 0.9, 32-bit mode, with
`jax_threefry_partitionable=True`):

  PRNGKey(seed)       the raw key [seed >> 32, seed & 0xFFFFFFFF] of a
                      32-bit seed, so [0, seed mod 2**32]
  fold_in(key, data)  threefry2x32(key, (0, data)) as the new key
  random_bits(key, shape)
                      for flat index i of `shape`, the two words of
                      threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)),
                      xor-ed together
  uniform(key, shape, minval, maxval)
                      the top 23 bits as the mantissa of a float in
                      [1, 2), less 1, scaled to [minval, maxval) and
                      floored at minval
  gumbel(key, shape)  -log(-log(uniform(key, shape, tiny, 1)))
  split(key, num)     key i is threefry2x32(key, (0, i))
  randint(key, shape, minval, maxval)
                      int32 from two words a value (see `randint`)

A key is an int64 tensor whose last axis holds the two 32-bit words, so
a batch of keys (..., 2) draws for every lane at once. Every word is
held in int64 and masked to 32 bits after each operation: the same code
runs on the CPU and on CUDA, where PyTorch has no uint32 arithmetic.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
# threefry2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of key (k1, k2) over counts
    (x1, x2); all int64 holding 32-bit words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & MASK32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed, device=None) -> torch.Tensor:  # noqa: N802 (jax's name)
    """The raw key of an integer seed (a Python int or an integer
    tensor of seeds): (..., 2) int64."""
    s = _u32(seed).to(device) if device is not None else _u32(seed)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key from `key` (..., 2) and integer `data`, broadcast."""
    d = _u32(data).to(key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element of `shape` for every key of `key`
    (..., 2): int64 values in [0, 2**32), shape key.shape[:-1] + shape."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    k1, k2 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), as `jax.random.uniform`.
    XLA fuses `floats * (maxval - minval) + minval` into one FMA, so
    this rounds it once: the product of two f32 values and its sum with
    minval are exact in f64 for ranges like [1e-6, 1) and [tiny, 1)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    fused = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 standard Gumbel noise, as `jax.random.gumbel` (mode
    "low"). The two logs may differ from XLA's in the last bit."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys from `key` (..., 2), as `jax.random.split` under
    `jax_threefry_partitionable`: key i is threefry2x32(key, (0, i)).
    Returns (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1] + (1,)
    k1, k2 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    y1, y2 = threefry2x32(k1, k2, i >> 32, i & MASK32)
    return torch.stack([y1, y2], dim=-1)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2**32 for 32-bit words a and b, without leaving int64:
    b's high half contributes only the low 16 bits of its product."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 values in [minval, maxval), as `jax.random.randint` for
    int32: the key split in two, 32 bits drawn from each (higher,
    lower), reduced modulo the span in uint32 arithmetic, which wraps,
    with `(2**16 % span)**2 % span` as the higher word's multiplier. The span is 1 where
    maxval <= minval, so minval comes back."""
    k1, k2 = split(key).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & MASK32) % span
    offset = (_mul32(higher % span, torch.tensor(mult, device=key.device))
              + lower % span) & MASK32
    out = (minval + offset % span) & MASK32
    # back from the uint32 word to the int32 it encodes
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
