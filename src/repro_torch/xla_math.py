"""f32 elementary functions as XLA's CPU backend computes them.

The JAX package is the reference, and the reference runs on XLA. Its
f32 `exp`, `log`, `log1p`, `tanh` and `logistic` are XLA's own
polynomial and rational approximations (Cephes and Eigen), not the
C library's, and XLA contracts a multiply into the add that takes it
(a fused multiply-add). torch's functions round the last bit apart on
a few percent of inputs (`exp` on 10 %, `tanh` on half), and a last bit
moves an 8-bit LUT entry, a readout level or a random normal. This
module restates XLA's algorithms op for op in torch, so that the port's
LUTs, softmax and normals equal the reference's bit for bit on the CPU;
the same arithmetic runs on CUDA. It tracks jax 0.9.0's XLA, the
version its tests hold it against.

A fused multiply-add is formed in f64: the product of two f32 values is
exact there, and the f64 sum is rounded once more to f32 (a double
rounding that a true FMA avoids; it has not shown in any test here).
"""
from __future__ import annotations

import torch

_F32_TINY = torch.finfo(torch.float32).tiny


def f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """v rounded to f32, as a 0-dim tensor on like's device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with the product unrounded."""
    return (a.double() * b.double() + c.double()).float()


def horner(x: torch.Tensor, coefs) -> torch.Tensor:
    """The polynomial with `coefs` (highest degree first) at x, one
    fused multiply-add a step."""
    p = f32(coefs[0], x).expand_as(x)
    for c in coefs[1:]:
        p = fma(p, x, f32(c, x))
    return p


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2**n for integer-valued f32 n in [-127, 127], built in the
    exponent field as XLA builds it (2**-127 comes out 0)."""
    bits = (n.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


# Cephes exp: e**x = e**a * 2**n with n = floor(x log2(e) + 1/2)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 e**x: x clamped to [-87.8, 88.8], reduced by n ln 2 (in two
    parts), a degree-6 polynomial, times 2**n; a subnormal result is
    flushed to 0, as XLA's CPU code runs with denormals off."""
    x = torch.clamp(x.float(), -87.8, 88.8)
    n = torch.floor(fma(x, f32(1.44269504088896341, x), f32(0.5, x)))
    n = torch.clamp(n, -127.0, 127.0)
    a = fma(-f32(_LN2_HI, x), n, x)
    a = fma(-f32(_LN2_LO, x), n, a)
    y = fma(horner(a, _EXP_P), a * a, a)
    return _flush((1.0 + y) * _pow2(n))


# Cephes log (Eigen's plog), highest coefficient first
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log(x: torch.Tensor) -> torch.Tensor:
    """f32 log of positive normal x: x = m * 2**e with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1 evaluated in
    three fused parts, then ln 2 * e added in two parts."""
    m, e = torch.frexp(x.float())
    e = e.float()
    below = m < 0.707106781186547524
    m = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.float()
    x2 = m * m
    x3 = x2 * m
    c = [f32(v, m) for v in _LOG_P]
    y = fma(fma(m, c[0], c[1]), m, c[2])
    y1 = fma(fma(m, c[3], c[4]), m, c[5])
    y2 = fma(fma(m, c[6], c[7]), m, c[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, f32(_LN2_LO, m) * e)
    out = fma(f32(-0.5, m), x2, m) + y
    return fma(f32(_LN2_HI, m), e, out)


# log1p below |x| < sqrt(2) - 1: Cephes' rational function
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 log(1 + x): for |x| below sqrt(2) - 1,
    x - x**2/2 + x**3 * P(x)/Q(x), else `log`(1 + x)."""
    x = x.float()
    x2 = x * x
    r = x * x2 * (horner(x, _LOG1P_NUM) / horner(x, _LOG1P_DEN))
    small = x + fma(f32(-0.5, x), x2, r)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       log(1.0 + x))


# Eigen's rational tanh, odd numerator and even denominator in x**2
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)
_TANH_CLAMP = 7.99881172180175781


def tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh: x itself below |x| < 0.0004, else x * P(x**2) /
    Q(x**2) on x clamped to +-7.9988 (where it gives exactly +-1)."""
    x = x.float()
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    c2 = c * c
    out = c * horner(c2, _TANH_NUM) / horner(c2, _TANH_DEN)
    return torch.where(x.abs() < 0.0004, x, out)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """x with subnormal values flushed to 0, as XLA's CPU code runs."""
    return torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)


def logistic(x: torch.Tensor) -> torch.Tensor:
    """f32 1 / (1 + exp(-x)), `jax.nn.sigmoid`, subnormals flushed."""
    return _flush(1.0 / (1.0 + exp(-x.float())))
