"""Shared neural building blocks in PyTorch (counterpart of
`repro.models.layers`).

Every dense matmul routes through `mm(...)`, the ArithmeticPolicy
switch: exact mode keeps the compute dtype; the quantized modes call
`repro_torch.core.artemis_matmul`, whose int8 core is the sc_matmul
kernel on CUDA. The attention score/value contractions go through
`qeinsum`, the batched int8 (and artemis_mxu) ladder of the reference.

Numerics follow the reference op for op: norms and RoPE run in f32 and
cast back, the norm scales are read as f32, and the FFN activations
match `jax.nn` (its `gelu` is the tanh approximation).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quantization as q
from repro_torch.core.artemis_matmul import artemis_matmul
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.core.quantization import SC_LEVELS

# ---------------------------------------------------------------------------
# policy-routed matmuls
# ---------------------------------------------------------------------------


def mm(x: torch.Tensor, w: torch.Tensor,
       policy: ArithmeticPolicy) -> torch.Tensor:
    """x: (..., K) activations, w: (K, N) weights -> (..., N), x.dtype."""
    if policy.mode == "exact":
        return torch.matmul(x, w.to(x.dtype))
    return artemis_matmul(x, w, policy).to(x.dtype)


def _int_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer einsum of two integer tensors, as f32 (the
    reference's int32 einsum cast to f32). PyTorch has no integer
    product on CUDA and f32 is inexact once a sum passes 2**24, so the
    product runs in f64, exact for any contraction this model has."""
    return torch.einsum(spec, a.double(), b.double()).float()


def _quant_einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
                  policy: ArithmeticPolicy) -> torch.Tensor:
    """Batched einsum through the int8 / artemis_mxu ladder, in the
    operands' dtype up to the integer product, as the reference. Only
    artemis_mxu takes the sign correction: every other quantized mode
    (artemis included) is a plain int8 contraction here."""
    sa = q.quant_scale(a, 8, policy.act_quant_axis)
    sb = q.quant_scale(b, 8, policy.act_quant_axis)
    aq, bq = q.quantize(a, sa), q.quantize(b, sb)
    dot = _int_einsum(spec, aq, bq)
    if policy.mode == "artemis_mxu":
        sgn = _int_einsum(spec, torch.sign(aq), torch.sign(bq))
        dot = dot - policy.rbar / SC_LEVELS * sgn
    out = dot * sa * sb
    if policy.ste:
        exact = torch.einsum(spec, a.float(), b.float())
        out = exact + (out - exact).detach()
    return out


def qeinsum(spec: str, a: torch.Tensor, b: torch.Tensor,
            policy: ArithmeticPolicy) -> torch.Tensor:
    """Attention-style batched contraction under the policy ladder, in
    a's dtype."""
    if policy.mode == "exact":
        return torch.einsum(spec, a, b)
    return _quant_einsum(spec, a, b, policy).to(a.dtype)


# ---------------------------------------------------------------------------
# initializers (same distributions as repro.models.layers)
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device, dtype=torch.float32) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, device,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    return (_rms(x.float(), eps) * scale.float()).to(dt)


def headwise_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: normalize over head_dim. x: (..., H, Dh), scale: (Dh,)."""
    return rmsnorm(scale, x, eps)


# ---------------------------------------------------------------------------
# rotary embeddings (split halves, computed in f32)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    dt = x.dtype
    freqs = rope_frequencies(x.shape[-1], theta, x.device)    # (Dh/2,)
    ang = positions[..., None].float() * freqs                # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu,
         "relu2": lambda x: torch.square(F.relu(x))}


def ffn(p, x: torch.Tensor, act: str, glu: bool,
        policy: ArithmeticPolicy = ArithmeticPolicy()) -> torch.Tensor:
    """p: an object with `w_up`, `w_down` (and `w_gate` when glu)."""
    up = mm(x, p.w_up, policy)
    if glu:
        up = _ACTS[act](mm(x, p.w_gate, policy)) * up
    else:
        up = _ACTS[act](up)
    return mm(up, p.w_down, policy)
