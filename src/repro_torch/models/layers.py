"""Shared neural building blocks in PyTorch (counterpart of
`repro.models.layers`).

Every dense matmul routes through `mm(...)`, the ArithmeticPolicy
switch. Only `mode="exact"` is ported: it keeps the compute dtype. The
quantized ARTEMIS modes raise until the arithmetic of `repro.core` is
ported.

Numerics follow the reference op for op: norms and RoPE run in f32 and
cast back, the norm scales are read as f32, and the FFN activations
match `jax.nn` (its `gelu` is the tanh approximation).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.policy import ArithmeticPolicy

# ---------------------------------------------------------------------------
# policy-routed matmuls
# ---------------------------------------------------------------------------


def mm(x: torch.Tensor, w: torch.Tensor,
       policy: ArithmeticPolicy) -> torch.Tensor:
    """x: (..., K) activations, w: (K, N) weights -> (..., N), x.dtype."""
    if policy.mode != "exact":
        raise NotImplementedError(
            f"policy mode {policy.mode!r} is not ported yet: the port's "
            f"mm takes only mode='exact'")
    return torch.matmul(x, w.to(x.dtype))


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
