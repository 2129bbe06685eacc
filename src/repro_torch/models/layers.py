"""Shared neural building blocks in PyTorch (counterpart of
`repro.models.layers`).

Every dense matmul routes through `mm(...)`, the ArithmeticPolicy
switch: exact mode keeps the compute dtype; the quantized modes call
`repro_torch.core.artemis_matmul`, whose int8 core is the sc_matmul
kernel on CUDA. The attention score/value contractions go through
`qeinsum`, the batched int8 (and artemis_mxu) ladder of the reference.
`attention` runs its score-softmax-context part, under the exact
policy, through the flash-attention kernel (`attn_impl="flash"`), and
otherwise through the reference's own math (`attn_impl="gather"`).

A `LanePolicy` (`per_lane(policy)`) marks a batch of independent
lanes, the state-slot steps' batched form of the reference's per-lane
vmap at batch 1: `mm` and `qeinsum` then take each lane's activation
scale over that lane alone (axis 0 is the lane), as the reference's
per-tensor scale does on its batch-1 lane, so no lane's values depend
on another's.

Numerics follow the reference op for op: norms and RoPE run in f32 and
cast back, the norm scales are read as f32, and the FFN activations
match `jax.nn` (its `gelu` is the tanh approximation).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import quantization as q
from repro_torch.core.artemis_matmul import artemis_matmul
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.core.quantization import SC_LEVELS
from repro_torch.kernels.flash_attention import flash_attention

# ---------------------------------------------------------------------------
# policy-routed matmuls
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LanePolicy(ArithmeticPolicy):
    """An `ArithmeticPolicy` applied to a batch of independent lanes
    (axis 0): each lane's activations take their own per-tensor scale."""


def per_lane(policy: ArithmeticPolicy) -> LanePolicy:
    """`policy` over independent lanes; it must scale activations per
    tensor, which per lane it then does."""
    if policy.act_quant_axis is not None:
        raise ValueError(
            f"per-lane scales replace a per-tensor activation scale; "
            f"act_quant_axis={policy.act_quant_axis} is not per tensor")
    return LanePolicy(**dataclasses.asdict(policy))


def _lane_axes(t: torch.Tensor) -> tuple:
    return tuple(range(1, t.dim()))


def mm(x: torch.Tensor, w: torch.Tensor,
       policy: ArithmeticPolicy) -> torch.Tensor:
    """x: (..., K) activations, w: (K, N) weights -> (..., N), x.dtype.
    Under a `LanePolicy` x is (B, ..., K) over B independent lanes."""
    if policy.mode == "exact":
        return torch.matmul(x, w.to(x.dtype))
    if isinstance(policy, LanePolicy):
        policy = dataclasses.replace(policy, act_quant_axis=_lane_axes(x))
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
    (artemis included) is a plain int8 contraction here. Under a
    `LanePolicy` both operands and the output lead with the lane axis,
    and each lane's operands take their own scales."""
    lanes = isinstance(policy, LanePolicy)
    if lanes:
        sa = q.quant_scale(a, 8, _lane_axes(a))
        sb = q.quant_scale(b, 8, _lane_axes(b))
    else:
        sa = q.quant_scale(a, 8, policy.act_quant_axis)
        sb = q.quant_scale(b, 8, policy.act_quant_axis)
    aq, bq = q.quantize(a, sa), q.quantize(b, sb)
    dot = _int_einsum(spec, aq, bq)
    if policy.mode == "artemis_mxu":
        sgn = _int_einsum(spec, torch.sign(aq), torch.sign(bq))
        dot = dot - policy.rbar / SC_LEVELS * sgn
    if lanes:
        lane = (-1,) + (1,) * (dot.dim() - 1)
        sa, sb = sa.reshape(lane), sb.reshape(lane)
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
# parameters and initializers (same distributions as repro.models.layers)
# ---------------------------------------------------------------------------


def param(shape, dtype, device) -> nn.Parameter:
    """A zeroed weight, frozen: a serving model never asks for its
    gradient. A training model turns gradients on for all of its
    weights (`transformer.Transformer(train=True)`)."""
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device, dtype=torch.float32, lead: tuple = ()) -> torch.Tensor:
    """A (*lead, d_in, d_out) stack of independent dense weights."""
    scale = (1.0 / d_in) ** 0.5
    w = torch.randn((*lead, d_in, d_out), generator=generator,
                    device=device, dtype=torch.float32)
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
# attention (GQA, optional qk-norm, dense KV cache, sliding window)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


ATTN_IMPLS = ("flash", "gather")


def resolve_attn_impl(attn_impl: str | None,
                      policy: ArithmeticPolicy) -> str:
    """The attention core `attention` runs: "flash" (the kernel) for the
    exact policy and "gather" (the reference's masked-softmax math,
    through `qeinsum`) for a quantized one, unless asked otherwise. The
    kernel computes exact f32 attention, so "flash" with a quantized
    policy raises."""
    if attn_impl is None:
        return "gather" if policy.is_quantized() else "flash"
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    if attn_impl == "flash" and policy.is_quantized():
        raise ValueError(
            f"attn_impl='flash' computes exact fp32 attention and "
            f"cannot reproduce quantized policy mode "
            f"{policy.mode!r}; use attn_impl='gather'")
    return attn_impl


def _causal_mask(q_pos, k_pos, window: int):
    """q_pos: (B, Sq), k_pos: (B, Sk) -> (B, 1, Sq, Sk) bool (True=keep)."""
    dq = q_pos[:, None, :, None]
    dk = k_pos[:, None, None, :]
    keep = dk <= dq
    if window:
        keep = keep & (dk > dq - window)
    return keep


def _flash_core(qh, kh, vh, *, window: int, q_offset: int,
                kv_len: int | None, kv_cast):
    """Causal GQA attention of qh (B, S, H, Dh) over kh/vh (B, T, KV, Dh)
    through the flash-attention kernel, query row r at key position
    r + q_offset. The (B, heads, S, Dh) views are strided, not copied.
    Returns the context (B, S, H * Dh) in qh's dtype."""
    b, s, h, hd = qh.shape
    o = flash_attention(qh.transpose(1, 2), kh.transpose(1, 2),
                        vh.transpose(1, 2), causal=True,
                        window=window or None, scale=hd ** -0.5,
                        kv_len=kv_len, q_offset=q_offset, kv_cast=kv_cast)
    return o.transpose(1, 2).to(qh.dtype).reshape(b, s, h * hd)


def attention(p, x: torch.Tensor, dims: AttnDims, *, positions,
              kv_positions=None, policy=ArithmeticPolicy(), qk_norm=False,
              rope_theta=1e4, window=0, norm_eps=1e-6, cache=None,
              cache_index: int | torch.Tensor = 0,
              attn_impl: str | None = None):
    """GQA attention (counterpart of `repro.models.layers.attention`).
    x: (B, S, D); p: an object with wq, wk, wv, wo (and q_norm, k_norm
    when qk_norm).

    cache: optional dict {"k","v"}: (B, Smax, KV, Dh), UPDATED IN PLACE
    (the reference returns updated copies); cache_index: the host int
    write offset, or a (B,) tensor of per-lane offsets for one token a
    lane (S == 1; the gather core; what the reference's per-lane vmap
    writes at batch 1). Returns (out, the cache dict or None).

    attn_impl (see `resolve_attn_impl`): "gather" is the reference's
    math, masked by `positions` / `kv_positions`; "flash" runs the
    kernel, which derives its mask from the layout instead: query row r
    at position cache_index + r (in-sequence: r), cache slot c at
    position c, so it takes no `kv_positions` and assumes `positions`
    are those contiguous ones.
    """
    impl = resolve_attn_impl(attn_impl, policy)
    per_lane = isinstance(cache_index, torch.Tensor)
    if impl == "flash" and (kv_positions is not None or per_lane):
        raise ValueError("attn_impl='flash' derives the key mask from "
                         "a host cache_index; it takes no kv_positions")
    b, s, _ = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    qh = mm(x, p.wq, policy).reshape(b, s, h, hd)
    kh = mm(x, p.wk, policy).reshape(b, s, kv, hd)
    vh = mm(x, p.wv, policy).reshape(b, s, kv, hd)
    if qk_norm:
        qh = headwise_rmsnorm(p.q_norm, qh, norm_eps)
        kh = headwise_rmsnorm(p.k_norm, kh, norm_eps)
    qh = apply_rope(qh, positions, rope_theta)
    kh = apply_rope(kh, positions, rope_theta)

    new_kv = None
    # in-sequence attention unless a cache shorter than the input holds
    # the keys: flash's query offset and key length, gather's key mask
    q_offset, kv_len, kv_cast = 0, None, None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        smax = ck.shape[1]
        new_kv = cache
        if s >= smax:
            # prefill longer than the cache ring: attend in-sequence
            # (the window mask handles causality) and store only the
            # LAST smax tokens
            ck.copy_(kh[:, -smax:])
            cv.copy_(vh[:, -smax:])
            kv_positions = None
        else:
            if per_lane:
                if s != 1:
                    raise ValueError(f"a per-lane cache_index writes one "
                                     f"token a lane, got S={s}")
                rows = torch.arange(b, device=x.device)
                ck[rows, cache_index] = kh[:, 0].to(ck.dtype)
                cv[rows, cache_index] = vh[:, 0].to(cv.dtype)
            else:
                # dynamic_update_slice clamps the offset so the write fits
                start = min(max(cache_index, 0), smax - s)
                ck[:, start:start + s] = kh.to(ck.dtype)
                cv[:, start:start + s] = vh.to(cv.dtype)
            if impl == "flash":
                q_offset = cache_index
                kv_len = min(q_offset + s, smax)
                kv_cast = x.dtype
                kh, vh = ck, cv
            else:
                kh, vh = ck.to(x.dtype), cv.to(x.dtype)
                if kv_positions is None:
                    kv_positions = torch.arange(
                        smax, dtype=torch.int32,
                        device=x.device)[None].expand(b, smax)
    if impl == "flash":
        ctx = _flash_core(qh, kh, vh, window=window, q_offset=q_offset,
                          kv_len=kv_len, kv_cast=kv_cast)
        return mm(ctx, p.wo, policy), new_kv
    if kv_positions is None:
        kv_positions = positions

    g = h // kv
    qg = qh.reshape(b, s, kv, g, hd)
    scores = qeinsum("bskgd,btkd->bkgst", qg, kh, policy)
    scores = scores.float() * (hd ** -0.5)
    mask = _causal_mask(positions, kv_positions, window)       # (B,1,Sq,Sk)
    scores = torch.where(mask[:, :, None, :, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = qeinsum("bkgst,btkd->bskgd", probs, vh, policy)
    ctx = ctx.reshape(b, s, h * hd)
    return mm(ctx, p.wo, policy), new_kv


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

ACTS = {"silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x))}


def ffn(p, x: torch.Tensor, act: str, glu: bool,
        policy: ArithmeticPolicy = ArithmeticPolicy()) -> torch.Tensor:
    """p: an object with `w_up`, `w_down` (and `w_gate` when glu)."""
    up = mm(x, p.w_up, policy)
    if glu:
        up = ACTS[act](mm(x, p.w_gate, policy)) * up
    else:
        up = ACTS[act](up)
    return mm(up, p.w_down, policy)
