"""RWKV-6 "Finch" in PyTorch (counterpart of `repro.models.rwkv6`):
attention-free, with a data-dependent per-channel decay.

  S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: (H, N, N))
  o_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t   (bonus on the current token)

`_wkv_chunked` evaluates it exactly, chunk by chunk, as the reference
does: within a chunk the pairwise decay exp(lc_{t-1} - lc_m) (<= 1) is
contracted directly, and a loop over chunks carries S. Time mix uses
the ddlerp (low-rank data-dependent token-shift mixing); channel mix
is the squared-ReLU MLP; the norms are LayerNorms.

Only the nine projections (`td_w1`, `wr`, `wk`, `wv`, `wg`, `wo`,
`cm_wk`, `cm_wv`, `cm_wr`) go through the policy (`layers.mm`); the
LoRA einsums, `td_w2`'s f32 product and the wkv recurrence stay exact.

The module holds the reference's tree (`layers` stacked on L there, a
`ModuleList` here). Storage: what the reference casts to the compute
dtype on use (the projections, the token-shift mixes, the LoRA
matrices, the embedding and head) is stored cast once; what it reads
in f32 (the LayerNorms, `td_base`, `td_w2`, `u`) stays in f32. A
training model (`train=True`) keeps every weight in `param_dtype` (f32
master weights) with gradients on, and each use casts where the
reference casts. `apply(remat=True)` recomputes each layer in the
backward pass (`torch.utils.checkpoint`, the reference's
`jax.checkpoint` of its scan body).

The clips are written `minimum(maximum(x, lo), hi)`, as `jnp.clip`
is: the same values as `torch.clamp`, and jax's gradient, which
splits 1/2 and 1/2 where x equals a bound (`torch.clamp` passes all of
it). In the chunk's kept sub-diagonal the wkv exponent is often
exactly 0, the clip's upper bound.

Decode cache: {"layers": {"x_tm", "x_cm": (L, B, d), "wkv": (L, B, H,
N, N)}, "index"}, always f32 (`repro.models.model.init_cache`), its
state UPDATED IN PLACE by `apply`. `index` is a host int, or a (B,)
tensor of per-lane indices: then the batch is a set of independent
lanes (the state-slot steps) and a quantized policy scales each lane on
its own (`layers` module docstring).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, torch_dtype

LORA_MIX = 32     # ddlerp rank
LORA_DECAY = 64   # decay lora rank


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`: min(max(x, lo), hi), with its gradient at the
    bounds (module docstring)."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = L.param((d,), torch.float32, device)
        self.bias = L.param((d,), torch.float32, device)
        nn.init.ones_(self.scale)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the population variance (`jnp.var`)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    x = xc * torch.rsqrt(var + eps)
    return (x * p.scale.float() + p.bias.float()).to(dt)


class Block(nn.Module):
    """One layer's weights, the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        h, n = d // cfg.ssm_head_dim, cfg.ssm_head_dim
        f32 = torch.float32
        self.ln1 = LayerNorm(d, device)
        self.ln2 = LayerNorm(d, device)
        self.maa_x = L.param((d,), dtype, device)
        self.maa_wkvrg = L.param((5, d), dtype, device)
        self.maa_w1 = L.param((d, 5 * LORA_MIX), dtype, device)
        self.maa_w2 = L.param((5, LORA_MIX, d), dtype, device)
        self.td_base = L.param((d,), f32, device)
        self.td_w1 = L.param((d, LORA_DECAY), dtype, device)
        self.td_w2 = L.param((LORA_DECAY, d), f32, device)
        self.u = L.param((h, n), f32, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, L.param((d, d), dtype, device))
        self.ln_x = LayerNorm(d, device)
        self.cm_maa_k = L.param((d,), dtype, device)
        self.cm_maa_r = L.param((d,), dtype, device)
        self.cm_wk = L.param((d, dff), dtype, device)
        self.cm_wv = L.param((dff, d), dtype, device)
        self.cm_wr = L.param((d, d), dtype, device)


class RWKV6(nn.Module):
    """The model's weights: embed, ln0, layers, final_norm, head. Build
    it empty and fill it with `init` or `repro_torch.bridge`. `train`
    stores every weight in `param_dtype` with gradients on."""

    embed_tokens = Transformer.embed_tokens
    logits = Transformer.logits
    device = Transformer.device

    def __init__(self, cfg: ModelConfig, device="cuda", train: bool = False):
        super().__init__()
        if cfg.family != "rwkv6":
            raise ValueError(f"RWKV6 holds the rwkv6 family, got "
                             f"{cfg.family!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        dt = torch_dtype(cfg.param_dtype) if train else self.compute_dtype
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = L.param((v, d), dt, device)
        self.ln0 = LayerNorm(d, device)
        self.layers = nn.ModuleList(
            Block(cfg, dt, device) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(d, device)
        self.head = None if cfg.tie_embeddings else L.param((d, v), dt, device)
        self.requires_grad_(train)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "RWKV6":
        """Seeded random weights with the reference's distributions
        (`rwkv6_layer_init`), drawn in f32 and rounded to `param_dtype`
        before they are stored. The stream is torch's, not jax's."""
        cfg, dev = self.cfg, self.device
        pdt = torch_dtype(cfg.param_dtype)

        def normal(w, scale):
            w.copy_((torch.randn(w.shape, generator=generator, device=dev)
                     * scale).to(pdt))

        def dense(w):
            w.copy_(L.dense_init(generator, *w.shape, dev, pdt))

        self.embed.copy_(L.embed_init(generator, *self.embed.shape, dev, pdt))
        for blk in self.layers:
            for name in ("maa_x", "maa_wkvrg", "cm_maa_k", "cm_maa_r", "u"):
                getattr(blk, name).fill_(0.5)
            blk.td_base.fill_(-1.0)
            for name in ("maa_w1", "maa_w2", "td_w1", "td_w2"):
                normal(getattr(blk, name), 1e-2)
            for name in ("wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wv",
                         "cm_wr"):
                dense(getattr(blk, name))
        if self.head is not None:
            dense(self.head)
        return self


def init(cfg: ModelConfig, seed: int = 0, device="cuda",
         train: bool = False) -> RWKV6:
    model = RWKV6(cfg, device=device, train=train)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init(gen)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               dtype=torch.float32, device="cuda") -> dict:
    """The decode carry, stacked (L, ...); max_len unused (O(1) state)."""
    h, n = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    dev = resolve_device(device)
    lead = (cfg.n_layers, batch)
    return {"layers": {
        "x_tm": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=dev),
        "x_cm": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=dev),
        "wkv": torch.zeros(lead + (h, n, n), dtype=dtype, device=dev)},
        "index": 0}


# ---------------------------------------------------------------------------
# chunked wkv
# ---------------------------------------------------------------------------


def _wkv_chunked(r, k, v, log_w, u, s0, chunk: int):
    """r,k: (B,S,H,N); v: (B,S,H,Nv); log_w: (B,S,H,N) <= 0; u: (H,N);
    s0: (B,H,N,Nv). N counts the key channels and Nv the value ones
    (both the head size, but for a tensor-parallel rank's part).

    Returns (o: (B,S,H,Nv), s_final). The reference's three-operand
    einsums run as two-operand contractions after the elementwise
    factor."""
    b, s, h, n = r.shape
    nv = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v, log_w = (torch.nn.functional.pad(a, z)
                          for a in (r, k, v, log_w))
    nc = r.shape[1] // chunk
    r, k, log_w = (a.reshape(b, nc, chunk, h, n) for a in (r, k, log_w))
    v = v.reshape(b, nc, chunk, h, nv)
    lc = torch.cumsum(log_w, dim=2)                   # inclusive
    # exclusive cumsum for the output side (S_{t-1} uses lc_{t-1})
    lx = lc - log_w
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    state = s0
    outs = []
    for c in range(nc):
        rc, kc, vc, lcc, lxc = (a[:, c] for a in (r, k, v, lc, lx))
        # bonus (current token)
        # intra: A[t,m] = sum_i r_t k_m exp(lx_t - lc_m), m < t
        dec = torch.exp(clip(
            lxc[:, :, None, :, :] - lcc[:, None, :, :, :], -60.0, 0.0))
        amat = torch.einsum("btmhn,bmhn->bhtm", rc[:, :, None] * dec, kc)
        amat = torch.where(strict[None, None], amat,
                           torch.zeros((), dtype=amat.dtype,
                                       device=amat.device))
        o = torch.einsum("bhtm,bmhn->bthn", amat, vc)
        # bonus (current token)
        o = o + torch.einsum("bthn,bthn->bth", rc * u, kc)[..., None] * vc
        # inter: o_t += (r_t * exp(lx_t)) . S0
        o = o + torch.einsum("bthn,bhnj->bthj", rc * torch.exp(lxc), state)
        # state: S' = diag(exp(lc_L)) S0 + sum_m exp(lc_L - lc_m) k_m v_m^T
        dlast = torch.exp(lcc[:, -1, None, :, :] - lcc)   # (B,L,H,N)
        state = state * torch.exp(lcc[:, -1])[:, :, :, None] \
            + torch.einsum("bmhn,bmhj->bhnj", kc * dlast, vc)
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(b, nc * chunk, h, nv)
    return o[:, :s], state


# ---------------------------------------------------------------------------
# layer forward
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: the previous token's activation. x: (B,S,d), prev:
    (B,d) or None (zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def rwkv6_layer(p: Block, x: torch.Tensor, cfg: ModelConfig,
                policy: ArithmeticPolicy = ArithmeticPolicy(), state=None,
                tp=None):
    """x: (B, S, d) -> (out, new_state or None); the state is not
    modified. `tp`: a tensor-parallel rank's seams (module docstring),
    for a layer holding that rank's part of the weights."""
    b, s, d = x.shape
    hn = cfg.ssm_head_dim
    mm = L.mm if tp is None else tp.mm
    # this rank's wkv heads and key channels a head (all of them on one
    # device)
    h, n = p.u.shape

    # ---- time mix ---------------------------------------------------------
    xt = layernorm(p.ln1, x)
    dt = xt.dtype
    prev = state["x_tm"].to(dt) if state is not None else None
    xprev = _shift(xt, prev)
    dx = xprev - xt
    xxx = xt + dx * p.maa_x.to(dt)
    delta = torch.tanh(torch.einsum("bsd,dr->bsr", xxx, p.maa_w1.to(dt))
                       ).reshape(b, s, 5, LORA_MIX)
    dyn = torch.einsum("bsfr,frd->bsfd", delta, p.maa_w2.to(dt))
    mixes = xt[:, :, None] + dx[:, :, None] * (
        p.maa_wkvrg.to(dt)[None, None] + dyn)             # (B,S,5,d)
    mw, mk, mv, mr, mg = mixes.unbind(2)

    dd = torch.tanh(mm(mw, p.td_w1, policy)).float()
    if tp is not None:
        dd = tp.enter(dd)        # td_w2's columns are the rank's channels
    log_w = -torch.exp(clip(
        p.td_base.float()[None, None] + torch.matmul(dd, p.td_w2.float()),
        -8.0, 6.0))

    # projections go through the policy ladder; the wkv recurrence
    # itself stays exact f32
    r = mm(mr, p.wr, policy).reshape(b, s, h, n).float()
    k = mm(mk, p.wk, policy).reshape(b, s, h, n).float()
    v = mm(mv, p.wv, policy)
    if tp is not None and n < hn:
        v = tp.enter(v)          # whole, read by the rank's key channels
    v = v.reshape(b, s, h, hn).float()
    g = torch.nn.functional.silu(mm(mg, p.wg, policy))
    log_w = log_w.reshape(b, s, h, n)

    s0 = (state["wkv"].float() if state is not None
          else torch.zeros((b, h, n, hn), dtype=torch.float32,
                           device=x.device))
    o, s_final = _wkv_chunked(r, k, v, log_w, p.u.float(), s0,
                              min(cfg.chunk_size, max(s, 1)))
    o = o.reshape(b, s, h * hn)
    if tp is None:
        o = layernorm(p.ln_x, o.to(x.dtype)) * g
        x = x + L.mm(o, p.wo, policy)
    else:
        # ln_x normalizes over the whole d: the heads gathered, or the
        # key channels' partial readouts summed (in f32), first
        o = tp.gather(o.to(x.dtype)) if n == hn else \
            tp.reduce(o).to(x.dtype)
        x = x + tp.whole_out(layernorm(p.ln_x, o), p.wo, policy, gate=g)

    # ---- channel mix (a squared ReLU of its own, not `layers.ffn`) --------
    xc = layernorm(p.ln2, x)
    prevc = state["x_cm"].to(xc.dtype) if state is not None else None
    dxc = _shift(xc, prevc) - xc
    xk = xc + dxc * p.cm_maa_k.to(xc.dtype)
    xr = xc + dxc * p.cm_maa_r.to(xc.dtype)
    kk = torch.square(torch.relu(mm(xk, p.cm_wk, policy)))
    if tp is None:
        cm = torch.sigmoid(L.mm(xr, p.cm_wr, policy)) \
            * L.mm(kk, p.cm_wv, policy)
    else:
        cm = tp.gather(torch.sigmoid(mm(xr, p.cm_wr, policy))) \
            * tp.out_proj(kk, p.cm_wv, policy, k_full=cfg.d_ff)
    x = x + cm

    new_state = None
    if state is not None:
        new_state = {"x_tm": xt[:, -1].to(state["x_tm"].dtype),
                     "x_cm": xc[:, -1].to(state["x_cm"].dtype),
                     "wkv": s_final.to(state["wkv"].dtype)}
    return x, new_state


# ---------------------------------------------------------------------------
# model level (embed -> layers -> head)
# ---------------------------------------------------------------------------


def apply(model: RWKV6, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None,
          remat: bool = False, tp=None):
    """Returns (logits, aux (= 0), new_cache). The family has no
    attention, so `attn_impl` is not read. The cache's state tensors
    are updated IN PLACE and returned with index + S. `remat`
    recomputes each layer in the backward pass; without a cache only,
    and only while autograd records. `tp`: a tensor-parallel rank's
    seams for a model holding its part of the weights (module
    docstring); the cache then holds the rank's part of the wkv state
    (`tensor_parallel.rank_cache`), and every rank ends with the same
    logits."""
    x = model.embed_tokens(inputs["tokens"],
                           lookup=F.embedding if tp is None else tp.embedding)
    x = layernorm(model.ln0, x)
    s = x.shape[1]
    if cache is not None and isinstance(cache["index"], torch.Tensor):
        policy = L.per_lane(policy)
    remat = remat and cache is None and torch.is_grad_enabled()
    for li, lp in enumerate(model.layers):
        st = None
        if cache is not None:
            st = {k: a[li] for k, a in cache["layers"].items()}
        if remat:
            x, new_st = checkpoint(rwkv6_layer, lp, x, cfg, policy, None, tp,
                                   use_reentrant=False)
        else:
            x, new_st = rwkv6_layer(lp, x, cfg, policy, st, tp)
        if cache is not None:
            for k, a in new_st.items():
                st[k].copy_(a)
    x = layernorm(model.final_norm, x)
    logits = model.logits(x) if tp is None else tp.logits(model, x)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": cache["layers"], "index": cache["index"] + s}
    return logits, torch.zeros((), dtype=torch.float32,
                               device=x.device), new_cache
