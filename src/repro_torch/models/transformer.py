"""Decoder-only transformer as an `nn.Module` (counterpart of
`repro.models.transformer`, the dense and MoE families).

The module holds what the reference's parameter pytree holds, with the
stacked leading L axis of `params["layers"]` unstacked into a
`ModuleList` of blocks (the reference's `lax.scan` over layers becomes
a Python loop):

  embed       (V, d)
  layers[i]   ln1.scale, attn.{wq,wk,wv,wo,q_norm,k_norm}, ln2.scale,
              and ffn.{w_up,w_gate,w_down} (dense) or
              moe.{router, experts.*, shared.*} (MoE; `models/moe.py`)
  final_norm  scale (d,)
  head        (d, V); absent if tied

Storage dtypes: the reference casts every matrix that reaches `mm`,
the embedding and the head to the compute dtype on every call
(`w.astype(x.dtype)`). A serving model casts them ONCE, when they are
set, which is bit-identical and saves re-reading f32 weights each
forward. A training model (`train=True`) keeps every weight in the
reference's `param_dtype` (f32 master weights) with gradients on, and
each use casts where the reference casts: `layers.mm` the matrices,
`embed_tokens` after the gather, `logits` the head. The norm scales and
the MoE router stay f32 in both: the reference reads them as f32,
never in the compute dtype.

KV cache layout (decode): {"k"/"v": (L, B, Smax, KV, Dh), "index": int}.
`apply` is the single forward entry point, as in the reference: no
cache (in-sequence: the train step), prefill (cache at index 0) and
decode (S == 1).
The cache's `index` is a host int, not a device scalar: the positions
and the key mask follow from it without a device-to-host sync per
step, and the flash-attention kernel takes it as a launch argument.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
FAMILIES = ("dense", "moe")


def torch_dtype(name: str) -> torch.dtype:
    """A torch dtype from the reference's dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = L.param((d,), torch.float32, device)
        nn.init.ones_(self.scale)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        self.wq = L.param((d, h * hd), dtype, device)
        self.wk = L.param((d, kv * hd), dtype, device)
        self.wv = L.param((d, kv * hd), dtype, device)
        self.wo = L.param((h * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = L.param((hd,), torch.float32, device)
            self.k_norm = L.param((hd,), torch.float32, device)
            nn.init.ones_(self.q_norm)
            nn.init.ones_(self.k_norm)


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_up = L.param((d, f), dtype, device)
        self.w_down = L.param((f, d), dtype, device)
        if cfg.glu:
            self.w_gate = L.param((d, f), dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        if cfg.family == "moe":
            self.moe = M.MoE(cfg, dtype, device)
        else:
            self.ffn = FFN(cfg, dtype, device)


def block_ffn(lp: Block, x: torch.Tensor, cfg: ModelConfig,
              policy: ArithmeticPolicy):
    """The FFN half of a block on its normed input x: (out, aux), aux
    the MoE layer's load-balance loss (None for the dense family)."""
    if cfg.family == "moe":
        return M.moe_ffn(lp.moe, x, cfg, policy)
    return L.ffn(lp.ffn, x, cfg.act, cfg.glu, policy), None


class Transformer(nn.Module):
    """The decoder's weights. Build it empty (zeros) and fill it with
    `init` (seeded random weights) or `repro_torch.bridge`. `train`
    stores the weights in `param_dtype` with gradients on; otherwise
    they are frozen in the compute dtype."""

    def __init__(self, cfg: ModelConfig, device="cuda", train: bool = False):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet "
                f"(ported: {FAMILIES})")
        if cfg.modality != "text":
            raise NotImplementedError(
                f"modality {cfg.modality!r} is not ported yet (text only)")
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        dt = torch_dtype(cfg.param_dtype) if train else self.compute_dtype
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = L.param((v, d), dt, device)
        self.layers = nn.ModuleList(
            Block(cfg, dt, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(d, device)
        self.head = None if cfg.tie_embeddings else L.param((d, v), dt, device)
        self.requires_grad_(train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Seeded random weights with the reference's distributions
        (`layers.dense_init` / `embed_init`; norm scales are ones).
        Each matrix is drawn in f32, rounded to the reference's
        `param_dtype`, then stored in the model's dtype. The stream of
        `generator` is not jax's, so the values differ from
        `repro.models.model.init` for the same seed."""
        cfg, dev = self.cfg, self.device
        pdt = torch_dtype(cfg.param_dtype)

        def dense(w):
            # a stack of matrices (experts) draws them all at once
            *lead, d_in, d_out = w.shape
            w.copy_(L.dense_init(generator, d_in, d_out, dev, pdt,
                                 lead=tuple(lead)))

        self.embed.copy_(L.embed_init(generator, *self.embed.shape, dev, pdt))
        for blk in self.layers:
            for name in ("wq", "wk", "wv", "wo"):
                dense(getattr(blk.attn, name))
            if cfg.family == "moe":
                dense(blk.moe.router)
                ffns = [f for f in (blk.moe.experts, blk.moe.shared)
                        if f is not None]
            else:
                ffns = [blk.ffn]
            for ffn in ffns:
                for name in ("w_up", "w_down", "w_gate"):
                    if hasattr(ffn, name):
                        dense(getattr(ffn, name))
        if self.head is not None:
            dense(self.head)
        return self

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """`transformer._embed_tokens` for text: (B, S) -> (B, S, d) in
        the compute dtype, cast after the gather as the reference casts."""
        x = F.embedding(tokens, self.embed).to(self.compute_dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """`transformer._logits` for text: (B, S, d) -> (B, S, V)."""
        if self.head is None:
            return torch.matmul(x, self.embed.to(x.dtype).T)
        return torch.matmul(x, self.head.to(x.dtype))


def init(cfg: ModelConfig, seed: int = 0, device="cuda",
         train: bool = False) -> Transformer:
    """A model with seeded random weights on `device` (trainable f32
    master weights with `train`)."""
    model = Transformer(cfg, device=device, train=train)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init(gen)


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """A zeroed dense KV cache: {"k","v": (L, B, max_len, KV, Dh),
    "index": 0}."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "index": 0}


def _block(lp: Block, x: torch.Tensor, cfg: ModelConfig, policy, positions,
           kv_positions, ckv, index, impl):
    """One decoder layer (the reference's `_block`): (x, aux or None)."""
    h, _ = L.attention(
        lp.attn, L.rmsnorm(lp.ln1.scale, x, cfg.norm_eps), _dims(cfg),
        positions=positions, kv_positions=kv_positions, policy=policy,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.attn_window, norm_eps=cfg.norm_eps, cache=ckv,
        cache_index=index, attn_impl=impl)
    x = x + h
    f, a = block_ffn(lp, L.rmsnorm(lp.ln2.scale, x, cfg.norm_eps), cfg,
                     policy)
    return x + f, a


def apply(model: Transformer, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None,
          remat: bool = False):
    """Forward pass (counterpart of `repro.models.transformer.apply`).

    inputs: {"tokens": (B, S) int, optional "positions": (B, S) int}.
    attn_impl: see `layers.resolve_attn_impl` ("flash", the kernel, for
    the exact policy by default); explicit positions need "gather",
    because the kernel's mask assumes contiguous ones.
    remat: recompute each layer in the backward pass instead of keeping
    its activations (`torch.utils.checkpoint`, the reference's
    `jax.checkpoint` of its scan body); without a cache only, and only
    while autograd records.
    Returns (logits (B, S, V), aux_loss (the sum of the MoE layers'
    load-balance losses; 0 for the dense family), new_cache). The
    cache's K/V tensors are updated IN PLACE, layer by layer, and
    returned in new_cache with index + S.
    """
    impl = L.resolve_attn_impl(attn_impl, policy)
    positions = inputs.get("positions")
    if positions is not None and impl == "flash":
        raise ValueError(
            "attn_impl='flash' assumes contiguous positions (cache index "
            "+ arange(S)); explicit inputs['positions'] need "
            "attn_impl='gather'")
    x = model.embed_tokens(inputs["tokens"])
    b, s, _ = x.shape
    index = cache["index"] if cache is not None else 0
    if positions is None:
        positions = (index + torch.arange(s, dtype=torch.int32,
                                          device=x.device))[None].expand(b, s)
    kv_positions = None
    if cache is not None and impl == "gather":
        smax = cache["k"].shape[2]
        t = torch.arange(smax, dtype=torch.int32,
                         device=x.device)[None].expand(b, smax)
        # mask out cache slots not yet written
        kv_positions = torch.where(t <= positions.max(), t,
                                   torch.iinfo(torch.int32).max)

    remat = remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, lp in enumerate(model.layers):
        ckv = None
        if cache is not None:
            ckv = {"k": cache["k"][li], "v": cache["v"][li]}
        args = (lp, x, cfg, policy, positions, kv_positions, ckv, index, impl)
        if remat:
            x, a = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, a = _block(*args)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = model.logits(x)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "index": index + s}
    return logits, aux, new_cache
