"""Decoder-only transformer as an `nn.Module` (counterpart of
`repro.models.transformer`, the dense and MoE families).

The module holds what the reference's parameter pytree holds, with the
stacked leading L axis of `params["layers"]` unstacked into a
`ModuleList` of blocks (the reference's `lax.scan` over layers becomes
a Python loop):

  embed       (V, d)            audio: (C, V, d), one per codebook
  layers[i]   ln1.scale, attn.{wq,wk,wv,wo,q_norm,k_norm}, ln2.scale,
              and ffn.{w_up,w_gate,w_down} (dense) or
              moe.{router, experts.*, shared.*} (MoE; `models/moe.py`)
  final_norm  scale (d,)
  head        (d, V)            audio: (C, d, V); absent if tied

Storage dtypes: the reference casts every matrix that reaches `mm`,
the embedding and the head to the compute dtype on every call
(`w.astype(x.dtype)`). A serving model casts them ONCE, when they are
set, which is bit-identical and saves re-reading f32 weights each
forward. A training model (`train=True`) keeps every weight in the
reference's `param_dtype` (f32 master weights) with gradients on, and
each use casts where the reference casts: `layers.mm` the matrices,
`embed_tokens` after the gather, `logits` the head. The norm scales and
the MoE router stay f32 in both: the reference reads them as f32,
never in the compute dtype. Audio's embedding is the exception: the
reference gathers its C codebook rows from the f32 table and sums them
in f32 before the cast, and a cast does not commute with a sum, so
every audio model keeps `embed` in `param_dtype`.

Modalities: audio tokens are (B, S, C), C = `n_codebooks`; their
embeddings are summed and the head predicts every codebook, logits (B,
S, C, V). A vlm forward takes `inputs["prefix_embeds"]` (B, P, d)
(`models/frontend.py`), put before the token embeddings: positions
and the cache run over P + S.

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
              policy: ArithmeticPolicy, tp=None):
    """The FFN half of a block on its normed input x: (out, aux), aux
    the MoE layer's load-balance loss (None for the dense family).
    `tp`: a tensor-parallel rank's `parallel.tensor_parallel.
    TensorParallel`, for a model holding that rank's part of the
    weights."""
    if cfg.family == "moe":
        return M.moe_ffn(lp.moe, x, cfg, policy, tp=tp)
    if tp is None:
        return L.ffn(lp.ffn, x, cfg.act, cfg.glu, policy), None

    def down(h, w, pol):
        return tp.out_proj(h, w, pol, k_full=cfg.d_ff)
    return L.ffn(lp.ffn, x, cfg.act, cfg.glu, policy, proj=tp.mm,
                 down=down), None


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
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        dt = torch_dtype(cfg.param_dtype) if train else self.compute_dtype
        self.embed, self.head = vocab_params(cfg, dt, device)
        self.layers = nn.ModuleList(
            Block(cfg, dt, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.requires_grad_(train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Seeded random weights with the reference's distributions
        (`init_values`), stored in the model's dtype. The stream of
        `generator` is not jax's, so the values differ from
        `repro.models.model.init` for the same seed."""
        for name, value in self.init_values(generator, self.device):
            self.get_parameter(name).copy_(value)
        return self

    def init_values(self, generator: torch.Generator, device):
        """(parameter name, whole value) of `init`'s weights, one leaf at
        a time, in the order they are drawn (`layers.dense_init` /
        `embed_init`, each matrix drawn in f32 and rounded to the
        reference's `param_dtype`; norm scales are ones). Only the
        parameters' shapes are read, so a model on the meta device
        gives the same stream."""
        cfg = self.cfg
        pdt = torch_dtype(cfg.param_dtype)

        def dense(name):
            # a stack of matrices (experts) draws them all at once
            *lead, d_in, d_out = self.get_parameter(name).shape
            return name, L.dense_init(generator, d_in, d_out, device, pdt,
                                      lead=tuple(lead))

        v, d = self.embed.shape[-2:]
        tables = [L.embed_init(generator, v, d, device, pdt)
                  for _ in range(self.embed.numel() // (v * d))]
        yield "embed", torch.stack(tables).reshape(self.embed.shape)
        drawn = {"embed"}
        for i, blk in enumerate(self.layers):
            names = [f"layers.{i}.attn.{w}" for w in ("wq", "wk", "wv", "wo")]
            if cfg.family == "moe":
                names.append(f"layers.{i}.moe.router")
                ffns = [(f"layers.{i}.moe.{part}", f) for part, f in
                        (("experts", blk.moe.experts),
                         ("shared", blk.moe.shared)) if f is not None]
            else:
                ffns = [(f"layers.{i}.ffn", blk.ffn)]
            for prefix, ffn in ffns:
                names += [f"{prefix}.{w}" for w in ("w_up", "w_down",
                                                    "w_gate")
                          if hasattr(ffn, w)]
            for name in names:
                yield dense(name)
            drawn.update(names)
        if self.head is not None:
            yield dense("head")
            drawn.add("head")
        for name, p in self.named_parameters():
            if name not in drawn:               # norm scales
                yield name, torch.ones(p.shape, device=device)

    def embed_tokens(self, tokens: torch.Tensor,
                     lookup=F.embedding) -> torch.Tensor:
        """`transformer._embed_tokens`: (B, S) [audio: (B, S, C)] ->
        (B, S, d) in the compute dtype, cast after the gather (audio:
        after the f32 sum over codebooks) as the reference casts.
        `lookup(tokens, table)` gathers the rows (the vocab-parallel
        seam: `TensorParallel.embedding`)."""
        table = self.embed   # read once: a data-parallel rank's read gathers
        if self.cfg.modality == "audio":
            x = sum(lookup(tokens[..., c], table[c])
                    for c in range(table.shape[0]))
        else:
            x = lookup(tokens, table)
        x = x.to(self.compute_dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """`transformer._logits`: (B, S, d) -> (B, S, V) [audio: (B, S,
        C, V)]."""
        audio = self.cfg.modality == "audio"
        head = self.head   # read once: a data-parallel rank's read gathers
        if head is None:
            w = self.embed.to(x.dtype)
            if audio:
                return torch.einsum("bsd,cvd->bscv", x, w)
            return torch.matmul(x, w.T)
        if audio:
            return torch.einsum("bsd,cdv->bscv", x, head.to(x.dtype))
        return torch.matmul(x, head.to(x.dtype))


def vocab_params(cfg: ModelConfig, dtype, device):
    """(embed, head or None) of the config, zeroed: audio draws one
    table and one head per codebook and keeps its table in
    `param_dtype` (module docstring)."""
    v, d = cfg.padded_vocab, cfg.d_model
    lead = (cfg.n_codebooks,) if cfg.modality == "audio" else ()
    edt = torch_dtype(cfg.param_dtype) if lead else dtype
    embed = L.param(lead + (v, d), edt, device)
    head = None if cfg.tie_embeddings else L.param(lead + (d, v), dtype,
                                                   device)
    return embed, head


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
           kv_positions, ckv, index, impl, tp=None):
    """One decoder layer (the reference's `_block`): (x, aux or None).
    `tp`: a tensor-parallel rank's seams (`block_ffn`)."""
    seams = dict(dims=_dims(cfg)) if tp is None else tp.attention()
    h, _ = L.attention(
        lp.attn, L.rmsnorm(lp.ln1.scale, x, cfg.norm_eps),
        positions=positions, kv_positions=kv_positions, policy=policy,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.attn_window, norm_eps=cfg.norm_eps, cache=ckv,
        cache_index=index, attn_impl=impl, **seams)
    x = x + h
    f, a = block_ffn(lp, L.rmsnorm(lp.ln2.scale, x, cfg.norm_eps), cfg,
                     policy, tp=tp)
    return x + f, a


def apply(model: Transformer, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None,
          remat: bool = False, tp=None):
    """Forward pass (counterpart of `repro.models.transformer.apply`).

    inputs: {"tokens": (B, S) int [audio: (B, S, C)], optional
    "prefix_embeds": (B, P, d) (vlm), optional "positions": (B, S) int}.
    attn_impl: see `layers.resolve_attn_impl` ("flash", the kernel, for
    the exact policy by default); explicit positions need "gather",
    because the kernel's mask assumes contiguous ones.
    remat: recompute each layer in the backward pass instead of keeping
    its activations (`torch.utils.checkpoint`, the reference's
    `jax.checkpoint` of its scan body); without a cache only, and only
    while autograd records.
    Returns (logits (B, S, V) [audio: (B, S, C, V); vlm: S counts the
    prefix], aux_loss (the sum of the MoE layers'
    load-balance losses; 0 for the dense family), new_cache). The
    cache's K/V tensors are updated IN PLACE, layer by layer, and
    returned in new_cache with index + S.
    tp: a tensor-parallel rank's `parallel.tensor_parallel.
    TensorParallel` (the sharded train step's, the dry run's serving
    cells), for a model holding that rank's part of the weights: the
    embedding, the layers and the logits go through its seams, and
    every rank ends with the same logits; a cache then holds the rank's
    KV heads (`TensorParallel.attn_dims`).
    """
    impl = L.resolve_attn_impl(attn_impl, policy)
    positions = inputs.get("positions")
    if positions is not None and impl == "flash":
        raise ValueError(
            "attn_impl='flash' assumes contiguous positions (cache index "
            "+ arange(S)); explicit inputs['positions'] need "
            "attn_impl='gather'")
    if tp is not None and cache is not None and \
            cache["k"].shape[3] != tp.attn_dims.n_kv_heads:
        raise ValueError(f"a tensor-parallel rank's cache holds its "
                         f"{tp.attn_dims.n_kv_heads} KV heads, got "
                         f"{cache['k'].shape[3]}")
    x = model.embed_tokens(inputs["tokens"],
                           lookup=F.embedding if tp is None else tp.embedding)
    prefix = inputs.get("prefix_embeds")
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
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
        args = (lp, x, cfg, policy, positions, kv_positions, ckv, index, impl,
                tp)
        if remat:
            x, a = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, a = _block(*args)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = model.logits(x) if tp is None else tp.logits(model, x)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "index": index + s}
    return logits, aux, new_cache
