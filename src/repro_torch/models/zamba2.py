"""Zamba2-style hybrid in PyTorch (counterpart of
`repro.models.zamba2`): a Mamba2 (SSD) backbone and one SHARED
transformer block applied after every `shared_attn_period` layers,
its weights reused across invocations; the layers past the last whole
group (the tail) run after it.

Decode cache (`init_cache`):
  mamba     per-layer SSD and conv states, {"ssd", "conv"}: (L, B, ...),
            always f32
  attn_k/v  per-invocation K/V rings (n_inv, B, Sc, KV, Dh) in the
            cache dtype, Sc = min(max_len, attn_window)
  attn_pos  (B, Sc) the absolute position each ring slot holds,
            int32 max where unwritten (so a zeroed cache is NOT
            pristine: max keeps unwritten K/V masked)
  index     host int, or a (B,) tensor of per-lane indices (below)
The state and the rings are UPDATED IN PLACE by `apply`.

The ring follows the reference path for path: a prompt of S >= Sc
attends in-sequence and leaves its last Sc tokens in the ring in
sequence order; otherwise the S tokens land at index % Sc
(`dynamic_update_slice`, clamped so they fit) and the key mask reads
`attn_pos`.

A (B,) tensor `index` marks a batch of independent lanes, the
state-slot steps' batched form of the reference's per-lane vmap: one
token a lane, each lane at its own positions, ring slot
(index[b] % Sc) and `attn_pos` row, and under a quantized policy its
own activation scales (`layers` module docstring).

The shared block's attention core is chosen by `shared_attn_impl`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    FFN,
    Attention,
    RMSNorm,
    Transformer,
    torch_dtype,
)

INT32_MAX = torch.iinfo(torch.int32).max


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def n_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_period


class SharedBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.ffn = FFN(cfg, dtype, device)


class Zamba2(nn.Module):
    """The model's weights: embed, layers (Mamba2), shared (the
    transformer block), final_norm, head. Build it empty and fill it
    with `init` or `repro_torch.bridge`."""

    embed_tokens = Transformer.embed_tokens
    logits = Transformer.logits
    device = Transformer.device

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "zamba2":
            raise ValueError(f"Zamba2 holds the zamba2 family, got "
                             f"{cfg.family!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        dt = self.compute_dtype
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = L.param((v, d), dt, device)
        self.layers = nn.ModuleList(
            M2.Mamba2Layer(cfg, dt, device) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, dt, device)
        self.final_norm = RMSNorm(d, device)
        self.head = None if cfg.tie_embeddings else L.param((d, v), dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Zamba2":
        """Seeded random weights with the reference's distributions,
        rounded to `param_dtype` before they are stored. The stream is
        torch's, not jax's."""
        cfg, dev = self.cfg, self.device
        pdt = torch_dtype(cfg.param_dtype)

        def dense(w):
            w.copy_(L.dense_init(generator, *w.shape, dev, pdt))

        self.embed.copy_(L.embed_init(generator, *self.embed.shape, dev, pdt))
        for lp in self.layers:
            lp.init(generator, cfg)
        sp = self.shared
        for w in (sp.attn.wq, sp.attn.wk, sp.attn.wv, sp.attn.wo,
                  sp.ffn.w_up, sp.ffn.w_down):
            dense(w)
        if cfg.glu:
            dense(sp.ffn.w_gate)
        if self.head is not None:
            dense(self.head)
        return self


def init(cfg: ModelConfig, seed: int = 0, device="cuda") -> Zamba2:
    model = Zamba2(cfg, device=device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init(gen)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    dev = resolve_device(device)
    sc = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    ring = (n_invocations(cfg), batch, sc, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    st = M2.init_state(cfg, batch, dev)
    return {
        "mamba": {k: torch.zeros((cfg.n_layers,) + a.shape, dtype=a.dtype,
                                 device=dev) for k, a in st.items()},
        "attn_k": torch.zeros(ring, dtype=dtype, device=dev),
        "attn_v": torch.zeros(ring, dtype=dtype, device=dev),
        "attn_pos": torch.full((batch, sc), INT32_MAX, dtype=torch.int32,
                               device=dev),
        "index": 0,
    }


def shared_attn_impl(attn_impl: str | None, policy: ArithmeticPolicy, *,
                     cached: bool, index, s: int, sc: int,
                     explicit_positions: bool) -> str:
    """The shared block's attention core. The flash kernel derives each
    key's position from the layout (query row r at index + r, ring slot
    c at c), so it serves exactly where the keys sit there: in-sequence
    (no cache, or a prompt of S >= Sc) or a ring that has not wrapped
    (index + S <= Sc, every lane at one host index). There `attn_pos`
    adds nothing: its unwritten slots hold int32 max, and the kernel's
    key length index + S excludes them. Everywhere else (a wrapped
    ring, per-lane slot steps, explicit positions, a quantized policy)
    the gather core reads `attn_pos`. attn_impl=None picks by this
    rule; "gather" is always taken; "flash" where the rule does not
    give it raises."""
    impl = L.resolve_attn_impl(attn_impl, policy)
    fits = not explicit_positions and (
        not cached or s >= sc
        or (not isinstance(index, torch.Tensor) and index + s <= sc))
    if impl == "flash" and not fits:
        if attn_impl == "flash":
            raise ValueError(
                "attn_impl='flash' needs the shared block's keys where the "
                "kernel derives them: in-sequence or an unwrapped ring at "
                "one host index, with contiguous positions")
        return "gather"
    return impl


def _shared_block(sp: SharedBlock, x, cfg, policy, positions, kv_positions,
                  cache_kv, slot, impl):
    h, new_kv = L.attention(
        sp.attn, L.rmsnorm(sp.ln1.scale, x, cfg.norm_eps), _dims(cfg),
        positions=positions, kv_positions=kv_positions, policy=policy,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.attn_window, norm_eps=cfg.norm_eps, cache=cache_kv,
        cache_index=slot, attn_impl=impl)
    x = x + h
    f = L.ffn(sp.ffn, L.rmsnorm(sp.ln2.scale, x, cfg.norm_eps), cfg.act,
              cfg.glu, policy)
    return x + f, new_kv


def apply(model: Zamba2, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None):
    """Returns (logits, aux (= 0), new_cache). inputs: {"tokens": (B,
    S), optional "positions": (B, S)}. The cache's states, rings and
    `attn_pos` are updated IN PLACE and returned with index + S."""
    x = model.embed_tokens(inputs["tokens"])
    b, s, _ = x.shape
    dev = x.device
    period = cfg.shared_attn_period
    ninv = n_invocations(cfg)
    index = cache["index"] if cache is not None else 0
    lanes = isinstance(index, torch.Tensor)
    if lanes and s != 1:
        raise ValueError(f"per-lane indices step one token a lane, got "
                         f"S={s}")
    positions = inputs.get("positions")
    explicit = positions is not None
    if positions is None:
        ar = torch.arange(s, dtype=torch.int32, device=dev)
        positions = (index[:, None] + ar if lanes
                     else (index + ar)[None].expand(b, s))

    # -- attention cache bookkeeping (ring) ---------------------------------
    kv_positions, slot, sc = None, 0, 0
    if cache is not None:
        sc = cache["attn_k"].shape[2]
        pos = cache["attn_pos"]
        if s >= sc:
            # a prompt at least the ring's size: in-sequence attention,
            # the ring keeps the last sc tokens
            pos.copy_(positions[:, -sc:])
        elif lanes:
            slot = torch.remainder(index, sc)
            pos[torch.arange(b, device=dev), slot] = positions[:, 0]
            kv_positions = pos
        else:
            slot = index % sc
            start = min(slot, sc - s)     # dynamic_update_slice's clamp
            pos[:, start:start + s] = positions
            kv_positions = pos
    impl = shared_attn_impl(attn_impl, policy, cached=cache is not None,
                            index=index, s=s, sc=sc,
                            explicit_positions=explicit)
    if impl == "flash":
        kv_positions = None
    if lanes:
        policy = L.per_lane(policy)

    def mamba(li, x):
        st = None
        if cache is not None:
            st = {k: a[li] for k, a in cache["mamba"].items()}
        out, new_st = M2.mamba2_layer(model.layers[li], x, cfg, policy, st)
        if cache is not None:
            for k, a in new_st.items():
                st[k].copy_(a)
        return x + out

    for g in range(ninv):
        for li in range(g * period, (g + 1) * period):
            x = mamba(li, x)
        ckv = None
        if cache is not None:
            ckv = {"k": cache["attn_k"][g], "v": cache["attn_v"][g]}
        x, _ = _shared_block(model.shared, x, cfg, policy, positions,
                             kv_positions, ckv, slot, impl)
    for li in range(ninv * period, cfg.n_layers):
        x = mamba(li, x)

    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = model.logits(x)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache, index=index + s)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=dev), new_cache
