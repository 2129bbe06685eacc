"""Paged-attention forward passes for the serving engine (counterpart
of `repro.serve.paged_model`).

Three step builders:

  make_paged_prefill(cfg, policy) ->
      (model, tokens (1, S_pad), kv, page_ids (P_req,)) -> (logits, kv)
    Whole-prompt prefill for ONE request through the standard
    `model.apply` in-sequence attention path (the flash-attention
    kernel under the exact policy), K/V scattered into the request's
    pages afterwards. Kept as the reference path the paged steps are
    pinned against; the engine itself uses the chunked builder.

  make_paged_chunked_prefill(cfg, policy) ->
      (model, tokens (B, C), kv, block_tables (B, Pmax),
       start_pos (B,), chunk_lens (B,), active (B,),
       write_from (B,)) -> (logits (B, C, V), kv)
    One chunk of C prompt tokens for up to B requests at once. Row b
    holds chunk_lens[b] valid tokens of request b's effective prompt
    starting at absolute position start_pos[b]; each chunk token's K/V
    is scattered into the row's pages first, then queries attend to the
    request's whole written prefix (earlier chunks + this one) under a
    causal mask. write_from[b] masks the SCATTER (not the queries) for
    positions below it: a prefix-sharing hit already has those
    positions' K/V resident in shared pages.

  make_paged_decode(cfg, policy) ->
      (model, tokens (B, 1), kv, block_tables (B, Pmax),
       seq_lens (B,), active (B,)) -> (logits (B, V), kv)
    One token for every lane of a fixed max-batch.

Inactive rows / padding chunk positions scatter into the reserved
trash page 0 and are excluded from every valid query's mask. The pool
`kv` is updated in place and returned.

The chunked-prefill and decode builders take `tp`, a tensor-parallel
rank's `parallel.tensor_parallel.TensorParallel`, for a model holding
that rank's part of the weights (`serve.sharded_backend`).

Every arithmetic policy runs: under a quantized one the projections go
through the sc_matmul kernel (`L.mm`) and the attention contractions
through `L.qeinsum`, with the gather core (the fused core is exact
only). The dense and MoE families run; an MoE layer routes every row
of the step, idle lanes and padding included, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L
from repro_torch.models import model as modellib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged_cache import TRASH_PAGE

NEG_INF = -1e30


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(
            f"paged serving of family {cfg.family!r} is not ported yet "
            f"(ported: {transformer.FAMILIES})")
    if cfg.modality != "text":
        raise ValueError(
            f"paged serving supports text modality, got {cfg.modality!r}")


# ---------------------------------------------------------------------------
# whole-prompt prefill (reference path)
# ---------------------------------------------------------------------------


def make_paged_prefill(cfg: ModelConfig,
                       policy: ArithmeticPolicy = ArithmeticPolicy()):
    """Returns prefill(model, tokens, kv, page_ids) -> (logits, kv).

    tokens: (1, S_pad) int, S_pad a page multiple; page_ids: (S_pad /
    page,) int pages owned by the request, in position order. Returns
    logits for ALL S_pad positions (the caller indexes the true last
    prompt position) and the pool, with the request's K/V written in
    place. A dense cache of exactly S_pad slots makes `apply` take its
    in-sequence branch, as in the reference.
    """
    _check_family(cfg)

    @torch.no_grad()
    def prefill(model, tokens, kv, page_ids):
        s_pad = tokens.shape[1]
        page = kv["k"].shape[2]
        dense = modellib.init_cache(cfg, 1, s_pad, kv["k"].dtype,
                                    device=tokens.device)
        logits, _, dense = modellib.apply(
            model, cfg, {"tokens": tokens}, policy=policy, cache=dense)
        n_layers, _, _, kvh, hd = dense["k"].shape
        ids = page_ids.long()
        kv["k"][:, ids] = dense["k"].reshape(n_layers, s_pad // page, page,
                                             kvh, hd)
        kv["v"][:, ids] = dense["v"].reshape(n_layers, s_pad // page, page,
                                             kvh, hd)
        return logits[0], kv

    return prefill


# ---------------------------------------------------------------------------
# shared paged-attention step body (chunked prefill and decode)
# ---------------------------------------------------------------------------


def _attn_core(qg, kall, vall, positions, cfg: ModelConfig, policy,
               amax=None):
    """Default grouped-query attention over the gathered KV view.
    qg: (B, S, KV, G, Dh) grouped queries; kall/vall: (B, Smax, KV, Dh);
    positions: (B, S) absolute query positions. Returns the context
    (B, S, KV, G, Dh). Both contractions go through `L.qeinsum`, so a
    quantized policy quantizes the whole gathered view (trash page, stale
    and idle slots included) with one scale, as the reference does.
    Scores and softmax in f32, probabilities cast to the compute dtype
    before the value product. `amax`: `qeinsum`'s tensor-parallel seam,
    for a rank that holds some of the KV heads."""
    hd = qg.shape[-1]
    smax = kall.shape[1]
    scores = L.qeinsum("bskgd,btkd->bkgst", qg, kall, policy, amax)
    scores = scores.float() * (hd ** -0.5)
    # page j of a block table holds positions [j*page, (j+1)*page), so
    # the gathered view's kv position IS its index t
    t = torch.arange(smax, dtype=positions.dtype,
                     device=qg.device)[None, None, :]          # (1, 1, Smax)
    keep = t <= positions[:, :, None]                          # (B, S, Smax)
    if cfg.attn_window:
        keep = keep & (t > positions[:, :, None] - cfg.attn_window)
    scores = torch.where(keep[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return L.qeinsum("bkgst,btkd->bskgd", probs, vall, policy, amax)


def make_fused_paged_core(cfg: ModelConfig, policy: ArithmeticPolicy):
    """The fused-kernel occupant of the `paged_core` seam: a
    core(qg, ckl, cvl, block_tables, positions) -> (B, S, KV, G, Dh)
    that hands the RAW page pool to the paged-attention kernel, which
    walks the block table itself — no gathered view is built. The
    kernel computes exact f32 attention, so it stands in for the
    default core only under the exact policy."""
    if policy.is_quantized():
        raise ValueError(
            f"attn_impl='fused' computes exact fp32 attention and "
            f"cannot reproduce quantized policy mode "
            f"{policy.mode!r}; use attn_impl='gather'")
    window = cfg.attn_window or None

    def core(qg, ckl, cvl, block_tables, positions):
        b, s, kvh, g, hd = qg.shape
        o = paged_attention(
            qg.reshape(b, s, kvh * g, hd), ckl, cvl, block_tables,
            positions, window=window, scale=hd ** -0.5)
        return o.to(qg.dtype).reshape(b, s, kvh, g, hd)

    return core


def last_writers(page_idx: torch.Tensor, offset: torch.Tensor,
                 page: int) -> torch.Tensor:
    """(B*S,) index, in row-major (b, s) order, of the LAST token that
    writes the same (page, slot) as each token. Every inactive and
    padding token writes (TRASH_PAGE, 0); jax's scatter on the CPU keeps
    the last of such duplicates, while a CUDA `index_put_` keeps any of
    them. Giving every duplicate the last writer's values makes the
    port's pool deterministic and equal to the reference's, trash row
    included, which matters because a quantized policy's per-tensor
    scales see that row."""
    key = (page_idx * page + offset).reshape(-1)
    order = torch.arange(key.numel(), device=key.device)
    same = key[:, None] == key[None, :]
    return torch.where(same, order, -1).amax(dim=1)


def _paged_attn_block(lp, x, cfg: ModelConfig, policy, positions,
                      ckl, cvl, block_tables, page_idx, offset, writer,
                      attn_core=None, paged_core=None, tp=None):
    """One layer's attention with paged K/V. x: (B, S, d); lp: the
    layer's `Block`. The head counts are the weights': a
    tensor-parallel rank (`tp`) holding some of the heads attends over
    those, with its part of the pool.

    ckl/cvl: this layer's page pool (P, page, KV, Dh), written in place;
    positions, page_idx, offset: (B, S) — the absolute position of every
    query token and its scatter coordinates in the pool (trash page for
    inactive / padding tokens); writer: `last_writers` of those
    coordinates. Returns the attention output.

    Two occupants share the attention seam: `attn_core` consumes the
    GATHERED (B, Smax, KV, Dh) view (default `_attn_core`), while
    `paged_core(qg, ckl, cvl, block_tables, positions)` consumes the raw
    pool + block tables — when it is set, the gather never happens.
    """
    b, s, _ = x.shape
    p = lp.attn
    hd = cfg.resolved_head_dim
    h, kvh = p.wq.shape[-1] // hd, p.wk.shape[-1] // hd
    mm = L.mm if tp is None else tp.mm
    qh = mm(x, p.wq, policy).reshape(b, s, h, hd)
    kh = mm(x, p.wk, policy).reshape(b, s, kvh, hd)
    vh = mm(x, p.wv, policy).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        qh = L.headwise_rmsnorm(p.q_norm, qh, cfg.norm_eps)
        kh = L.headwise_rmsnorm(p.k_norm, kh, cfg.norm_eps)
    qh = L.apply_rope(qh, positions, cfg.rope_theta)
    kh = L.apply_rope(kh, positions, cfg.rope_theta)

    # scatter the new tokens' K/V into their (page, slot) coordinates,
    # BEFORE the attention read, so chunk tokens attend to earlier
    # tokens of the same chunk. Every inactive/padding token lands on
    # (TRASH_PAGE, 0): all of them carry the last one's values
    ckl[page_idx, offset] = kh.reshape(b * s, kvh, hd)[writer].reshape(
        kh.shape).to(ckl.dtype)
    cvl[page_idx, offset] = vh.reshape(b * s, kvh, hd)[writer].reshape(
        vh.shape).to(cvl.dtype)

    g = h // kvh
    qg = qh.reshape(b, s, kvh, g, hd)
    if paged_core is not None:
        ctx = paged_core(qg, ckl, cvl, block_tables, positions)
    else:
        # gather each row's block table back to a contiguous KV view:
        # (B, Pmax, page, KV, Dh) -> (B, Smax, KV, Dh), position order
        pmax, page = block_tables.shape[1], ckl.shape[1]
        smax = pmax * page
        kall = ckl[block_tables].reshape(b, smax, kvh, hd).to(x.dtype)
        vall = cvl[block_tables].reshape(b, smax, kvh, hd).to(x.dtype)
        core = attn_core if attn_core is not None else _attn_core
        ctx = core(qg, kall, vall, positions, cfg, policy)
    ctx = ctx.reshape(b, s, h * hd)
    if tp is not None:
        return tp.out_proj(ctx, p.wo, policy, k_full=cfg.n_heads * hd)
    return L.mm(ctx, p.wo, policy)


def _paged_forward(model, cfg: ModelConfig, policy, tokens, kv,
                   block_tables, positions, page_idx, offset,
                   attn_core=None, paged_core=None, tp=None):
    """Full-model paged step: embed -> layers -> logits (B, S, V). The
    pool `kv` is written in place, layer by layer. With `tp` (a
    tensor-parallel rank's `TensorParallel`; `model` then holds that
    rank's part of the weights and `kv` its part of the pool) the
    embedding, the output projections, the experts and the logits go
    through its seams, and every rank ends with the same logits."""
    if tp is None:
        x = model.embed_tokens(tokens)                           # (B, S, d)
    else:
        x = model.embed_tokens(tokens, lookup=tp.embedding)
    writer = last_writers(page_idx, offset, kv["k"].shape[2])
    for li, lp in enumerate(model.layers):
        x = x + _paged_attn_block(
            lp, L.rmsnorm(lp.ln1.scale, x, cfg.norm_eps), cfg, policy,
            positions, kv["k"][li], kv["v"][li], block_tables, page_idx,
            offset, writer, attn_core=attn_core, paged_core=paged_core,
            tp=tp)
        f, _ = transformer.block_ffn(
            lp, L.rmsnorm(lp.ln2.scale, x, cfg.norm_eps), cfg, policy, tp=tp)
        x = x + f
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = model.logits(x) if tp is None else tp.logits(model, x)
    return logits, kv                                            # (B, S, V)


# ---------------------------------------------------------------------------
# chunked + batched prefill
# ---------------------------------------------------------------------------


def make_paged_chunked_prefill(cfg: ModelConfig,
                               policy: ArithmeticPolicy = ArithmeticPolicy(),
                               attn_core=None, paged_core=None, tp=None):
    """Returns chunked_prefill(model, tokens, kv, block_tables,
    start_pos, chunk_lens, active, write_from) -> (logits (B, C, V), kv).

    block_tables[b] must already contain the pages covering
    [0, start_pos[b] + chunk_lens[b]) (unused slots: trash page).
    Padding positions, inactive rows, and positions below write_from[b]
    scatter to the trash page and never enter a valid query's mask.
    """
    _check_family(cfg)

    @torch.no_grad()
    def chunked_prefill(model, tokens, kv, block_tables, start_pos,
                        chunk_lens, active, write_from):
        b, c = tokens.shape
        page = kv["k"].shape[2]
        pmax = block_tables.shape[1]
        idx = torch.arange(c, dtype=start_pos.dtype,
                           device=tokens.device)[None, :]       # (1, C)
        positions = start_pos[:, None] + idx                    # (B, C)
        valid = active[:, None] & (idx < chunk_lens[:, None])
        do_write = valid & (positions >= write_from[:, None])
        # explicit clamp: padding positions may run past the table, and
        # a torch gather, unlike jax's, faults out of range
        slot = torch.gather(
            block_tables, 1,
            torch.clamp(positions // page, 0, pmax - 1).long())
        page_idx = torch.where(do_write, slot, TRASH_PAGE).long()
        offset = torch.where(do_write, positions % page, 0).long()
        return _paged_forward(model, cfg, policy, tokens, kv,
                              block_tables, positions, page_idx, offset,
                              attn_core=attn_core, paged_core=paged_core,
                              tp=tp)

    return chunked_prefill


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def make_paged_decode(cfg: ModelConfig,
                      policy: ArithmeticPolicy = ArithmeticPolicy(),
                      attn_core=None, paged_core=None, tp=None):
    """Returns decode(model, tokens, kv, block_tables, seq_lens, active)
    -> (logits (B, V), kv). One token per lane at a fixed batch shape."""
    _check_family(cfg)

    @torch.no_grad()
    def decode(model, tokens, kv, block_tables, seq_lens, active):
        page = kv["k"].shape[2]
        pmax = block_tables.shape[1]
        positions = seq_lens[:, None]                           # (B, 1)
        # scatter coordinates; inactive lanes write to the trash page.
        # seq_lens // page is in range for every active lane (the
        # backend validates that requests fit the table); the clamp
        # keeps a torch gather from faulting on any other lane
        page_slot = torch.gather(
            block_tables, 1,
            torch.clamp(seq_lens // page, 0, pmax - 1).long()[:, None])[:, 0]
        page_idx = torch.where(active, page_slot, TRASH_PAGE).long()[:, None]
        offset = torch.where(active, seq_lens % page, 0).long()[:, None]
        logits, kv = _paged_forward(model, cfg, policy, tokens, kv,
                                    block_tables, positions, page_idx,
                                    offset, attn_core=attn_core,
                                    paged_core=paged_core, tp=tp)
        return logits[:, 0], kv

    return decode
