"""Ring attention, the ARTEMIS token-based dataflow over a process
group (counterpart of `repro.parallel.ring_attention`).

Paper §III.D.1 / Fig 5(b): tokens are sharded across banks; each bank
holds its Q_i/K_i/V_i, the K_i and V_i shards travel a ring while each
bank accumulates partial attention, with the softmax max tracked as
scores stream. Here banks are ranks, the ring is
`parallel.comm.ring_shift` (send to rank + 1, receive from rank - 1),
and the running max is the online-softmax merge carried across ring
steps: per-chunk partial (o, m, l) statistics merge associatively
(Eq. 5's log-sum-exp decomposition), so the sharded result equals full
attention up to float reassociation.

Layout: q, k, v are (B, S_local, H, Dh) on each rank, S sharded over
the group in rank order; causal masking uses global positions (by
default rank * S_local + arange). A chunk's kv positions travel the
ring WITH its K/V, so striped or paged layouts mask exactly on every
hop. INT32_MAX positions mark unwritten cache slots and are masked
under both modes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.comm import all_gather, ring_shift

NEG_INF = -1e30
_EMPTY = 2**31 - 1   # INT32_MAX position = unwritten cache slot


def _repeat_kv(h: int, k: torch.Tensor, v: torch.Tensor):
    """Native GQA: repeat (B, S, KV, D) K/V heads up to the H query heads
    (KV must divide H), q head i reading kv head i // g."""
    kvh = k.shape[2]
    if kvh == h:
        return k, v
    if h % kvh:
        raise ValueError(
            f"query heads ({h}) must be a multiple of KV heads ({kvh})")
    g = h // kvh
    return (torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


def _chunk_attn(q, k, v, q_pos, k_pos, scale, causal):
    """Single-chunk attention partials in f32. q: (B, Sq, H, D), k/v:
    (B, Sk, H, D) -> (o_unnorm (B, Sq, H, D), m, l (B, Sq, H))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = (k_pos < _EMPTY)[:, None, None, :]
    if causal:
        keep = keep & (q_pos[:, None, :, None] >= k_pos[:, None, None, :])
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)                            # (B, H, Sq)
    # a fully masked row (m == NEG_INF) would give exp(0) = 1 everywhere
    m_safe = torch.clamp_min(m, -1e29)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)                             # (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m_safe.transpose(1, 2), l.transpose(1, 2)


def _merge(o1, m1, l1, o2, m2, l2):
    """Associative online-softmax merge of two partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def _positions(rank: int, length: int, b: int, device) -> torch.Tensor:
    pos = rank * length + torch.arange(length, dtype=torch.int32,
                                       device=device)
    return pos[None].expand(b, length)


def ring_attention(q, k, v, *, group, causal: bool = True,
                   scale: float | None = None, q_positions=None,
                   kv_positions=None):
    """Sequence-sharded attention over `group` (every rank calls it).

    q: (B, Sq_local, H, Dh); k, v: (B, Sk_local, H|KV, Dh), KV-head
    counts that divide H repeated internally (GQA); the K/V chunk may be
    longer or shorter than the query chunk. `q_positions` /
    `kv_positions`: (B, S) GLOBAL positions of the local chunks
    (defaults: contiguous layout in rank order). Returns (B, Sq_local,
    H, Dh) in q.dtype."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    b, s_local, h, d = q.shape
    k, v = _repeat_kv(h, k, v)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_positions is None:
        q_positions = _positions(idx, s_local, b, q.device)
    if kv_positions is None:
        kv_positions = _positions(idx, k.shape[1], b, q.device)
    qf = q.float()
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, s_local, h), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, s_local, h), dtype=torch.float32, device=q.device)
    kc, vc, pc = k, v, kv_positions
    for step in range(n):
        oc, mc, lc = _chunk_attn(qf, kc.float(), vc.float(), q_positions,
                                 pc, scale, causal)
        o, m, l = _merge(o, m, l, oc, mc, lc)
        if step < n - 1:
            # the chunk and its positions move on to the next rank
            kc, vc, pc = ring_shift([kc, vc, pc], group)
    l = torch.clamp_min(l, 1e-30)
    return (o / l[..., None]).to(q.dtype)


def layer_dataflow_attention(q, k, v, *, group, causal: bool = True,
                             scale: float | None = None):
    """The LAYER-BASED dataflow baseline (paper Fig 8 'layer_*'): gather
    the whole K/V onto every rank, then attend locally. Same math as
    `ring_attention`, strictly more bytes over the link."""
    idx = dist.get_rank(group)
    b, s_local, h, d = q.shape
    k, v = _repeat_kv(h, k, v)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kg = all_gather(k, group, dim=1)
    vg = all_gather(v, group, dim=1)
    q_pos = _positions(idx, s_local, b, q.device)
    k_pos = _positions(0, kg.shape[1], b, q.device)
    o, _, l = _chunk_attn(q.float(), kg.float(), vg.float(), q_pos, k_pos,
                          scale, causal)
    l = torch.clamp_min(l, 1e-30)
    return (o / l[..., None]).to(q.dtype)
