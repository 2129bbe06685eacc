"""Split-KV decode attention, the token dataflow's decode side, over a
process group (counterpart of `repro.parallel.split_kv`).

Eq. 5's log-sum-exp decomposition is associative across token shards,
so a decode step against a sequence-sharded KV view computes each
shard's partial attention and merges exactly with one max and two sums:

  m   = max_i(m_i)
  out = sum_i(o_i * exp(m_i - m)) / sum_i(l_i * exp(m_i - m))

(o_i the shard's unnormalized output, m_i its running max, l_i its
sum-exp). Only (B, Sq, H)-sized statistics and the (B, Sq, H, D)
output cross the link, never the S-sized scores.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.comm import all_reduce
from repro_torch.parallel.ring_attention import NEG_INF, _chunk_attn, _repeat_kv

__all__ = ["NEG_INF", "split_kv_attention"]


def split_kv_attention(q, k_local, v_local, *, group, q_positions,
                       kv_positions_local, scale: float | None = None,
                       causal: bool = True):
    """q: (B, Sq, H, D), the same on every rank (Sq = 1 at decode);
    k_local / v_local: (B, S_shard, H|KV, D), this rank's token shard
    (KV-head counts that divide H repeated: GQA); kv_positions_local:
    (B, S_shard) global positions (INT32_MAX = empty slot). Returns
    (B, Sq, H, D) in q.dtype, the same on every rank."""
    b, sq, h, d = q.shape
    k_local, v_local = _repeat_kv(h, k_local, v_local)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    o, m, l = _chunk_attn(q.float(), k_local.float(), v_local.float(),
                          q_positions, kv_positions_local, scale,
                          causal=causal)
    m_glob = all_reduce(m, group, "max")
    w = torch.exp(m - m_glob)
    num = all_reduce(o * w[..., None], group)
    den = torch.clamp_min(all_reduce(l * w, group), 1e-30)
    return (num / den[..., None]).to(q.dtype)
