"""Plain PyTorch versions of the flash-attention kernel.

`attention_ref` is a copy of `repro.kernels.flash_attention.ref`
(GQA, causal with the BOTTOM-RIGHT alignment, query row r at key
position r + Sk - Sq, an optional window).

`flash_attention_ref` is the function the kernel computes, edge values
included, which the wrapper runs for CPU tensors and `chip_smoke.py`
holds the CUDA kernel against on the card:

- causal masking is TOP-LEFT and shifted by `q_offset`: query row r
  sits at key position r + q_offset and keeps keys c <= r + q_offset
  (`_flash_kernel`'s `rows >= cols` is q_offset = 0; q_offset = Sk - Sq
  is `attention_ref`'s alignment);
- a window W (causal only) keeps c > r + q_offset - W;
- keys at or past `kv_len` are masked; Sq and Sk are padded with zeros
  up to multiples of (bq, bk) and the padded keys are masked too;
- a masked score is NEG_INF = -1e30, and only the (bq, bk) tiles that
  the kernel visits take part: a tile is skipped when it lies wholly
  above the causal diagonal, wholly below every row's window, or wholly
  at or past kv_len, for every row of its query tile;
- `l` is clamped at 1e-30: a row that visits no tile gives o = 0 and
  lse = -1e30 + log(1e-30); a row whose visited scores are all masked
  averages V uniformly over its visited keys (each scores exp(0) = 1),
  as the Pallas kernel's online softmax does.

The products run in f32 (bf16 inputs are widened first); `kv_cast`
rounds K and V to that dtype before they are widened, which reproduces
`ck.astype(x.dtype)` of the reference's cached attention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). Returns (o, lse).

    `window` (causal only) keeps keys in (pos - window, pos] per query,
    where query row r sits at absolute position r + (Sk - Sq) — the
    same sliding-window semantics as the kernel and `_attn_core`."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    if window is not None and not causal:
        raise ValueError("window masking requires causal=True")
    if scale is None:
        scale = 1.0 / (d**0.5)
    kf = torch.repeat_interleave(k, group, dim=1).float()
    vf = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        if window is not None:
            pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
            mask &= torch.arange(sk, device=q.device)[None, :] > pos - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, vf)
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def _tile_range(qi: torch.Tensor, *, n_k_tiles: int, causal: bool, window,
                kv_len: int, q_offset: int, bq: int, bk: int):
    """(lo, hi): the first and last K tile that each query tile `qi`
    (an integer tensor) visits, lo > hi when it visits none. The tiles
    a query tile visits are always one contiguous run."""
    qs = qi * bq + q_offset                  # key position of its first row
    hi = torch.full_like(qi, min(n_k_tiles - 1, (kv_len - 1) // bk))
    lo = torch.zeros_like(qi)
    if causal:
        hi = torch.minimum(hi, (qs + bq - 1) // bk)
        if window is not None:
            # tile t's last key must lie above the first row's window start
            lo = torch.clamp((qs - window - bk + 1) // bk + 1, min=0)
    return lo, hi


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        kv_len=None, q_offset: int = 0, scale=None,
                        bq: int = 128, bk: int = 128, kv_cast=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0. Any Sq
    and Sk: they are padded with zeros up to multiples of bq and bk.

    Returns (o (B, Hq, Sq, D) f32, lse (B, Hq, Sq) f32, nvis
    (B, Hq, Sq) f32), nvis being the number of K tiles that query row's
    tile visits. Arguments are those of `flash_attention_all`."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    kv_len = sk if kv_len is None else min(kv_len, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    sq_pad, sk_pad = nq * bq, nk * bk
    if kv_cast is not None:
        k, v = k.to(kv_cast), v.to(kv_cast)
    qf = F.pad(q.float(), (0, 0, 0, sq_pad - sq))
    kf = F.pad(torch.repeat_interleave(k, group, dim=1).float(),
               (0, 0, 0, sk_pad - sk))
    vf = F.pad(torch.repeat_interleave(v, group, dim=1).float(),
               (0, 0, 0, sk_pad - sk))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale

    dev = q.device
    rows = torch.arange(sq_pad, device=dev)[:, None]         # (Sq_pad, 1)
    cols = torch.arange(sk_pad, device=dev)[None, :]         # (1, Sk_pad)
    pos = rows + q_offset
    keep = cols < kv_len
    if causal:
        keep = keep & (cols <= pos)
        if window is not None:
            keep = keep & (cols > pos - window)
    lo, hi = _tile_range(rows // bq, n_k_tiles=nk, causal=causal,
                        window=window, kv_len=kv_len, q_offset=q_offset,
                        bq=bq, bk=bk)
    tile = cols // bk
    visited = (tile >= lo) & (tile <= hi)                    # (Sq_pad, Sk_pad)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    s = torch.where(visited, s, torch.full_like(s, -torch.inf))
    m = torch.amax(s, dim=-1, keepdim=True)
    # a row that visits nothing keeps the kernel's initial m = -1e30
    m = torch.where(torch.isinf(m), torch.full_like(m, NEG_INF), m)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    nvis = torch.clamp(hi - lo + 1, min=0).float()           # (Sq_pad, 1)
    nvis = nvis[:, 0].expand(b, hq, sq_pad)
    return o[:, :, :sq], lse[:, :, :sq], nvis[:, :, :sq].contiguous()
