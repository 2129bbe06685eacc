"""Plain PyTorch version of the paged-attention kernel (transcribes
`repro.kernels.paged_attention.ref.paged_attention_ref`).

Materializes the gathered view and applies the masked softmax of the
serve layer's gather core. The wrapper runs it for CPU tensors, and
the chip smoke holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def paged_attention_ref(q, k_pages, v_pages, block_tables, positions,
                        *, window=None, scale=None) -> torch.Tensor:
    """Same signature/semantics as `paged_attention` (q: (B, S, H, Dh),
    pools (P, page, KV, Dh), block_tables (B, Pmax), positions (B, S));
    returns (B, S, H, Dh) f32 via the explicit gather."""
    b, s, h, hd = q.shape
    _, page, kvh, _ = k_pages.shape
    group = h // kvh
    if scale is None:
        scale = 1.0 / (hd**0.5)
    bt = block_tables.long()
    smax = bt.shape[1] * page
    kall = k_pages[bt].reshape(b, smax, kvh, hd)
    vall = v_pages[bt].reshape(b, smax, kvh, hd)
    kf = torch.repeat_interleave(kall, group, dim=2).float()  # (B,Smax,H,Dh)
    vf = torch.repeat_interleave(vall, group, dim=2).float()
    sc = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    t = torch.arange(smax, dtype=torch.int32,
                     device=q.device)[None, None, :]          # (1, 1, Smax)
    pos = positions.to(torch.int32)
    keep = t <= pos[:, :, None]                               # (B, S, Smax)
    if window is not None:
        keep = keep & (t > pos[:, :, None] - window)
    sc = torch.where(keep[:, None], sc, torch.full_like(sc, -1e30))
    probs = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return torch.einsum("bhst,bthd->bshd", probs, vf)
