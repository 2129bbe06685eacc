"""Public wrapper of the flash-attention kernel (counterpart of
`repro.kernels.flash_attention.ops`).

It picks the reference's effective tiles, `bq_eff`/`bk_eff`, so that a
short Sq or Sk runs one small tile instead of a mostly padded 128-row
one. The reference pads Q/K/V to tile multiples, masks the padded keys
with `kv_len=sk` and so checks window-requires-causal before padding;
the port pads nothing: `flash_attention_all` validates before it reads,
and the kernel treats the ragged edge as zero padding and masks keys at
or past Sk itself (`kv_len` defaults to Sk), which is the same function
without the copies.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_all,
)


def effective_tiles(sq: int, sk: int, bq: int = 128,
                    bk: int = 128) -> tuple[int, int]:
    """The reference's (bq_eff, bk_eff): a length shorter than its tile
    takes a tile of that length, rounded up to 8."""
    bq_eff = min(bq, max(8, sq)) if sq < bq else bq
    bk_eff = min(bk, max(8, sk)) if sk < bk else bk
    return bq_eff, bk_eff


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    bq: int = 128, bk: int = 128, return_lse: bool = False,
                    kv_len: int | None = None, q_offset: int = 0,
                    kv_cast=None):
    """Fused LSE attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).

    Beyond the reference's arguments: `kv_len` masks keys at or past
    it, `q_offset` places query row 0 at that key position for the
    causal mask (the reference's kernel is q_offset = 0), and `kv_cast`
    rounds K/V to that dtype before use. Returns o (B, Hq, Sq, D) f32,
    and lse (B, Hq, Sq) f32 with `return_lse`."""
    bq_eff, bk_eff = effective_tiles(q.shape[2], k.shape[2], bq, bk)
    o, lse, _ = flash_attention_all(
        q, k, v, causal=causal, window=window, kv_len=kv_len,
        q_offset=q_offset, scale=scale, bq=bq_eff, bk=bk_eff,
        kv_cast=kv_cast)
    if return_lse:
        return o, lse
    return o
