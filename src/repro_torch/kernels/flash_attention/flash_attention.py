"""Flash attention: the wrapper of the hand-written Hopper kernel
(`csrc/flash_attention.cu`), the port of the Pallas kernel
`repro.kernels.flash_attention.flash_attention`.

Entries, as in the reference:

  flash_attention_all(q, k, v, ...) -> (o, lse, nvis)
      the port of `_flash_attention_all`; it also takes Sq and Sk that
      are not multiples of (bq, bk), treating them as padded with
      zeros (which `ops.flash_attention` relies on: no padded copy of
      Q, K or V is made), and takes `kv_len`, `q_offset` and
      `kv_cast` as runtime arguments of the launch;
  flash_attention_kernel(q, k, v, ...) -> (o, lse)
  flash_attention_block_counts(q, k, v, ...) -> nvis
      the reference's two public entries, which take block multiples.

Dispatch is by the tensors' device, explicitly: CPU tensors go to the
plain version (`ref.flash_attention_ref`), CUDA tensors to the kernel,
and anything the kernel does not take raises. There is no fallback
from the kernel to the plain version, nor from one kernel instance to
the other.

The kernel has two instances (`kernel_variant` picks one per call):
"tile", bf16 tensor-core tiles of 128 query rows, for bf16 q over K/V
that are bf16 or rounded to it (`kv_cast`) with at least 16 query rows
(the static path's prefill), and "rows", f32 on the CUDA cores, for
everything else (its decode steps, f32 operands).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("rows", "tile")          # the C entry's variant 0 and 1
# the tile instance takes a call with at least this many query rows, at
# one of these head dims
TILE_MIN_ROWS = 16
TILE_HEAD_DIMS = (16, 32, 64, 128)


def tile_takes(q_dtype, kv_dtype, kv_cast, head_dim: int) -> bool:
    """Whether the tile instance computes this call's function: bf16 q,
    K/V bf16 or f32 rounded to bf16 by `kv_cast` (bf16-valued operands,
    so its bf16 products are exact), and D one of TILE_HEAD_DIMS."""
    kv_bf16 = kv_dtype == torch.bfloat16 or (
        kv_dtype == torch.float32 and kv_cast == torch.bfloat16)
    return (q_dtype == torch.bfloat16 and kv_bf16
            and head_dim in TILE_HEAD_DIMS)


def kernel_variant(q_dtype, kv_dtype, kv_cast, sq: int,
                   head_dim: int) -> str:
    """The kernel instance a call takes: "tile" when `tile_takes` and
    the Sq query rows fill at least a 16-row mma tile (the static path's
    prefill), "rows" otherwise (its decode steps, f32 operands)."""
    if sq >= TILE_MIN_ROWS and tile_takes(q_dtype, kv_dtype, kv_cast,
                                          head_dim):
        return "tile"
    return "rows"


def _entry():
    lib = build.load(SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return fn


def _validate(q, k, v, *, causal, window, kv_len, bq, bk, kv_cast,
              variant):
    """The reference's checks (Hq % Hkv, window requires causal, window
    >= 1), the shapes and the kernel instance, before anything is read."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    bk_, hkv, sk, dk = k.shape
    if bk_ != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if window is not None and not causal:
        raise ValueError("window masking requires causal=True")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if sq < 1 or sk < 1:
        raise ValueError(f"empty attention: Sq={sq}, Sk={sk}")
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be >= 1, got bq={bq}, bk={bk}")
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant == "tile" and not tile_takes(q.dtype, k.dtype, kv_cast, d):
        raise ValueError(f"the tile instance takes bf16 q, K/V bf16 or "
                         f"rounded to it (kv_cast) and D in "
                         f"{TILE_HEAD_DIMS}, got q {q.dtype}, k {k.dtype}, "
                         f"kv_cast {kv_cast}, D {d}")


def _aligned(t: torch.Tensor) -> bool:
    """Rows of 4-element groups on 16-byte (f32) or 8-byte (bf16)
    boundaries, as the kernel's vector loads and stores need."""
    align = 4 * t.element_size()
    return (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
            and t.data_ptr() % align == 0)


def _launch(q, k, v, *, causal, window, kv_len, q_offset, scale, bq, bk,
            kv_cast, variant):
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _FLOAT_TYPES or k.dtype not in _FLOAT_TYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"flash_attention kernel takes f32/bf16 q and K/V, "
                        f"got q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if kv_cast not in (None, *_FLOAT_TYPES):
        raise TypeError(f"flash_attention kernel rounds K/V to bf16 or "
                        f"f32 only, got kv_cast={kv_cast}")
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes D a multiple of 4 "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    if not _aligned(q):
        q = q.contiguous()
    if not (_aligned(k) and _aligned(v)):
        # a copy of K/V (a whole cache) would cost more than the attention
        raise ValueError("flash_attention kernel needs K/V with unit stride "
                         "over D and 4-element aligned rows")
    # o is laid out (B, Sq, Hq, D), returned as a (B, Hq, Sq, D) view: the
    # attention layer's reshape to (B, Sq, Hq * D) is then free
    o = torch.empty((b, sq, hq, d), dtype=torch.float32,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    nvis = torch.empty_like(lse)
    round_kv = int(kv_cast == torch.bfloat16 and k.dtype == torch.float32)
    variant = variant or kernel_variant(q.dtype, k.dtype, kv_cast, sq, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), nvis.data_ptr(), b, hq, hkv, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), window or 0, kv_len, q_offset, bq, bk, float(scale),
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        round_kv, VARIANTS.index(variant), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: CUDA error {err}")
    build.launch_counts[NAME] += 1
    build.launch_counts[f"{NAME}.{variant}"] += 1
    return o, lse, nvis


def flash_attention_all(q, k, v, *, causal: bool = True,
                        window: int | None = None, kv_len: int | None = None,
                        q_offset: int = 0, scale: float | None = None,
                        bq: int = 128, bk: int = 128, kv_cast=None,
                        variant: str | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0.

    Query row r sits at key position r + q_offset. It keeps key c when
    c < kv_len (default Sk) and, if causal, c <= r + q_offset and, with
    a window W, c > r + q_offset - W. Sq and Sk count as padded with
    zeros to multiples of (bq, bk), the tiles of the Pallas kernel's
    block skip; padded keys are masked. `kv_cast` (bf16) rounds f32 K/V
    to bf16 before use. See `ref.flash_attention_ref` for the edge
    values. `variant`, "rows" or "tile", names the kernel instance; None
    (the static path) takes `kernel_variant`'s choice. It is checked on
    every device; the plain version computes the same function for both.

    Returns (o (B, Hq, Sq, D) f32, lse (B, Hq, Sq) f32, nvis (B, Hq, Sq)
    f32: the K tiles each row's query tile executed). On CUDA, o is a
    view of a (B, Sq, Hq, D) tensor.
    """
    build.refuse_autograd(NAME, "the gather core (attn_impl='gather')", q,
                          k, v)
    _validate(q, k, v, causal=causal, window=window, kv_len=kv_len, bq=bq,
              bk=bk, kv_cast=kv_cast, variant=variant)
    sk = k.shape[2]
    kv_len = sk if kv_len is None else min(int(kv_len), sk)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    kw = dict(causal=causal, window=window, kv_len=kv_len,
              q_offset=int(q_offset), scale=scale, bq=bq, bk=bk,
              kv_cast=kv_cast)
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_ref(q, k, v, **kw)
    if not all(t.device.type == "cuda" and t.device == q.device
               for t in tensors):
        raise ValueError(f"flash_attention: all operands must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    return _launch(q, k, v, variant=variant, **kw)


def _check_multiples(q, k, bq, bk):
    sq, sk = q.shape[2], k.shape[2]
    if sq % bq or sk % bk:
        raise ValueError(f"Sq={sq} and Sk={sk} must be multiples of bq={bq} "
                         f"and bk={bk} (ops.flash_attention pads)")


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           window: int | None = None,
                           kv_len: int | None = None, q_offset: int = 0,
                           scale: float | None = None, bq: int = 128,
                           bk: int = 128):
    """The reference's kernel entry: block multiples only. Returns
    (o (B, Hq, Sq, D) f32, lse (B, Hq, Sq) f32)."""
    _check_multiples(q, k, bq, bk)
    o, lse, _ = flash_attention_all(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len, q_offset=q_offset,
                                    scale=scale, bq=bq, bk=bk)
    return o, lse


def flash_attention_block_counts(q, k, v, *, causal: bool = True,
                                 window: int | None = None,
                                 kv_len: int | None = None,
                                 q_offset: int = 0,
                                 scale: float | None = None, bq: int = 128,
                                 bk: int = 128):
    """Number of K blocks that executed per (B, Hq, Sq) row; every row
    of a q block shares one count."""
    _check_multiples(q, k, bq, bk)
    _, _, nvis = flash_attention_all(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len, q_offset=q_offset,
                                     scale=scale, bq=bq, bk=bk)
    return nvis
