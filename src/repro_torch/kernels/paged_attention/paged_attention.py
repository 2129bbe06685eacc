"""Paged attention: the wrapper of the hand-written Hopper kernel
(`csrc/paged_attention.cu`), the port of the Pallas kernel
`repro.kernels.paged_attention.paged_attention`.

Dispatch is by the tensors' device, explicitly: CPU tensors go to the
plain version (`ref.paged_attention_ref`), CUDA tensors to the kernel,
and anything the kernel does not take raises. There is no fallback
from the kernel to the plain version, nor from one kernel instance to
the other.

The kernel has two instances (`kernel_variant` picks one per call):
"rows" for few query rows per (lane, kv head), the engine's decode
steps, and "tile", tensor-core tiles of 64 query rows, for the
engine's prefill chunks.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

NAME = "paged_attention"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
MAX_HEAD_DIM = 256
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("rows", "tile")          # the C entry's variant 0 and 1
# the tile instance takes a call with at least this many query rows per
# (lane, kv head), G * S, at one of these head dims
TILE_MIN_ROWS = 16
TILE_HEAD_DIMS = (16, 32, 64, 128)


def kernel_variant(group: int, s: int, head_dim: int) -> str:
    """The kernel instance a call of G = `group` query heads per kv head
    and S = `s` queries per lane takes: "tile" when the G * S query rows
    of a (lane, kv head) fill at least a 16-row mma tile and Dh is one
    of TILE_HEAD_DIMS (the engine's prefill chunks), "rows" otherwise
    (its decode steps, and Dh the tile instance is not built for)."""
    if group * s >= TILE_MIN_ROWS and head_dim in TILE_HEAD_DIMS:
        return "tile"
    return "rows"


def _entry():
    lib = build.load(SOURCE)
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn


def _check(q, k_pages, v_pages, block_tables, positions, window, variant):
    b, s, h, hd = q.shape
    if k_pages.dim() != 4:
        raise ValueError(f"k_pages must be (P, page, KV, Dh), got "
                         f"{tuple(k_pages.shape)}")
    _, _, kvh, hd_k = k_pages.shape
    if hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"pool/query shape mismatch: q {tuple(q.shape)}, k_pages "
            f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    if h % kvh:
        raise ValueError(f"H={h} not a multiple of KV={kvh}")
    if block_tables.shape[0] != b or tuple(positions.shape) != (b, s):
        raise ValueError(
            f"batch mismatch: q {tuple(q.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, positions "
            f"{tuple(positions.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant == "tile" and hd not in TILE_HEAD_DIMS:
        raise ValueError(f"the tile instance takes Dh in {TILE_HEAD_DIMS}, "
                         f"got {hd}")


def paged_attention(q, k_pages, v_pages, block_tables, positions, *,
                    window: int | None = None,
                    scale: float | None = None,
                    variant: str | None = None) -> torch.Tensor:
    """Fused paged attention over one layer's page pool.

    q:            (B, S, H, Dh) queries (S = chunk, or 1 for decode)
    k/v_pages:    (P, page, KV, Dh) the layer's page pool, H % KV == 0
    block_tables: (B, Pmax) int page ids per row, trash page 0 in
                  unused slots
    positions:    (B, S) int absolute query positions, monotone
                  non-decreasing within a row

    variant:      the kernel instance, "rows" or "tile"; None (the
                  serve path) takes `kernel_variant`'s choice. The chip
                  smoke names one to hold each against the plain
                  version on the same inputs.

    Returns the context tensor (B, S, H, Dh) f32: a query at position
    p attends to kv positions t <= p (and t > p - window when set) of
    its own row's table.
    """
    build.refuse_autograd(NAME, "the gather core (attn_impl='gather')", q,
                          k_pages, v_pages)
    _check(q, k_pages, v_pages, block_tables, positions, window, variant)
    b, s, h, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd**0.5)
    tensors = (q, k_pages, v_pages, block_tables, positions)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   positions, window=window, scale=scale)
    if not all(t.device.type == "cuda" and t.device == q.device
               for t in tensors):
        raise ValueError(f"paged_attention: all operands must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _FLOAT_TYPES or k_pages.dtype not in _FLOAT_TYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention kernel takes f32/bf16 q and "
                        f"pools, got q {q.dtype}, k {k_pages.dtype}, "
                        f"v {v_pages.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel takes Dh <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        # a copy of the pool would cost more than the attention itself
        raise ValueError("paged_attention kernel needs contiguous pools")
    g = h // k_pages.shape[2]
    variant = variant or kernel_variant(g, s, hd)
    if variant == "tile" and (k_pages.data_ptr() % 16
                              or v_pages.data_ptr() % 16):
        raise ValueError("the tile instance needs 16-byte aligned pools")
    q = q.contiguous()
    if variant == "tile" and q.data_ptr() % 16:
        q = q.clone()                # the tile instance reads 16 bytes
    bt = block_tables.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        bt.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, s, h, k_pages.shape[2], hd, k_pages.shape[0], k_pages.shape[1],
        bt.shape[1], window or 0, float(scale),
        int(q.dtype == torch.bfloat16), int(k_pages.dtype == torch.bfloat16),
        VARIANTS.index(variant), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({variant}) launch "
                           f"failed: CUDA error {err}")
    build.launch_counts[NAME] += 1
    build.launch_counts[f"{NAME}.{variant}"] += 1
    return out
