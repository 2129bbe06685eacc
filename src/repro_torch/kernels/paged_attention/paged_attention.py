"""Paged attention: the wrapper of the hand-written Hopper kernel
(`csrc/paged_attention.cu`), the port of the Pallas kernel
`repro.kernels.paged_attention.paged_attention`.

Dispatch is by the tensors' device, explicitly: CPU tensors go to the
plain version (`ref.paged_attention_ref`), CUDA tensors to the kernel,
meta tensors (the dry run's) to an output of the right shape and dtype
and nothing else, and anything the kernel does not take raises. There
is no fallback from the kernel to the plain version, nor from one
kernel instance to the other. On every device the output is a
contiguous (B, S, H, Dh) f32 tensor, and a work counter counts the call
by `work` (`build.kernel_call`).

The kernel has two instances (`kernel_variant` picks one per call):
"rows" for few query rows per (lane, kv head), the engine's decode
steps, and "tile", tensor-core tiles of 64 query rows at Dh 16, 32, 64,
128 or 256, for the engine's prefill chunks. Where the tile instance's
grid of (row tile, kv head, lane) blocks would fill less than half the
card (gemma_2b's chunk: 32 blocks), `tile_plan` cuts each block's walk
into parts, a block each, whose partials the split path's merge adds.

A decode step is bound by the pool's bytes: each K/V row a lane's
query can see is read once, for about G / 2 FLOP a byte of an f32 pool.
The rows instance takes such calls (at most SPLIT_MAX_ROWS = 16 query
rows per (lane, kv head), `split_takes`) on its split path: one block
per (part, kv head, lane) holds all G * S rows of its kv head, so each
K/V row is read once for the whole query group, and walks one of
`split_plan`'s n equal parts of its lane's key range (read from the
positions on the device) with pipelined copies; a second kernel adds
the parts. The plan reads shapes only, never the device's positions,
so a decode step takes no host sync. Larger rows-instance calls keep
its walk of many rows. The plan is shared with flash attention
(`kernels.plan`).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build, plan
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.plan import CARD_SMS, SPLIT_MAX_ROWS  # noqa: F401

NAME = "paged_attention"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
MAX_HEAD_DIM = 256
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("rows", "tile")          # the C entry's variant 0 and 1
# the tile instance takes a call with at least this many query rows per
# (lane, kv head), G * S, at one of these head dims
TILE_MIN_ROWS = 16
TILE_HEAD_DIMS = (16, 32, 64, 128, 256)
TILE_ROWS = 64      # query rows a tile-instance block holds
TILE_KEYS = 32      # keys a stage of its walk


def kernel_variant(group: int, s: int, head_dim: int) -> str:
    """The kernel instance a call of G = `group` query heads per kv head
    and S = `s` queries per lane takes: "tile" when the G * S query rows
    of a (lane, kv head) fill at least a 16-row mma tile and Dh is one
    of TILE_HEAD_DIMS (the engine's prefill chunks), "rows" otherwise
    (its decode steps, and Dh the tile instance is not built for)."""
    if group * s >= TILE_MIN_ROWS and head_dim in TILE_HEAD_DIMS:
        return "tile"
    return "rows"


def split_takes(rows: int, head_dim: int) -> bool:
    """Whether the rows instance's split path takes a call of `rows` =
    G * S query rows per (lane, kv head) at `head_dim`: every decode
    step of the shipped configurations."""
    return (rows <= plan.SPLIT_MAX_ROWS and head_dim % 4 == 0
            and (rows <= 8 or head_dim <= 128))


def split_plan(batch: int, kv_heads: int, rows: int, head_dim: int,
               max_keys: int) -> int:
    """`plan.split_plan` for this kernel's split path (`split_takes`;
    `max_keys`: the keys a lane's table can hold, Pmax * page)."""
    return plan.split_plan(split_takes, batch, kv_heads, rows, head_dim,
                           max_keys)


def tile_plan(batch: int, kv_heads: int, rows: int, max_keys: int) -> int:
    """The number of blocks the tile instance gives each (row tile, kv
    head, lane), each walking its share of the block's stages of
    TILE_KEYS keys, from shapes and host ints alone (`rows`: G * S;
    `max_keys`: Pmax * page): 1 where the grid's blocks fill at least
    half the card's SMs; else as many as one wave holds (CARD_SMS //
    blocks), at most one a stage the table can give."""
    blocks = batch * kv_heads * -(-rows // TILE_ROWS)
    if 2 * blocks >= plan.CARD_SMS:
        return 1
    return max(1, min(plan.CARD_SMS // blocks, -(-max_keys // TILE_KEYS)))


def _entry():
    lib = build.load(SOURCE)
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
    return fn


def _check(q, k_pages, v_pages, block_tables, positions, window, variant,
           splits, tile_parts):
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
    if splits is not None:
        if (variant or kernel_variant(h // kvh, s, hd)) != "rows":
            raise ValueError("splits names a path of the rows instance")
        if not isinstance(splits, int) or splits < 0 or (
                splits and not split_takes(h // kvh * s, hd)):
            raise ValueError(f"splits must be 0 (the walk of many rows) or, "
                             f"where the split path takes the call "
                             f"(split_takes), >= 1; got {splits!r}")
    if tile_parts is not None:
        if (variant or kernel_variant(h // kvh, s, hd)) != "tile":
            raise ValueError("tile_parts names a path of the tile instance")
        if not isinstance(tile_parts, int) or tile_parts < 1:
            raise ValueError(f"tile_parts must be >= 1, got {tile_parts!r}")


def paged_attention(q, k_pages, v_pages, block_tables, positions, *,
                    window: int | None = None,
                    scale: float | None = None,
                    variant: str | None = None,
                    splits: int | None = None,
                    tile_parts: int | None = None) -> torch.Tensor:
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
    splits:       the rows instance's path: None (the serve path) takes
                  `split_plan`'s count, n >= 1 forces n parts of the split
                  path, 0 its walk of many rows; the chip smoke names
                  them to hold each against the plain version.
    tile_parts:   the tile instance's blocks per (row tile, kv head,
                  lane), each on its share of the walk: None (the serve
                  path) takes `tile_plan`'s count, n >= 1 forces n.

    Returns the context tensor (B, S, H, Dh) f32: a query at position
    p attends to kv positions t <= p (and t > p - window when set) of
    its own row's table.
    """
    build.refuse_autograd(NAME, "the gather core (attn_impl='gather')", q,
                          k_pages, v_pages)
    _check(q, k_pages, v_pages, block_tables, positions, window, variant,
           splits, tile_parts)
    b, s, h, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd**0.5)
    tensors = (q, k_pages, v_pages, block_tables, positions)
    with build.kernel_call(NAME, lambda: work(q, k_pages, block_tables,
                                              positions, window=window)):
        if all(t.device.type == "meta" for t in tensors):
            return _output(q)
        if all(t.device.type == "cpu" for t in tensors):
            return _output(q).copy_(paged_attention_ref(
                q, k_pages, v_pages, block_tables, positions, window=window,
                scale=scale))
        return _launch(q, k_pages, v_pages, block_tables, positions,
                       window=window, scale=scale, variant=variant,
                       splits=splits, tile_parts=tile_parts)


def _output(q) -> torch.Tensor:
    b, s, h, hd = q.shape
    return torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)


def work(q, k_pages, block_tables, positions, *,
         window: int | None = None) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's function: 4 * Dh FLOPs (q.k and p.v)
    per kept (query head, key) pair, a query at position p keeping keys
    0..p (the last `window` of them with a window); each lane's K/V rows
    from its first kept key to its last position read once, q, the
    tables and the positions read once, the f32 context written once.
    Meta positions hold no values: each lane then counts its table's
    capacity (Pmax * page keys) for its keys and for every query."""
    b, s, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    if positions.device.type == "meta":
        cap = block_tables.shape[1] * page
        kept = min(cap, window) if window else cap
        pairs, keys = b * s * kept, b * cap
    else:
        pos = positions.detach().to("cpu", torch.int64)
        kept = torch.clamp(pos + 1, max=window) if window else pos + 1
        pairs = int(kept.sum())
        first = (torch.clamp(pos[:, 0] - window + 1, min=0) if window
                 else torch.zeros_like(pos[:, 0]))
        keys = int((pos[:, -1] + 1 - first).sum())
    n_bytes = (2 * keys * kvh * hd * k_pages.element_size()
               + q.numel() * q.element_size()
               + block_tables.numel() * block_tables.element_size()
               + positions.numel() * positions.element_size()
               + b * s * h * hd * 4)
    return 4 * hd * h * pairs, n_bytes


def _launch(q, k_pages, v_pages, block_tables, positions, *, window, scale,
            variant, splits, tile_parts):
    b, s, h, hd = q.shape
    tensors = (q, k_pages, v_pages, block_tables, positions)
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
    max_keys = bt.shape[1] * k_pages.shape[1]
    if variant == "tile":
        n_splits = (tile_plan(b, k_pages.shape[2], g * s, max_keys)
                    if tile_parts is None else tile_parts)
    else:
        n_splits = (split_plan(b, k_pages.shape[2], g * s, hd, max_keys)
                    if splits is None else splits)
        # the split path copies 4 elements at a time
        if n_splits and any(t.data_ptr() % (4 * t.element_size())
                            for t in (k_pages, v_pages)):
            raise ValueError("the split path needs pools aligned to 4 "
                             "elements")
    out = _output(q)
    # the split walks' partials: (m, l, o) of every row and part
    part = (torch.empty(n_splits * b * s * h * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        bt.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, s, h, k_pages.shape[2], hd, k_pages.shape[0], k_pages.shape[1],
        bt.shape[1], window or 0, float(scale),
        int(q.dtype == torch.bfloat16), int(k_pages.dtype == torch.bfloat16),
        VARIANTS.index(variant), n_splits,
        part.data_ptr() if part is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({variant}) launch "
                           f"failed: CUDA error {err}")
    build.launch_counts[NAME] += 1
    build.launch_counts[f"{NAME}.{variant}"] += 1
    return out
