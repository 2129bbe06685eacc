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

A decode call's device time is about 20 µs, so the host path is kept
short: the checks that read only shapes, strides, dtypes and host
arguments, the instance, its parts and the C entry's argument block
(`_Args`, the .cu's `PagedAttentionArgs`) are made once per call
signature (`_Plan`), a call writes the block's pointers and stream and
makes one ctypes call with one pointer, and the split walks' partials
come from a buffer kept per (device, stream) (`build.workspace`).
"""
from __future__ import annotations

import ctypes
import pathlib
import threading

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


class _Args(ctypes.Structure):
    """The C entry's `PagedAttentionArgs`, field for field."""
    _fields_ = [*((n, ctypes.c_void_p) for n in (
                    "q", "k_pages", "v_pages", "block_tables", "positions",
                    "out", "part", "stream")),
                *((n, ctypes.c_int) for n in (
                    "B", "S", "H", "KV", "Dh", "n_pages", "page", "pmax",
                    "window")),
                ("scale", ctypes.c_float),
                *((n, ctypes.c_int) for n in (
                    "q_bf16", "kv_bf16", "variant", "n_splits"))]


def _entry():
    """The C entry, built and loaded at first use; its argument block is
    held against `_Args` when the library loads."""
    lib = build.load(SOURCE)
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        build.check_launch_args(lib, "paged_attention_launch_args_bytes",
                                _Args)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args)]
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
    dev = q.device
    kind = dev.type if (k_pages.device == dev and v_pages.device == dev
                        and block_tables.device == dev
                        and positions.device == dev) else None
    key = (kind, q.shape, q.stride(), q.dtype, k_pages.shape,
           k_pages.stride(), k_pages.dtype, v_pages.shape, v_pages.stride(),
           v_pages.dtype, block_tables.shape, block_tables.stride(),
           block_tables.dtype, positions.shape, positions.stride(),
           positions.dtype, window, scale, variant, splits, tile_parts)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS.put(key, _Plan(kind, q, k_pages, v_pages, block_tables,
                                     positions, window, scale, variant,
                                     splits, tile_parts))
    with build.kernel_call(NAME, lambda: work(q, k_pages, block_tables,
                                              positions, window=window)):
        if kind == "meta":
            return _output(q)
        if kind == "cpu":
            return _output(q).copy_(paged_attention_ref(
                q, k_pages, v_pages, block_tables, positions, window=window,
                scale=plan.scale))
        if kind != "cuda":
            tensors = (q, k_pages, v_pages, block_tables, positions)
            raise ValueError(f"paged_attention: all operands must be on one "
                             f"device, got {[str(t.device) for t in tensors]}")
        return _launch(plan, q, k_pages, v_pages, block_tables, positions)


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


# the launch plans, by call signature (`paged_attention`'s key)
_PLANS = build.PlanCache()


class _Plan:
    """What a call signature decides once: the checks that read only
    shapes, strides, dtypes and host arguments (`_check` on every device;
    on the card also the kernel's types, Dh and contiguous pools), the
    scale, and for the card the instance, its parts, the workspace's
    size and the C entry's argument block with every size filled in.
    Made only after every check passed, so a refused call stores none.
    What a signature does not fix (the operands' device and their
    addresses' alignment) is checked per call by `_launch`."""

    def __init__(self, kind, q, k_pages, v_pages, block_tables, positions,
                 window, scale, variant, splits, tile_parts):
        _check(q, k_pages, v_pages, block_tables, positions, window,
               variant, splits, tile_parts)
        b, s, h, hd = q.shape
        self.scale = 1.0 / (hd**0.5) if scale is None else scale
        if kind != "cuda":
            return
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
        n_pages, page, kvh, _ = k_pages.shape
        g = h // kvh
        self.variant = variant or kernel_variant(g, s, hd)
        max_keys = block_tables.shape[1] * page
        if self.variant == "tile":
            n_splits = (tile_plan(b, kvh, g * s, max_keys)
                        if tile_parts is None else tile_parts)
            # the tile instance reads 16 bytes at a time
            self.align = 16
        else:
            n_splits = (split_plan(b, kvh, g * s, hd, max_keys)
                        if splits is None else splits)
            # the split path copies 4 elements at a time
            self.align = 4 * k_pages.element_size() if n_splits else 0
        self.n_splits = n_splits
        # the split walks' partials: (m, l, o) of every row and part
        self.part_numel = (n_splits * b * s * h * (hd + 2)
                           if n_splits > 1 else 0)
        self.out_shape = (b, s, h, hd)
        self.q_ready = q.is_contiguous()
        self.tables_ready = (block_tables.dtype == torch.int32
                             and block_tables.is_contiguous())
        self.positions_ready = (positions.dtype == torch.int32
                                and positions.is_contiguous())
        self.launch = _entry()
        self.args = _Args(
            B=b, S=s, H=h, KV=kvh, Dh=hd, n_pages=n_pages, page=page,
            pmax=block_tables.shape[1], window=window or 0,
            scale=float(self.scale), q_bf16=int(q.dtype == torch.bfloat16),
            kv_bf16=int(k_pages.dtype == torch.bfloat16),
            variant=VARIANTS.index(self.variant), n_splits=n_splits)
        self.args_ref = ctypes.byref(self.args)
        # the block is written and read by one call at a time
        self.lock = threading.Lock()
        self.count_key = f"{NAME}.{self.variant}"


def _launch(plan, q, k_pages, v_pages, block_tables, positions):
    if plan.align and (k_pages.data_ptr() % plan.align
                       or v_pages.data_ptr() % plan.align):
        raise ValueError("the tile instance needs 16-byte aligned pools"
                         if plan.variant == "tile" else
                         "the split path needs pools aligned to 4 elements")
    if not plan.q_ready:
        q = q.contiguous()
    if plan.variant == "tile" and q.data_ptr() % 16:
        q = q.clone()                # the tile instance reads 16 bytes
    bt = (block_tables if plan.tables_ready
          else block_tables.to(torch.int32).contiguous())
    pos = (positions if plan.positions_ready
           else positions.to(torch.int32).contiguous())
    dev = q.device
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = (build.workspace(dev, stream, plan.part_numel,
                            torch.cuda.is_current_stream_capturing())
            if plan.part_numel else None)
    with plan.lock:
        a = plan.args
        a.q, a.k_pages, a.v_pages = (q.data_ptr(), k_pages.data_ptr(),
                                     v_pages.data_ptr())
        a.block_tables, a.positions = bt.data_ptr(), pos.data_ptr()
        a.out = out.data_ptr()
        a.part = part.data_ptr() if part is not None else None
        a.stream = stream
        err = plan.launch(plan.args_ref)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({plan.variant}) launch "
                           f"failed: CUDA error {err}")
    build.launch_counts[NAME] += 1
    build.launch_counts[plan.count_key] += 1
    return out
