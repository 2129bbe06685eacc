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
meta tensors (the dry run's) to outputs of the right shape and dtype
and nothing else, and anything the kernel does not take raises. There
is no fallback from the kernel to the plain version, nor from one
kernel instance to the other. On every device the outputs have the
kernel's layout (o a view of a (B, Sq, Hq, D) tensor), and a work
counter counts the call by `work` (`build.kernel_call`).

The kernel has two instances (`kernel_variant` picks one per call):
"tile", bf16 tensor-core tiles of 128 query rows, for bf16 q over K/V
that are bf16 or rounded to it (`kv_cast`) with at least 16 query rows
at D 16, 32, 64, 112, 128 or 256 (the static path's prefill at every
shipped head dim), and "rows", f32 on the CUDA cores, for everything
else (its decode steps, f32 operands).

A decode step is bound by the cache's bytes: each K/V row up to kv_len
is read once, for about G / 2 FLOP a byte of an f32 cache. The rows
instance takes such calls (at most SPLIT_MAX_ROWS = 16 query rows per
(batch, kv head), `split_takes`) on its split path: one block per
(part, kv head, batch) holds all G * Sq rows of its kv head, so each
K/V row is read once for the whole query group (the walk of many rows
reads it once per query head), and walks one of `split_plan`'s n equal
parts of the keys with pipelined copies; a second kernel adds the
parts. Larger rows-instance calls keep its walk of many rows. The plan
is shared with paged attention (`kernels.plan`).

A decode call's device time is some 20-95 µs, so the host path is kept
short: the checks that read only shapes, strides, dtypes and host
arguments, the instance, its parts and the C entry's argument block
(`_Args`, the .cu's `FlashAttentionArgs`) are made once per call
signature (`_Plan`), a call writes the block's pointers and stream and
makes one ctypes call with one pointer, o, lse and nvis are views of
one allocation (`_layout`), and the split walks' partials come from a
buffer kept per (device, stream) (`build.workspace`).
"""
from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build, plan
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.plan import CARD_SMS, SPLIT_MAX_ROWS  # noqa: F401

NAME = "flash_attention"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("rows", "tile")          # the C entry's variant 0 and 1
# the tile instance takes a call with at least this many query rows, at
# one of these head dims
TILE_MIN_ROWS = 16
TILE_HEAD_DIMS = (16, 32, 64, 112, 128, 256)


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


def split_takes(rows: int, head_dim: int) -> bool:
    """Whether the rows instance's split path takes a call of `rows` =
    G * Sq query rows per (batch, kv head) at `head_dim`: every decode
    step of the static path."""
    return rows <= plan.SPLIT_MAX_ROWS and (rows <= 8 or head_dim <= 128)


def split_plan(batch: int, kv_heads: int, rows: int, head_dim: int,
               max_keys: int) -> int:
    """`plan.split_plan` for this kernel's split path (`split_takes`;
    `max_keys`: the call's kv_len, the keys it can visit)."""
    return plan.split_plan(split_takes, batch, kv_heads, rows, head_dim,
                           max_keys)


class _Args(ctypes.Structure):
    """The C entry's `FlashAttentionArgs`, field for field."""
    _fields_ = [*((n, ctypes.c_void_p) for n in (
                    "q", "k", "v", "o", "lse", "nvis", "part", "stream")),
                *((n, ctypes.c_int) for n in (
                    "B", "Hq", "Hkv", "Sq", "Sk", "D")),
                *((f"{t}_s{dim}", ctypes.c_longlong)
                  for t in "qkvo" for dim in "bhs"),
                *((n, ctypes.c_int) for n in (
                    "causal", "window", "kv_len", "q_offset", "bq", "bk")),
                ("scale", ctypes.c_float),
                *((n, ctypes.c_int) for n in (
                    "q_bf16", "kv_bf16", "kv_round", "variant",
                    "n_splits"))]


def _entry():
    """The C entry, built and loaded at first use; its argument block is
    held against `_Args` when the library loads."""
    lib = build.load(SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        build.check_launch_args(lib, "flash_attention_launch_args_bytes",
                                _Args)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args)]
    return fn


def _validate(q, k, v, *, causal, window, kv_len, bq, bk, kv_cast,
              variant, splits):
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
    if splits is not None:
        if (variant or kernel_variant(q.dtype, k.dtype, kv_cast, sq,
                                      d)) != "rows":
            raise ValueError("splits names a path of the rows instance")
        if not isinstance(splits, int) or splits < 0 or (
                splits and not split_takes(hq // hkv * sq, d)):
            raise ValueError(f"splits must be 0 (the walk of many rows) or, "
                             f"where the split path takes the call "
                             f"(split_takes), >= 1; got {splits!r}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride over D and strides of 4 elements elsewhere: with an
    address on a 16-byte (f32) or 8-byte (bf16) boundary, rows of
    4-element groups on such boundaries, as the kernel's vector loads
    and stores need."""
    return t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:3])


_KV_LAYOUT = ("flash_attention kernel needs K/V with unit stride over D "
              "and 4-element aligned rows")

# the launch plans, by call signature (`flash_attention_all`'s key)
_PLANS = build.PlanCache()


class _Plan:
    """What a call signature decides once: `_validate`'s checks, kv_len
    resolved, the scale and the outputs' layout on every device; on the
    card also the kernel's types, D and K/V strides, the instance, its
    parts, the workspace's size and the C entry's argument block with
    every size, stride and mask filled in. Made only after every check
    passed, so a refused call stores none. What a signature does not fix
    (the operands' device and their addresses' alignment) is checked per
    call by `_launch`."""

    def __init__(self, kind, q, k, v, *, causal, window, kv_len, q_offset,
                 scale, bq, bk, kv_cast, variant, splits):
        _validate(q, k, v, causal=causal, window=window, kv_len=kv_len,
                  bq=bq, bk=bk, kv_cast=kv_cast, variant=variant,
                  splits=splits)
        b, hq, sq, d = q.shape
        _, hkv, sk, _ = k.shape
        kv_len = sk if kv_len is None else min(int(kv_len), sk)
        self.kv_len, self.q_offset = kv_len, int(q_offset)
        self.scale = 1.0 / (d ** 0.5) if scale is None else scale
        self.ref_kw = dict(causal=causal, window=window, kv_len=kv_len,
                           q_offset=self.q_offset, scale=self.scale, bq=bq,
                           bk=bk, kv_cast=kv_cast)
        self.layout = _layout(q.shape)
        if kind != "cuda":
            return
        if q.dtype not in _FLOAT_TYPES or k.dtype not in _FLOAT_TYPES \
                or v.dtype != k.dtype:
            raise TypeError(f"flash_attention kernel takes f32/bf16 q and "
                            f"K/V, got q {q.dtype}, k {k.dtype}, v {v.dtype}")
        if kv_cast not in (None, *_FLOAT_TYPES):
            raise TypeError(f"flash_attention kernel rounds K/V to bf16 or "
                            f"f32 only, got kv_cast={kv_cast}")
        if d % 4 or d > MAX_HEAD_DIM:
            raise ValueError(f"flash_attention kernel takes D a multiple of "
                             f"4 up to {MAX_HEAD_DIM}, got {d}")
        if not (_rows_aligned(k) and _rows_aligned(v)):
            # a copy of K/V (a whole cache) would cost more than the
            # attention
            raise ValueError(_KV_LAYOUT)
        # q's rows as given, else a contiguous copy's (a new allocation,
        # so aligned)
        self.q_ready = _rows_aligned(q)
        self.q_align = 4 * q.element_size()
        self.kv_align = 4 * k.element_size()
        q_strides = (q.stride()[:3] if self.q_ready
                     else (hq * sq * d, sq * d, d))
        self.variant = variant or kernel_variant(q.dtype, k.dtype, kv_cast,
                                                 sq, d)
        n_splits = 0
        if self.variant == "rows":
            n_splits = (split_plan(b, hkv, hq // hkv * sq, d, kv_len)
                        if splits is None else splits)
        # the split path's partials: (m, l, o) of every row and part
        self.part_numel = (n_splits * b * hq * sq * (d + 2)
                           if n_splits > 1 else 0)
        self.launch = _entry()
        strides = (*q_strides, *k.stride()[:3], *v.stride()[:3],
                   *self.layout[1][0][1][:3])
        self.args = _Args(
            B=b, Hq=hq, Hkv=hkv, Sq=sq, Sk=sk, D=d,
            **{f"{t}_s{dim}": stride for (t, dim), stride in zip(
                ((t, dim) for t in "qkvo" for dim in "bhs"), strides)},
            causal=int(causal), window=window or 0, kv_len=kv_len,
            q_offset=self.q_offset, bq=bq, bk=bk, scale=float(self.scale),
            q_bf16=int(q.dtype == torch.bfloat16),
            kv_bf16=int(k.dtype == torch.bfloat16),
            kv_round=int(kv_cast == torch.bfloat16
                         and k.dtype == torch.float32),
            variant=VARIANTS.index(self.variant), n_splits=n_splits)
        self.args_ref = ctypes.byref(self.args)
        # the block is written and read by one call at a time
        self.lock = threading.Lock()
        self.count_key = f"{NAME}.{self.variant}"


def _launch(plan, q, k, v):
    if k.data_ptr() % plan.kv_align or v.data_ptr() % plan.kv_align:
        raise ValueError(_KV_LAYOUT)
    if not plan.q_ready:
        q = q.clone(memory_format=torch.contiguous_format)
    elif q.data_ptr() % plan.q_align:
        # an aligned copy in q's own layout, which the plan's strides name
        q = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                device=q.device).copy_(q)
    dev = q.device
    o, lse, nvis = _outputs(plan.layout, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = (build.workspace(dev, stream, plan.part_numel,
                            torch.cuda.is_current_stream_capturing())
            if plan.part_numel else None)
    with plan.lock:
        a = plan.args
        a.q, a.k, a.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
        a.o, a.lse, a.nvis = o.data_ptr(), lse.data_ptr(), nvis.data_ptr()
        a.part = part.data_ptr() if part is not None else None
        a.stream = stream
        err = plan.launch(plan.args_ref)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({plan.variant}) launch "
                           f"failed: CUDA error {err}")
    build.launch_counts[NAME] += 1
    build.launch_counts[plan.count_key] += 1
    return o, lse, nvis


def flash_attention_all(q, k, v, *, causal: bool = True,
                        window: int | None = None, kv_len: int | None = None,
                        q_offset: int = 0, scale: float | None = None,
                        bq: int = 128, bk: int = 128, kv_cast=None,
                        variant: str | None = None,
                        splits: int | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0.

    Query row r sits at key position r + q_offset. It keeps key c when
    c < kv_len (default Sk) and, if causal, c <= r + q_offset and, with
    a window W, c > r + q_offset - W. Sq and Sk count as padded with
    zeros to multiples of (bq, bk), the tiles of the Pallas kernel's
    block skip; padded keys are masked. `kv_cast` (bf16) rounds f32 K/V
    to bf16 before use. See `ref.flash_attention_ref` for the edge
    values. `variant`, "rows" or "tile", names the kernel instance; None
    (the static path) takes `kernel_variant`'s choice. `splits` names
    the rows instance's path: None (the static path) takes `split_plan`'s
    count, n >= 1 forces n parts of the split path, 0 its walk of many
    rows. Both are checked on every device; the plain version computes
    the same function for every instance and path.

    Returns (o (B, Hq, Sq, D) f32, lse (B, Hq, Sq) f32, nvis (B, Hq, Sq)
    f32: the K tiles each row's query tile executed), views of one
    allocation (`_layout`); o is laid out (B, Sq, Hq, D), on every
    device.
    """
    build.refuse_autograd(NAME, "the gather core (attn_impl='gather')", q,
                          k, v)
    dev = q.device
    kind = dev.type if (k.device == dev and v.device == dev) else None
    key = (kind, q.shape, q.stride(), q.dtype, k.shape, k.stride(), k.dtype,
           v.shape, v.stride(), v.dtype, causal, window, kv_len, q_offset,
           scale, bq, bk, kv_cast, variant, splits)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS.put(key, _Plan(
            kind, q, k, v, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset, scale=scale, bq=bq, bk=bk, kv_cast=kv_cast,
            variant=variant, splits=splits))
    with build.kernel_call(NAME, lambda: work(
            q, k, causal=causal, window=window, kv_len=plan.kv_len,
            q_offset=plan.q_offset)):
        if kind == "meta":
            return _outputs(plan.layout, dev)
        if kind == "cpu":
            out = _outputs(plan.layout, dev)
            for dst, src in zip(out, flash_attention_ref(q, k, v,
                                                         **plan.ref_kw)):
                dst.copy_(src)
            return out
        if kind != "cuda":
            raise ValueError(f"flash_attention: all operands must be on "
                             f"one device, got "
                             f"{[str(t.device) for t in (q, k, v)]}")
        return _launch(plan, q, k, v)


def _layout(shape) -> tuple:
    """(elements, ((size, stride, offset) of o, lse, nvis)): the outputs
    as views of one f32 allocation in the kernel's layout. o, first and
    so as aligned as the allocation, is laid out (B, Sq, Hq, D) and seen
    as (B, Hq, Sq, D), so the attention layer's reshape to (B, Sq,
    Hq * D) is free; lse and nvis follow it, each (B, Hq, Sq)
    contiguous."""
    b, hq, sq, d = shape
    n_o, n_row = b * sq * hq * d, b * hq * sq
    rows = ((b, hq, sq), (hq * sq, sq, 1))
    return n_o + 2 * n_row, (((b, hq, sq, d), (sq * hq * d, d, hq * d, 1), 0),
                             (*rows, n_o), (*rows, n_o + n_row))


def _outputs(layout, device) -> tuple:
    """Empty (o, lse, nvis) of `_layout`, on `device`."""
    numel, views = layout
    buf = torch.empty(numel, dtype=torch.float32, device=device)
    return tuple(buf.as_strided(*view) for view in views)


def _kept_pairs(sq: int, *, causal: bool, window: int | None, kv_len: int,
               q_offset: int) -> tuple[int, int]:
    """(the (query row, key) pairs the call's mask keeps, the keys any row
    keeps), per (batch, query head): row r at position p = r + q_offset
    keeps keys c < kv_len with, if causal, c <= p and, with a window W,
    c > p - W."""
    p = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(p + 1, max=kv_len) if causal else torch.full_like(
        p, kv_len)
    lo = torch.clamp(p - window + 1, min=0) if window else torch.zeros_like(p)
    pairs = int(torch.clamp(hi - lo, min=0).sum())
    keys = max(0, int(hi.max()) - int(lo.min()))
    return pairs, keys


def work(q, k, *, causal: bool = True, window: int | None = None,
         kv_len: int | None = None, q_offset: int = 0) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's function: 2 * D FLOPs of q.k and 2 *
    D of p.v per kept (query head, key) pair; q read once, K and V once
    over the keys some row keeps, o (f32), lse and nvis written once."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else min(int(kv_len), sk)
    pairs, keys = _kept_pairs(sq, causal=causal, window=window,
                             kv_len=kv_len, q_offset=q_offset)
    flops = 4 * d * hq * b * pairs
    n_bytes = (q.numel() * q.element_size()
               + 2 * b * hkv * keys * d * k.element_size()
               + b * hq * sq * (d + 2) * 4)
    return flops, n_bytes


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
