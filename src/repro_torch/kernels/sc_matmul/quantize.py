"""The symmetric int8 quantization in front of the ARTEMIS MAC: the
wrapper of the hand-written Hopper kernel `sc_quantize`
(`csrc/sc_matmul.cu`, built into sc_matmul's library).

It replaces no Pallas kernel. The reference quantizes both operands of
a quantized product inside the jitted float entry of its Pallas kernel
(`repro.kernels.sc_matmul.ops`, through `repro.core.quantization`'s
`quant_scale` and `quantize`), where XLA fuses the chain into a pass or
two; as eager torch ops it is some ten passes over the operand in f32.
`quantize_int8(x, axis, absmax)` returns (q, scale), what
`core.quantization.quant_scale` and `quantize` give on the f32 of x,
bit for bit: the int8 tensor and the f32 scale with the reduced dims
kept. `axis` names the reduced dims as there (None: one scale for the
tensor); a given `absmax` (the whole tensor's, one element: the
tensor- and data-parallel seams) replaces x's own, and then the scale
is per tensor whatever `axis` says.

Dispatch is by the tensor's device, as every wrapper's: CPU tensors go
to the plain version (`quantize_int8_ref`, the two functions above),
CUDA tensors to the kernel, meta tensors to outputs of the right shapes
and nothing else, and anything the kernel does not take raises; there
is no fallback. A work counter counts the call by `work`
(`build.kernel_call`). The kernel has no backward: a caller that needs
the scale's gradient takes the plain ops (`build.refuse_autograd`).

The kernel views x as (outer, reduce, inner), each group the `reduce`
elements of one (outer, inner) index, so it takes any axes that form
one run of consecutive dims: per tensor, per lane (every dim but the
first), per row (the last), per column (the first of a matrix). Each
group is cut into `chunk_plan`'s chunks, a block each: a first pass
reduces every chunk to its max into a scratch of chunk maxima (from
`build.workspace`), a second reduces a group's chunk maxima to its
scale and quantizes its chunk. As sc_matmul's host path, the checks
that read shapes, strides, dtypes and host arguments and the C entry's
argument block (`_Args`, the .cu's `ScQuantizeArgs`) are made once per
call signature (`_Plan`), and a call writes the block's pointers and
stream and makes one ctypes call.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import build, plan
from repro_torch.kernels.sc_matmul.sc_matmul import SOURCE

NAME = "sc_quantize"
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
# blocks a pass aims for: 8 blocks of 256 threads on every SM, the most
# an SM holds
TARGET_BLOCKS = 8 * plan.CARD_SMS
THREADS = 256
# the least a block takes: elements of a row (8 bf16 a load, 2 loads a
# thread), rows of a column tile
MIN_ROW_CHUNK = 4096
MIN_COL_CHUNK = 16
# a row chunk is whole 16-byte vectors of bf16
ROW_CHUNK_GRANULE = 64


class _Args(ctypes.Structure):
    """The C entry's `ScQuantizeArgs`, field for field."""
    _fields_ = [*((n, ctypes.c_void_p) for n in (
                    "x", "absmax", "q", "scale", "part", "stream")),
                *((n, ctypes.c_longlong) for n in (
                    "outer", "reduce", "inner", "chunk")),
                *((n, ctypes.c_int) for n in ("chunks", "x_bf16"))]


def _entry():
    """The C entry, built and loaded at first use; its argument block is
    held against `_Args` when the library loads."""
    lib = build.load(SOURCE)
    fn = lib.sc_quantize_launch
    if fn.argtypes is None:
        build.check_launch_args(lib, "sc_quantize_launch_args_bytes", _Args)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args)]
    return fn


def _axes(axis, ndim: int) -> tuple | None:
    """`axis` as the sorted tuple of reduced dims (None: per tensor, as
    no dims reduce every dim in torch.amax); ValueError for a dim out of
    range or named twice."""
    dims = () if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    if not dims:
        return None
    out = []
    for d in dims:
        if not isinstance(d, int) or not -ndim <= d < ndim:
            raise ValueError(f"axis {axis!r} is out of range for a "
                             f"{ndim}-dim tensor")
        out.append(d % ndim)
    if len(set(out)) != len(out):
        raise ValueError(f"axis {axis!r} names a dim twice")
    return tuple(sorted(out))


def scale_shape(shape, axis) -> tuple:
    """The scale's shape: x's with the reduced dims kept as 1 (all of
    them per tensor)."""
    axes = _axes(axis, len(shape))
    if axes is None:
        return (1,) * len(shape)
    return tuple(1 if d in axes else n for d, n in enumerate(shape))


def groups(shape, axis) -> tuple[int, int, int] | None:
    """(outer, reduce, inner): x of `shape` as the kernel views it, each
    group the `reduce` elements of one (outer, inner) index; None where
    the reduced dims are not one run of consecutive dims."""
    axes = _axes(axis, len(shape))
    if axes is None:
        return 1, math.prod(shape), 1
    first, last = axes[0], axes[-1]
    if axes != tuple(range(first, last + 1)):
        return None
    return (math.prod(shape[:first]), math.prod(shape[first:last + 1]),
            math.prod(shape[last + 1:]))


def chunk_plan(outer: int, reduce: int, inner: int) -> tuple[int, int]:
    """(chunks, chunk): each group's `reduce` elements cut into `chunks`
    chunks of `chunk` (the last ragged), a block each, so that the
    grid holds about TARGET_BLOCKS blocks: rows (inner 1) in chunks of
    at least MIN_ROW_CHUNK elements and whole ROW_CHUNK_GRANULEs, column
    tiles of THREADS in chunks of at least MIN_COL_CHUNK rows; one chunk
    where the groups alone fill the grid."""
    if inner == 1:
        want = min(-(-TARGET_BLOCKS // outer), reduce // MIN_ROW_CHUNK)
        if want <= 1:
            return 1, reduce
        chunk = -(-reduce // want)
        chunk += -chunk % ROW_CHUNK_GRANULE
    else:
        tiles = -(-inner // THREADS)
        want = min(-(-TARGET_BLOCKS // (outer * tiles)),
                   reduce // MIN_COL_CHUNK)
        if want <= 1:
            return 1, reduce
        chunk = -(-reduce // want)
    return -(-reduce // chunk), chunk


def quantize_int8_ref(x: torch.Tensor, axis=None, absmax=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: `core.quantization.quant_scale` (8 bits) and
    `quantize` on the f32 of x."""
    # imported here: repro_torch.core imports this package
    from repro_torch.core import quantization
    xf = x.float()
    scale = quantization.quant_scale(xf, 8, axis, absmax_of=absmax)
    return quantization.quantize(xf, scale), scale


def quantize_int8(x: torch.Tensor, axis=None,
                  absmax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): x quantized to int8 with a symmetric scale per group
    (module docstring). x: any shape, f32 or bf16 on the card."""
    build.refuse_autograd(NAME, "core.quantization.quant_scale and quantize",
                          x)
    if axis is not None and not isinstance(axis, int):
        axis = tuple(axis)
    key = (x.device, x.shape, x.stride(), x.dtype, axis) if absmax is None \
        else (x.device, x.shape, x.stride(), x.dtype, axis, absmax.device,
              absmax.shape, absmax.dtype)
    p = _PLANS.get(key)
    if p is None:
        p = _PLANS.put(key, _Plan(x, axis, absmax))
    with build.kernel_call(NAME, lambda: work(x, axis, absmax)):
        if p.kind == "cuda":
            return _launch(p, x, absmax)
        if p.kind == "meta":
            return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                    torch.empty(p.scale_shape, dtype=torch.float32,
                                device=x.device))
        if p.kind == "cpu":
            return quantize_int8_ref(x, axis, absmax)
        raise ValueError(f"quantize_int8: x and absmax must be on one "
                         f"device, got {x.device} and {absmax.device}")


def work(x: torch.Tensor, axis=None, absmax=None) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's function: no FLOPs (elementwise work,
    which the count does not price); x read once, the absmax read once
    where given, the int8 tensor and the f32 scale written once."""
    n_scales = 1 if absmax is not None else math.prod(
        scale_shape(x.shape, axis))
    return 0, (x.numel() * (x.element_size() + 1) + 4 * n_scales
               + (4 if absmax is not None else 0))


# the launch plans, by call signature (`quantize_int8`'s key)
_PLANS = build.PlanCache()


class _Plan:
    """What a call signature decides once: the checks that read shapes,
    strides, dtypes and host arguments, the scale's shape, and for the
    card the groups, their chunks, the scratch's size and the C entry's
    argument block. Made only after every check passed, so a refused
    call stores none."""

    def __init__(self, x, axis, absmax, kind=None):
        _axes(axis, x.dim())                 # raises on a bad axis
        if absmax is not None and absmax.numel() != 1:
            raise ValueError(f"absmax is the whole tensor's, one element; "
                             f"got shape {tuple(absmax.shape)}")
        self.scale_shape = scale_shape(x.shape, None if absmax is not None
                                       else axis)
        dev = x.device
        # x's device kind (None: absmax elsewhere); `kind` names it for a
        # test that plans a card's call from CPU tensors
        self.kind = kind or (dev.type if absmax is None or absmax.device ==
                             dev else None)
        if self.kind != "cuda":
            return
        if x.dtype not in _FLOAT_TYPES:
            raise TypeError(f"the sc_quantize kernel takes f32 or bf16, got "
                            f"{x.dtype}")
        if x.numel() == 0:
            raise ValueError("the sc_quantize kernel takes a non-empty "
                             "tensor")
        view = (1, x.numel(), 1) if absmax is not None else groups(
            x.shape, axis)
        if view is None:
            raise ValueError(f"the sc_quantize kernel takes reduced dims "
                             f"that form one run of consecutive dims, got "
                             f"axis {axis!r} of a {x.dim()}-dim tensor")
        outer, reduce, inner = view
        chunks, chunk = chunk_plan(outer, reduce, inner)
        self.part_numel = 0 if absmax is not None else chunks * outer * inner
        self.x_ready = x.is_contiguous()
        self.absmax_ready = absmax is None or absmax.dtype == torch.float32
        self.q_shape = tuple(x.shape)
        self.device = dev
        self.launch = _entry()
        self.args = _Args(outer=outer, reduce=reduce, inner=inner,
                          chunk=chunk, chunks=chunks,
                          x_bf16=int(x.dtype == torch.bfloat16))
        self.args_ref = ctypes.byref(self.args)
        # the block is written and read by one call at a time
        self.lock = threading.Lock()


def _launch(p, x, absmax):
    if not p.x_ready:
        x = x.contiguous()
    if not p.absmax_ready:
        absmax = absmax.float()
    dev = p.device
    q = torch.empty(p.q_shape, dtype=torch.int8, device=dev)
    scale = torch.empty(p.scale_shape, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = (build.workspace(dev, stream, p.part_numel,
                            torch.cuda.is_current_stream_capturing())
            if p.part_numel else None)
    with p.lock:
        a = p.args
        a.x, a.q, a.scale = x.data_ptr(), q.data_ptr(), scale.data_ptr()
        a.absmax = absmax.data_ptr() if absmax is not None else None
        a.part = part.data_ptr() if part is not None else None
        a.stream = stream
        err = p.launch(p.args_ref)
    if err != 0:
        raise RuntimeError(f"sc_quantize kernel launch failed: CUDA error "
                           f"{err}")
    build.launch_counts[NAME] += 1
    return q, scale
