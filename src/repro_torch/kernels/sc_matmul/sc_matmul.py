"""The ARTEMIS MAC over pre-quantized int8 operands: the wrapper of the
hand-written Hopper kernel (`csrc/sc_matmul.cu`), the port of the
Pallas kernel `repro.kernels.sc_matmul.sc_matmul.sc_matmul_quantized`.

Dispatch is by the tensors' device, explicitly: CPU tensors go to the
plain version (`ref.sc_matmul_ref`), CUDA tensors to the kernel, meta
tensors (the dry run's) to an output of the right shape and dtype and
nothing else, and anything the kernel does not take raises. There is
no fallback from the kernel to the plain version. On every device the
output has the kernel's layout (the (M, N) corner of an (M, N padded
to `DOT_N_GRANULE`) tensor), and a work counter counts the call by
`work` (`build.kernel_call`).

The kernel computes what `repro.core.artemis_matmul`'s quantized core
computes, bit for bit: exact integer dots for `int8` and `artemis_mxu`
(the sign correction applied once, on the full sums), and for
`artemis` the MOMCAP groups of `acc_depth` products read out with a
true division and accumulated in group order. For `artemis` the wrapper
hands the kernel the readout level of every possible group sum
(`readout_table`, built once per device, depth and readout) and, at
decode, scratch where the groups' exact sums meet before the scan;
above decode each warp reads its groups out of its registers, looking
the levels up in the table, and where the output has too few tiles to
fill the card K is split too and the scratch holds every group's
levels for the scan.

Every quantized projection calls it, so its host path is kept short,
as the attention wrappers' are: the checks that read only shapes,
strides, dtypes and host arguments, the padded sizes, the scratch's
size, the readout table and the C entry's argument block (`_Args`, the
.cu's `ScMatmulArgs`) are made once per call signature (`_Plan`); a
call writes the block's pointers and stream and makes one ctypes call,
and the scratch of artemis_mxu and of artemis's splits comes from the
buffer kept per (device, stream) (`build.workspace`).
"""
from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sc_matmul.ref import (MODES, SC_LEVELS, readout_table,
                                               sc_matmul_ref)

NAME = "sc_matmul"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "sc_matmul.cu"
_MODE_IDS = {"int8": 0, "artemis_mxu": 1, "artemis": 2}
# the kernel sums a group's products in 16-bit lanes (at most 128 * 128)
# and keeps its readout table (acc_depth*128 + 1 floats) in shared memory
MAX_ACC_DEPTH = 128
# the integer dots run m16n8k32 tensor-core products over B rows copied
# 16 bytes at a time; artemis copies A and B rows 16 bytes at a time and
# zero-fills its ragged last group
DOT_K_GRANULE = 32
DOT_N_GRANULE = 16
ARTEMIS_K_GRANULE = 16
# readout tables by (device, acc_depth, readout_bits)
_TABLES: dict[tuple, torch.Tensor] = {}


class _Args(ctypes.Structure):
    """The C entry's `ScMatmulArgs`, field for field."""
    _fields_ = [*((n, ctypes.c_void_p) for n in (
                    "A", "B", "out", "scratch", "table", "stream")),
                *((n, ctypes.c_int) for n in (
                    "M", "N", "K", "mode", "acc_depth", "readout_bits")),
                ("delta", ctypes.c_float), ("rbar", ctypes.c_float)]


def _entries():
    """(sc_matmul_launch, sc_matmul_scratch_bytes) of the built library;
    the launch's argument block is held against `_Args` when the
    library loads."""
    lib = build.load(SOURCE)
    fn, nbytes = lib.sc_matmul_launch, lib.sc_matmul_scratch_bytes
    if fn.argtypes is None:
        build.check_launch_args(lib, "sc_matmul_launch_args_bytes", _Args)
        nbytes.restype = ctypes.c_longlong
        nbytes.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args)]
    return fn, nbytes


def _table(acc_depth: int, readout_bits: int | None,
           device: torch.device) -> torch.Tensor:
    key = (device, acc_depth, readout_bits)
    if key not in _TABLES:
        _TABLES[key] = readout_table(acc_depth, readout_bits, device)
    return _TABLES[key]


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x zero-padded at the end to (rows, cols); x itself when it fits."""
    if tuple(x.shape) == (rows, cols):
        return x
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def granules(mode: str, acc_depth: int) -> tuple[int, int]:
    """(k, n): what the kernel needs K and N to be multiples of. The
    integer dots (int8, artemis_mxu) take whole mma depths of K; artemis
    takes 16-byte rows of A, whatever `acc_depth` (the kernel zero-fills
    the last MOMCAP group); every mode takes whole 16-byte rows of B."""
    if mode == "artemis":
        return ARTEMIS_K_GRANULE, DOT_N_GRANULE
    return DOT_K_GRANULE, DOT_N_GRANULE


def pad_operands(aq: torch.Tensor, bq: torch.Tensor, mode: str,
                 acc_depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands as the kernel takes them: K and N zero-padded to the
    mode's `granules` (zeros add nothing to a dot or to a MOMCAP group,
    and a group of zeros adds +0 - 0), contiguous and 16-byte aligned.
    The (M, N) corner of the padded product is the product."""
    m, k = aq.shape
    n = bq.shape[1]
    gk, gn = granules(mode, acc_depth)
    kp = k + (-k) % gk
    np_ = n + (-n) % gn
    a = _pad(aq.contiguous(), m, kp)
    b = _pad(bq.contiguous(), kp, np_)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        a, b = a.clone(), b.clone()
    return a, b


def _check(aq, bq, mode, acc_depth, readout_bits):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if aq.dim() != 2 or bq.dim() != 2 or aq.shape[1] != bq.shape[0]:
        raise ValueError(f"sc_matmul_quantized takes (M, K) x (K, N), got "
                         f"{tuple(aq.shape)} x {tuple(bq.shape)}")
    if aq.dtype != torch.int8 or bq.dtype != torch.int8:
        raise TypeError(f"sc_matmul_quantized takes int8 operands, got "
                        f"{aq.dtype} x {bq.dtype}")
    if acc_depth < 1:
        raise ValueError(f"acc_depth must be >= 1, got {acc_depth}")
    if readout_bits is not None and not 1 <= readout_bits <= 24:
        raise ValueError(f"readout_bits must be None or in [1, 24], got "
                         f"{readout_bits}")


def sc_matmul_quantized(aq: torch.Tensor, bq: torch.Tensor, *,
                        mode: str = "artemis", acc_depth: int = 20,
                        readout_bits: int | None = 8,
                        rbar: float = 63.5) -> torch.Tensor:
    """ARTEMIS MAC over pre-quantized operands.

    aq: (M, K) int8, bq: (K, N) int8, any M, K, N >= 1. Returns (M, N):
    int32 for mode="int8" (integer dot units), float32 in SC product
    units otherwise.
    """
    # a plan on the card holds its device's readout table
    key = (aq.device, bq.device, aq.shape, aq.stride(), aq.dtype, bq.shape,
           bq.stride(), bq.dtype, mode, acc_depth, readout_bits, rbar)
    p = _PLANS.get(key)
    if p is None:
        # a plan holds int8 operands, which never require grad
        build.refuse_autograd(NAME, "the straight-through estimator "
                              "(core.artemis_matmul with policy.ste)", aq,
                              bq)
        p = _PLANS.put(key, _Plan(aq, bq, mode, acc_depth, readout_bits,
                                  rbar))
    with build.kernel_call(NAME, lambda: work(aq, bq), int8=True):
        if p.kind == "cuda":
            return _launch(p, aq, bq)
        if p.kind == "meta":
            return _output(aq.shape[0], bq.shape[1], mode, aq.device)
        if p.kind == "cpu":
            return _output(aq.shape[0], bq.shape[1], mode, aq.device).copy_(
                sc_matmul_ref(aq, bq, mode=mode, acc_depth=acc_depth,
                              readout_bits=readout_bits, rbar=rbar))
        raise ValueError(f"sc_matmul_quantized: both operands must be on "
                         f"one device, got {aq.device} and {bq.device}")


# the launch plans, by call signature (`sc_matmul_quantized`'s key)
_PLANS = build.PlanCache()


class _Plan:
    """What a call signature decides once: `_check` on every device; on
    the card also the kernel's depth limit, whether the operands need
    padding or a contiguous copy, the output's layout, the scratch's
    size (`sc_matmul_scratch_bytes`, asked once), the readout table and
    the C entry's argument block with every size filled in. Made only
    after every check passed, so a refused call stores none. What a
    signature does not fix (the operands' addresses' alignment) is
    checked per call by `_launch`."""

    def __init__(self, aq, bq, mode, acc_depth, readout_bits, rbar,
                 kind=None):
        _check(aq, bq, mode, acc_depth, readout_bits)
        dev = aq.device
        # the operands' device kind (None: two devices); `kind` names it
        # for a test that plans a card's call from CPU tensors
        self.kind = kind or (dev.type if bq.device == dev else None)
        if self.kind != "cuda":
            return
        if mode == "artemis" and acc_depth > MAX_ACC_DEPTH:
            raise ValueError(f"sc_matmul kernel takes acc_depth <= "
                             f"{MAX_ACC_DEPTH}, got {acc_depth}")
        m, k = aq.shape
        n = bq.shape[1]
        gk, gn = granules(mode, acc_depth)
        kp, np_ = k + (-k) % gk, n + (-n) % gn
        self.mode, self.acc_depth, self.n = mode, acc_depth, n
        self.device = dev
        # operands the kernel takes as they are, but for their alignment
        self.ready = (aq.is_contiguous() and bq.is_contiguous()
                      and (kp, np_) == (k, n))
        self.out_shape = (m, np_)
        self.out_dtype = torch.int32 if mode == "int8" else torch.float32
        self.launch, scratch_bytes = _entries()
        # artemis_mxu sums its two integer dots here first (split over K);
        # artemis at decode every group's exact sums, and above decode,
        # where it splits K, every group's levels, for the scan
        nbytes = scratch_bytes(m, np_, kp, _MODE_IDS[mode], acc_depth)
        self.scratch_numel = -(-nbytes // 4)
        self.table = (_table(acc_depth, readout_bits, aq.device)
                      if mode == "artemis" else None)
        levels = (0.0 if readout_bits is None
                  else float(2**readout_bits - 1))
        self.args = _Args(
            table=None if self.table is None else self.table.data_ptr(),
            M=m, N=np_, K=kp, mode=_MODE_IDS[mode], acc_depth=acc_depth,
            readout_bits=-1 if readout_bits is None else readout_bits,
            delta=(acc_depth * (SC_LEVELS - 1) / levels) if levels else 0.0,
            rbar=float(rbar))
        self.args_ref = ctypes.byref(self.args)
        # the block is written and read by one call at a time
        self.lock = threading.Lock()


def _launch(p, aq, bq):
    pa, pb = aq.data_ptr(), bq.data_ptr()
    if not p.ready or pa % 16 or pb % 16:
        a, b = pad_operands(aq, bq, p.mode, p.acc_depth)
        pa, pb = a.data_ptr(), b.data_ptr()
    dev = p.device
    out = torch.empty(p.out_shape, dtype=p.out_dtype, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = (build.workspace(dev, stream, p.scratch_numel,
                               torch.cuda.is_current_stream_capturing())
               if p.scratch_numel else None)
    with p.lock:
        args = p.args
        args.A, args.B, args.out = pa, pb, out.data_ptr()
        args.scratch = scratch.data_ptr() if scratch is not None else None
        args.stream = stream
        err = p.launch(p.args_ref)
    if err != 0:
        raise RuntimeError(f"sc_matmul kernel launch failed: CUDA error "
                           f"{err}")
    build.launch_counts[NAME] += 1
    return out if p.out_shape[1] == p.n else out[:, :p.n]


def _padded_n(n: int) -> int:
    return n + (-n) % DOT_N_GRANULE


def _output(m: int, n: int, mode: str, device) -> torch.Tensor:
    """An empty (M, N) product in the kernel's layout: the corner of an
    (M, N padded) tensor, int32 for int8, f32 otherwise."""
    out = torch.empty((m, _padded_n(n)), device=device,
                      dtype=torch.int32 if mode == "int8" else torch.float32)
    return out[:, :n]


def work(aq: torch.Tensor, bq: torch.Tensor) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's function in every mode: a multiply
    and an add per (m, k, n) product, int8 operations, which the
    roofline prices at the int8 tensor cores' rate (artemis_mxu's second
    integer dot and artemis's readouts are the implementation's, not the
    function's); A and B read once, the 4-byte (M, N) output written
    once."""
    m, k = aq.shape
    n = bq.shape[1]
    return 2 * m * k * n, m * k + k * n + 4 * m * n
