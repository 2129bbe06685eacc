"""The ARTEMIS MAC over pre-quantized int8 operands: the wrapper of the
hand-written Hopper kernel (`csrc/sc_matmul.cu`), the port of the
Pallas kernel `repro.kernels.sc_matmul.sc_matmul.sc_matmul_quantized`.

Dispatch is by the tensors' device, explicitly: CPU tensors go to the
plain version (`ref.sc_matmul_ref`), CUDA tensors to the kernel, and
anything the kernel does not take raises. There is no fallback from the
kernel to the plain version.

The kernel computes what `repro.core.artemis_matmul`'s quantized core
computes, bit for bit: exact integer dots for `int8` and `artemis_mxu`
(the sign correction applied once, on the full sums), and for
`artemis` the MOMCAP groups of `acc_depth` products read out with a
true division and accumulated in group order. For `artemis` the wrapper
hands the kernel the readout level of every possible group sum
(`readout_table`, built once per device, depth and readout) and, at
decode, scratch where the groups' exact sums meet before the scan.
"""
from __future__ import annotations

import ctypes
import pathlib

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


def _entries():
    """(sc_matmul_launch, sc_matmul_scratch_bytes) of the built library."""
    lib = build.load(SOURCE)
    fn, nbytes = lib.sc_matmul_launch, lib.sc_matmul_scratch_bytes
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        nbytes.restype = ctypes.c_longlong
        nbytes.argtypes = [ctypes.c_int] * 5
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
    build.refuse_autograd(NAME, "the straight-through estimator "
                          "(core.artemis_matmul with policy.ste)", aq, bq)
    _check(aq, bq, mode, acc_depth, readout_bits)
    if aq.device.type == "cpu" and bq.device.type == "cpu":
        return sc_matmul_ref(aq, bq, mode=mode, acc_depth=acc_depth,
                             readout_bits=readout_bits, rbar=rbar)
    if not (aq.device.type == "cuda" and bq.device == aq.device):
        raise ValueError(f"sc_matmul_quantized: both operands must be on "
                         f"one device, got {aq.device} and {bq.device}")
    if mode == "artemis" and acc_depth > MAX_ACC_DEPTH:
        raise ValueError(f"sc_matmul kernel takes acc_depth <= "
                         f"{MAX_ACC_DEPTH}, got {acc_depth}")
    a, b = pad_operands(aq, bq, mode, acc_depth)
    m, kp = a.shape
    n, np_ = bq.shape[1], b.shape[1]
    out = torch.empty((m, np_), device=aq.device,
                      dtype=torch.int32 if mode == "int8" else torch.float32)
    launch, scratch_bytes = _entries()
    # artemis_mxu sums its two integer dots here first (split over K);
    # artemis at decode every group's exact sums, for the scan
    nbytes = scratch_bytes(m, np_, kp, _MODE_IDS[mode], acc_depth)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=aq.device)
               if nbytes else out)
    table = (_table(acc_depth, readout_bits, aq.device)
             if mode == "artemis" else out)
    levels = 0.0 if readout_bits is None else float(2**readout_bits - 1)
    delta = (acc_depth * (SC_LEVELS - 1) / levels) if levels else 0.0
    stream = torch.cuda.current_stream(aq.device).cuda_stream
    err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), table.data_ptr(), m, np_, kp,
                 _MODE_IDS[mode], acc_depth,
                 -1 if readout_bits is None else readout_bits, delta,
                 float(rbar), stream)
    if err != 0:
        raise RuntimeError(f"sc_matmul kernel launch failed: CUDA error "
                           f"{err}")
    build.launch_counts[NAME] += 1
    return out if np_ == n else out[:, :n]
