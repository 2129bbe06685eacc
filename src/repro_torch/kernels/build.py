"""Build and load the port's CUDA kernels, and count their launches.

Each kernel is a `.cu` source with a plain C entry point, compiled by
`nvcc` for sm_90a into a shared library and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). Libraries go to
`<repo>/build/kernels/`, named by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused. The
build happens at a kernel's first launch, never at import.

`refuse_autograd` is every wrapper's first check: the kernels have no
backward, so a wrapper raises where autograd would record through it
(on both devices alike, so a CPU test sees what the card would do).

`launch_counts` holds one plain integer per kernel: a wrapper adds one
where it launches its kernel and nowhere else, so a caller can zero the
counts, run the serve path, and see which kernels it went through.

`kernel_call` wraps each wrapper's dispatch: while a work counter
(`roofline.count.Count`) is open, it counts the call once with the
work of the function the kernel computes, declared by the wrapper from
the call's shapes and arguments, and nothing of the ops inside, so a
kernel's work reads the same whether the kernel, its plain version or
a meta tensor's shape computes it.

The wrappers keep their host path short, since a decode call's device
time is some 5-60 µs: each caches a launch plan per call
signature (`PlanCache`: the checks that read shapes, strides, dtypes
and host arguments, done once, and the C entry's argument block,
`check_launch_args`, filled once), and takes its scratch (the split
walks' partials, sc_matmul's sums, sc_quantize's chunk maxima) from one
buffer per (device, stream) (`workspace`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
# --split-compile 0: the compiler's passes over a source's kernel instances
# run on every core (the attention sources hold some 40-60 instances each)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

launch_counts: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
# the open work counters (`roofline.count.Count`), innermost last
COUNTERS: list = []
# the split walks' f32 partials: one buffer per (device, raw stream)
workspaces: dict = {}
# the most launch plans a wrapper keeps (a static decode's query offset
# makes each step a signature of its own)
MAX_PLANS = 4096


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile `source` unless its library exists; returns the path.
    The compiler's resource report (`-Xptxas -v`) is kept beside the
    library as `<name>.log`."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load(source: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of `source`, built on first use."""
    key = str(source)
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _LIBS[key] = lib
    return lib


def check_launch_args(lib: ctypes.CDLL, size_fn: str, mirror) -> None:
    """Raise unless the library's argument block (`size_fn()`, its
    sizeof) has the size of its ctypes mirror: an entry whose layout
    drifted from the wrapper's must never launch."""
    fn = getattr(lib, size_fn)
    fn.restype, fn.argtypes = ctypes.c_int, []
    size = fn()
    if size != ctypes.sizeof(mirror):
        raise RuntimeError(f"{size_fn}() = {size} bytes, but the wrapper's "
                           f"{mirror.__name__} takes "
                           f"{ctypes.sizeof(mirror)}: the C entry's "
                           f"argument block and its mirror differ")


class PlanCache(dict):
    """A wrapper's launch plans by call signature (a dict, so a lookup
    costs one hash): `put` stores a plan made after every check passed,
    and empties the cache first when it holds MAX_PLANS."""

    def put(self, key, plan):
        if len(self) >= MAX_PLANS:
            self.clear()
        self[key] = plan
        return plan


def workspace(device: torch.device, stream: int, numel: int,
              capturing: bool) -> torch.Tensor:
    """An f32 scratch buffer of at least `numel` elements for kernels
    launched on `stream` (its raw handle) of `device`: one per (device,
    stream), made at the first call and grown when a call needs more,
    else the same storage again. Calls on one stream run in order, so a
    call's partials are read before the next call writes them.

    Under a CUDA graph capture (`capturing`) the call gets a buffer of
    its own, from the graph's pool, and the shared one is neither made,
    grown nor handed out: a graph would keep its address after a later
    growth freed it."""
    if capturing:
        return torch.empty(numel, dtype=torch.float32, device=device)
    key = (device, stream)
    buf = workspaces.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=device)
        workspaces[key] = buf
    return buf


def refuse_autograd(name: str, route: str, *tensors) -> None:
    """Raise if autograd would record through kernel `name`: grad mode
    on and a floating input that requires grad. The kernels compute no
    gradient, so the differentiable `route` must be taken instead."""
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled() \
            and any(t.is_floating_point() and t.requires_grad
                    for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: a differentiable caller takes "
            f"{route} (or runs under torch.no_grad())")


_NO_COUNT = contextlib.nullcontext()


def kernel_call(name: str, work, int8: bool = False):
    """The context a wrapper dispatches in: a no-op unless a work counter
    is open; then every open counter counts one call of kernel `name`,
    `work()` -> (FLOPs, bytes) of its function (on int8 operands if
    `int8`), in place of the ops run inside."""
    if not COUNTERS:
        return _NO_COUNT
    stack = contextlib.ExitStack()
    for counter in COUNTERS:
        stack.enter_context(counter.kernel(name, work, int8))
    return stack
