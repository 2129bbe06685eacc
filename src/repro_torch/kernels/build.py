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
"""
from __future__ import annotations

import collections
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


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


def refuse_autograd(name: str, route: str, *tensors) -> None:
    """Raise if autograd would record through kernel `name`: grad mode
    on and a floating input that requires grad. The kernels compute no
    gradient, so the differentiable `route` must be taken instead."""
    if torch.is_grad_enabled() and any(
            t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: a differentiable caller takes "
            f"{route} (or runs under torch.no_grad())")
