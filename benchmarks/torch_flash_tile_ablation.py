"""Where the time of flash_attention's tile instance goes at the static
prefill, and what its block shape and grid order buy.

Builds the flash_attention CUDA source as it is and in ablated or
altered copies, and times the tile instance of every copy at the static
path's prefill shape (qwen3_8b: B 8, Hq 32, Hkv 8, D 128, Sq 1024
causal over an f32 cache of 1056 slots read as strided views and
rounded to bf16, another of 4 layers' caches a call, beyond L2), in
turns (each copy, then each again in reverse order):

  base        the kernel as it is (128 query rows a block, 8 warps);
  rows64      64 query rows a block of 4 warps, two blocks an SM;
  x_fastest   the grid with the query tile as its fastest index (the
              tiles of one head together) instead of its slowest;
  no_lo_pass  P.V in one bf16 pass (P rounded to bf16, not split);
  no_convert  the staged chunk not converted (the bf16 buffers keep
              whatever they hold);
  no_copies   the next chunk's copies not issued.

base, rows64 and x_fastest compute the function (their max error
against the plain version is printed); the others measure what their
part costs. The copies go to `build/flash_tile_ablation/`.

    PYTHONPATH=src python3 benchmarks/torch_flash_tile_ablation.py

Needs a CUDA device; it refuses to run without one.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    SOURCE,
    VARIANTS as INSTANCES,
)

GRID_OLD = ("  const int b = blockIdx.y, h = blockIdx.x;\n"
            "  const int hkv = h / (a.Hq / a.Hkv);\n"
            "  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;")
GRID_NEW = ("  const int b = blockIdx.z, h = blockIdx.y;\n"
            "  const int hkv = h / (a.Hq / a.Hkv);\n"
            "  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;")
LO_PASS = ("          mma_bf16(o[2 * np], pl, vf[0], vf[1]);\n"
           "          mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);\n")
CONVERT = ("    convert_chunk<KVT, D>(k_st, k_buf, tid);\n"
           "    convert_chunk<KVT, D>(v_st, v_buf, tid);\n")
COPIES = ("    if (c1 < c_end)\n"
          "      issue_chunk<KVT, D>(a, k_base, v_base, c1, k_st, v_st, tid);")
VARIANTS = {
    "base": [],
    "rows64": [("constexpr int kTileWarps = 8;",
                "constexpr int kTileWarps = 4;"),
               ("__launch_bounds__(kTileThreads, 1)",
                "__launch_bounds__(kTileThreads, 2)")],
    "x_fastest": [(GRID_OLD, GRID_NEW),
                  ("  dim3 grid(a.Hq, B, (a.Sq + kRows - 1) / kRows);",
                   "  dim3 grid((a.Sq + kRows - 1) / kRows, a.Hq, B);")],
    "no_lo_pass": [(LO_PASS, "")],
    "no_convert": [(CONVERT, "")],
    "no_copies": [(COPIES, "")],
}
COMPUTES = ("base", "rows64", "x_fastest")
B, HQ, HKV, D, SQ, SMAX, LAYERS = 8, 32, 8, 128, 1024, 1056, 4


def variant_sources() -> dict[str, pathlib.Path]:
    src = SOURCE.read_text()
    out = ROOT / "build" / "flash_tile_ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old.strip()[:60]!r} once")
            text = text.replace(old, new)
        paths[name] = out / f"flash_attention_{name}.cu"
        paths[name].write_text(text)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_tile_ablation: no CUDA device", file=sys.stderr)
        return 2
    paths = variant_sources()
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(build.build, paths.values())))
    entries = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        entries[name] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    shape = (LAYERS, B, SMAX, HKV, D)
    ck = torch.randn(shape, generator=gen, device="cuda")
    cv = torch.randn(shape, generator=gen, device="cuda")
    q = torch.randn((B, SQ, HQ, D), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    o = torch.empty((B, SQ, HQ, D), device="cuda").transpose(1, 2)
    lse = torch.empty((B, HQ, SQ), device="cuda")
    nvis = torch.empty_like(lse)
    scale, bq = D ** -0.5, 128
    stream = torch.cuda.current_stream().cuda_stream

    def kv(i):
        return ck[i % LAYERS].transpose(1, 2), cv[i % LAYERS].transpose(1, 2)

    def call(name, i):
        k, v = kv(i)
        err = entries[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), nvis.data_ptr(), B, HQ, HKV, SQ, SMAX, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1, 0, SQ, 0, bq, bq, scale, 1, 0, 1,
            INSTANCES.index("tile"), stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    ref = flash_attention_ref(q, *kv(0), causal=True, kv_len=SQ, scale=scale,
                              bq=bq, bk=bq, kv_cast=torch.bfloat16)[0]
    times: dict[str, list[float]] = {name: [] for name in entries}
    errs = {}
    for name in list(entries) + list(entries)[::-1]:
        call(name, 0)
        torch.cuda.synchronize()
        if name in COMPUTES:
            errs[name] = (o - ref).abs().max().item()
        for i in range(3):
            call(name, i)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(50):
            call(name, i)
        stop.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(stop) / 50 * 1e3)
    print(f"tile instance, B {B} Sq {SQ} Smax {SMAX} D {D}, f32 cache: " +
          " | ".join(f"{name} {' / '.join(f'{t:.2f}' for t in ts)} us"
                     + (f" (max err {errs[name]:.1e})" if name in errs
                        else "") for name, ts in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
