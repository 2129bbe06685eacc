"""Where the time of sc_matmul's artemis path goes at a prefill chunk.

Builds the sc_matmul CUDA source as it is and in three ablated copies,
each with one part of the in-block path (M > 16) taken out, and times
every copy at qwen3_8b's M 256 projection shapes, in turns (each copy,
then each again in reverse order), on int8 operands drawn from a seed:

  base        the kernel as it is;
  no_chain    the f32 readout scan without its FMAs (acc += pos - neg);
  no_lookup   the scan without its readout-table lookups (the sums'
              own bits stand in for the levels);
  no_products the groups' products skipped (the staging, A's
              conversion, the barriers and the scan stay).

Only "base" computes the product; the others measure what their part
costs. The ablated copies go to `build/artemis_ablation/`.

    PYTHONPATH=src python3 benchmarks/torch_sc_artemis_ablation.py

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
from repro_torch.kernels.sc_matmul.sc_matmul import (  # noqa: E402
    SOURCE,
    _Args,
    _table,
)

CHAIN = ("            acc[q] = readout_step(acc[q], pl[s], nl[s], delta, "
         "ideal != 0);")
LOOKUP = ("            pl[s] = s_table[v & 0xFFFFu];\n"
          "            nl[s] = s_table[v >> 16];")
PRODUCTS = ("      for (; kk + 1 < ke; kk += 2)\n"
            "        artemis_rows<true")
VARIANTS = {
    "base": [],
    "no_chain": [(CHAIN, "            acc[q] += pl[s] - nl[s];")],
    "no_lookup": [(LOOKUP, "            pl[s] = __uint_as_float(v & 0xFFFFu);\n"
                           "            nl[s] = __uint_as_float(v >> 16);")],
    "no_products": [(PRODUCTS, "      for (; kk + 1 < ke && K < 0; kk += 2)\n"
                               "        artemis_rows<true")],
}
SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
M, DEPTH, BITS = 256, 20, 8


def variant_sources() -> dict[str, pathlib.Path]:
    src = SOURCE.read_text()
    out = ROOT / "build" / "artemis_ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
        paths[name] = out / f"sc_matmul_{name}.cu"
        paths[name].write_text(text)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sc_artemis_ablation: no CUDA device", file=sys.stderr)
        return 2
    paths = variant_sources()
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(build.build, paths.values())))
    entries = {}
    for name, lib in libs.items():
        loaded = ctypes.CDLL(str(lib))
        build.check_launch_args(loaded, "sc_matmul_launch_args_bytes", _Args)
        fn = loaded.sc_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args)]
        entries[name] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    delta = DEPTH * 127 / (2**BITS - 1)
    table = _table(DEPTH, BITS, torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    for k, n in SHAPES:
        a = int8(M, k)
        bs = [int8(k, n) for _ in range(4)]   # beyond L2, as in a forward
        out = torch.empty((M, n), device="cuda")
        times: dict[str, list[float]] = {name: [] for name in entries}
        for name in list(entries) + list(entries)[::-1]:
            fn = entries[name]

            args = _Args(A=a.data_ptr(), out=out.data_ptr(),
                         scratch=out.data_ptr(), table=table.data_ptr(),
                         stream=stream, M=M, N=n, K=k, mode=2,
                         acc_depth=DEPTH, readout_bits=BITS, delta=delta,
                         rbar=63.5)

            def call(i):
                args.B = bs[i % 4].data_ptr()
                err = fn(ctypes.byref(args))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            for i in range(2):
                call(i)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(10):
                call(i)
            stop.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(stop) / 10 * 1e3)
        print(f"M {M} K {k:5d} N {n:5d}: " + " | ".join(
            f"{name} {' / '.join(f'{t:.2f}' for t in ts)} us"
            for name, ts in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
