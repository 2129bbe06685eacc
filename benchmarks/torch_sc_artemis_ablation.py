"""Where the time of sc_matmul's artemis path above decode goes, for the
port found under `--src`, so that two trees of the port, each unpacked
with `git archive`, are compared in one call to the card, in turns
(parent, change, change, parent).

Builds the tree's sc_matmul CUDA source as it is and, where the source
has the tile path (`artemis_tile_kernel`: a warp walks all of K and
reads each group out in registers), in ablated copies, each with one
part of that path taken out or forced; then times every variant at
qwen3_8b's projection shapes at M 256 (a prefill chunk of 8 lanes x 32
tokens) and M 1024, on int8 operands drawn from a seed, each call
reading another of 4 weight copies (beyond L2, as in a forward):

  base        the kernel as it is (the wrapper's call bit-equal to
              the plain version, checked once a shape; so are the
              variants that still compute the product: the forced
              tiles, wk16 and lanes1);
  no_readout  the group readouts replaced by a fold of the lanes into
              the accumulators (a few instructions a word; the unsplit
              path's);
  no_convert  A's window not converted into words (the products read
              stale words);
  no_staging  no window copied after the first (the copies' issue);
  no_products the products skipped (staging, conversion and readouts
              stay);
  no_scan     where K is split over blocks, the levels' scan not
              launched;
  tile88, tile84: the thread tile forced to 8 x 8 or 8 x 4 outputs,
              with no split over K, whatever the grid's size;
  wk16        windows of 16 k rows, not 32;
  lanes1      8 x 4 tiles reading the table with tot's lanes at 1x
              their sums (two instructions a lane's offset), not 4x;
  decode_split where the plan splits K over blocks, the decode path
              instead (artemis_kernel's 8 x 256 tiles, the groups'
              sums in scratch, artemis_scan_kernel).

no_readout, no_convert, no_staging, no_products and no_scan only
measure what their part costs. A tree without the tile path (the parent's) times base
only. Variants go to `build/artemis_ablation/<tag>/`. `--shapes` and
`--bits` time other K x N shapes (qwen2_moe's experts: 2048x1408,
1408x2048) and readouts.

    PYTHONPATH=src python3 benchmarks/torch_sc_artemis_ablation.py \\
        [--src DIR] [--tag NAME] [--variants base,no_readout,...] \\
        [--rows 256,1024] [--shapes 4096x4096,...] [--bits 8]

Prints a line a shape with each variant's µs a call (CUDA events around
10 calls, in turns: each variant, then each again in reverse order) and
writes `chiprun_out/torch_sc_artemis_ablation_<tag>.json`. Needs a CUDA
device; it refuses to run without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

STOP = "      const int stop = min(wend, gend - k0);\n"
READOUT = "        tile_readout<R, C, kRead>(tot, neg, acc, s_table, delta);\n"
FOLD = """#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C / 2; ++j) {
            acc[i][j] += __uint_as_float(tot[i][j] ^ neg[i][j]);
            tot[i][j] = neg[i][j] = 0u;
          }
"""
PLAN = "TilePlan artemis_tile_plan(int M, int N, int K, int depth) {\n"
PATCHES = {
    "base": [],
    "no_readout": [(READOUT, FOLD)],
    "no_convert": [("    convert(w);\n", "    if (K < 0) convert(w);\n")],
    "no_staging": [("    if (w + 1 < windows) stage(w + 1);\n",
                    "    if (K < 0 && w + 1 < windows) stage(w + 1);\n")],
    "no_products": [(STOP, STOP + "      if (K > 0) kk = stop;\n")],
    "tile88": [(PLAN, PLAN + "  return {88, 1, 0};\n")],
    "tile84": [(PLAN, PLAN + "  return {84, 1, 0};\n")],
    "wk16": [("constexpr int kTileWK = 32; ", "constexpr int kTileWK = 16; ")],
    "lanes1": [("kRead == kReadTable && depth < kMaxAccDepth",
                "kRead == kReadTable && depth < 0")],
    "decode_split": [("    if (M <= kArtSplitMaxM)\n",
                      "    if (M <= kArtSplitMaxM || artemis_tile_plan("
                      "M, N, K, acc_depth).splits > 1)\n")],
    "no_scan": [("  if (err != cudaSuccess || !kSplit) return err;\n",
                 "  if (err != cudaSuccess || !kSplit || K > 0) return err;\n")],
}
# the variants that still compute the product, held bit-equal once
EXACT = ("tile88", "tile84", "wk16", "lanes1", "decode_split")
ORDER = ("base", "no_readout", "no_convert", "no_staging",
         "no_products", "no_scan", "tile88", "tile84", "wk16", "lanes1",
         "decode_split")
SHAPES = "4096x4096,4096x1024,4096x12288,12288x4096"
DEPTH, COPIES = 20, 4


def variant_sources(source: pathlib.Path, tag: str,
                    names: list[str]) -> dict[str, pathlib.Path]:
    """The source as each variant patches it; a variant whose text the
    source lacks (a tree without the tile path) is left out."""
    src = source.read_text()
    out = REPO / "build" / "artemis_ablation" / tag
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in names:
        text = src
        if any(old not in text for old, _ in PATCHES[name]):
            continue
        for old, new in PATCHES[name]:
            text = text.replace(old, new)
        paths[name] = out / f"sc_matmul_{name}.cu"
        paths[name].write_text(text)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"),
                    help="the directory that holds the port's repro_torch")
    ap.add_argument("--tag", default="change", help="names the output")
    ap.add_argument("--variants", default=",".join(ORDER))
    ap.add_argument("--rows", default="256,1024",
                    help="the M of the timed calls (8: decode, whose path "
                         "the variants leave as it is)")
    ap.add_argument("--shapes", default=SHAPES, help="K x N of the calls")
    ap.add_argument("--bits", type=int, default=8,
                    help="the readout's bits (0: the ideal readout)")
    args = ap.parse_args()
    bits = args.bits or None
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",") if s]
    import torch
    if not torch.cuda.is_available():
        print("torch_sc_artemis_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels.sc_matmul import sc_matmul as sc
    from repro_torch.kernels.sc_matmul.ref import sc_matmul_ref
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(ORDER)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    paths = variant_sources(sc.SOURCE, args.tag, names)
    # the wrapper's own library (its plans) is built beside the variants
    with concurrent.futures.ThreadPoolExecutor(len(paths) + 1) as pool:
        libs = dict(zip(paths, pool.map(build.build, [*paths.values(),
                                                      sc.SOURCE])))
    entries = {}
    for name, lib in libs.items():
        loaded = ctypes.CDLL(str(lib))
        build.check_launch_args(loaded, "sc_matmul_launch_args_bytes",
                                sc._Args)
        fn = loaded.sc_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(sc._Args)]
        entries[name] = fn
    order = [n for n in ORDER if n in entries]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card} | port {pathlib.Path(repro_torch.__file__).parent} | "
          f"variants {order}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    rows = []
    for m in (int(x) for x in args.rows.split(",")):
        for k, n in shapes:
            a = int8(m, k)
            bs = [int8(k, n) for _ in range(COPIES)]
            # the wrapper's own plan for this call: its argument block
            # (the tree's fields) and output layout
            plan = sc._Plan(a, bs[0], "artemis", DEPTH, bits, 63.5)
            out = sc._launch(plan, a, bs[0])
            # at decode (M <= 16) the groups' sums meet in scratch, and
            # so do the parts' levels where K is split above it
            scratch = (torch.empty(plan.scratch_numel, device="cuda",
                                   dtype=torch.float32)
                       if plan.scratch_numel else None)
            torch.cuda.synchronize()
            ref = sc_matmul_ref(a, bs[0], mode="artemis", acc_depth=DEPTH,
                                readout_bits=bits)
            if not torch.equal(out, ref):
                raise AssertionError(f"M {m} K {k} N {n}: the wrapper's call "
                                     f"is not bit-equal to the plain version")
            times: dict[str, list[float]] = {name: [] for name in order}
            for turn, name in enumerate(order + order[::-1]):
                fn = entries[name]
                block = type(plan.args).from_buffer_copy(plan.args)
                ref_block = ctypes.byref(block)
                o = torch.empty((m, out.stride(0)), device="cuda")
                block.A, block.out = a.data_ptr(), o.data_ptr()
                block.scratch = scratch.data_ptr() if scratch is not None \
                    else None
                block.stream = torch.cuda.current_stream().cuda_stream
                if turn < len(order) and name in EXACT:
                    block.B = bs[0].data_ptr()   # computes the product too
                    if fn(ref_block):
                        raise RuntimeError(f"{name}: launch failed")
                    torch.cuda.synchronize()
                    if not torch.equal(o[:, :n], ref):
                        raise AssertionError(f"{name} M {m} K {k} N {n}: "
                                             f"not bit-equal")

                def call(i):
                    block.B = bs[i % COPIES].data_ptr()
                    err = fn(ref_block)
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
            rows.append(dict(M=m, K=k, N=n, us=times))
            print(f"{args.tag} M {m:4d} K {k:5d} N {n:5d}: " + " | ".join(
                f"{name} {' / '.join(f'{t:.2f}' for t in ts)}"
                for name, ts in times.items()) + " us", flush=True)
            del bs
    path = REPO / "chiprun_out" / f"torch_sc_artemis_ablation_{args.tag}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dict(card=card, src=args.src, bits=bits,
                                    rows=rows),
                               indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
