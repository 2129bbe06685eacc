"""sc_matmul's float entry on one H100: the quantize/cast group of a
qwen3_8b int8 forward, the wrapper's host µs a call, and an int8 drain,
for the port found under `--src`, so that two trees of the port, each
unpacked with `git archive`, are compared in one call to the card, in
turns (parent, change, change, parent).

    python3 benchmarks/torch_sc_entry.py [--src DIR] [--tag NAME]

It runs chip_smoke.py's own measurements over that port:
- `profile_forwards` (phase 7's profile): one prefill-chunk forward (8
  lanes x 32 tokens) and one decode forward of full-width qwen3_8b
  (bf16, seeded random weights, gather core) under int8, device ms by
  group (quantize/cast, the STE's exact product, sc_matmul, other);
- an int8 drain of phase 7's trace (8 requests, prompts 128-256, 32 new
  tokens): tok/s and ms a forward;
- sc_matmul_quantized at qwen3_8b's four projection shapes at M 8, in
  every mode: host µs a call (`_host_ms`: perf_counter around 50
  back-to-back calls, a synchronize before and none inside, the median
  of 5 runs) and µs on the device alone (`_graph_ms`, a CUDA graph's
  replay), each call reading another of 4 weight copies;
- where the tree has `quantize_int8`: the same two times for it at the
  four bf16 weights and the M 8 activations.
Prints a line a number, prefixed by `--tag`, and the card's name and
power limit, and writes `chiprun_out/torch_sc_entry_<tag>.json`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
COPIES = 4


def host_and_device(chip_smoke, tag: str, gen) -> list[dict]:
    """Host and device µs a call of the wrappers at qwen3_8b's M 8
    shapes."""
    import torch
    from repro_torch.kernels import sc_matmul as sc
    rows = []
    for k, n in chip_smoke.SC_SHAPES:
        a = chip_smoke._int8(gen, 8, k)
        bs = [chip_smoke._int8(gen, k, n) for _ in range(COPIES)]
        for mode in chip_smoke.SC_MODES:
            def call(i):
                return sc.sc_matmul_quantized(a, bs[i % COPIES], mode=mode)
            rows.append(dict(entry="sc_matmul_quantized", mode=mode, M=8,
                             K=k, N=n, host_ms=chip_smoke._host_ms(call),
                             device_ms=chip_smoke._graph_ms(call)))
        del bs
        if not hasattr(sc, "quantize_int8"):
            continue
        for label, shape in (("weight", (k, n)), ("activation", (8, k))):
            xs = [chip_smoke._q_input(gen, shape, torch.bfloat16)
                  for _ in range(COPIES)]

            def quant(i):
                return sc.quantize_int8(xs[i % COPIES])
            rows.append(dict(entry="quantize_int8", shape=label,
                             dims=list(shape),
                             host_ms=chip_smoke._host_ms(quant),
                             device_ms=chip_smoke._graph_ms(quant)))
            del xs
    for r in rows:
        what = (f"{r['mode']} M 8 K {r['K']} N {r['N']}"
                if r["entry"] == "sc_matmul_quantized"
                else f"{r['shape']} {tuple(r['dims'])}")
        print(f"{tag} {r['entry']} {what}: host {r['host_ms'] * 1e3:.2f} "
              f"us, device {r['device_ms'] * 1e3:.2f} us", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"),
                    help="the directory that holds the port's repro_torch")
    ap.add_argument("--tag", default="change", help="names the output file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sc_entry: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(REPO))
    import chip_smoke
    import repro_torch
    from repro_torch import configs
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"{card} | port {pathlib.Path(repro_torch.__file__).parent}",
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = dict(card=card, src=args.src,
               calls=host_and_device(chip_smoke, args.tag, gen))
    cfg = configs.get_config("qwen3_8b")
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{args.tag} weights drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out["profile"] = chip_smoke.profile_forwards(cfg, model, "int8")
    for label, p in out["profile"].items():
        print(f"{args.tag} int8 {label}: wall {p['wall_ms']:.2f} ms, device "
              f"{p['device_ms']:.2f} ms | " + " | ".join(
                  f"{g} {ms:.2f}" for g, ms in sorted(
                      p["groups"].items(), key=lambda kv: -kv[1])),
              flush=True)
    policy = ArithmeticPolicy(mode="int8")
    chip_smoke.drain(cfg, model, chip_smoke.short_trace(cfg)[:1], "gather",
                     policy)                                   # warm-up
    run = chip_smoke.drain(cfg, model, chip_smoke.smoke_trace(cfg),
                           "gather", policy)
    n_tok = run["metrics"]["n_generated_tokens"]
    out["drain"] = dict(tok_s=n_tok / run["wall_s"], wall_s=run["wall_s"],
                        n_forwards=run["n_forwards"], n_tokens=n_tok,
                        launches=run["counts"])
    print(f"{args.tag} int8 drain: {n_tok} tokens in {run['wall_s']:.3f} s "
          f"({out['drain']['tok_s']:.2f} tok/s; {run['n_forwards']} "
          f"forwards, {run['wall_s'] / run['n_forwards'] * 1e3:.2f} ms "
          f"each); launches {run['counts']}", flush=True)
    path = REPO / "chiprun_out" / f"torch_sc_entry_{args.tag}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
