"""The attention wrappers' calls on one H100: host µs a call, µs a call
and µs on the device alone, beside SDPA's, at the decode steps of every
shipped configuration that serves through them and at paged_attention's
prefill chunks.

It runs chip_smoke.py's phase 4 timers (`time_paged_attention`,
`time_flash_attention`: each kernel held against its plain version
first) over the port found under `--src` (default: this checkout's
`src/`), so that two trees of the port, each unpacked with `git
archive`, are compared in one call to the card, in turns (parent,
change, change, parent). "host" is perf_counter around 50 back-to-back
calls with a synchronize before and none inside (the median of 5 such
runs); "call" is CUDA events around back-to-back calls, so where the
host's time is the longer it is that time; "device" is a CUDA graph's
replay of 20 calls.

    python3 benchmarks/torch_attention_host.py [--src DIR] [--tag NAME]

Then, for a tree whose wrappers keep launch plans, it splits a qwen3_8b
decode call's host time (`host_breakdown`). Prints a line a shape and
the card's name and power limit, and writes the rows to
`chiprun_out/torch_attention_host_<tag>.json`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
# (config, kernels timed): the configurations of chip_smoke's phases 4-4e
CONFIGS = (("qwen3_8b", ("paged", "flash")),
           ("qwen2_moe_a2_7b", ("paged", "flash")),
           ("zamba2_7b", ("flash",)),
           ("musicgen_large", ("flash",)),
           ("internvl2_1b", ("flash",)),
           ("gemma_2b", ("paged", "flash")),
           ("qwen3_14b", ("paged", "flash")),
           ("deepseek_coder_33b", ("paged", "flash")))


def _us(row, key):
    value = row.get(key)
    return "-" if value is None else f"{value * 1e3:.2f}"


def _host_us(fn, n_calls=200, repeats=5) -> float:
    """Median host µs a call of fn() over `repeats` runs of n_calls
    back-to-back calls, a synchronize before each run and none inside."""
    import statistics
    import time

    import torch
    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / n_calls)
    torch.cuda.synchronize()
    return statistics.median(runs)


def host_breakdown() -> dict:
    """Where a decode call's host time goes, at qwen3_8b's decode shapes
    (paged: 8 lanes of 288 tokens, page 8; flash: a 1056-slot f32 cache
    at index 1040): the whole call, the launch after the plan (`_launch`),
    the C entry alone on a filled argument block (its two launches), and
    the outputs' allocation. Only for a tree whose wrappers keep launch
    plans."""
    import importlib

    import torch
    pa = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    if not hasattr(pa, "_PLANS"):
        return {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, h, kvh, hd, page, tokens = 8, 32, 8, 128, 8, 288
    pmax = tokens // page + 1
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").bfloat16()
    kp = torch.randn((512, page, kvh, hd), generator=gen, device="cuda")
    vp = torch.randn_like(kp)
    bt = torch.randint(1, 512, (b, pmax), generator=gen, device="cuda",
                       dtype=torch.int32)
    pos = torch.full((b, 1), tokens - 1, device="cuda", dtype=torch.int32)
    args = (q, kp, vp, bt, pos)
    scale = hd ** -0.5
    pa._PLANS.clear()                # this shape's plan alone
    pa.paged_attention(*args, scale=scale)
    (plan,) = pa._PLANS.values()
    dev = q.device
    out = {"paged": dict(
        call=_host_us(lambda: pa.paged_attention(*args, scale=scale)),
        launch=_host_us(lambda: pa._launch(plan, *args)),
        c_entry=_host_us(lambda: plan.launch(plan.args_ref)),
        empty=_host_us(lambda: torch.empty(plan.out_shape,
                                           dtype=torch.float32,
                                           device=dev)))}
    qf = torch.randn((b, 1, h, hd), generator=gen,
                     device="cuda").bfloat16().transpose(1, 2)
    cache = torch.randn((b, 1056, kvh, hd), generator=gen,
                        device="cuda").transpose(1, 2)
    kw = dict(causal=True, kv_len=1041, q_offset=1040, scale=scale,
              kv_cast=torch.bfloat16, bq=8, bk=128)
    fa._PLANS.clear()
    fa.flash_attention_all(qf, cache, cache, **kw)
    (fplan,) = fa._PLANS.values()
    out["flash"] = dict(
        call=_host_us(lambda: fa.flash_attention_all(qf, cache, cache,
                                                     **kw)),
        launch=_host_us(lambda: fa._launch(fplan, qf, cache, cache)),
        c_entry=_host_us(lambda: fplan.launch(fplan.args_ref)),
        outputs=_host_us(lambda: fa._outputs(fplan.layout, dev)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"),
                    help="the directory that holds the port's repro_torch")
    ap.add_argument("--tag", default="change",
                    help="names the output file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(REPO))
    import chip_smoke
    from repro_torch import configs
    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"{card} | port {pathlib.Path(repro_torch.__file__).parent}",
          flush=True)
    timers = {"paged": chip_smoke.time_paged_attention,
              "flash": chip_smoke.time_flash_attention}
    rows = []
    for arch, kernels in CONFIGS:
        cfg = configs.get_config(arch)
        for kernel in kernels:
            for row in timers[kernel](cfg):
                if row["shape"] == "prefill":      # flash's: device-bound
                    continue
                row = dict(row, model=arch, kernel=kernel)
                rows.append(row)
                print(f"{args.tag} {kernel} {arch} {row['shape']}: host "
                      f"{_us(row, 'host_ms')} | call {_us(row, 'ms')} | "
                      f"device {_us(row, 'device_ms')} | sdpa host "
                      f"{_us(row, 'library_host_ms')}, call "
                      f"{_us(row, 'library_ms')}, device "
                      f"{_us(row, 'library_device_ms')} (µs)", flush=True)
    breakdown = host_breakdown()
    for kernel, parts in breakdown.items():
        print(f"{args.tag} {kernel} qwen3_8b decode host µs: " + ", ".join(
            f"{name} {us:.2f}" for name, us in parts.items()), flush=True)
    out = REPO / "chiprun_out" / f"torch_attention_host_{args.tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=card, src=args.src, rows=rows,
                                   breakdown=breakdown),
                              indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
