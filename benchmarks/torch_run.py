"""Benchmark orchestrator of the PyTorch port, one suite per paper table
or figure (the counterpart of `benchmarks/run.py`).

    PYTHONPATH=src python -m benchmarks.torch_run [--only fig8,table5] \
        [--skip table4] [--device cuda|cpu]

Each suite prints its own comparison against the paper's numbers and
returns row dicts; a summary comes at the end. Suites that take a
device (`table4`, `table5`, `kernels`) run on `--device`; the hwsim
figures run on the host. The reference's `collectives` and `serve`
suites have no counterpart yet and are skipped by name, with the
reason. The script exits 1 when a suite fails, and every failure's
traceback is printed.

Wall-clock use here is the harness timing its suites, not serve logic.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import time
import traceback

SUITES = [
    ("table4", "benchmarks.torch_table4_accuracy",
     "Table IV  — accuracy ladder FP32/Q8/Q8+SC"),
    ("table5", "benchmarks.torch_table5_calibration",
     "Table V   — per-component calibration accuracy"),
    ("fig2", "benchmarks.torch_fig2_breakdown",
     "Fig 2     — conventional-PIM time breakdown"),
    ("fig7", "benchmarks.torch_fig7_momcap",
     "Fig 7     — MOMCAP accumulation linearity"),
    ("fig8", "benchmarks.torch_fig8_dataflow",
     "Fig 8     — dataflow x pipelining sensitivity"),
    ("fig9_11", "benchmarks.torch_fig9_11_comparison",
     "Figs 9-11 — platform comparison (published anchors)"),
    ("fig12", "benchmarks.torch_fig12_scalability",
     "Fig 12    — sequence-length scalability"),
    ("kernels", "benchmarks.torch_kernel_micro",
     "Kernels   — CUDA kernels vs plain versions + ladder accuracy"),
]

# the reference's suites with no counterpart in the port, and why
NOT_PORTED = {
    "collectives": "token vs layer dataflow in lowered HLO: needs the "
                   "multi-device stack (ROADMAP Queue 1 item 9)",
    "serve": "continuous-batching throughput benchmark: not ported "
             "yet (ROADMAP Queue 1 item 2)",
}


def run_suite(module: str, device: str) -> list[dict]:
    """Import a suite and call its run(), with `device` where it takes
    one."""
    mod = importlib.import_module(module)
    if "device" in inspect.signature(mod.run).parameters:
        return mod.run(device=device)
    return mod.run()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated suite names")
    ap.add_argument("--skip", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    skip = set(args.skip.split(",")) if args.skip else set()

    results = {}
    for name, module, desc in SUITES:
        if (only is not None and name not in only) or name in skip:
            continue
        print(f"\n{'=' * 72}\n{desc}\n{'=' * 72}")
        t0 = time.time()  # repro: allow[wall-clock-in-serve] -- benchmark harness timing, reported per suite
        try:
            rows = run_suite(module, args.device)
            results[name] = ("ok", len(rows or []), time.time() - t0)  # repro: allow[wall-clock-in-serve] -- benchmark harness timing, reported per suite
        except Exception as e:
            traceback.print_exc()
            results[name] = ("FAIL: " + str(e)[:80], 0, time.time() - t0)  # repro: allow[wall-clock-in-serve] -- benchmark harness timing, reported per suite
    for name, why in NOT_PORTED.items():
        if (only is None or name in only) and name not in skip:
            results[name] = ("skipped", 0, 0.0)
            print(f"\nskipped {name}: {why}")

    print(f"\n{'=' * 72}\nSUMMARY\n{'=' * 72}")
    for name, (status, n, dt) in results.items():
        print(f"  {name:12s} {status:12s} {n:4d} rows {dt:7.1f}s")
    return 1 if any(v[0].startswith("FAIL") for v in results.values()) \
        else 0


if __name__ == "__main__":
    raise SystemExit(main())
