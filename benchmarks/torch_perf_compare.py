"""Before/after comparison of two dry-run caches of the port, per cell
(counterpart of `benchmarks/perf_compare.py`): a baseline, a saved copy
of the port's cache that `--baseline` names, against the port's cache,
`experiments/torch_dryrun_cache.json` unless `--current` names another.
A cache that is not the port's (its ok rows lack `hw` or `t_count_s`:
the reference's, whose counts are XLA's post-fusion ones), a missing
one, or two caches priced on different hardware are refused, with exit
code 1.

PYTHONPATH=src python benchmarks/torch_perf_compare.py --baseline PATH
    [--current PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

CURRENT = os.path.join(os.path.dirname(__file__), "..", "experiments",
                       "torch_dryrun_cache.json")
PORT_KEYS = ("hw", "t_count_s")


def _rows(path, mesh="pod1_16x16"):
    with open(path) as f:
        cache = json.load(f)
    return {(row["arch"], row["shape"]): row for row in cache.values()
            if row.get("mesh") == mesh and row.get("status") == "ok"}


def check(label: str, path: str) -> tuple[dict | None, str | None]:
    """(the cache's single-pod ok rows, None), or (None, why it is
    refused)."""
    if not os.path.exists(path):
        return None, f"no {label} cache at {os.path.normpath(path)}"
    rows = _rows(path)
    bad = [k for k, row in rows.items()
           if any(key not in row for key in PORT_KEYS)]
    if bad:
        return None, (f"the {label} cache {os.path.normpath(path)} is not "
                      f"the port's: {len(bad)} ok rows lack "
                      f"{' or '.join(PORT_KEYS)}")
    return rows, None


def run(base: dict, opt: dict) -> list[dict]:
    rows = []
    print(f"{'cell':34s} {'t_mem b->o':>18s} {'t_coll b->o':>18s} "
          f"{'GiB b->o':>14s} {'roofl b->o':>14s}")
    for key in sorted(base):
        b, o = base[key], opt.get(key)
        if o is None:
            continue
        cell = f"{key[0]} x {key[1]}"
        same = abs(o["t_memory_s"] - b["t_memory_s"]) < 1e-12
        print(f"{cell:34s} "
              f"{b['t_memory_s']:8.2e}->{o['t_memory_s']:8.2e} "
              f"{b['t_collective_s']:8.2e}->{o['t_collective_s']:8.2e} "
              f"{b['bytes_per_device_gib']:6.1f}->"
              f"{o['bytes_per_device_gib']:6.1f} "
              f"{b['roofline_frac']:6.3f}->{o['roofline_frac']:6.3f}"
              + ("  (=baseline)" if same else ""))
        rows.append({"cell": cell, "base": b, "opt": o})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True,
                    help="a saved copy of the port's dry-run cache")
    ap.add_argument("--current", default=CURRENT)
    args = ap.parse_args()
    base, why = check("baseline", args.baseline)
    opt, why_opt = check("current", args.current) if why is None \
        else (None, None)
    why = why or why_opt
    if why is None:
        hws = {row["hw"] for row in [*base.values(), *opt.values()]}
        if len(hws) > 1:
            why = f"the caches are priced on different hardware: {hws}"
    if why is not None:
        print(f"torch_perf_compare: {why}", file=sys.stderr)
        return 1
    run(base, opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
