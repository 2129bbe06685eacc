"""Render the port's roofline table from its dry-run cache
(`experiments/torch_dryrun_cache.json`, written by
`python -m repro_torch.launch.dryrun`; counterpart of
`benchmarks/roofline_table.py`). The terms are one rank's step priced
on the H100 (`repro_torch.roofline.HW_H100`).

PYTHONPATH=src python benchmarks/torch_roofline_table.py
[--mesh pod1_16x16] [--markdown] [--errors]
"""
from __future__ import annotations

import argparse
import json
import os

CACHE = os.path.join(os.path.dirname(__file__), "..", "experiments",
                     "torch_dryrun_cache.json")


def load_rows(mesh: str = "pod1_16x16", status: str = "ok") -> list[dict]:
    with open(CACHE) as f:
        cache = json.load(f)
    rows = [row for row in cache.values()
            if row.get("mesh") == mesh and row.get("status") == status]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    return rows


def render(rows, markdown: bool = False) -> str:
    out = []
    if markdown:
        out.append("| arch | shape | t_comp | t_mem | t_coll | dominant | "
                   "useful | roofline | GiB/dev | fits |")
        out.append("|" + "---|" * 10)
        for r in rows:
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.2e} | "
                f"{r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} | "
                f"{r['dominant']} | {r['useful_flop_frac']:.2f} | "
                f"{r['roofline_frac']:.3f} | "
                f"{r['bytes_per_device_gib']:.2f} | "
                f"{'y' if r.get('fits_hbm') else 'N'} |")
    else:
        out.append(f"{'arch':20s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s}"
                   f" {'t_coll':>9s} {'dom':>6s} {'useful':>7s}"
                   f" {'roofl':>6s} {'GiB/dev':>8s} fits")
        for r in rows:
            out.append(
                f"{r['arch']:20s} {r['shape']:12s} "
                f"{r['t_compute_s']:9.2e} {r['t_memory_s']:9.2e} "
                f"{r['t_collective_s']:9.2e} {r['dominant'][:6]:>6s} "
                f"{r['useful_flop_frac']:7.2f} {r['roofline_frac']:6.3f} "
                f"{r['bytes_per_device_gib']:8.2f} "
                f"{'y' if r.get('fits_hbm') else 'N'}")
    return "\n".join(out)


def render_errors(rows) -> str:
    return "\n".join(f"{r['arch']} x {r['shape']}: {r['error']}"
                     for r in rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1_16x16")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--errors", action="store_true",
                    help="list the cells the port cannot place yet")
    args = ap.parse_args()
    if args.errors:
        print(render_errors(load_rows(args.mesh, status="error")))
    else:
        print(render(load_rows(args.mesh), markdown=args.markdown))


if __name__ == "__main__":
    main()
