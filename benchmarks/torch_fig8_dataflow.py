"""Fig 8 reproduction: dataflow x pipelining sensitivity (hwsim).

Four schemes per workload; speedup + energy normalized to layer_NP.
Paper aggregates: token-vs-layer 11.0x speedup / 3.5x energy; pipelining
1.50x (layer) / 1.43x (token) speedup, 1.42x / 1.43x energy.

The PyTorch port's counterpart of `benchmarks/fig8_dataflow.py`, on
`repro_torch`; its rows equal the reference script's.

    PYTHONPATH=src python -m benchmarks.torch_fig8_dataflow
"""
from __future__ import annotations

import statistics

from repro_torch.hwsim import DataflowConfig, paper_models, simulate_model

SCHEMES = ("layer_NP", "layer_PP", "token_NP", "token_PP")

PAPER_AGG = {"sp_tok": 11.0, "en_tok": 3.5, "sp_ppl": 1.50,
             "sp_ppt": 1.43, "en_ppl": 1.42, "en_ppt": 1.43}


def run() -> list[dict]:
    rows = []
    agg = {k: [] for k in PAPER_AGG}
    print(f"{'model':18s}" + "".join(f" {s:>16s}" for s in SCHEMES[1:]))
    for name, w in paper_models().items():
        res = {s: simulate_model(w, DataflowConfig(scheme=s))
               for s in SCHEMES}
        base = res["layer_NP"]
        row = {"model": name}
        cells = []
        for s in SCHEMES[1:]:
            sp = base.latency_ns / res[s].latency_ns
            en = base.energy_pj / res[s].energy_pj
            row[f"{s}_speedup"] = sp
            row[f"{s}_energy"] = en
            cells.append(f"{sp:6.1f}x/E{en:4.1f}x")
        print(f"{name:18s}" + "".join(f" {c:>16s}" for c in cells))
        rows.append(row)
        agg["sp_tok"].append(base.latency_ns / res["token_NP"].latency_ns)
        agg["en_tok"].append(base.energy_pj / res["token_NP"].energy_pj)
        agg["sp_ppl"].append(base.latency_ns / res["layer_PP"].latency_ns)
        agg["sp_ppt"].append(res["token_NP"].latency_ns
                             / res["token_PP"].latency_ns)
        agg["en_ppl"].append(base.energy_pj / res["layer_PP"].energy_pj)
        agg["en_ppt"].append(res["token_NP"].energy_pj
                             / res["token_PP"].energy_pj)
    print("\naggregate (ours vs paper):")
    for k, target in PAPER_AGG.items():
        ours = statistics.mean(agg[k])
        print(f"  {k:8s} {ours:6.2f} vs {target:5.2f}")
        rows.append({"metric": k, "ours": ours, "paper": target})
    return rows


if __name__ == "__main__":
    run()
