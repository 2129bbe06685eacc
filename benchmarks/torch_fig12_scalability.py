"""Fig 12 reproduction: speedup vs input sequence length for growing HBM
stack counts. The paper's finding: larger configurations yield
near-linear gains on long sequences (more token groups fit -> fewer
remaps), so ARTEMIS scales to long-sequence workloads.

The PyTorch port's counterpart of `benchmarks/fig12_scalability.py`, on
`repro_torch`; its rows equal the reference script's.

    PYTHONPATH=src python -m benchmarks.torch_fig12_scalability
"""
from __future__ import annotations

import dataclasses

from repro_torch.hwsim import DataflowConfig, paper_models, simulate_model

SEQ_LENS = (128, 512, 2048, 8192)
STACKS = (1, 2, 4, 8)


def run() -> list[dict]:
    rows = []
    base_model = paper_models()["bert_base"]
    print(f"{'seq':>6s}" + "".join(f" {s}-stack" for s in STACKS)
          + "   (speedup vs 1-stack @ same seq)")
    for seq in SEQ_LENS:
        w = dataclasses.replace(base_model, n_tokens=seq)
        lat1 = simulate_model(w, DataflowConfig(), n_stacks=1).latency_ns
        cells = []
        row = {"seq": seq}
        for s in STACKS:
            lat = simulate_model(w, DataflowConfig(), n_stacks=s).latency_ns
            sp = lat1 / lat
            row[f"stacks_{s}"] = sp
            cells.append(f"{sp:7.2f}x")
        print(f"{seq:6d}" + "".join(f" {c}" for c in cells))
        rows.append(row)
    # scaling efficiency on the longest sequence
    eff = rows[-1][f"stacks_{STACKS[-1]}"] / STACKS[-1]
    print(f"\n{STACKS[-1]}-stack scaling efficiency at seq "
          f"{SEQ_LENS[-1]}: {eff:.0%} (paper: 'approaching near-linear')")
    return rows


if __name__ == "__main__":
    run()
