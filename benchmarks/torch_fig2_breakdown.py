"""Fig 2 reproduction: component-wise time on a conventional digital PIM
(DRISA: 1600 ns MUL) — the motivation figure. The paper's claim: >90% of
transformer execution time goes to the MatMuls in MHA + FFN.

The PyTorch port's counterpart of `benchmarks/fig2_breakdown.py`, on
`repro_torch`; its rows equal the reference script's.

    PYTHONPATH=src python -m benchmarks.torch_fig2_breakdown
"""
from __future__ import annotations

from repro_torch.hwsim import paper_models, simulate_breakdown


def run() -> list[dict]:
    rows = []
    print(f"{'model':18s} {'matmul':>8s} {'softmax':>8s} {'nonlin':>8s} "
          f"{'move':>8s}")
    for name, w in paper_models().items():
        b = simulate_breakdown(w)
        print(f"{name:18s} {b['matmul']:8.1%} {b['softmax']:8.1%} "
              f"{b['nonlinear']:8.1%} {b['data_movement']:8.1%}")
        rows.append({"model": name, **b})
    ok = all(r["matmul"] > 0.9 for r in rows)
    print(f"\n>90% MatMul on all workloads: {ok} (paper: yes)")
    return rows


if __name__ == "__main__":
    run()
