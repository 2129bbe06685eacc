"""Fig 7 reproduction: MOMCAP charge-accumulation linearity vs capacitance.

The RC charge model (repro_torch.core.analog): each 128-bit accumulation event
adds dv = (Q/C)(1 - v/V_SAT); the staircase stays "linear" while the step
exceeds 95% of the first step. The paper selects 8 pF (tile-area-matched,
338 um^2) => 20 linear accumulations.

The PyTorch port's counterpart of `benchmarks/fig7_momcap.py`, on
`repro_torch`: the same rows, the f32 staircase within 1e-6 of the
reference's.

    PYTHONPATH=src python -m benchmarks.torch_fig7_momcap
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import max_linear_accumulations, momcap_voltage_trace


def run() -> list[dict]:
    rows = []
    print(f"{'C (pF)':>7s} {'max linear accs':>16s} {'V @ 20 accs':>12s}")
    for c_pf in (4, 8, 12, 16, 24, 32, 40):
        n = max_linear_accumulations(c_pf)
        trace = np.asarray(momcap_voltage_trace(c_pf, 40))
        rows.append({"c_pf": c_pf, "max_linear": n,
                     "v20": float(trace[19])})
        print(f"{c_pf:7d} {n:16d} {rows[-1]['v20']:12.3f}")
    # the paper's design point
    n8 = max_linear_accumulations(8.0)
    print(f"\n8 pF supports {n8} linear accumulations "
          f"(paper: 20, tile-area-matched)")
    assert n8 == 20, n8
    return rows


if __name__ == "__main__":
    run()
