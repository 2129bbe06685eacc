"""Table V counterpart on the PyTorch port: per-component calibration
accuracy (the `benchmarks/table5_calibration.py` protocol).

For each approximate block (stochastic MUL, analog ACC, A_to_B, softmax)
it measures MAE / max error normalized to the block's full scale, plus
the paper's "calibration accuracy" metric, -log2(MAE). The
deterministic implementation gives the ideal-digital error floor; the
paper's values are SPICE-measured. `sigma_analog` = MAE_paper /
sqrt(2/pi) (Gaussian readout noise) reproduces the paper's ACC row.

The inputs are the reference's own, drawn with `repro_torch.prng`:
`randint(PRNGKey(0), (4096, 20), 0, 128)` products, the noise from
`PRNGKey(1)`, softmax scores `normal(PRNGKey(1), (64, 64)) * 4`, and
the A_to_B grid is the reference's f32 `linspace(0, full_scale,
100001)`. Every block runs on `device`; the errors are reduced there.

    PYTHONPATH=src python -m benchmarks.torch_table5_calibration \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch import prng, xla_math
from repro_torch.core import (
    MomcapConfig, artemis_softmax, readout_quantize, sc_multiply,
)
from repro_torch.core.quantization import div_by
from repro_torch.device import resolve_device


def _calib(mae: float) -> float:
    return -math.log2(max(mae, 1e-12))


def _stats(err: torch.Tensor) -> dict:
    """MAE, max and calibration bits of f32 errors. The mean is summed
    in f64, where these sums are exact or nearly so, so that the card
    and the CPU, which add in other orders, give the same MAE."""
    mae = float(err.double().mean())
    return {"mae": mae, "max": float(err.max()), "calib_bits": _calib(mae)}


def mul_errors(dev) -> dict:
    """Stochastic MUL over the full 128x128 operand square."""
    a = torch.arange(128, device=dev)
    prod_exact = div_by((a[:, None] * a[None, :]).float(), 128.0)
    prod_sc = sc_multiply(a[:, None], a[None, :]).float()
    return _stats(div_by((prod_sc - prod_exact).abs(), 127.0))


def acc_errors(dev, n_trials: int = 4096, sigma: float = 0.0) -> dict:
    """Analog ACC: group-of-20 accumulation + 8-bit quantizing readout,
    optional Gaussian analog noise."""
    cfg = MomcapConfig(acc_depth=20, readout_bits=8, sigma_analog=sigma)
    prods = prng.randint(prng.PRNGKey(0, dev), (n_trials, 20), 0, 128)
    exact = prods.sum(dim=-1).float()
    ro = readout_quantize(exact, cfg,
                          prng.PRNGKey(1, dev) if sigma > 0 else None)
    return _stats(div_by((ro - exact).abs(), cfg.full_scale))


def linspace_f32(start: float, stop: float, num: int, dev) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` as jax computes it in f32:
    start + i * delta with delta = (stop - start) / (num - 1) in f32,
    and the last point exactly `stop` (equal to jax's at start 0)."""
    delta = torch.tensor(stop - start, dtype=torch.float32) / (num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=dev)
    xs = start + i * delta.item()
    return torch.cat([xs, torch.tensor([stop], dtype=torch.float32,
                                       device=dev)])


def a_to_b_errors(dev) -> dict:
    """A_to_B ladder: quantization of one analog value over a fine grid
    (the conversion path alone)."""
    cfg = MomcapConfig(acc_depth=20, readout_bits=8)
    xs = linspace_f32(0.0, cfg.full_scale, 100001, dev)
    ro = readout_quantize(xs, cfg)
    return _stats(div_by((ro - xs).abs(), cfg.full_scale))


def softmax(y: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` over the last axis: exp(y - max) / sum, with
    XLA's exp (the sum may round apart from XLA's in a last bit)."""
    unnormalized = xla_math.exp(y - y.amax(dim=-1, keepdim=True))
    return unnormalized / unnormalized.sum(dim=-1, keepdim=True)


def softmax_errors(dev, n_trials: int = 64) -> dict:
    y = prng.normal(prng.PRNGKey(1, dev), (n_trials, 64)) * 4.0
    ref = softmax(y)
    lut = artemis_softmax(y, axis=-1, n_in=256, out_bits=8)
    return _stats((lut - ref).abs())                # prob units


PAPER = {
    "Stochastic MUL": (0.039, 0.123, 4.68),
    "Analog ACC": (0.0085, 0.0729, 6.88),
    "A_to_B": (0.00037, 0.00062, 11.38),
    "Softmax": (0.0020, 0.0078, 8.20),
}

# Gaussian sigma that reproduces the paper's measured ACC MAE:
# E|N(0, s)| = s*sqrt(2/pi) -> s = 0.0085 / 0.7979
ACC_SIGMA_CALIBRATED = 0.0085 / math.sqrt(2.0 / math.pi)


def run(device="cuda") -> list[dict]:
    dev = resolve_device(device)
    ours = {
        "Stochastic MUL": mul_errors(dev),
        "Analog ACC": acc_errors(dev),
        "A_to_B": a_to_b_errors(dev),
        "Softmax": softmax_errors(dev),
    }
    acc_cal = acc_errors(dev, sigma=ACC_SIGMA_CALIBRATED)
    rows = []
    print(f"device: {dev}")
    print(f"{'Block':18s} {'MAE':>9s} {'paper':>9s} {'Max':>9s} "
          f"{'paper':>9s} {'Calib':>6s} {'paper':>6s}")
    for name, o in ours.items():
        p = PAPER[name]
        print(f"{name:18s} {o['mae']:9.5f} {p[0]:9.5f} {o['max']:9.5f} "
              f"{p[1]:9.5f} {o['calib_bits']:6.2f} {p[2]:6.2f}")
        rows.append({"block": name, **o, "paper_mae": p[0],
                     "paper_max": p[1], "paper_calib": p[2]})
    print(f"{'ACC (noise-cal.)':18s} {acc_cal['mae']:9.5f} "
          f"{PAPER['Analog ACC'][0]:9.5f} {acc_cal['max']:9.5f} "
          f"{PAPER['Analog ACC'][1]:9.5f} {acc_cal['calib_bits']:6.2f} "
          f"{PAPER['Analog ACC'][2]:6.2f}")
    rows.append({"block": "Analog ACC (noise-calibrated)", **acc_cal,
                 "paper_mae": PAPER["Analog ACC"][0],
                 "paper_max": PAPER["Analog ACC"][1],
                 "paper_calib": PAPER["Analog ACC"][2]})
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
