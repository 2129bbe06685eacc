"""Accuracy across the arithmetic ladder with the PyTorch port (the
counterpart of `examples/accuracy_ablation.py`, paper Table IV's shape).

Trains a small transformer on sequence copy, then evaluates its token
accuracy under exact, int8, artemis_mxu and artemis inference
arithmetic: FP32 against Q(8-bit) against Q(8-bit)+SC, the last in both
its MXU-style approximation and the full MOMCAP pipeline. On the card
every dense projection of the quantized ladders runs the sc_matmul
kernel.

Run: PYTHONPATH=src python examples/torch_accuracy_ablation.py
         [--device cuda|cpu] [--steps 600]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_table4_accuracy import (accuracy, table_config,
                                              train_task)
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.device import resolve_device

TASK, N = "copy", 12
LABELS = {"exact": "FP32", "int8": "Q(8-bit)",
          "artemis_mxu": "Q(8-bit)+SC (mxu)", "artemis": "Q(8-bit)+SC"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=600)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = table_config()
    model = train_task(cfg, TASK, N, dev, args.steps, seed=0, data_seed=0,
                       log_every=50)
    print(f"\n{'mode':18s} {'token accuracy':>14s}   (paper Table IV shape)")
    for mode, label in LABELS.items():
        acc = accuracy(model, cfg, TASK, N,
                       ArithmeticPolicy(mode=mode, ste=False), dev, seed=999)
        print(f"{label:18s} {acc / 100:14.1%}")


if __name__ == "__main__":
    main()
