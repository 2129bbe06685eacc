"""Table IV counterpart on the PyTorch port: model quality under FP32 /
Q(8-bit) / Q(8-bit)+SC (the `benchmarks/table4_accuracy.py` protocol).

Trains a small transformer from scratch per task (the smoke qwen3_8b
config with a 64-token vocab; f32 master weights, bf16 compute, exact
arithmetic, AdamW) on deterministic learnable tasks, then evaluates
token accuracy under three arithmetic ladders on the same weights: only
the inference arithmetic changes, and under Q8 (int8) and Q8+SC
(artemis_mxu) every dense projection runs the sc_matmul kernel on the
card. The claim under test is the shape of the paper's table: int8
costs little against FP32 (paper: -0.9 points on average) and SC little
against int8 (paper: -0.5). The tasks' batches are the reference's, bit
for bit (`repro_torch.prng`); the weights come from a torch generator,
not jax's stream, so the accuracies need not equal the reference's.

    PYTHONPATH=src python3 benchmarks/torch_table4_accuracy.py \
        [--device cuda|cpu] [--steps N]

Prints the table, the average drops and the wall seconds of each task's
training, and writes them as JSON to
`chiprun_out/torch_table4_accuracy.json`; on the card also its name and
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time

import torch

from repro_torch import configs, prng
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.data.pipeline import synthetic_task_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as modellib
from repro_torch.optim import OptimizerConfig, adamw_init

VOCAB = 64
TASKS = [
    ("transformer-base*", "copy", 12),
    ("bert-base*", "reverse", 12),
    ("albert-base*", "sort", 12),
    ("vit-base*", "modadd", 12),
    ("opt-350*", "copy", 24),       # longer-range variant
]
STEPS, BATCH = 600, 64
OUT = pathlib.Path("chiprun_out") / "torch_table4_accuracy.json"

PAPER_ROWS = {
    "transformer-base*": (70.90, 70.40, 69.45),
    "bert-base*": (87.00, 86.27, 85.92),
    "albert-base*": (86.07, 84.80, 84.51),
    "vit-base*": (97.60, 96.50, 96.20),
    "opt-350*": (18.07, 17.79, 17.49),   # BLEU, shape-compared only
}
LADDERS = [
    ("FP32", ArithmeticPolicy(mode="exact")),
    ("Q8", ArithmeticPolicy(mode="int8", ste=False)),
    ("Q8+SC", ArithmeticPolicy(mode="artemis_mxu", ste=False)),
]


def table_config():
    base = configs.get_config("qwen3_8b", smoke=True)
    return dataclasses.replace(base, vocab_size=VOCAB, vocab_round_to=16,
                               name="table4-lm")


def task_batch(seed: int, i: int, task: str, n: int, device):
    """Batch i of the stream `seed`: tokens, mask and next-token labels."""
    key = prng.fold_in(prng.PRNGKey(seed, device), i)
    tokens, mask = synthetic_task_batch(key, task, BATCH, n, VOCAB)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    return tokens, mask, labels


def train_task(cfg, task: str, n: int, device, steps: int = STEPS,
               seed: int = 0, data_seed: int | None = None, log_every=0):
    """A model trained on `task` (exact arithmetic) from seed `seed`;
    its batches come from `data_seed` (default seed + 1)."""
    data_seed = seed + 1 if data_seed is None else data_seed
    model = modellib.init(cfg, seed=seed, device=device, train=True)
    opt = adamw_init(model)
    opt_cfg = OptimizerConfig(lr=3e-3, total_steps=steps, warmup_steps=30,
                              weight_decay=0.01)
    step_fn = make_train_step(cfg, opt_cfg)
    for step in range(steps):
        tokens, _, labels = task_batch(data_seed, step, task, n, device)
        model, opt, metrics = step_fn(model, opt, {"tokens": tokens,
                                                   "labels": labels})
        if log_every and step % log_every == 0:
            print(f"step {step:4d} loss {float(metrics['loss']):.3f}")
    return model


@torch.no_grad()
def accuracy(model, cfg, task: str, n: int, policy, device,
             seed: int = 12345, n_batches: int = 8) -> float:
    """Token accuracy (%) on the target span of `n_batches` held-out
    batches, under `policy` (the reference's jnp attention: gather)."""
    correct = total = 0
    for i in range(n_batches):
        tokens, mask, _ = task_batch(seed, i, task, n, device)
        logits, _, _ = modellib.apply(model, cfg, {"tokens": tokens},
                                      policy=policy, attn_impl="gather")
        pred = torch.argmax(logits[:, :-1], dim=-1)
        m = mask[:, 1:] > 0
        correct += int(((pred == tokens[:, 1:]) & m).sum())
        total += int(m.sum())
    return 100.0 * correct / total


def card_line(device) -> str | None:
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[device.index or 0]


def run(device="cuda", steps: int = STEPS) -> list[dict]:
    dev = resolve_device(device)
    cfg = table_config()
    rows = []
    print(f"{'model (task)':26s} {'FP32':>7s} {'Q8':>7s} {'Q8+SC':>7s}"
          f"   paper: FP32 / Q8 / Q8+SC")
    drops_q8, drops_sc = [], []
    for name, task, n in TASKS:
        t0 = time.perf_counter()
        model = train_task(cfg, task, n, dev, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        accs = {lbl: accuracy(model, cfg, task, n, pol, dev)
                for lbl, pol in LADDERS}
        p = PAPER_ROWS[name]
        print(f"{name+' ('+task+')':26s} {accs['FP32']:7.2f} "
              f"{accs['Q8']:7.2f} {accs['Q8+SC']:7.2f}   "
              f"{p[0]:.2f} / {p[1]:.2f} / {p[2]:.2f}   "
              f"(trained in {train_s:.1f} s)")
        rows.append({"model": name, "task": task, **accs, "paper": p,
                     "train_s": train_s})
        drops_q8.append(accs["FP32"] - accs["Q8"])
        drops_sc.append(accs["Q8"] - accs["Q8+SC"])
    avg_q8 = sum(drops_q8) / len(drops_q8)
    avg_sc = sum(drops_sc) / len(drops_sc)
    print(f"\navg drop FP32->Q8:   {avg_q8:+.2f} points (paper ~0.9)")
    print(f"avg drop Q8->Q8+SC:  {avg_sc:+.2f} points (paper ~0.5)")
    rows.append({"model": "AVG", "drop_q8": avg_q8, "drop_sc": avg_sc})
    card = card_line(dev)
    if card:
        print(card)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"device": str(dev), "card": card,
                               "steps": steps, "rows": rows}, indent=1))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="training steps per task (the protocol's 600)")
    args = ap.parse_args()
    run(args.device, args.steps)


if __name__ == "__main__":
    main()
