"""Train a small LM for a few hundred steps with the PyTorch port (the
counterpart of `examples/train_tiny_lm.py`).

Shows the deterministic data pipeline, AdamW with the cosine schedule,
a checkpoint and restart in the middle of the run (the job restarts
itself from its own checkpoint) and the loss falling under exact or
ARTEMIS arithmetic (on the card, a quantized policy runs every dense
projection through the sc_matmul kernel).

Run: PYTHONPATH=src python examples/torch_train_tiny_lm.py
         [--steps 300] [--policy exact] [--device cuda|cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--policy", default="exact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        half = args.steps // 2
        kw = dict(arch=args.arch, smoke=True, policy_mode=args.policy,
                  ckpt_dir=ckpt, save_every=max(half // 2, 10),
                  device=args.device)
        print(f"=== phase 1: steps 0..{half} (then simulated preemption)")
        out1 = train(steps=half, **kw)
        print(f"\n=== phase 2: auto-resume -> step {args.steps}")
        out2 = train(steps=args.steps, **kw)
        print(f"\nloss: {out1['first_loss']:.3f} -> {out2['final_loss']:.3f}"
              f" (policy={args.policy})")
        assert out2["final_loss"] < out1["first_loss"], "loss did not drop"
        print("OK: trained through a checkpoint/restart boundary")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
