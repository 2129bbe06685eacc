"""Training launcher for the PyTorch port (counterpart of
`repro.launch.train`): the deterministic data pipeline, AdamW with the
cosine schedule, checkpoint and restart, the straggler monitor.

`python -m repro_torch.launch.train` trains the smoke config of
`--arch` (a transformer family: dense or MoE) for `--steps` steps on
`--device` (default cuda) under `--policy`; `--full` takes the full
config, which needs the card (full qwen3_8b, 36 layers with f32 weights
and AdamW state, needs more than one). Weights are random, drawn from
seed 0 with a torch generator, so losses differ from the reference's
for the same flags.

Fault tolerance:
  * auto-resume from the newest valid checkpoint in `--ckpt-dir`
    (corrupt ones skipped), in the reference's layout;
  * the stateless data pipeline resumes at the exact step;
  * a step slower than `straggler_factor` x the EMA of step times is
    flagged (logged and counted).

Wall-clock use here is intentional: the monitor and the log report
real step times.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import bridge, configs
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.data import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as stepslib
from repro_torch.models import model as modellib
from repro_torch.optim import OptimizerConfig, adamw_init


def train_state(model, opt_state) -> dict:
    """The training state as the reference checkpoints it: {"params",
    "opt"} in its tree layout, numpy leaves."""
    return {"params": bridge.params_to_numpy(model),
            "opt": bridge.opt_state_to_numpy(opt_state, model)}


def train(arch: str = "qwen3_8b", smoke: bool = True, steps: int = 100,
          seq_len: int = 128, global_batch: int = 8,
          policy_mode: str = "exact", ckpt_dir: str | None = None,
          save_every: int = 50, log_every: int = 10,
          straggler_factor: float = 3.0, lr: float = 3e-4,
          device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = configs.get_config(arch, smoke=smoke)
    policy = ArithmeticPolicy(mode=policy_mode)
    opt_cfg = OptimizerConfig(lr=lr, total_steps=steps,
                              warmup_steps=max(steps // 20, 5))
    dcfg = DataConfig(seq_len=seq_len, global_batch=global_batch)

    model = modellib.init(cfg, seed=0, device=dev, train=True)
    opt_state = adamw_init(model)
    start_step = 0

    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(CheckpointConfig(
            directory=ckpt_dir, save_every=save_every))
        step0, restored = mgr.restore_latest(train_state(model, opt_state))
        if step0 is not None:
            model = bridge.params_from_numpy(restored["params"], cfg,
                                             device=dev, train=True)
            opt_state = bridge.opt_state_from_numpy(restored["opt"], model)
            start_step = step0
            print(f"[train] resumed from step {step0}")

    step_fn = stepslib.make_train_step(cfg, opt_cfg, policy)

    losses = []
    ema = None
    stragglers = 0
    for step in range(start_step, steps):
        batch = make_batch(cfg, dcfg, step, device=dev)
        t0 = time.time()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        # straggler monitor: steps beyond straggler_factor x EMA are
        # flagged (cluster hook point: replace/requeue the slow worker)
        if ema is not None and dt > straggler_factor * ema and step > 3:
            stragglers += 1
            print(f"[straggler] step {step}: {dt:.2f}s vs ema {ema:.2f}s")
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        losses.append(loss)
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1000:6.0f}ms")
        if mgr and (step + 1) % save_every == 0:
            mgr.save(step + 1, train_state(model, opt_state))
    if mgr:
        mgr.save(steps, train_state(model, opt_state))
        mgr.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "losses": losses, "stragglers": stragglers,
            "model": model, "opt_state": opt_state}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--full", action="store_true",
                    help="full config (needs the card); default smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--policy", default="exact",
                    choices=["exact", "int8", "artemis", "artemis_mxu"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    out = train(arch=args.arch, smoke=not args.full, steps=args.steps,
                seq_len=args.seq_len, global_batch=args.global_batch,
                policy_mode=args.policy, ckpt_dir=args.ckpt_dir,
                lr=args.lr, device=args.device)
    print(f"\nfinal loss {out['final_loss']:.4f} "
          f"(from {out['first_loss']:.4f}); "
          f"stragglers flagged: {out['stragglers']}")


if __name__ == "__main__":
    main()
