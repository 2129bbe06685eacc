"""AdamW + cosine schedule + global-norm clipping (counterpart of
`repro.optim.adamw`), over a model's named parameters.

The state is the reference's `{"m", "v", "step"}`: m and v f32 tensors
by parameter name, step an int32 scalar tensor. `adamw_update` updates
the parameters and the state IN PLACE (the reference returns new
trees), one parameter at a time, so its temporaries never exceed a few
of one parameter's size. Its arithmetic is the reference's, op for op,
in f32 (where XLA fuses a product into its add, last bits differ).

Weight decay follows the reference's leaf rank, not the tensor's: the
reference decays every leaf of rank >= 2, and its per-layer leaves are
stacked on L, so a layer's norm scales ((L, d) there, (d,) here) are
decayed too (`bridge.leaf_ndim`).

`global_norm` sums the leaves in another order than the reference's
(per-layer tensors here, stacked leaves there), so the norm and the
clip scale agree with it to rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.bridge import leaf_ndim


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr (f32)."""
    step = step.float()
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, step) * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


@torch.no_grad()
def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32 (a metric: no
    gradient flows through it)."""
    sums = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_init(model: torch.nn.Module) -> dict:
    """Zeroed f32 moments by parameter name, and step 0."""
    def zeros():
        return {name: torch.zeros_like(p, dtype=torch.float32)
                for name, p in model.named_parameters()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


@torch.no_grad()
def adamw_update(model: torch.nn.Module, grads: dict, state: dict,
                 cfg: OptimizerConfig) -> dict:
    """One AdamW step on `model`'s parameters from `grads` (by name),
    in place: the parameters, m, v and step. The gradients are scaled
    in place too (by the clip factor, as f32). Returns the metrics
    {"lr", "grad_norm", "param_norm"} as 0-dim f32 tensors."""
    params = dict(model.named_parameters())
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm)
                        / torch.clamp_min(gnorm, 1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1.0 - torch.pow(_f32(b1, t), t)
    bc2 = 1.0 - torch.pow(_f32(b2, t), t)
    for name, p in params.items():
        # the reference's expressions, each product rounded on its own;
        # in place where a temporary would only be copied back
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((g * (1 - b2)).mul_(g))
        u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if leaf_ndim(name, p) >= 2 and cfg.weight_decay:
            u.add_(cfg.weight_decay * p.float())
        p.sub_(u.mul_(lr))
    state["step"] = step
    return {"lr": lr, "grad_norm": gnorm,
            "param_norm": global_norm(params.values())}
