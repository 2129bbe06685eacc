"""Model factory (counterpart of `repro.models.model`): one
`init`/`apply`/`init_cache` surface over the families.

  init(cfg, seed, device)                  -> the model, seeded weights
  apply(model, cfg, inputs, ...)           -> (logits, aux, new_cache)
  init_cache(cfg, batch, max_len, ...)     -> the decode carry

Only the dense text family is ported (`models/transformer.py`); the
others raise NotImplementedError naming their ROADMAP item. `lm_loss`
comes with training.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 3, MoE",
    "rwkv6": "ROADMAP Queue 1 item 6, recurrent families",
    "zamba2": "ROADMAP Queue 1 item 6, recurrent families",
}


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet "
            f"({_NOT_PORTED[cfg.family]})")
    if cfg.modality != "text":
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported yet (ROADMAP Queue 1 "
            f"item 7, multimodal static paths)")


def init(cfg: ModelConfig, seed: int = 0,
         device="cuda") -> transformer.Transformer:
    _check(cfg)
    return transformer.init(cfg, seed=seed, device=device)


def apply(model, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None):
    _check(cfg)
    return transformer.apply(model, cfg, inputs, policy=policy, cache=cache,
                             attn_impl=attn_impl)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    _check(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype=dtype,
                                  device=device)
