"""Model factory (counterpart of `repro.models.model`): one
`init`/`apply`/`init_cache` surface over the families.

  init(cfg, seed, device)                  -> the model, seeded weights
  empty(cfg, device)                       -> the model, zeroed weights
  apply(model, cfg, inputs, ...)           -> (logits, aux, new_cache)
  init_cache(cfg, batch, max_len, ...)     -> the decode carry

dense and MoE (`models/transformer.py`, `models/moe.py`), rwkv6
(`models/rwkv6.py`) and zamba2 (`models/zamba2.py`, over
`models/mamba2.py`) are ported; the multimodal configs raise
NotImplementedError naming their ROADMAP item. `lm_loss` comes with
training.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import rwkv6, transformer, zamba2
from repro_torch.models.config import ModelConfig

_FAMILY = {"dense": transformer, "moe": transformer, "rwkv6": rwkv6,
           "zamba2": zamba2}
_CLASS = {"dense": transformer.Transformer, "moe": transformer.Transformer,
          "rwkv6": rwkv6.RWKV6, "zamba2": zamba2.Zamba2}


def _mod(cfg: ModelConfig):
    if cfg.modality != "text":
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported yet (ROADMAP Queue 1 "
            f"item 7, multimodal static paths)")
    return _FAMILY[cfg.family]


def empty(cfg: ModelConfig, device="cuda"):
    """The family's model with zeroed weights (`repro_torch.bridge`
    fills it)."""
    _mod(cfg)
    return _CLASS[cfg.family](cfg, device=device)


def init(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return _mod(cfg).init(cfg, seed=seed, device=device)


def apply(model, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None):
    return _mod(cfg).apply(model, cfg, inputs, policy=policy, cache=cache,
                           attn_impl=attn_impl)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The family's decode carry; rwkv6's is f32 whatever `dtype`, as
    the reference's."""
    if cfg.family == "rwkv6":
        dtype = torch.float32
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                device=device)
