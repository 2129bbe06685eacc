"""Model factory (counterpart of `repro.models.model`): one
`init`/`apply`/`init_cache` surface over the families.

  init(cfg, seed, device, train)           -> the model, seeded weights
  empty(cfg, device, train)                -> the model, zeroed weights
  apply(model, cfg, inputs, ...)           -> (logits, aux, new_cache)
  init_cache(cfg, batch, max_len, ...)     -> the decode carry
  lm_loss(logits, labels, mask)            -> mean token cross-entropy

dense and MoE (`models/transformer.py`, `models/moe.py`), rwkv6
(`models/rwkv6.py`) and zamba2 (`models/zamba2.py`, over
`models/mamba2.py`) are ported; the multimodal configs raise
NotImplementedError naming their ROADMAP item. `train=True` builds a
trainable model (f32 master weights, gradients on), for the dense and
MoE families only: training the recurrent families waits for ROADMAP
Queue 1 item 10.
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


def _train_kw(cfg: ModelConfig, train: bool) -> dict:
    if not train:
        return {}
    if _mod(cfg) is not transformer:
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 10, recurrent training)")
    return {"train": True}


def empty(cfg: ModelConfig, device="cuda", train: bool = False):
    """The family's model with zeroed weights (`repro_torch.bridge`
    fills it)."""
    kw = _train_kw(cfg, train)
    return _CLASS[cfg.family](cfg, device=device, **kw)


def init(cfg: ModelConfig, seed: int = 0, device="cuda", train: bool = False):
    kw = _train_kw(cfg, train)
    return _mod(cfg).init(cfg, seed=seed, device=device, **kw)


def apply(model, cfg: ModelConfig, inputs: dict, *,
          policy: ArithmeticPolicy = ArithmeticPolicy(),
          cache: dict | None = None, attn_impl: str | None = None,
          remat: bool = False):
    """The family's forward: (logits, aux, new_cache). `remat` (the
    train step's) is the transformer's; the other families take none."""
    kw = {"remat": remat} if remat else {}
    return _mod(cfg).apply(model, cfg, inputs, policy=policy, cache=cache,
                           attn_impl=attn_impl, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The family's decode carry; rwkv6's is f32 whatever `dtype`, as
    the reference's."""
    if cfg.family == "rwkv6":
        dtype = torch.float32
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                device=device)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32: logsumexp minus the picked
    logit, as the reference writes it.

    logits: (B, S, V) [audio: (B, S, C, V)]; labels: the same minus V,
    int. mask: optional (B, S) weights."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if nll.dim() == 3:  # audio: mean over codebooks
        nll = nll.mean(dim=-1)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
