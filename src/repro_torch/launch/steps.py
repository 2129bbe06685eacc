"""Step builders of the static serve path (counterpart of the prefill
and decode builders of `repro.launch.steps`; `make_train_step` comes
with training).

Each builder closes over the config, the arithmetic policy and the
attention core, and returns a function of (model, inputs, cache). The
cache is updated in place and returned.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import layers as L
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig,
                      policy: ArithmeticPolicy = ArithmeticPolicy(),
                      attn_impl: str | None = None):
    """(model, batch, cache) -> (last_logits (B, V), cache). Writes the
    prompt into the cache and returns the next-token logits."""
    L.resolve_attn_impl(attn_impl, policy)

    @torch.no_grad()
    def prefill_step(model, batch, cache):
        logits, _, new_cache = modellib.apply(
            model, cfg, {"tokens": batch["tokens"]}, policy=policy,
            cache=cache, attn_impl=attn_impl)
        return logits[:, -1], new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     policy: ArithmeticPolicy = ArithmeticPolicy(),
                     attn_impl: str | None = None):
    """(model, tokens (B, 1), cache) -> (logits (B, V), cache): ONE new
    token against the populated KV cache."""
    L.resolve_attn_impl(attn_impl, policy)

    @torch.no_grad()
    def decode_step(model, tokens, cache):
        logits, _, new_cache = modellib.apply(
            model, cfg, {"tokens": tokens}, policy=policy, cache=cache,
            attn_impl=attn_impl)
        return logits[:, -1], new_cache

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
