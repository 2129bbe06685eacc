"""Step builders (counterpart of `repro.launch.steps`): the train step
and the static serve path's prefill and decode steps.

Each builder closes over the config and the arithmetic policy. The
serve steps also close over the attention core and return a function
of (model, inputs, cache); the cache is updated in place and returned.
The train step returns a function of (model, opt_state, batch) that
updates the model and the optimizer state in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import layers as L
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, adamw_update

# the reference's train forward runs its jnp attention, never a kernel
# (and the kernels have no backward): the gather core, under every policy
TRAIN_ATTN_IMPL = "gather"


def loss_and_grads(model, cfg: ModelConfig, batch: dict,
                   policy: ArithmeticPolicy = ArithmeticPolicy(),
                   remat: bool = True):
    """The train step's forward and backward: (loss, aux, grads by
    parameter name). The objective is `lm_loss + aux`, aux the MoE
    load-balance loss (0 for the dense family); under a quantized
    policy the gradients are the straight-through estimator's."""
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        logits, aux, _ = modellib.apply(
            model, cfg, {"tokens": batch["tokens"]}, policy=policy,
            attn_impl=TRAIN_ATTN_IMPL, remat=remat)
        loss = modellib.lm_loss(logits, batch["labels"])
        (loss + aux).backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    return loss.detach(), aux.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    policy: ArithmeticPolicy = ArithmeticPolicy(),
                    remat: bool = True):
    """(model, opt_state, batch) -> (model, opt_state, metrics): one
    AdamW step on `lm_loss + aux`, model and state updated in place.
    metrics: loss, aux_loss, total_loss, lr, grad_norm, param_norm
    (0-dim f32 tensors on the model's device)."""

    def train_step(model, opt_state, batch):
        loss, aux, grads = loss_and_grads(model, cfg, batch, policy, remat)
        om = adamw_update(model, grads, opt_state, opt_cfg)
        # the gradients are spent: free them before the next forward
        model.zero_grad(set_to_none=True)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": loss + aux,
                   **om}
        return model, opt_state, metrics

    return train_step


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
