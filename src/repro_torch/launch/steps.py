"""Step builders (counterpart of `repro.launch.steps`): the train step
and the static serve path's prefill and decode steps.

Each builder closes over the config and the arithmetic policy. The
serve steps also close over the attention core and return a function
of (model, inputs, cache); the cache is updated in place and returned.
The train step returns a function of (model, opt_state, batch) that
updates the model and the optimizer state in place; given a mesh, one
rank's step of the sharded train step (`parallel.data_parallel`).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import layers as L
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, adamw_update
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel.context import use_sharding
from repro_torch.parallel.tensor_parallel import named_shards

# the reference's train forward runs its jnp attention, never a kernel
# (and the kernels have no backward): the gather core, under every policy
TRAIN_ATTN_IMPL = "gather"


def _model_inputs(batch: dict) -> dict:
    """The forward's inputs of a batch: its tokens, and the vlm
    prefix embeddings where it has them."""
    inputs = {"tokens": batch["tokens"]}
    if "prefix_embeds" in batch:
        inputs["prefix_embeds"] = batch["prefix_embeds"]
    return inputs


def loss_and_grads(model, cfg: ModelConfig, batch: dict,
                   policy: ArithmeticPolicy = ArithmeticPolicy(),
                   remat: bool = True, tp=None, n_data: int = 1):
    """The train step's forward and backward: (loss, aux, grads by
    parameter name). The objective is `lm_loss + aux`, aux the MoE
    load-balance loss (0 for the other families); under a quantized
    policy the gradients are the straight-through estimator's. A vlm
    batch's `prefix_embeds` go before its tokens, and only the token
    positions' logits enter the loss. A sharded rank's
    (`sharded_loss_and_grads`) passes its tensor-parallel seams `tp` and
    back-propagates the objective over `n_data`, the data ranks."""
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        logits, aux, _ = modellib.apply(
            model, cfg, _model_inputs(batch), policy=policy,
            attn_impl=TRAIN_ATTN_IMPL, remat=remat, tp=tp)
        if "prefix_embeds" in batch:
            logits = logits[:, -batch["tokens"].shape[1]:]
        loss = modellib.lm_loss(logits, batch["labels"])
        total = loss + aux
        (total if n_data == 1 else total / n_data).backward()
    grads = {name: p.grad for name, p in named_shards(model)}
    return loss.detach(), aux.detach(), grads


def sharded_loss_and_grads(model, cfg: ModelConfig, batch: dict, mesh,
                           policy: ArithmeticPolicy = ArithmeticPolicy(),
                           remat: bool = True):
    """The sharded step's forward and backward on a rank's model
    (`parallel.data_parallel`) and its rows of the global `batch`, run
    inside `use_sharding(mesh, ...)`: (the whole batch's loss, its aux,
    this rank's blocks of the whole batch's gradients). Every rank
    returns the same loss and aux."""
    tp = dp.tensor_parallel(model, cfg, mesh)
    loss, aux, grads = loss_and_grads(
        model, cfg, dp.local_batch(cfg, mesh, batch), policy, remat, tp=tp,
        n_data=mesh.size("data"))
    loss, grads = dp.whole_batch(model, loss, grads, mesh, tp)
    return loss, aux, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    policy: ArithmeticPolicy = ArithmeticPolicy(),
                    mesh=None, rules=None, remat: bool = True):
    """(model, opt_state, batch) -> (model, opt_state, metrics): one
    AdamW step on `lm_loss + aux`, model and state updated in place.
    metrics: loss, aux_loss, total_loss, lr, grad_norm, param_norm
    (0-dim f32 tensors on the model's device).

    With `mesh` (a rank's `launch.mesh.RankMesh` over (data, model)) and
    `rules` (`parallel.ShardingRules`), the step of one rank of the
    sharded step, inside `use_sharding(mesh, rules)`: `model` and
    `opt_state` are the rank's (`parallel.data_parallel.
    shard_train_state` or `init_rank_model`), `batch` the global batch,
    of which the rank takes its rows; the loss and the gradients are
    the whole batch's, AdamW updates the rank's blocks, and the metrics
    are the global ones, the same on every rank. Without either, the
    single-device step, as the reference's."""
    if mesh is not None and rules is not None:
        return _sharded_train_step(cfg, opt_cfg, policy, mesh, rules, remat)

    def train_step(model, opt_state, batch):
        loss, aux, grads = loss_and_grads(model, cfg, batch, policy, remat)
        om = adamw_update(model, grads, opt_state, opt_cfg)
        # the gradients are spent: free them before the next forward
        model.zero_grad(set_to_none=True)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": loss + aux,
                   **om}
        return model, opt_state, metrics

    return train_step


def _sharded_train_step(cfg, opt_cfg, policy, mesh, rules, remat):
    dp.check_mesh(cfg, mesh.mesh, policy, rules)

    def train_step(model, opt_state, batch):
        with use_sharding(mesh, rules):
            loss, aux, grads = sharded_loss_and_grads(model, cfg, batch,
                                                      mesh, policy, remat)
            om = adamw_update(
                named_shards(model), grads, opt_state, opt_cfg,
                norm=functools.partial(dp.global_norm,
                                       specs=model.placement, rmesh=mesh))
        model.zero_grad(set_to_none=True)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": loss + aux,
                   **om}
        return model, opt_state, metrics

    return train_step


def _check_serve_mesh(mesh, policy: ArithmeticPolicy) -> None:
    """Refuse per-channel scales on a mesh of several model ranks: a
    rank's part of a weight takes the whole leaf's per-tensor scale."""
    if mesh is not None and mesh.size("model") > 1 and (
            policy.act_quant_axis is not None
            or policy.weight_quant_axis is not None):
        raise ValueError("the tensor-parallel serving steps keep per-tensor "
                         "scales; act_quant_axis and weight_quant_axis must "
                         "be None")


def _serve_tp(model, cfg: ModelConfig, mesh):
    """A serving rank's seams over the mesh's model ranks, or None."""
    return None if mesh is None else dp.tensor_parallel(model, cfg, mesh)


def make_prefill_step(cfg: ModelConfig,
                      policy: ArithmeticPolicy = ArithmeticPolicy(),
                      attn_impl: str | None = None, mesh=None):
    """(model, batch, cache) -> (last_logits (B, V) [audio: (B, C, V)],
    cache). Writes the prompt (after a vlm batch's `prefix_embeds`)
    into the cache and returns the next-token logits. With `mesh` (a
    rank's `launch.mesh.RankMesh`), one rank's step, any family: `model`
    holds its part of the weights (`parallel.tensor_parallel.placement`
    over the model ranks), `batch` its rows and `cache` its rows of its
    part (`parallel.tensor_parallel.rank_cache`)."""
    L.resolve_attn_impl(attn_impl, policy)
    _check_serve_mesh(mesh, policy)

    @torch.no_grad()
    def prefill_step(model, batch, cache):
        logits, _, new_cache = modellib.apply(
            model, cfg, _model_inputs(batch), policy=policy,
            cache=cache, attn_impl=attn_impl,
            tp=_serve_tp(model, cfg, mesh))
        return logits[:, -1], new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     policy: ArithmeticPolicy = ArithmeticPolicy(),
                     attn_impl: str | None = None, mesh=None):
    """(model, tokens (B, 1) [audio: (B, 1, C)], cache) -> (logits (B,
    V) [audio: (B, C, V)], cache): ONE new token against the populated
    KV cache. `mesh` as in `make_prefill_step`."""
    L.resolve_attn_impl(attn_impl, policy)
    _check_serve_mesh(mesh, policy)

    @torch.no_grad()
    def decode_step(model, tokens, cache):
        logits, _, new_cache = modellib.apply(
            model, cfg, {"tokens": tokens}, policy=policy, cache=cache,
            attn_impl=attn_impl, tp=_serve_tp(model, cfg, mesh))
        return logits[:, -1], new_cache

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the last (vocab) axis: (B, V) -> (B,), audio's
    (B, C, V) -> (B, C)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
