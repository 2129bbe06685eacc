"""Mixture-of-Experts layer on one device (counterpart of
`repro.models.moe`): top-k routing, sort-based dispatch with a per-
expert capacity, the expert FFNs, and the gate-weighted combine plus
the always-on shared experts.

The reference splits the tokens into data-parallel groups from its
sharding context, G = the data ranks, group i the block of rows i; on
one device that is one group (G = 1), which is what this module
computes. A data rank of the sharded train step holds exactly its
group's rows, so each rank computing one group of its own tokens IS
the reference's grouping: capacity and drops per group. Only the aux
loss reads the whole batch, through the sharding context
(`parallel.context.data_sum`):

  1. router logits in f32 (exact unless `policy.apply_to_router`), pad
     experts masked to -1e30, softmax, top-k, gates renormalized;
  2. the Switch aux loss: router_aux_weight * E * sum(density *
     mean probability), density from each token's first choice, both
     over the whole batch (every data rank's tokens);
  3. capacity C = max(int(capacity_factor * T * k / E), 1); the T * k
     choices stably sorted by expert id, each one's slot its rank
     within its expert; choices past C are dropped (their destination
     is a trash row, their contribution zero);
  4. the kept tokens scattered into (E, C, d), the expert FFN over all
     E padded experts, and each choice's output gathered back;
  5. the combine: each token's k gated outputs added, from zero, in
     the order the reference's scatter-add applies them (sorted-slot
     order, i.e. by expert id), rounded to the compute dtype after each
     add; then the sum of the shared experts' outputs (accumulated in
     f32, rounded once, as `jnp.sum` does) added.

Every step has a fixed shape and none reads a value back to the host.
The combine is a fixed loop over k, never an atomic scatter, so the
output is the same from run to run on CUDA as well.

Under the exact policy the expert FFN is three batched products over
the experts (`torch.bmm`), as the reference's vmap of `layers.ffn`.
Under a quantized policy each expert is quantized on its own, as the
vmap gives it its own activation and weight scales, so `layers.ffn`
runs once per expert (its three products through sc_matmul), the pad
experts included.
"""
from __future__ import annotations

import functools
import types

import torch
from torch import nn

from repro_torch.core.policy import EXACT, ArithmeticPolicy
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.context import data_size, data_sum

NEG_INF = -1e30


class ExpertFFN(nn.Module):
    """The FFN weights of n experts, stacked on a leading expert axis:
    w_up, w_gate (n, d, f) and w_down (n, f, d), as the reference's
    vmapped `ffn_init` leaves."""

    def __init__(self, n: int, d: int, f: int, glu: bool, dtype, device):
        super().__init__()
        self.w_up = L.param((n, d, f), dtype, device)
        self.w_down = L.param((n, f, d), dtype, device)
        if glu:
            self.w_gate = L.param((n, d, f), dtype, device)

    def stacks(self) -> dict:
        """The stacked weights by name, each read once (a data-parallel
        rank's read gathers them)."""
        return {name: getattr(self, name)
                for name in ("w_up", "w_down", "w_gate") if hasattr(self, name)}


class MoE(nn.Module):
    """router (d, E) f32 (the reference reads it in f32), experts over
    the E padded experts, shared over the n_shared_experts."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff_expert
        self.router = L.param((d, cfg.padded_experts), torch.float32, device)
        self.experts = ExpertFFN(cfg.padded_experts, d, f, cfg.glu, dtype,
                                 device)
        self.shared = (ExpertFFN(cfg.n_shared_experts, d, f, cfg.glu, dtype,
                                 device) if cfg.n_shared_experts else None)


def expert_ffn(p: ExpertFFN, xs: torch.Tensor, act: str, glu: bool,
               policy: ArithmeticPolicy) -> torch.Tensor:
    """xs: (n, C, d) -> (n, C, d), expert i on row block i."""
    if policy.mode != "exact":
        ws = p.stacks()
        return torch.stack([
            L.ffn(types.SimpleNamespace(**{k: w[i] for k, w in ws.items()}),
                  xs[i], act, glu, policy) for i in range(xs.shape[0])])
    dt = xs.dtype
    up = torch.bmm(xs, p.w_up.to(dt))
    if glu:
        up = L.ACTS[act](torch.bmm(xs, p.w_gate.to(dt))) * up
    else:
        up = L.ACTS[act](up)
    return torch.bmm(up, p.w_down.to(dt))


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig,
          policy: ArithmeticPolicy):
    """Routing and dispatch of xt (T, d): (gate (T, k) f32, ids (T, k),
    aux, cap, order, keep, dest) with order, keep and dest over the
    T * k choices in sorted-slot order."""
    t = xt.shape[0]
    e, k = cfg.padded_experts, cfg.top_k
    rpol = policy if policy.apply_to_router else EXACT
    logits = L.mm(xt.float(), p.router.float(), rpol)          # (T, E)
    if cfg.padded_experts != cfg.n_experts:
        real = torch.arange(e, device=xt.device) < cfg.n_experts
        logits = torch.where(real, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower
    # expert id first, as jax.lax.top_k breaks ties
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # the first choices counted per expert (bincount's counts, in a
    # tensor whose shape does not depend on the ids: meta tensors have it)
    first = ids[:, 0]
    density = torch.zeros(e, dtype=first.dtype, device=first.device)
    density = density.index_add_(0, first, torch.ones_like(first)).float() / t
    mean_probs = probs.mean(dim=0)
    n_data = data_size()
    if n_data > 1:
        # the whole batch's statistics (every data rank holds as many
        # tokens); the sum's adjoint gives each rank's router, after the
        # step averages gradients over the ranks, the whole batch's
        # gradient of the aux loss
        density = data_sum(density.detach()) / n_data
        mean_probs = data_sum(mean_probs) / n_data
    aux = cfg.router_aux_weight * e * torch.sum(density * mean_probs)

    cap = max(int(cfg.capacity_factor * t * k / e), 1)
    flat_ids = ids.reshape(t * k)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(e, device=xt.device), side="left")
    slot = torch.arange(t * k, device=xt.device) - seg_start[sorted_ids]
    keep = slot < cap
    dest = torch.where(keep, sorted_ids * cap + slot, e * cap)
    return gate, ids, aux, cap, order, keep, dest


def combine(contrib: torch.Tensor, order: torch.Tensor,
            k: int) -> torch.Tensor:
    """The reference's `zeros(T, d).at[order // k].add(contrib)` without
    a scatter: contrib (T * k, d) holds the gated outputs in sorted-slot
    order; token i's k of them sit at the sorted positions of its
    choices i*k .. i*k + k - 1 and are added from zero in ascending
    position, the order in which the scatter-add applies them, each
    add rounded to contrib's dtype."""
    n, d = contrib.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    at = torch.sort(inv.reshape(n // k, k), dim=1).values
    out = contrib.new_zeros((n // k, d))
    for j in range(k):
        out = out + contrib[at[:, j]]
    return out


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig,
            policy: ArithmeticPolicy = ArithmeticPolicy(), tp=None):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux_loss f32 scalar).
    `tp`: a tensor-parallel rank's `TensorParallel`, for a layer holding
    that rank's block of the experts (expert parallelism): routing and
    dispatch run whole on every rank, each rank runs its experts, and
    their outputs are gathered before the combine, which then runs in
    the single-device order."""

    def whole(stack, xs):
        return expert_ffn(stack, xs, cfg.act, cfg.glu, policy)

    run = whole if tp is None else functools.partial(tp.experts, run=whole)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.padded_experts, cfg.top_k
    xt = x.reshape(t, d)
    gate, _, aux, cap, order, keep, dest = route(p, xt, cfg, policy)
    src_token = order // k

    # dispatch: row e * cap is the trash row of the dropped choices
    buf = xt.new_zeros((e * cap + 1, d))
    buf[dest] = xt[src_token]
    out_e = run(p.experts, buf[:e * cap].reshape(e, cap, d))
    out_g = torch.cat([out_e.reshape(e * cap, d), xt.new_zeros((1, d))])
    w = gate.reshape(t * k)[order].to(x.dtype)
    combined = combine(out_g[dest] * w[:, None], order, k)

    if p.shared is not None:
        ns = cfg.n_shared_experts
        shared = run(p.shared, xt.expand(ns, t, d))
        combined = combined + shared.float().sum(dim=0).to(x.dtype)
    return combined.reshape(b, s, d), aux
