"""Tensor-parallel serving: where each rank's part of the weights lies,
how it is cut, and the forward's seams that exchange activations
(the port's counterpart of what GSPMD derives from
`repro.parallel.sharding` for `repro.serve.sharded_backend`).

Placement (`placement`) is the reference's `param_specs` with FSDP off
over one "model" axis of n ranks, with three choices of the port's:

  * attention: when n divides the KV heads, wq / wk / wv split by
    columns on whole heads and the pool on KV heads, each rank
    attending over its heads. Otherwise the attention weights stay
    whole on every rank (the reference splits wk / wv by columns there
    too and lets GSPMD gather them): each rank computes every head, and
    the attention core either splits the sequence (the ring / split-KV
    dataflow cores of `serve.sharded_backend`) or runs whole.
  * wo and w_down: the reference's row split, with one all-reduce of
    the f32 partial products rounded to the compute dtype once, under
    the exact policy. Under a quantized policy a column split instead:
    the input is gathered first, so every product keeps its whole K
    and its single-device value bit for bit (the artemis mode's MOMCAP
    groups of 20 and their ordered scan would move with a K split, and
    its integer partials could not be summed), and the output columns
    are gathered after.
  * shared experts: split by expert where n divides their count, whole
    on every rank otherwise.

A quantized policy takes per-tensor scales (`quant_scale` over the
whole tensor). When a matrix is cut, the absmax of its whole leaf is
kept in the rank's model, in `leaf_absmax` next to `placement`, and
`TensorParallel.mm` passes it to `layers.mm` for every product on one
of the rank's weights; the attention's quantized operands, split by
heads, take the group's max of their absmax (`TensorParallel.all_max`).
So every scale is the single-device one.

`TensorParallel` holds a rank's group and the seams: the products on
the rank's weights, the vocab-parallel embedding lookup (a masked
lookup and a sum), the logits' gather, the output projections and the
expert-parallel expert products. The forward reads what is split from
the local weights' shapes; the placement's only other records it reads
are `leaf_absmax` and whether the vocab is cut.

The seams carry gradients (`parallel.comm`'s training collectives), so
the same forward trains a rank's part of a dense or MoE model
(`parallel.data_parallel`): the input of a column-split product sums
its gradient over the ranks, a row-split product's partial sums and
the vocab-split lookup sum with an identity backward, and a gathered
output hands each rank its own block of the gradient. A training
rank's weights change every step, so its model keeps no `leaf_absmax`
but `tp_cut`: {weight: whether its matrix is cut over the ranks}, by
tensor identity (weak keys), for every weight the forward reads (the
data-parallel gather enters each weight it gathers). A quantized
product on a cut one takes the group's max of its absmax; a product on
any tensor not in the table is refused, as in serving.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import layers as L
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (ShardingRules, local_shape,
                                           param_shapes, param_specs,
                                           shard_leaf)

AXIS = "model"


def serve_mesh_shape(n: int) -> MeshShape:
    """The one-axis mesh of tensor-parallel serving."""
    return MeshShape(((AXIS, n),))


def placement(cfg: ModelConfig, shapes: dict[str, tuple], n: int,
              policy: ArithmeticPolicy) -> dict:
    """{parameter name: spec} of a rank's part over n ranks (module
    docstring)."""
    if policy.act_quant_axis is not None or \
            policy.weight_quant_axis is not None:
        raise ValueError(
            "tensor-parallel serving keeps the per-tensor scales of the "
            "single device; act_quant_axis and weight_quant_axis must be "
            "None")
    specs = param_specs(cfg, shapes, serve_mesh_shape(n),
                        ShardingRules(fsdp=False))
    col = (None, AXIS) if cfg.d_model % n == 0 else ()
    for name, spec in specs.items():
        parts = name.split(".")
        if "attn" in parts and cfg.n_kv_heads % n:
            specs[name] = ()
        elif "shared" in parts and spec[:1] != (AXIS,):
            specs[name] = ()
        elif policy.is_quantized() and parts[-1] in ("wo", "w_down") \
                and spec[:1] == (AXIS,) and len(spec) == 2:
            specs[name] = col
    return specs


def _cuts_products(name: str, spec: tuple, ndim: int) -> bool:
    """Whether `spec` cuts a dim of the matrices a leaf holds (its last
    two). A stack of matrices (experts) may be cut only by matrix: its
    products each take their own matrix's scale, which is whole."""
    cut = any(a is not None for a in spec[-2:]) if ndim >= 2 else False
    if cut and ndim > 2:
        raise ValueError(f"{name}: a stack of matrices is cut only along "
                         f"its stack, got spec {spec}")
    return cut


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return (model.get_submodule(path) if path else model), leaf


def empty_shard(cfg: ModelConfig, specs: dict, n: int, device) -> nn.Module:
    """The family's serving model with every parameter at its local
    shape (zeros), built without ever holding the whole model."""
    model = modellib.empty(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        owner, leaf = _owner(model, name)
        setattr(owner, leaf, L.param(local_shape(p.shape, specs[name], n),
                                     p.dtype, device))
    return model


@torch.no_grad()
def fill_shard(shard: nn.Module, leaves, specs: dict, rank: int,
               n: int) -> nn.Module:
    """Copy rank `rank`'s part of each whole leaf of `leaves` ((name,
    tensor) pairs, every parameter once) into `shard`. The shard records
    its `placement` (the specs), its `shard_rank` and, for every matrix
    that is cut, the whole leaf's absmax in the stored dtype as an f32
    scalar (`leaf_absmax`, by name): a quantized policy's per-tensor
    scale of that weight."""
    covered, absmax = set(), {}
    for name, full in leaves:
        owner, leaf = _owner(shard, name)
        p = getattr(owner, leaf)
        full = full.to(p.device, p.dtype)
        p.copy_(shard_leaf(full, specs[name], rank, n))
        if _cuts_products(name, specs[name], p.dim()):
            lo, hi = torch.aminmax(full)
            absmax[name] = torch.clamp_min(
                torch.maximum(hi, -lo).float(), 1e-8)
        covered.add(name)
    missing = set(specs) - covered
    if missing:
        raise ValueError(f"no leaf given for {sorted(missing)}")
    shard.placement = specs
    shard.leaf_absmax = absmax
    shard.shard_rank = rank
    return shard


def shard_of(model: nn.Module, cfg: ModelConfig, rank: int, n: int,
             policy: ArithmeticPolicy) -> nn.Module:
    """Rank `rank`'s part of a whole serving model, as a new model."""
    specs = placement(cfg, param_shapes(model), n, policy)
    return fill_shard(empty_shard(cfg, specs, n, model.device),
                      model.named_parameters(), specs, rank, n)


def init_shard(cfg: ModelConfig, rank: int, n: int, policy: ArithmeticPolicy,
               seed: int = 0, device="cuda") -> nn.Module:
    """Rank `rank`'s part of `modellib.init(cfg, seed, device)`, bit for
    bit: the leaves are drawn whole, in the same order from the same
    generator, one at a time, and cut as they come, so the largest
    transient is one leaf, not the model."""
    meta = modellib.empty(cfg, device="meta")
    specs = placement(cfg, param_shapes(meta), n, policy)
    shard = empty_shard(cfg, specs, n, device)
    gen = torch.Generator(device=shard.device)
    gen.manual_seed(seed)
    return fill_shard(shard, meta.init_values(gen, shard.device), specs,
                      rank, n)


def shape_shard(cfg: ModelConfig, rank: int, n: int,
                policy: ArithmeticPolicy) -> nn.Module:
    """Rank `rank`'s part of the serving model as shapes only (the dry
    run's): every parameter a meta tensor of its local shape, the
    placement recorded and a meta absmax kept for each cut matrix, no
    value drawn or copied."""
    meta = modellib.empty(cfg, device="meta")
    specs = placement(cfg, param_shapes(meta), n, policy)
    shard = empty_shard(cfg, specs, n, "meta")
    shard.placement = specs
    shard.leaf_absmax = {
        name: torch.empty((), dtype=torch.float32, device="meta")
        for name, p in shard.named_parameters()
        if _cuts_products(name, specs[name], p.dim())}
    shard.shard_rank = rank
    return shard


class TensorParallel:
    """A rank's view of the tensor-parallel group and the forward's seams
    (module docstring). `group` is the process group, `rank` this
    rank's index in it, `n` its size, `model` the rank's part of the
    weights (`fill_shard`'s)."""

    def __init__(self, group, rank: int, n: int, cfg: ModelConfig,
                 model: nn.Module):
        self.group, self.rank, self.n = group, rank, n
        self.d_model = cfg.d_model
        self.vocab = cfg.padded_vocab
        self.vocab_cut = AXIS in model.placement[
            "embed" if cfg.tie_embeddings else "head"]
        hd = cfg.resolved_head_dim
        self.attn_cut = cfg.n_kv_heads % n == 0
        div = n if self.attn_cut else 1
        self.attn_dims = L.AttnDims(cfg.n_heads // div,
                                    cfg.n_kv_heads // div, hd)
        self.attn_k = cfg.n_heads * hd
        # a training rank's {weight: cut} (module docstring), else None
        self._cut = getattr(model, "tp_cut", None)
        # id -> (weight, its whole leaf's absmax or None if it is whole)
        self._weights = {}
        if self._cut is not None:
            return
        for name, p in model.named_parameters():
            cut = _cuts_products(name, model.placement[name], p.dim())
            if cut and name not in model.leaf_absmax:
                raise ValueError(f"{name} is cut but its whole leaf's "
                                 f"absmax is not kept")
            self._weights[id(p)] = (p, model.leaf_absmax.get(name))

    def mm(self, x: torch.Tensor, w: torch.Tensor,
           policy: ArithmeticPolicy) -> torch.Tensor:
        """`layers.mm` on one of the rank's weights, a cut one scaled by
        its whole leaf's absmax. A quantized product on any other
        tensor (a slice or a copy of a weight) is refused: its scale
        could not be the single device's. A training rank's weight
        (`tp_cut`) is scaled by the group's max of its absmax where it
        is cut, and its input then sums its gradient over the ranks."""
        if self._cut is not None:
            cut = self._cut.get(w)
            if cut is None:
                raise ValueError("a tensor-parallel training product takes "
                                 "one of the rank's weights as read")
            absmax = None
            if cut:
                x = comm.copy_sum_grad(x, self.group)
                if policy.is_quantized():
                    absmax = self.all_max(w.detach().abs().amax().float())
            return L.mm(x, w, policy, b_absmax=absmax)
        if policy.mode == "exact":
            return L.mm(x, w, policy)
        held, absmax = self._weights.get(id(w), (None, None))
        if held is not w:
            raise ValueError("a quantized tensor-parallel product takes "
                             "one of the rank's weights as they are held")
        return L.mm(x, w, policy, b_absmax=absmax)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x, self.group, "max")

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return comm.all_gather(x, self.group, dim)

    def embedding(self, tokens: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
        """The rows of a vocab-split table: each rank looks up the tokens
        in its rows, zeros elsewhere, and the sum over ranks (exact: one
        rank holds each row) is every row whole."""
        v_local = table.shape[0]
        if v_local == self.vocab:
            return F.embedding(tokens, table)
        local = tokens - self.rank * v_local
        hit = (local >= 0) & (local < v_local)
        rows = F.embedding(torch.where(hit, local, 0), table)
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        return comm.reduce_sum(rows.float(), self.group).to(table.dtype)

    def logits(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """The model's logits (B, S, V), every rank's vocab columns
        gathered."""
        if not self.vocab_cut:
            return model.logits(x)
        out = model.logits(comm.copy_sum_grad(x, self.group))
        return comm.gather_split_grad(out, self.group, -1)

    def partial_grad(self, name: str) -> bool:
        """Whether a rank's gradient of whole leaf `name` is its heads'
        part only, to be summed over the ranks: the qk-norm scales,
        applied to each rank's own heads where they are split."""
        return self.attn_cut and name.rsplit(".", 1)[-1] in ("q_norm",
                                                             "k_norm")

    def attention(self) -> dict:
        """The keyword arguments of `layers.attention` on this rank's
        heads: their counts, the products and the quantized scores'
        group max where the heads are split."""
        return dict(dims=self.attn_dims, proj=self.mm,
                    out=functools.partial(self.out_proj, k_full=self.attn_k),
                    amax=self.all_max if self.attn_cut else None)

    def out_proj(self, x: torch.Tensor, w: torch.Tensor,
                 policy: ArithmeticPolicy, k_full: int) -> torch.Tensor:
        """x @ w back to the whole d_model on every rank, for the product
        after a column-parallel one (wo after the heads, w_down after
        w_up): x (..., K_local) is this rank's part of a K = k_full
        input. A row-split w sums the ranks' f32 partial products and
        rounds once; otherwise x is gathered whole, and a column-split
        w's output columns are gathered after the product."""
        if x.shape[-1] == w.shape[0] < k_full:
            if policy.is_quantized():
                raise ValueError("a quantized policy takes wo and w_down "
                                 "split by columns (placement)")
            part = torch.matmul(x.float(), w.float())
            return comm.reduce_sum(part, self.group).to(x.dtype)
        if x.shape[-1] < w.shape[0]:
            x = comm.gather_split_grad(x, self.group, -1)
        y = self.mm(x, w, policy)
        if y.shape[-1] < self.d_model:
            return comm.gather_split_grad(y, self.group, -1)
        return y

    def experts(self, stack: nn.Module, xs: torch.Tensor, run) -> torch.Tensor:
        """Expert parallelism: `run(stack, rows)` over this rank's block
        of the expert stack (xs: (E, C, d), one row block an expert),
        the blocks of every rank gathered back to (E, C, d)."""
        n_local = stored(stack, "w_up").shape[0]
        if n_local == xs.shape[0]:
            return run(stack, xs)
        xs = comm.copy_sum_grad(xs, self.group)
        lo = self.rank * n_local
        return comm.gather_split_grad(run(stack, xs[lo:lo + n_local]),
                                      self.group, 0)


def stored(module: nn.Module, leaf: str) -> torch.Tensor:
    """The tensor `module` stores for `leaf`: a data-parallel rank's
    shard where the leaf is gathered at each use (`parametrize`), never
    the gathered one."""
    if parametrize.is_parametrized(module, leaf):
        return module.parametrizations[leaf].original
    return getattr(module, leaf)


def named_shards(model: nn.Module):
    """(parameter name, stored tensor) of every parameter, under the
    names `param_specs` and the bridge read: a gathered leaf's
    `parametrizations.<leaf>.original` is named `<leaf>`."""
    for name, p in model.named_parameters():
        yield name.replace("parametrizations.", "").replace(
            ".original", ""), p
