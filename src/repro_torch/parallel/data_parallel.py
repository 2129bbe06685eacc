"""The sharded train step's placement over a (data, model) mesh: data
parallelism with FSDP (ZeRO-3 style) over `data`, tensor parallelism
over `model` (the port's counterpart of what GSPMD derives from the
reference's `param_specs` and `batch_specs` for
`repro.launch.steps.make_train_step(mesh=, rules=)`).

Placement (`train_placement`): a spec a parameter, one entry a dim,
"data", "model" or None.
  * "model" entries are tensor-parallel serving's placement
    (`tensor_parallel.placement`: the reference's tp and ep dims, with
    the port's choices named there), for every family.
  * "data" entries are the reference's fsdp dims. Where the placement
    moved a matrix's model cut onto that dim (wo and w_down under a
    quantized policy), "data" takes the first other dim it divides.
    FSDP is storage only: a rank holds its block, and each use gathers
    the matrix back over the data ranks, so where it is cut changes no
    value.

A rank's model (`init_rank_model`, `shard_model`) holds its block of
every parameter, and AdamW's m and v the same blocks
(`shard_train_state`). A leaf with a "data" entry is gathered at every
read of it (`torch.nn.utils.parametrize`): in the forward, in the remat
recompute of its layer, and nowhere else, so no gathered weight
outlives its layer; the gather's backward reduce-scatters the gradient
into the rank's block. Parametrized leaves are stored as
`parametrizations.<leaf>.original`; `tensor_parallel.named_shards`
gives every stored block under the parameter's own name, the one
`param_specs`, `bridge.leaf_ndim` (weight decay by the reference's leaf
rank) and the checkpoint bridge read; `optim.adamw_init` and
`adamw_update` take them so. The model's `tp_cut` table holds
every weight a rank's forward reads (`tensor_parallel.TensorParallel.
mm`): the stored ones, and each gathered one as it is gathered.

The step (`launch.steps.sharded_loss_and_grads`, run by
`make_train_step` with a mesh): a rank takes its rows of the global
batch (`local_batch`, by `batch_specs`), computes `(lm_loss + aux) /
data` on them through the model's forward with the tensor-parallel
seams (`tensor_parallel`), and back-propagates; the FSDP gathers'
reduce-scatters and `whole_batch`'s sums make each rank's gradient
block the whole batch's. `global_norm` counts each leaf once over the
ranks.

`gather_train_state` is the inverse of `shard_train_state`: the whole
tensors of every leaf, on every rank.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (Segments, ShardingRules,
                                           batch_specs, cut_dim, entry_axis,
                                           local_size, param_shapes,
                                           param_specs, spec_axes)
from repro_torch.parallel.tensor_parallel import (AXIS, TensorParallel,
                                                  named_shards, placement)

DATA = "data"


def check_mesh(cfg: ModelConfig, mesh, policy: ArithmeticPolicy,
               rules: ShardingRules) -> None:
    """Refuse what the sharded step does not run: a sequence-parallel
    placement, per-channel scales (a per-tensor scale is taken over the
    ranks), a gradient through the scales (they are taken over the
    ranks without one), a mesh axis other than data and model."""
    axes = set(mesh.shape)
    if not axes <= {DATA, AXIS}:
        raise ValueError(f"the sharded train step runs over (data, model) "
                         f"meshes, got axes {sorted(axes)}")
    if rules.seq_parallel:
        raise ValueError(f"{cfg.name}: the sharded train step has no "
                         f"sequence-parallel placement "
                         f"(ShardingRules.seq_parallel)")
    if policy.is_quantized() and (policy.act_quant_axis is not None or
                                  policy.weight_quant_axis is not None):
        raise ValueError("the sharded train step keeps per-tensor scales; "
                         "act_quant_axis and weight_quant_axis must be None")
    if policy.is_quantized() and not policy.ste:
        raise ValueError("the sharded train step takes its quantized "
                         "scales over the ranks with no gradient; it needs "
                         "the straight-through estimator (ste=True)")


def _pad(spec: tuple, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def train_placement(cfg: ModelConfig, shapes: dict[str, tuple], mesh,
                    policy: ArithmeticPolicy = ArithmeticPolicy(),
                    rules: ShardingRules = ShardingRules()) -> dict:
    """{parameter name: spec} over the (data, model) `mesh` (module
    docstring)."""
    check_mesh(cfg, mesh, policy, rules)
    n_data, n_model = mesh.shape.get(DATA, 1), mesh.shape.get(AXIS, 1)
    ref = param_specs(cfg, shapes, mesh, rules)
    tp = placement(cfg, shapes, n_model, policy) if n_model > 1 else {}
    out = {}
    for name, shape in shapes.items():
        ndim = len(shape)
        spec = _pad(tp.get(name, ()), ndim)
        for i, axis in enumerate(_pad(ref[name], ndim)):
            if axis != DATA:
                continue
            free = [j for j in [i] + list(range(ndim))
                    if spec[j] is None and shape[j] % n_data == 0]
            if free:
                spec[free[0]] = DATA
        out[name] = tuple(spec)
    return out


def _size(rmesh, entry) -> int:
    axis = entry_axis(entry)
    return 1 if axis is None else rmesh.size(axis)


def local_shape(shape: tuple, spec: tuple, rmesh) -> tuple:
    """The shape of a rank's block of a tensor of `shape` under `spec`."""
    return tuple(local_size(d, e, _size(rmesh, e))
                 for d, e in zip(shape, _pad(spec, len(shape))))


def cut(x: torch.Tensor, spec: tuple, rmesh) -> torch.Tensor:
    """This rank's block of x under `spec`."""
    for i, entry in enumerate(_pad(spec, x.dim())):
        if entry is not None:
            axis = entry_axis(entry)
            x = cut_dim(x, i, entry, rmesh.index(axis), rmesh.size(axis))
    return x


def whole(x: torch.Tensor, spec: tuple, rmesh) -> torch.Tensor:
    """The whole tensor of which x is this rank's block under `spec`
    (every rank's blocks gathered, on every rank)."""
    for i, entry in enumerate(_pad(spec, x.dim())):
        axis = entry_axis(entry)
        if axis is None or rmesh.size(axis) == 1:
            continue
        group, n = rmesh.group(axis), rmesh.size(axis)
        if isinstance(entry, Segments):
            x = torch.cat([comm.all_gather(p, group, i) if c else p
                           for p, c in zip(torch.split(
                               x, entry.local_sizes(n), dim=i), entry.cut)],
                          dim=i)
        else:
            x = comm.all_gather(x, group, i)
    return x


def _held_once(t: torch.Tensor, spec: tuple, rmesh) -> torch.Tensor:
    """The elements of a rank's block that no other rank holds as well:
    a `Segments` cut's whole segments count on its axis's rank 0 only."""
    for i, entry in enumerate(_pad(spec, t.dim())):
        if isinstance(entry, Segments) and rmesh.index(entry.axis):
            t = torch.cat([p for p, c in zip(torch.split(
                t, entry.local_sizes(rmesh.size(entry.axis)), dim=i),
                entry.cut) if c], dim=i)
    return t


class _Gather(nn.Module):
    """The FSDP read of a leaf: its blocks gathered over the data ranks
    (backward: the gradient reduce-scattered), entered in the model's
    `tp_cut` table with whether the matrix is cut over the model
    ranks."""

    def __init__(self, group, dim: int, cut_over_model: bool,
                 table: WeakIdKeyDictionary):
        super().__init__()
        self.group, self.dim, self.cut = group, dim, cut_over_model
        self.table = table

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        out = comm.gather_scatter_grad(shard, self.group, self.dim)
        self.table[out] = self.cut
        return out


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return (model.get_submodule(path) if path else model), leaf


def _empty(cfg: ModelConfig, specs: dict, rmesh, device) -> nn.Module:
    """The family's training model with every parameter a zeroed block
    of its placement."""
    model = modellib.empty(cfg, device="meta", train=True)
    for name, p in list(model.named_parameters()):
        owner, leaf = _owner(model, name)
        setattr(owner, leaf, nn.Parameter(torch.zeros(
            local_shape(p.shape, specs[name], rmesh), dtype=p.dtype,
            device=device)))
    return model


@torch.no_grad()
def _fill(model: nn.Module, leaves, specs: dict, rmesh) -> nn.Module:
    """Copy this rank's block of each whole leaf ((name, tensor) pairs,
    every parameter once) into `model`, then set up the reads of its
    leaves (module docstring)."""
    covered = set()
    for name, full in leaves:
        owner, leaf = _owner(model, name)
        p = getattr(owner, leaf)
        p.copy_(cut(full.to(p.device, p.dtype), specs[name], rmesh))
        covered.add(name)
    missing = set(specs) - covered
    if missing:
        raise ValueError(f"no leaf given for {sorted(missing)}")
    return _reads(model, specs, rmesh)


def _reads(model: nn.Module, specs: dict, rmesh) -> nn.Module:
    """Set up the reads of the model's leaves (module docstring) and
    record its placement."""
    # (a placement names only axes of more than one rank)
    table = WeakIdKeyDictionary()
    for name, spec in specs.items():
        owner, leaf = _owner(model, name)
        axes = spec_axes(spec)
        if DATA in axes:
            parametrize.register_parametrization(
                owner, leaf, _Gather(rmesh.group(DATA), axes.index(DATA),
                                     AXIS in axes, table), unsafe=True)
        else:
            table[getattr(owner, leaf)] = AXIS in axes
    model.placement, model.tp_cut = specs, table
    return model


def shard_model(model: nn.Module, cfg: ModelConfig, rmesh,
                policy: ArithmeticPolicy = ArithmeticPolicy(),
                rules: ShardingRules = ShardingRules()) -> nn.Module:
    """This rank's part of a whole training model, as a new model."""
    specs = train_placement(cfg, param_shapes(model), rmesh.mesh, policy,
                            rules)
    device = next(model.parameters()).device
    return _fill(_empty(cfg, specs, rmesh, device), model.named_parameters(),
                 specs, rmesh)


def init_rank_model(cfg: ModelConfig, rmesh, policy=ArithmeticPolicy(),
                    seed: int = 0, device="cuda",
                    rules: ShardingRules = ShardingRules()) -> nn.Module:
    """This rank's part of `modellib.init(cfg, seed, device, train=True)`,
    bit for bit. The dense and MoE families draw their leaves whole, in
    the same order from the same generator, one at a time, and cut them
    as they come, so the largest transient is one leaf; the others draw
    the whole model first."""
    meta = modellib.empty(cfg, device="meta", train=True)
    specs = train_placement(cfg, param_shapes(meta), rmesh.mesh, policy,
                            rules)
    model = _empty(cfg, specs, rmesh, device)
    dev = next(model.parameters()).device
    if not hasattr(meta, "init_values"):
        full = modellib.init(cfg, seed=seed, device=dev, train=True)
        return _fill(model, full.named_parameters(), specs, rmesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _fill(model, meta.init_values(gen, dev), specs, rmesh)


def shape_rank_model(cfg: ModelConfig, rmesh,
                     policy: ArithmeticPolicy = ArithmeticPolicy(),
                     rules: ShardingRules = ShardingRules()) -> nn.Module:
    """This rank's part of the training model as shapes only (the dry
    run's): every parameter a meta block of its placement, with the
    placement and the reads `init_rank_model` sets up, and no value
    drawn or copied."""
    meta = modellib.empty(cfg, device="meta", train=True)
    specs = train_placement(cfg, param_shapes(meta), rmesh.mesh, policy,
                            rules)
    return _reads(_empty(cfg, specs, rmesh, "meta"), specs, rmesh)


def shard_train_state(model: nn.Module, opt_state: dict, cfg: ModelConfig,
                      rmesh, policy: ArithmeticPolicy = ArithmeticPolicy(),
                      rules: ShardingRules = ShardingRules()):
    """(this rank's model, its AdamW state) from the whole ones: every
    parameter, m and v cut by the same placement; the step copied."""
    part = shard_model(model, cfg, rmesh, policy, rules)
    specs = part.placement
    state = {k: {name: cut(t, specs[name], rmesh).clone()
                 for name, t in opt_state[k].items()} for k in ("m", "v")}
    state["step"] = opt_state["step"].clone()
    return part, state


def gather_train_state(model: nn.Module, opt_state: dict | None, rmesh):
    """The inverse of `shard_train_state`: ({name: whole parameter},
    {"m", "v", "step"} whole, or None without a state), on every rank."""
    specs = model.placement
    params = {name: whole(p.detach(), specs[name], rmesh)
              for name, p in named_shards(model)}
    if opt_state is None:
        return params, None
    state = {k: {name: whole(t, specs[name], rmesh)
                 for name, t in opt_state[k].items()} for k in ("m", "v")}
    return params, dict(state, step=opt_state["step"].clone())


def local_batch(cfg: ModelConfig, rmesh, batch: dict) -> dict:
    """This rank's rows of a global batch, by `batch_specs` (all of them
    where the data ranks outnumber the rows, as the reference
    replicates such a batch)."""
    specs = batch_specs(cfg, rmesh.mesh, batch["tokens"].shape[0])
    out = {}
    for key, x in batch.items():
        axis = specs.get(key, (None,))[0]
        out[key] = x if axis is None else cut(x, (axis,), rmesh)
    return out


@torch.no_grad()
def global_norm(tensors: dict, specs: dict, rmesh) -> torch.Tensor:
    """sqrt of the sum of squares of the whole leaves whose blocks
    `tensors` holds (by name), in f32, the same on every rank: each
    rank sums its blocks' squares, grouped by the axes they are cut
    over, and each group is summed over those axes' ranks, so a leaf
    held whole by several ranks counts once."""
    groups: dict[tuple, list] = {}
    for name, t in tensors.items():
        axes = tuple(sorted(a for a in spec_axes(specs[name])
                            if a is not None))
        t = _held_once(t, specs[name], rmesh)
        groups.setdefault(axes, []).append(torch.sum(torch.square(t.float())))
    total = []
    for axes in sorted(groups):
        s = torch.sum(torch.stack(groups[axes]))
        for axis in axes:
            s = comm.all_reduce(s, rmesh.group(axis))
        total.append(s)
    return torch.sqrt(torch.sum(torch.stack(total)))


def tensor_parallel(model: nn.Module, cfg: ModelConfig, rmesh):
    """This rank's tensor-parallel seams over the model ranks, or None
    on a mesh of one model rank."""
    if rmesh.size(AXIS) == 1:
        return None
    return TensorParallel(rmesh.group(AXIS), rmesh.index(AXIS),
                          rmesh.size(AXIS), cfg, model)


def whole_batch(model: nn.Module, loss: torch.Tensor, grads: dict, rmesh,
                tp: TensorParallel | None):
    """(the whole batch's loss, gradients) from this rank's: its rows'
    loss averaged over the data ranks; every gradient block not
    reduce-scattered by its FSDP read summed over the data ranks (the
    step back-propagates `(loss + aux) / data`), and the parts each
    model rank reads for its own part of the work only
    (`TensorParallel.sum_partial`) over the model ranks first. Every
    rank returns the same loss."""
    n_data = rmesh.size(DATA)
    for name, g in grads.items():
        if tp is not None:
            g = tp.sum_partial(name, g)
        if n_data > 1 and DATA not in spec_axes(model.placement[name]):
            g = comm.all_reduce(g, rmesh.group(DATA))
        grads[name] = g
    if n_data > 1:
        loss = comm.all_reduce(loss, rmesh.group(DATA)) / n_data
    return loss, grads
