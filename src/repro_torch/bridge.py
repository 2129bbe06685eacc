"""Numpy bridge between the reference's parameter pytree and the port's
models (`models.model.empty`: `Transformer`, `RWKV6`, `Zamba2`).

The reference keeps its weights as a nested dict of arrays whose
`"layers"` subtree is stacked on a leading L axis (it scans over
layers); the port holds one module per layer. `params_from_numpy`
unstacks that axis, `params_to_numpy` restacks it. The port's modules
carry the reference's leaf names, so a path maps to an attribute path:
`layers/moe/experts/w_up` (L, E, d, f) is `layers[i].moe.experts.w_up`
(E, d, f), and likewise the router (L, d, E) and the shared experts
(L, Ns, d, f); rwkv6's `ln0/scale` is `ln0.scale`, zamba2's unstacked
shared block `shared/attn/wq` is `shared.attn.wq`. Both take and give
numpy arrays only, so this module needs no JAX: a caller converts with
`jax.tree.map(np.asarray, params)` on its side.

Training adds the optimizer state: `opt_state_to_numpy` and
`opt_state_from_numpy` carry AdamW's m, v (one tree each, the
parameters' layout) and step between the port's state (tensors by
parameter name) and the reference's `{"m", "v", "step"}`. `leaf_ndim`
gives a parameter's rank in the reference's tree, which decides its
weight decay.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _target(model: torch.nn.Module, path: tuple[str, ...],
            layer: int | None = None) -> torch.Tensor:
    obj = model.layers[layer] if layer is not None else model
    for name in path:
        obj = getattr(obj, name)
    if not isinstance(obj, torch.Tensor):
        raise KeyError(f"parameter path {'/'.join(path)} has no tensor")
    return obj


def _set(dst: torch.Tensor, src: np.ndarray, path) -> None:
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{'/'.join(path)}: shape {src.shape} does not "
                         f"match the model's {tuple(dst.shape)}")
    # through f32 so every numpy float dtype (incl. ml_dtypes bfloat16)
    # lands with one rounding, the reference's astype to the compute
    # dtype; a copy, since arrays read out of jax are not writable
    dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def leaf_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of parameter `name` as a leaf of the reference's tree:
    one more under `layers.`, whose leaves the reference stacks on L."""
    return p.dim() + (name.split(".")[0] == "layers")


def _numpy_leaves(tree: dict, cfg: ModelConfig):
    """(parameter name, f32 tensor) of every leaf of a reference tree,
    the stacked layer leaves one layer at a time."""
    for path, leaf in _leaves(tree):
        if path[0] != "layers":
            yield ".".join(path), torch.from_numpy(np.array(leaf, np.float32))
            continue
        leaf = np.asarray(leaf)
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(
                f"{'/'.join(path)}: leading axis {leaf.shape[0]} is "
                f"not n_layers={cfg.n_layers}")
        for i in range(cfg.n_layers):
            yield (f"layers.{i}." + ".".join(path[1:]),
                   torch.from_numpy(np.array(leaf[i], np.float32)))


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda",
                      train: bool = False, mesh=None,
                      policy=None) -> torch.nn.Module:
    """The port's model holding the weights of a reference parameter
    tree (numpy leaves); a trainable one (f32 master weights, gradients
    on) with `train`. Every leaf of the tree must land somewhere and
    every parameter of the model must be covered.

    With a multi-shard `serve.mesh.ServeMesh` (a serving model), the
    model holds this rank's part under `policy`'s placement
    (`parallel.tensor_parallel.placement`, exact by default): each
    whole leaf is built, as on one device, then cut."""
    if mesh is not None and not mesh.is_single:
        from repro_torch.core.policy import EXACT
        from repro_torch.parallel import tensor_parallel as tpl
        from repro_torch.parallel.sharding import param_shapes
        specs = tpl.placement(cfg, param_shapes(modellib.empty(
            cfg, device="meta")), mesh.n_shards, policy or EXACT)
        shard = tpl.empty_shard(cfg, specs, mesh.n_shards, device)
        return tpl.fill_shard(shard, _numpy_leaves(tree, cfg), specs,
                              mesh.handle.rank, mesh.n_shards)
    model = modellib.empty(cfg, device=device, train=train)
    covered = set()
    for path, leaf in _leaves(tree):
        if path[0] == "layers":
            leaf = np.asarray(leaf)
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(
                    f"{'/'.join(path)}: leading axis {leaf.shape[0]} is "
                    f"not n_layers={cfg.n_layers}")
            for i in range(cfg.n_layers):
                _set(_target(model, path[1:], i), leaf[i], path)
                covered.add(f"layers.{i}." + ".".join(path[1:]))
        else:
            _set(_target(model, path), leaf, path)
            covered.add(".".join(path))
    missing = set(dict(model.named_parameters())) - covered
    if missing:
        raise ValueError(f"parameter tree leaves no value for "
                         f"{sorted(missing)}")
    return model


def named_to_numpy(named) -> dict:
    """The reference-layout tree (f32 numpy leaves, layers restacked on
    a leading L axis) of (parameter name, tensor) pairs in module
    order: a model's weights, or tensors held by parameter name such as
    its gradients or AdamW's moments."""
    tree: dict = {}
    layer_leaves: dict[str, list[np.ndarray]] = {}
    for name, p in named:
        # a copy, never a view of the tensor: a checkpoint thread may
        # write it while the parameter is updated in place
        arr = p.detach().to("cpu", torch.float32, copy=True).numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            layer_leaves.setdefault(".".join(parts[2:]), []).append(arr)
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    for name, arrs in layer_leaves.items():
        node = tree.setdefault("layers", {})
        parts = name.split(".")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = np.stack(arrs)
    return tree


def params_to_numpy(model: torch.nn.Module) -> dict:
    """The reference-layout tree (f32 numpy leaves, layers restacked on
    a leading L axis) of the port's model."""
    return named_to_numpy(model.named_parameters())


def opt_state_to_numpy(state: dict, model: torch.nn.Module) -> dict:
    """AdamW's state as the reference's `{"m", "v", "step"}`: m and v in
    the parameters' tree layout (f32), step an int32 scalar."""
    names = [name for name, _ in model.named_parameters()]
    return {"m": named_to_numpy((n, state["m"][n]) for n in names),
            "v": named_to_numpy((n, state["v"][n]) for n in names),
            "step": np.asarray(int(state["step"]), np.int32)}


@torch.no_grad()
def opt_state_from_numpy(tree: dict, model: torch.nn.Module) -> dict:
    """The port's AdamW state for `model` from the reference's `{"m",
    "v", "step"}` (numpy leaves): m and v by parameter name, f32 on the
    model's device, every parameter covered."""
    cfg = model.cfg
    state = {"step": torch.tensor(int(tree["step"]), dtype=torch.int32,
                                  device=model.device)}
    for part in ("m", "v"):
        # a model of zeros to unstack the tree into, then its tensors
        holder = params_from_numpy(tree[part], cfg, device=model.device,
                                   train=True)
        state[part] = {name: p.detach() for name, p
                       in holder.named_parameters()}
    return state
