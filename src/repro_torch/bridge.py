"""Numpy bridge between the reference's parameter pytree and the port's
`Transformer`.

The reference keeps its weights as a nested dict of arrays whose
`"layers"` subtree is stacked on a leading L axis (it scans over
layers); the port holds one `Block` per layer. `params_from_numpy`
unstacks that axis, `params_to_numpy` restacks it. The port's modules
carry the reference's leaf names, so a path maps to an attribute path:
`layers/moe/experts/w_up` (L, E, d, f) is `layers[i].moe.experts.w_up`
(E, d, f), and likewise the router (L, d, E) and the shared experts
(L, Ns, d, f). Both take and give
numpy arrays only, so this module needs no JAX: a caller converts with
`jax.tree.map(np.asarray, params)` on its side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _target(model: Transformer, path: tuple[str, ...],
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


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device="cuda") -> Transformer:
    """The port's model holding the weights of a reference parameter
    tree (numpy leaves). Every leaf of the tree must land somewhere and
    every parameter of the model must be covered."""
    model = Transformer(cfg, device=device)
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


def params_to_numpy(model: Transformer) -> dict:
    """The reference-layout tree (f32 numpy leaves, layers restacked on
    a leading L axis) of the port's model."""
    tree: dict = {}
    layer_leaves: dict[str, list[np.ndarray]] = {}
    for name, p in model.named_parameters():
        arr = p.detach().float().cpu().numpy()
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
