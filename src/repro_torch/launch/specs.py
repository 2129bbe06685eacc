"""input_specs(): meta-tensor stand-ins for every input of one rank's
step (the port's counterpart of `repro.launch.specs`, whose
`jax.ShapeDtypeStruct`s they replace). Meta tensors carry a shape and a
dtype and no storage, so nothing is ever allocated; the dry run
(`launch.dryrun.count_cell`) runs its steps on these inputs.

The reference's specs are the whole model's, which its partitioner
cuts; the port's are one rank's, the model a shape-only `nn.Module`
holding the rank's blocks: the training placement's
(`data_parallel.shape_rank_model`) or the serving one's
(`tensor_parallel.shape_shard`, the whole model on one model rank). On
a mesh of one rank they are the reference's leaf by leaf, parameters
and optimizer state keyed by parameter name (the port's unstacked
layers, `layers.<i>.`, which `parallel.sharding.reference_path` names
after the reference's stacked leaf), with one difference on purpose:
the reference casts every serving parameter to the compute dtype,
while a serving model of the port keeps the norm scales, the MoE
router, audio's embedding and the recurrent layers' vectors in f32, as
its forward reads them (`models/transformer.py`). A cache's `index` is
a host int, as in the port's models.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeCell
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import frontend
from repro_torch.models import model as modellib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import tensor_parallel as tpl

META = "meta"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                 with_labels: bool = True) -> dict:
    tok = _meta(frontend.token_shape(cfg, batch, seq), torch.int32)
    out = {"tokens": tok}
    if with_labels:
        out["labels"] = _meta(tok.shape, torch.int32)
    if cfg.modality == "vlm":
        out["prefix_embeds"] = _meta(
            (batch, frontend.VLM_PREFIX_TOKENS, cfg.d_model),
            transformer.torch_dtype(cfg.compute_dtype))
    return out


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, n_model: int = 1) -> dict:
    """The decode carry's meta tensors; over n_model > 1 model ranks a
    rank's part (`tensor_parallel.rank_cache`)."""
    if n_model > 1:
        return tpl.rank_cache(cfg, n_model, batch, max_len, dtype=dtype,
                              device=META)
    return modellib.init_cache(cfg, batch, max_len, dtype=dtype, device=META)


def serve_model(cfg: ModelConfig, rmesh,
                policy: ArithmeticPolicy = ArithmeticPolicy()):
    """A serving rank's shape-only model over the mesh's model ranks."""
    n = rmesh.size("model")
    if n == 1:
        return modellib.empty(cfg, device=META)
    return tpl.shape_shard(cfg, rmesh.index("model"), n, policy)


def local_rows(cfg: ModelConfig, rmesh, batch: int) -> int:
    """A rank's rows of a global batch (`batch_specs`)."""
    axis = sh.batch_specs(cfg, rmesh.mesh, batch)["tokens"][0]
    if axis is None:
        return batch
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= rmesh.mesh.shape[a]
    return batch // n


def input_specs(cfg: ModelConfig, cell: ShapeCell, rmesh,
                rules: sh.ShardingRules = sh.ShardingRules(),
                policy: ArithmeticPolicy = ArithmeticPolicy(), *,
                cache_len: int | None = None, cache_dtype=torch.bfloat16,
                cache_index: int | None = None) -> dict:
    """All inputs of rank `rmesh`'s step of one (arch x shape) cell, as
    meta tensors (`rmesh` a `launch.mesh.RankMesh`).

    train:   {model, opt_state (AdamW's, keyed by `named_shards`),
              batch{tokens, labels[, prefix_embeds]}} (the global
              batch: the step takes the rank's rows)
    prefill: {model, batch{tokens[, prefix_embeds]}, cache (empty)}
    decode:  {model, tokens (B, 1[, C]), cache (writing slot
              `cache_index`, default the last)}

    A serving cell's batch and cache are the rank's rows, the cache of
    `cache_len` slots (default seq_len + a vlm prefix) of `cache_dtype`
    holding the rank's part (`tensor_parallel.rank_cache`: its KV
    heads, its part of a recurrent state).
    """
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        model = dp.shape_rank_model(cfg, rmesh, policy, rules)
        return {"model": model,
                "opt_state": adamw_init(dict(tpl.named_shards(model))),
                "batch": batch_shapes(cfg, b, s)}
    if cell.kind not in ("prefill", "decode"):
        raise ValueError(f"unknown cell kind {cell.kind!r}")
    model = serve_model(cfg, rmesh, policy)
    rows = local_rows(cfg, rmesh, b)
    max_len = cache_len or s + frontend.n_prefix_tokens(cfg)
    cache = cache_shapes(cfg, rows, max_len, dtype=cache_dtype,
                         n_model=rmesh.size("model"))
    if cell.kind == "prefill":
        return {"model": model,
                "batch": batch_shapes(cfg, rows, s, with_labels=False),
                "cache": cache}
    cache["index"] = max_len - 1 if cache_index is None else cache_index
    return {"model": model,
            "tokens": _meta(frontend.token_shape(cfg, rows, 1), torch.int32),
            "cache": cache}
