"""Partition specs: DP / TP / EP / SP over a mesh (counterpart of
`repro.parallel.sharding`).

Mesh axes (`launch.mesh.make_production_mesh`):
  pod    outermost data parallelism (multi-pod only)
  data   batch DP + FSDP weight sharding (ZeRO-3 style)
  model  tensor parallelism (heads / d_ff / vocab / experts) and, for
         decode, SEQUENCE sharding of the KV cache (the ARTEMIS token
         dataflow mapped onto the TP axis)

A spec is a tuple with one entry a dimension: a mesh axis name, a tuple
of them, or None (that dimension whole on every rank), the entries of
the reference's `PartitionSpec`; () replicates. A mesh is anything with
a `shape` mapping of axis name to size (`launch.mesh.MeshShape`).

The parameter rules are the reference's table, name-matched over the
reference's paths of the leaves, with its divisibility guard: a dim
that the axis size does not divide stays whole. `param_specs` takes the
port's named parameters; a leaf under `layers.<i>.` is the reference's
stacked leaf less its leading L axis, and its spec is the reference's
less that axis's None. `shard_leaf` cuts a rank's part of a tensor by
its spec and `join_parts` puts the ranks' parts back together.

The port's placements add one kind of entry, `Segments`: a dim made of
segments, some cut over the axis and some whole on every rank (Mamba2's
`in_proj` columns [z, x, B, C, dt]: z, x and dt by SSD heads, B and C
whole), or every segment cut (rwkv6's key channels of each head).
`entry_axis` and `spec_axes` name the axes of any entry.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.models.config import ModelConfig

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry that cuts a dim segment by segment: the dim is the
    concatenation of segments of `sizes`, each one marked in `cut` split
    into contiguous blocks over `axis` and each other one whole on every
    rank. A rank's part of the dim is, in the dim's order, its block of
    every cut segment and every whole segment."""
    axis: str
    sizes: tuple[int, ...]
    cut: tuple[bool, ...]

    def local_sizes(self, n: int) -> list[int]:
        return [s // n if c else s for s, c in zip(self.sizes, self.cut)]


def entry_axis(entry):
    """The mesh axis (or axes) of one spec entry."""
    return entry.axis if isinstance(entry, Segments) else entry


def spec_axes(spec: Spec) -> tuple:
    """The mesh axes a spec cuts, one entry each (None where whole)."""
    return tuple(entry_axis(e) for e in spec)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Knobs iterated over in the reference's perf hillclimbing."""
    fsdp: bool = True              # shard the non-TP weight dim over `data`
    seq_parallel: bool = False     # activations S over `model` between blocks
    decode_kv_seq_shard: bool = True   # KV cache S over `model` (split-KV)
    expert_axis: str = "model"     # EP axis for MoE expert leaves


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def _guard(mesh, dim: int, axis):
    """`axis` where it divides `dim` evenly, else None (the dim stays
    whole)."""
    size = _axis_size(mesh, axis)
    if size == 1 or dim % size != 0:
        return None
    return axis


# (pattern over the reference's leaf path, per-dim logical axes applied
# right-aligned to the leaf's trailing dims): the reference's table
_RULES: list[tuple[str, tuple]] = [
    # -- MoE (match before generic ffn rules) --
    (r"experts.*w_(up|gate)", ("ep", None, None)),       # (E, d, d_ff_e)
    (r"experts.*w_down",      ("ep", None, None)),       # (E, d_ff_e, d)
    (r"shared.*w_(up|gate)",  ("ep", "fsdp", "tp")),     # (Ns, d, d_ff_e)
    (r"shared.*w_down",       ("ep", "tp", "fsdp")),
    (r"router",               ("fsdp", None)),           # (d, E) exact fp32
    # -- attention --
    (r"\['wq'\]|\['wk'\]|\['wv'\]", ("fsdp", "tp")),     # (d, H*hd)
    (r"\['wo'\]",             ("tp", "fsdp")),           # (H*hd, d)
    # -- FFN --
    (r"w_(up|gate)",          ("fsdp", "tp")),           # (d, d_ff)
    (r"w_down",               ("tp", "fsdp")),           # (d_ff, d)
    # -- embeddings / head --
    (r"embed",                ("tp", "fsdp")),           # (V, d) vocab-TP
    (r"head",                 ("fsdp", "tp")),           # (d, V)
    # -- mamba2 --
    (r"in_proj",              ("fsdp", "tp")),           # (d, 2di+2n+h)
    (r"out_proj",             ("tp", "fsdp")),           # (di, d)
    (r"conv_w",               (None, "tp")),             # (W, C)
    (r"conv_b",               ("tp",)),
    # -- rwkv6 --
    (r"\['wr'\]|\['wg'\]",    ("fsdp", "tp")),
    (r"cm_wk",                ("fsdp", "tp")),
    (r"cm_wv",                ("tp", "fsdp")),
    (r"cm_wr",                ("fsdp", "tp")),
    (r"td_w1|maa_w1",         ("fsdp", None)),
    (r"td_w2",                (None, "fsdp")),
    (r"maa_w2",               (None, None, "fsdp")),
]


def _logical_to_mesh(logical, mesh, rules: ShardingRules):
    if logical == "tp":
        return "model"
    if logical == "ep":
        return rules.expert_axis
    if logical == "fsdp":
        if not rules.fsdp:
            return None
        axes = dp_axes(mesh)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    return None


def reference_path(name: str) -> str:
    """The reference's key path of the port's parameter `name`: the
    layer index of `layers.<i>.` dropped (the reference stacks layers
    on a leading axis), e.g. layers.3.attn.wq -> ['layers']['attn']['wq']."""
    return "".join(f"['{part}']" for part in name.split(".")
                   if not part.isdigit())


def _spec_for_leaf(path: str, shape: tuple, mesh,
                   rules: ShardingRules) -> Spec:
    for pattern, logical in _RULES:
        if re.search(pattern, path):
            ndim = len(shape)
            spec: list = [None] * ndim
            # right-align the logical template onto trailing dims
            tmpl = logical[-ndim:] if len(logical) > ndim else logical
            off = ndim - len(tmpl)
            for i, ax in enumerate(tmpl):
                mesh_ax = _logical_to_mesh(ax, mesh, rules)
                spec[off + i] = _guard(mesh, shape[off + i], mesh_ax)
            # never shard the same mesh axis twice in one spec
            seen: set = set()
            for i, s in enumerate(spec):
                flat = s if isinstance(s, tuple) else (s,)
                if s is not None and seen & set(flat):
                    spec[i] = None
                else:
                    seen |= set(flat)
            return tuple(spec)
    return ()  # replicate (norms, scalars, luts, small loras)


def param_shapes(model: torch.nn.Module) -> dict[str, tuple]:
    """{parameter name: shape} of a port model (a meta-device model
    will do)."""
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def param_specs(cfg: ModelConfig, shapes: dict[str, tuple], mesh,
                rules: ShardingRules = ShardingRules()) -> dict[str, Spec]:
    """{parameter name: spec} for the port's parameters of these shapes
    (`param_shapes`)."""
    return {name: _spec_for_leaf(reference_path(name), tuple(shape), mesh,
                                 rules)
            for name, shape in shapes.items()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_axes(mesh):
    axes = dp_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_specs(cfg: ModelConfig, mesh, batch: int) -> dict:
    """Specs for {"tokens", "labels", optional "prefix_embeds"}."""
    bax = batch_axes(mesh)
    if _axis_size(mesh, bax) > batch:
        bax = None  # degenerate cells (B=1): replicate the batch
    tok = (bax, None, None) if cfg.modality == "audio" else (bax, None)
    out = {"tokens": tok, "labels": tok}
    if cfg.modality == "vlm":
        out["prefix_embeds"] = (bax, None, None)
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int,
                rules: ShardingRules = ShardingRules()) -> dict:
    """Decode-cache specs: the KV sequence axis over `model` (the token
    dataflow; attention is split-KV with an LSE-exact merge)."""
    bax = batch_axes(mesh)
    if _axis_size(mesh, bax) > batch:
        bax = None
    seq_ax = "model" if rules.decode_kv_seq_shard else None
    if cfg.family == "rwkv6":
        # O(1) state: H rarely divides the TP degree; the value dim N does
        h = cfg.d_model // cfg.ssm_head_dim
        h_ax = _guard(mesh, h, "model")
        n_ax = None if h_ax else _guard(mesh, cfg.ssm_head_dim, "model")
        return {
            "layers": {
                "x_tm": (None, bax, None),
                "x_cm": (None, bax, None),
                "wkv": (None, bax, h_ax, n_ax, None),
            },
            "index": (),
        }
    if cfg.family == "zamba2":
        h_ax = _guard(mesh, cfg.ssm_heads, "model")
        n_ax = None if h_ax else _guard(mesh, cfg.ssm_state, "model")
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        return {
            "mamba": {
                "ssd": (None, bax, h_ax, n_ax, None),
                "conv": (None, bax, None, _guard(mesh, conv_ch, "model")),
            },
            "attn_k": (None, bax, seq_ax, None, None),
            "attn_v": (None, bax, seq_ax, None, None),
            "attn_pos": (bax, None),
            "index": (),
        }
    # dense / moe transformer KV cache: (L, B, S, KV, hd)
    return {
        "k": (None, bax, seq_ax, None, None),
        "v": (None, bax, seq_ax, None, None),
        "index": (),
    }


def paged_pool_spec(cfg: ModelConfig, mesh) -> Spec:
    """Spec of the serve layer's paged KV pool (L, n_pages, page, KV,
    hd): partitioned on the KV-HEAD axis where the TP degree divides it,
    replicated otherwise. The page axis is indexed by host-side block
    tables, so there is no token axis to shard; the paged token dataflow
    lives in the attention core instead."""
    return (None, None, None, _guard(mesh, cfg.n_kv_heads, "model"), None)


# ---------------------------------------------------------------------------
# named spec constructors, and the cut of a rank's part
# ---------------------------------------------------------------------------


def replicated_spec() -> Spec:
    """The fully replicated spec (scalars, metrics, optimizer step)."""
    return ()


def logits_spec(lead: tuple) -> Spec:
    """Placement of a logits output: the leading axes as given, vocab
    over the TP axis."""
    return (*lead, "model")


def moe_dispatch_specs(dp_spec, ep_axis) -> dict:
    """The MoE hierarchical-dispatch placement set: tokens (G, Tg, d),
    buffers (G, E, C, d) and the expert-major view (E, G, C, d); the
    buffers -> expert flip is the all-to-all."""
    return {
        "tokens": (dp_spec, None, None),
        "buffers": (dp_spec, None, None, None),
        "expert": (ep_axis, dp_spec, None, None),
    }


def _sharded_dims(spec: Spec, ndim: int) -> list[int]:
    return [i for i, s in enumerate(tuple(spec) + (None,) * (ndim - len(spec)))
            if s is not None]


def local_size(size: int, entry, n: int) -> int:
    """A rank's length of a dim of `size` under one spec entry over n
    ranks."""
    if entry is None:
        return size
    if isinstance(entry, Segments):
        if sum(entry.sizes) != size:
            raise ValueError(f"segments {entry.sizes} do not make a dim of "
                             f"{size}")
        return sum(entry.local_sizes(n))
    return size // n


def local_shape(shape: tuple, spec: Spec, n: int) -> tuple:
    """The shape of one rank's part of a tensor of `shape` cut by `spec`
    over n ranks (one mesh axis of size n)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(local_size(d, e, n) for d, e in zip(shape, spec))


def cut_dim(x: torch.Tensor, dim: int, entry, rank: int,
            n: int) -> torch.Tensor:
    """Rank `rank`'s part of x along `dim` under one spec entry over n
    ranks."""
    if isinstance(entry, Segments):
        pieces = torch.split(x, list(entry.sizes), dim=dim)
        return torch.cat([p.narrow(dim, rank * (p.shape[dim] // n),
                                   p.shape[dim] // n) if c else p
                          for p, c in zip(pieces, entry.cut)], dim=dim)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {n} shards")
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size)


def join_dim(parts: list, dim: int, entry) -> torch.Tensor:
    """The inverse of `cut_dim`: every rank's part, in rank order, put
    back together along `dim`."""
    if not isinstance(entry, Segments):
        return torch.cat(parts, dim=dim)
    n = len(parts)
    split = [torch.split(p, entry.local_sizes(n), dim=dim) for p in parts]
    return torch.cat([torch.cat([s[i] for s in split], dim=dim) if c
                      else split[0][i] for i, c in enumerate(entry.cut)],
                     dim=dim)


def shard_leaf(x: torch.Tensor, spec: Spec, rank: int,
               n: int) -> torch.Tensor:
    """Rank `rank`'s part of x under `spec` over n ranks (every sharded
    dim is cut into n: one mesh axis), a contiguous block of a plain
    entry's dim, a block of each cut segment of a `Segments` one."""
    dims = _sharded_dims(spec, x.dim())
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards {len(dims)} dims over one "
                         f"mesh axis")
    for i in dims:
        x = cut_dim(x, i, spec[i], rank, n)
    return x


def join_parts(parts: list, spec: Spec) -> torch.Tensor:
    """The whole tensor whose parts over len(parts) ranks under `spec`
    are `parts` (in rank order): the inverse of `shard_leaf`."""
    dims = _sharded_dims(spec, parts[0].dim())
    if not dims:
        return parts[0]
    return join_dim(list(parts), dims[0], spec[dims[0]])
