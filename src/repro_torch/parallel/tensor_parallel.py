"""Tensor parallelism: where each rank's part of the weights lies, how it
is cut, and the forward's seams that exchange activations (the port's
counterpart of what GSPMD derives from `repro.parallel.sharding` for
`repro.serve.sharded_backend` and the steps of `repro.launch.steps`
with a mesh), for every family.

Placement (`placement`) is the reference's `param_specs` with FSDP off
over one "model" axis of n ranks, with these choices of the port's:

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
    on every rank otherwise (zamba2's shared transformer block is a
    dense layer's, split as one).
  * rwkv6 (`_rwkv6_layer`): where n divides the wkv heads, wr, wk, wv,
    td_w2's columns, td_base and u by heads; each head's recurrence
    runs on its rank and the heads' outputs are gathered. Otherwise
    (40 heads over 16 ranks) by each head's key channels, as the
    reference's `cache_specs` cuts the wkv state: wr, wk, td_w2, td_base
    by a `Segments` entry (a block of every head), u by its second dim,
    wv whole; each state element still evolves exactly on one rank, and
    the readout o sums the ranks' partial contractions over the key
    channels in f32 (one all-reduce a layer). wg, cm_wk and cm_wr by
    contiguous columns; wo and cm_wv as wo above; the token-shift
    mixes, the LoRAs but td_w2, and the norms whole.
  * Mamba2 (`_mamba2_layer`, zamba2's layers): in_proj's columns [z, x,
    B, C, dt] are a `Segments` entry, z, x and dt cut by SSD heads and B
    and C whole on every rank (every head reads them); the conv's [x,
    B, C] channels likewise; A_log, dt_bias and D by heads; out_proj as
    wo above; the gated norm's scale whole.
  * the embedding and the head by vocab where n divides the padded
    vocab (audio: each codebook's (V, d) table and (d, V) head).
  * the norms over a whole width that a rank holds only part of
    (rwkv6's `ln_x` over d, Mamba2's gated RMSNorm over d_inner) run on
    their input gathered whole (`TensorParallel.whole_out`), so every
    later product sees the single device's values.

A quantized policy takes per-tensor scales (`quant_scale` over the
whole tensor). When a matrix is cut, the absmax of its whole leaf is
kept in the rank's model, in `leaf_absmax` next to `placement`, and
`TensorParallel.mm` passes it to `layers.mm` for every product on one
of the rank's weights; the attention's quantized operands, split by
heads, take the group's max of their absmax (`TensorParallel.all_max`).
So every scale is the single-device one.

`TensorParallel` holds a rank's group and the seams: the products on
the rank's weights, the vocab-parallel embedding lookup (a masked
lookup and a sum), the logits' gather, the output projections (after a
column-parallel product, or after a norm over a whole width), the
expert-parallel expert products, and the entry of a whole activation
into a rank's part of the work, a partial sum and a gather of a split
activation. The forward reads what is split from the local weights'
shapes; the placement's only other records it reads are `leaf_absmax`,
whether the vocab is cut and which segments are whole. A rank's decode
carry holds its part (`cache_placement`, `rank_cache`).

The seams carry gradients (`parallel.comm`'s training collectives), so
the same forward trains a rank's part of any family
(`parallel.data_parallel`): the input of a column-split product (and
any whole activation entering a rank's part of the work) sums its
gradient over the ranks, a row-split product's partial sums and the
vocab-split lookup sum with an identity backward, and a gathered
output hands each rank its own block of the gradient. Where a rank
reads a whole leaf for its own part of the work only (the qk-norm
scales over split heads, Mamba2's B and C segments), the gradient is
summed over the ranks after the backward (`sum_partial`). A training
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
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import layers as L
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (Segments, ShardingRules,
                                           local_shape, param_shapes,
                                           param_specs, shard_leaf,
                                           spec_axes)

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
    quant = policy.is_quantized()
    specs = param_specs(cfg, shapes, serve_mesh_shape(n),
                        ShardingRules(fsdp=False))
    col = (None, AXIS) if cfg.d_model % n == 0 else ()
    for name, spec in specs.items():
        parts = name.split(".")
        if "attn" in parts and cfg.n_kv_heads % n:
            specs[name] = ()
        elif "moe" in parts and "shared" in parts and spec[:1] != (AXIS,):
            specs[name] = ()
        elif quant and parts[-1] in ("wo", "w_down") \
                and spec[:1] == (AXIS,) and len(spec) == 2:
            specs[name] = col
    layer = {"rwkv6": _rwkv6_layer, "zamba2": _mamba2_layer}.get(cfg.family)
    if layer is not None:
        own = layer(cfg, n, quant)
        for name in specs:
            parts = name.split(".")
            if parts[0] == "layers":
                specs[name] = own.get(".".join(parts[2:]), ())
    return specs


def _rwkv6_layer(cfg: ModelConfig, n: int, quant: bool) -> dict:
    """An rwkv6 layer's specs by leaf (module docstring): the wkv heads
    split by heads where n divides them, else by each head's key
    channels; the gate, the output and the channel mix by contiguous
    columns or rows; the token-shift mixes, the LoRAs but td_w2 and
    the norms whole."""
    d, hn = cfg.d_model, cfg.ssm_head_dim
    h = d // hn
    if d % n or cfg.d_ff % n or (h % n and hn % n):
        raise ValueError(f"{cfg.name}: rwkv6 over {n} ranks needs n to "
                         f"divide d_model {d}, d_ff {cfg.d_ff} and the "
                         f"{h} heads or their size {hn}")
    if h % n == 0:
        keys, values, u, vec = (None, AXIS), (None, AXIS), (AXIS, None), \
            (AXIS,)
    else:
        seg = Segments(AXIS, (hn,) * h, (True,) * h)
        keys, values, u, vec = (None, seg), (), (None, AXIS), (seg,)
    out = (None, AXIS) if quant else (AXIS, None)
    return {"wr": keys, "wk": keys, "td_w2": keys, "td_base": vec, "u": u,
            "wv": values, "wg": (None, AXIS), "wo": out,
            "cm_wk": (None, AXIS), "cm_wr": (None, AXIS), "cm_wv": out}


def _mamba2_layer(cfg: ModelConfig, n: int, quant: bool) -> dict:
    """A Mamba2 layer's specs by leaf (module docstring): in_proj's z, x
    and dt columns, the conv's x channels and the per-head vectors by
    SSD heads, B and C whole; out_proj by rows (exact) or columns
    (quantized); the gated norm's scale whole."""
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    if h % n or (quant and cfg.d_model % n):
        raise ValueError(f"{cfg.name}: Mamba2 over {n} ranks needs n to "
                         f"divide its {h} SSD heads (and d_model under a "
                         f"quantized policy)")
    conv = Segments(AXIS, (di, ns, ns), (True, False, False))
    return {"in_proj": (None, Segments(AXIS, (di, di, ns, ns, h),
                                       (True, True, False, False, True))),
            "conv_w": (None, conv), "conv_b": (conv,),
            "A_log": (AXIS,), "dt_bias": (AXIS,), "D": (AXIS,),
            "out_proj": (None, AXIS) if quant else (AXIS, None)}


def _cuts_products(name: str, spec: tuple, ndim: int) -> bool:
    """Whether `spec` cuts a matrix that may reach a policy product (a
    leaf's last two dims), whose quantized scale must then be the whole
    leaf's. The embedding and the head never reach one: the embedding
    is looked up and the logits are a plain matmul (audio's an einsum
    over its codebooks' heads, (C, d, V) cut on V), so no cut of theirs
    needs a scale. A stack of matrices (experts) may be cut only by
    matrix: its products each take their own matrix's scale, which is
    whole."""
    if name in ("embed", "head") or ndim < 2:
        return False
    cut = any(a is not None for a in spec[-2:])
    if cut and ndim > 2:
        raise ValueError(f"{name}: a stack of matrices is cut only along "
                         f"its stack, got spec {spec}")
    return cut


def cache_placement(cfg: ModelConfig, n: int) -> dict:
    """The specs of a tensor-parallel rank's decode carry over n ranks,
    the tree of `modellib.init_cache`'s: the attention's K and V by KV
    heads where the attention is split, rwkv6's wkv state by heads or
    key channels (as its `u`), Mamba2's SSD state by heads and its conv
    tail as its conv channels; the token-shift carries, zamba2's ring
    positions and the index whole."""
    kv = (None, None, None, AXIS, None) if cfg.n_heads and \
        cfg.n_kv_heads % n == 0 else ()
    if cfg.family == "rwkv6":
        u = _rwkv6_layer(cfg, n, False)["u"]
        return {"layers": {"x_tm": (), "x_cm": (),
                           "wkv": (None, None) + u + (None,)},
                "index": ()}
    if cfg.family == "zamba2":
        conv = _mamba2_layer(cfg, n, False)["conv_w"][1]
        return {"mamba": {"ssd": (None, None, AXIS, None, None),
                          "conv": (None, None, None, conv)},
                "attn_k": kv, "attn_v": kv, "attn_pos": (), "index": ()}
    return {"k": kv, "v": kv, "index": ()}


def rank_cache(cfg: ModelConfig, n: int, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """A zeroed decode carry of a tensor-parallel rank over n ranks:
    `modellib.init_cache`'s, every leaf at its part's shape
    (`cache_placement`), zamba2's ring positions filled as there."""
    whole = modellib.init_cache(cfg, batch, max_len, dtype=dtype,
                                device="meta")
    dev = resolve_device(device)

    def build(tree, specs):
        if isinstance(tree, dict):
            return {k: build(v, specs[k]) for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return tree
        return torch.zeros(local_shape(tree.shape, specs, n),
                           dtype=tree.dtype, device=dev)

    cache = build(whole, cache_placement(cfg, n))
    if "attn_pos" in cache:
        cache["attn_pos"].fill_(torch.iinfo(torch.int32).max)
    return cache


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
    bit. The dense and MoE families draw their leaves whole, in the
    same order from the same generator, one at a time, and cut them as
    they come, so the largest transient is one leaf, not the model; the
    others draw the whole model first."""
    meta = modellib.empty(cfg, device="meta")
    specs = placement(cfg, param_shapes(meta), n, policy)
    shard = empty_shard(cfg, specs, n, device)
    if not hasattr(meta, "init_values"):
        full = modellib.init(cfg, seed=seed, device=shard.device)
        return fill_shard(shard, full.named_parameters(), specs, rank, n)
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
        self.placement = model.placement
        self.vocab_cut = AXIS in spec_axes(model.placement[
            "embed" if cfg.tie_embeddings else "head"])
        # the attention's seams, for the families with attention (rwkv6
        # has none: its n_heads is 0)
        self.attn_cut = bool(cfg.n_heads) and cfg.n_kv_heads % n == 0
        self.attn_dims, self.attn_k = None, 0
        if cfg.n_heads:
            hd = cfg.resolved_head_dim
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

    def sum_partial(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A rank's gradient block of leaf `name` with its parts that
        every rank holds whole but reads for its own part of the work
        summed over the ranks: the qk-norm scales, applied to each
        rank's own heads where they are split, and the whole segments
        of a `Segments` cut (Mamba2's B and C columns of in_proj and
        channels of the conv, read by each rank's SSD heads)."""
        if self.attn_cut and name.rsplit(".", 1)[-1] in ("q_norm",
                                                         "k_norm"):
            return comm.all_reduce(g, self.group)
        for dim, entry in enumerate(self.placement[name]):
            if isinstance(entry, Segments) and not all(entry.cut):
                pieces = list(torch.split(g, entry.local_sizes(self.n),
                                          dim=dim))
                for i, cut in enumerate(entry.cut):
                    if not cut:
                        pieces[i] = comm.all_reduce(pieces[i], self.group)
                g = torch.cat(pieces, dim=dim)
        return g

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x, an activation every rank holds whole, entering this rank's
        part of the work (a product on a cut weight other than `mm`'s,
        a slice of its channels): the identity, its gradient summed
        over the ranks."""
        return comm.copy_sum_grad(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of their partial x (rwkv6's wkv readout
        split by key channels), every rank then using it whole."""
        return comm.reduce_sum(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's part of an activation along `dim`, gathered whole
        for every rank to use whole (a rank's gradient: its block), in
        contiguous memory: a reduction over the gathered dim (a norm's)
        then sums in the single device's order."""
        return comm.gather_split_grad(x, self.group, dim).contiguous()

    def whole_out(self, h: torch.Tensor, w: torch.Tensor,
                  policy: ArithmeticPolicy,
                  gate: torch.Tensor | None = None) -> torch.Tensor:
        """(h [* gate]) @ w back to the whole d_model on every rank, for an
        h every rank holds whole (a norm over the whole width of a split
        activation: rwkv6's `ln_x`, Mamba2's gated RMSNorm) and `gate`
        the rank's contiguous part of its factor (rwkv6's g). A row-split
        w takes the rank's block of h (`out_proj`'s f32 partial sums); a
        column-split one (a quantized policy) the whole of h [* gate],
        the gate gathered, so every product sees the single device's
        values."""
        k_full = h.shape[-1]
        if w.shape[0] < k_full:
            k = w.shape[0]
            x = self.enter(h).narrow(-1, self.rank * k, k)
            return self.out_proj(x if gate is None else x * gate, w, policy,
                                 k_full)
        if gate is not None:
            h = h * self.gather(gate)
        return self.out_proj(h, w, policy, k_full)

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
