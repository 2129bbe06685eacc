"""The collectives of the tensor-parallel slice, over a
`torch.distributed` process group (the port's counterparts of jax.lax's
`psum`, `pmax`, `all_gather` and `ppermute`).

  all_reduce(x, group, op)   elementwise sum or max over the ranks
  all_gather(x, group, dim)  the ranks' tensors concatenated along dim,
                             in rank order
  ring_shift(xs, group)      each rank's tensors sent to rank + 1 and
                             the ones of rank - 1 received
  reduce_scatter(x, group, dim)  the sum over the ranks, each rank
                             keeping its block of `dim`

Each returns new tensors and leaves its inputs as they are; every rank
holds the same result of a reduction or a gather.

The training collectives carry a gradient (`torch.autograd.Function`s;
under `torch.no_grad` they are the plain collectives):

  reduce_sum(x, group)       sum over the ranks; backward: identity
                             (the output of a row-split product, a
                             vocab-split lookup)
  copy_sum_grad(x, group)    identity; backward: sum over the ranks (the
                             input of a column-split product)
  gather_split_grad(x, group, dim)    all_gather; backward: the rank's
                             own block (an output every rank then uses
                             alike)
  gather_scatter_grad(x, group, dim)  all_gather; backward:
                             reduce_scatter (a weight gathered over the
                             data ranks, each using it on its own rows)

Over a group of one rank each is the identity.

Under gloo a CUDA tensor is staged through pinned host memory
explicitly: gloo's CUDA support covers only some collectives, and its
send and receive read a raw host pointer. Under NCCL the collectives
take the CUDA tensors themselves (`launch.mesh.transport_line` names
the route).

Lanes (gloo only). Gloo drives each group's collectives over one TCP
connection a peer, which moves well under 1 GB/s on one host. A gloo
group can be given lanes (`add_lanes`: more groups over the same
ranks, built with it): an all_reduce, all_gather or reduce_scatter of
at least `LANE_MIN_BYTES` is then cut into as many column blocks as
there are lanes, each block's collective running on its own lane
concurrently, and the results put back together. Each element still
takes the same collective over the same ranks, so the result is the
one-lane result. Under NCCL no group has lanes.

Each of all_reduce, all_gather, reduce_scatter and ring_shift writes
one record a call (one a tensor for ring_shift) to the open
`roofline.collectives.recording()`s, before any lane split. On meta
tensors ring_shift returns tensors of the same shapes and moves
nothing (the dry run's ranks hold no data).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.roofline import collectives

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the name torch gives the one-tensor reduce-scatter (newer releases
# rename `reduce_scatter_tensor`, same arguments)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
# the least bytes of a collective that splits over its group's lanes
LANE_MIN_BYTES = 1 << 24
# gloo group -> its extra lanes
_LANES: dict = {}


def add_lanes(group, lanes: list) -> None:
    """Let collectives of at least `LANE_MIN_BYTES` over the gloo
    `group` run split over `group` and `lanes` (groups over the same
    ranks)."""
    if dist.get_backend(group) != "gloo":
        raise ValueError("lanes split gloo collectives only")
    _LANES[group] = list(lanes)


def _lanes(x: torch.Tensor, group) -> list:
    """The groups a collective of x over `group` runs on, one a block."""
    extra = _LANES.get(group, ())
    if not extra or x.numel() * x.element_size() < LANE_MIN_BYTES:
        return [group]
    return [group, *extra]


def _note(kind: str, x: torch.Tensor, group) -> None:
    """The record of one collective of x over `group` (module
    docstring)."""
    if collectives.recording_open():
        collectives.record(kind, x.numel() * x.element_size(),
                           dist.get_world_size(group))


def _wait(works) -> None:
    for w in works:
        w.wait()


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise `op` ("sum" or "max") of x over the group."""
    _note("all-reduce", x, group)
    staged = _staged(x, group)
    buf = _host(x) if staged else x.clone(memory_format=torch.contiguous_format)
    lanes = _lanes(buf, group)
    _wait([dist.all_reduce(block, op=_OPS[op], group=g, async_op=True)
           for block, g in zip(buf.view(-1).chunk(len(lanes)), lanes)])
    return buf.to(x.device) if staged else buf


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    """An output buffer beside `like`: pinned where like is a staged
    host copy, so that its copy back to the card is a fast one."""
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       pin_memory=like.is_pinned())


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x, concatenated along `dim` in rank order."""
    _note("all-gather", x, group)
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    staged = _staged(src, group)
    lanes = _lanes(src, group)
    works, outs = [], []
    for block, g in zip(src.view(-1).chunk(len(lanes)), lanes):
        if staged:
            block = _host(block)
        outs.append(_empty((n * block.numel(),), block))
        works.append(_ALL_GATHER(outs[-1], block, group=g, async_op=True))
    _wait(works)
    # lane k holds every rank's block k: rank r's row is its blocks in order
    out = torch.cat([o.to(x.device).view(n, -1) for o in outs], dim=1)
    return out.view(n * src.shape[0], *src.shape[1:]).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of x over the ranks, cut into n blocks along `dim`; rank r
    keeps block r."""
    _note("reduce-scatter", x, group)
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    staged = _staged(src, group)
    lanes = _lanes(src, group)
    works, outs = [], []
    # rank r's result is row r of (n, rest); lane k reduces columns block k
    for block, g in zip(src.view(n, -1).chunk(len(lanes), dim=1), lanes):
        block = _host(block) if staged else block.contiguous()
        outs.append(_empty((block.shape[1],), block))
        works.append(_REDUCE_SCATTER(outs[-1], block.view(-1), group=g,
                                     async_op=True))
    _wait(works)
    out = torch.cat([o.to(x.device) for o in outs])
    return out.view(src.shape[0] // n, *src.shape[1:]).movedim(0, dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopySumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherSplitGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherScatterGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def _single(group) -> bool:
    return dist.get_world_size(group) == 1


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if _single(group) else _ReduceSum.apply(x, group)


def copy_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    return x if _single(group) else _CopySumGrad.apply(x, group)


def gather_split_grad(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return x if _single(group) else _GatherSplitGrad.apply(x, group,
                                                           dim % x.dim())


def gather_scatter_grad(x: torch.Tensor, group,
                        dim: int = 0) -> torch.Tensor:
    return x if _single(group) else _GatherScatterGrad.apply(x, group,
                                                             dim % x.dim())


def ring_shift(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """One step of the ring: each tensor of xs goes to the next rank
    (rank + 1 mod n), and the previous rank's come back, in order."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(xs)
    for x in xs:
        _note("collective-permute", x, group)
    if all(x.device.type == "meta" for x in xs):
        return [torch.empty_like(x) for x in xs]
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    staged = [_staged(x, group) for x in xs]
    srcs = [_host(x) if s else x.contiguous() for x, s in zip(xs, staged)]
    dsts = [torch.empty_like(s) for s in srcs]
    ops = []
    for tag, (src, dst) in enumerate(zip(srcs, dsts)):
        ops.append(dist.P2POp(dist.isend, src, nxt, group, tag))
        ops.append(dist.P2POp(dist.irecv, dst, prv, group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [d.to(x.device) if s else d for d, x, s in zip(dsts, xs, staged)]
