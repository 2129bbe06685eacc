"""The collectives of the tensor-parallel slice, over a
`torch.distributed` process group (the port's counterparts of jax.lax's
`psum`, `pmax`, `all_gather` and `ppermute`).

  all_reduce(x, group, op)   elementwise sum or max over the ranks
  all_gather(x, group, dim)  the ranks' tensors concatenated along dim,
                             in rank order
  ring_shift(xs, group)      each rank's tensors sent to rank + 1 and
                             the ones of rank - 1 received

Each returns new tensors and leaves its inputs as they are; every rank
holds the same result of a reduction or a gather.

Under gloo a CUDA tensor is staged through pinned host memory
explicitly: gloo's CUDA support covers only some collectives, and its
send and receive read a raw host pointer. Under NCCL the collectives
take the CUDA tensors themselves (`launch.mesh.transport_line` names
the route).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise `op` ("sum" or "max") of x over the group."""
    if _staged(x, group):
        buf = _host(x)
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return buf.to(x.device)
    buf = x.clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x, concatenated along `dim` in rank order."""
    n = dist.get_world_size(group)
    staged = _staged(x, group)
    src = _host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def ring_shift(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """One step of the ring: each tensor of xs goes to the next rank
    (rank + 1 mod n), and the previous rank's come back, in order."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(xs)
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
