"""Device-mesh seam for the serve stack (counterpart of
`repro.serve.mesh`).

Every serve-layer component that could care about placement (backend
construction, parameter and KV placement, cost pricing) takes a
`ServeMesh` value instead of asking about devices. This module is the
one place the serve tree reads the process group; everything
downstream takes the seam as a value.

Two invariants:

  * The single-device mesh (`make_serve_mesh(1)`, the default) is a
    strict no-op: it builds no group, makes no device query, and every
    placement helper below returns None, so the single-device serve
    path is the pre-mesh code exactly.
  * A multi-shard mesh is pure tensor parallelism over one axis
    ("model") of n ranks, one process each, in the `torch.distributed`
    group the ranks joined (`launch.mesh.spawn`, or `torchrun`):
    parameters are placed per `parallel.tensor_parallel.placement`
    (the reference's `param_specs` with FSDP off, and the port's
    choices named there), the paged KV pool is split on the KV-head axis
    where n divides it (`paged_pool_spec`), and page tables stay
    host-side, so the allocator, PrefixIndex and COW logic never see
    the mesh.

A placement helper returns a spec (`parallel.sharding`: one entry a
dim, the axis name or None); `parallel.sharding.shard_leaf` cuts a
rank's part by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "MeshHandle",
    "ServeMesh",
    "make_serve_mesh",
    "param_shardings",
    "kv_pool_sharding",
    "replicated",
    "seq_sharded_spec",
]


@dataclasses.dataclass(frozen=True)
class MeshHandle:
    """A rank's place in the mesh: the process group and its rank in it."""
    group: Any
    rank: int


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The serve layer's view of the topology.

    n_shards  tensor-parallel degree (1 = single device)
    axis      the mesh axis the TP collectives run over
    handle    a `MeshHandle` when n_shards > 1, else None: the
              single-device seam never touches the process group
    """
    n_shards: int = 1
    axis: str = "model"
    handle: Any = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if (self.handle is None) != (self.n_shards == 1):
            raise ValueError(
                "ServeMesh invariant: handle is None iff n_shards == 1 "
                f"(got n_shards={self.n_shards}, handle={self.handle!r})")

    @property
    def is_single(self) -> bool:
        return self.n_shards == 1


def make_serve_mesh(n_shards: int = 1, axis: str = "model") -> ServeMesh:
    """Build the serve mesh. n_shards == 1 is the strict no-op default;
    n_shards > 1 needs this process to be a rank of an n_shards-rank
    group."""
    if n_shards == 1:
        return ServeMesh()
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    import torch.distributed as dist
    if not dist.is_initialized():
        raise ValueError(
            f"cannot build a {n_shards}-way serve mesh: this process is "
            f"in no process group. Start the ranks with "
            f"repro_torch.launch.mesh.spawn (or torchrun, or "
            f"`python -m repro_torch.launch.serve --mesh-shards "
            f"{n_shards}`)")
    if dist.get_world_size() != n_shards:
        raise ValueError(
            f"cannot build a {n_shards}-way serve mesh in a group of "
            f"{dist.get_world_size()} ranks")
    return ServeMesh(n_shards=n_shards, axis=axis,
                     handle=MeshHandle(dist.group.WORLD, dist.get_rank()))


# ---------------------------------------------------------------------------
# placement helpers: all None on the single-device mesh
# ---------------------------------------------------------------------------


def param_shardings(mesh: ServeMesh, cfg, params, policy):
    """{parameter name: spec} of this rank's part of the model's
    parameters (`parallel.tensor_parallel.placement`), or None on the
    single mesh."""
    if mesh.is_single:
        return None
    from repro_torch.parallel.sharding import param_shapes
    from repro_torch.parallel.tensor_parallel import placement
    return placement(cfg, param_shapes(params), mesh.n_shards, policy)


def kv_pool_sharding(mesh: ServeMesh, cfg):
    """Spec of the paged KV pool (L, n_pages, page, KV, hd): split on the
    KV heads when the TP degree divides them, replicated otherwise.
    None on the single mesh."""
    if mesh.is_single:
        return None
    from repro_torch.parallel.sharding import paged_pool_spec
    from repro_torch.parallel.tensor_parallel import serve_mesh_shape
    return paged_pool_spec(cfg, serve_mesh_shape(mesh.n_shards))


def replicated(mesh: ServeMesh):
    """The replicated spec over the mesh, or None on the single mesh."""
    if mesh.is_single:
        return None
    from repro_torch.parallel.sharding import replicated_spec as rep
    return rep()


def seq_sharded_spec(mesh: ServeMesh):
    """The spec of a gathered (batch, seq, ...) KV view with its
    SEQUENCE axis over the TP axis (the token-dataflow layout the ring
    and split-KV cores take), or None on the single mesh."""
    if mesh.is_single:
        return None
    return (None, mesh.axis)
