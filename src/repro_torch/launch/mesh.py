"""Process groups and mesh shapes (counterpart of `repro.launch.mesh`).

The reference's multi-device code runs one program over a jax mesh;
the port runs one process per rank over a `torch.distributed` process
group. This module starts and ends those groups:

  spawn(fn, n, *args, device=...)  runs fn(rank_device, *args) in n
        fresh processes (the spawn start method: the parent may hold
        live CUDA and jax state, which fork would copy) joined in one
        group through a `FileStore` rendezvous in a temporary
        directory, so no TCP port is taken and parallel test workers
        never meet. It returns every rank's return value, and raises
        the first failing rank's exception.
  init_from_env(device)            joins the group `torchrun` set up
        (RANK, WORLD_SIZE and its rendezvous variables); `leave()`
        ends it.

Every group has a `timeout`: a rank that parts from the others waits
in a collective at most that long, then fails, instead of hanging.

The transport follows the card count, never a failure: NCCL when every
rank can have a CUDA device of its own, gloo otherwise (CPU ranks, or
ranks that share one card, where NCCL refuses a second rank on the
same device). `transport_line` prints it.

The mesh shapes (`make_production_mesh`, `make_smoke_mesh`) are axis
names and sizes only, what the sharding rules
(`repro_torch.parallel.sharding`) read. `rank_mesh(shape)` is a rank's
view of a mesh over the ranks of its group: its coordinates and one
process group an axis (the ranks that differ from it along that axis
only; under gloo with `LANES` - 1 lanes for its large collectives),
what the sharded train step runs its collectives over. This module
imports no jax.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel import comm

# seconds a rank waits in a collective before it fails
DEFAULT_TIMEOUT_S = 600.0
# gloo groups over the same ranks that an axis's large collectives split
# over (`parallel.comm.add_lanes`)
LANES = 4


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, in order."""
    axes: tuple[tuple[str, int], ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """single pod: (data=16, model=16) = 256 chips;
    multi-pod:  (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return MeshShape((("pod", 2), ("data", 16), ("model", 16)))
    return MeshShape((("data", 16), ("model", 16)))


def make_smoke_mesh(data: int = 2, model: int = 2) -> MeshShape:
    return MeshShape((("data", data), ("model", model)))


def mesh_chips(mesh: MeshShape) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n


def mesh_name(mesh: MeshShape) -> str:
    return "x".join(f"{k}{v}" for k, v in mesh.shape.items())


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A rank's view of a mesh: its `MeshShape`, its index along each
    axis (`coords`) and, for each axis, the process group of the ranks
    that share every other coordinate (`groups`). The ranks lie on the
    mesh in row-major order, the last axis fastest, as the devices of a
    jax mesh do: on a (data, model) mesh, rank r sits at data r //
    model, model r % model."""
    mesh: MeshShape
    coords: dict
    groups: dict

    @property
    def shape(self) -> dict[str, int]:
        return self.mesh.shape

    def size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]


def rank_mesh(mesh: MeshShape) -> RankMesh:
    """This rank's view of `mesh` over the default group, whose size must
    be `mesh_chips(mesh)`. Every rank of the group must call it, in the
    same order: each axis's groups are built with `dist.new_group`, all
    of them on every rank (the call is collective), and the rank keeps
    the one it is in. They take the default group's transport."""
    n = dist.get_world_size()
    lanes = LANES if dist.get_backend() == "gloo" else 1
    if n != mesh_chips(mesh):
        raise ValueError(f"mesh {mesh_name(mesh)} needs {mesh_chips(mesh)} "
                         f"ranks, the group has {n}")
    rank = dist.get_rank()
    sizes = [size for _, size in mesh.axes]
    coords, rest = {}, rank
    for name, size in reversed(mesh.axes):
        coords[name] = rest % size
        rest //= size
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    groups = {}
    for i, (name, size) in enumerate(mesh.axes):
        # the ranks along axis i: every other coordinate fixed; the
        # groups are enumerated by their first member, the same order
        # on every rank
        starts = sorted({r - ((r // strides[i]) % size) * strides[i]
                         for r in range(n)})
        for start in starts:
            members = [start + j * strides[i] for j in range(size)]
            g, *extra = [dist.new_group(members)
                         for _ in range(lanes if size > 1 else 1)]
            if rank in members:
                groups[name] = g
                if extra:
                    comm.add_lanes(g, extra)
    return RankMesh(mesh, {k: coords[k] for k, _ in mesh.axes}, groups)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


def transport(n: int, device) -> str:
    """"nccl" when `device` is CUDA and there are at least n cards (one
    a rank), else "gloo"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def rank_device(rank: int, n: int, device) -> torch.device:
    """The device rank `rank` of n computes on: its own card under NCCL,
    the one card all ranks share under gloo, or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if transport(n, dev) == "nccl" else 0)


def transport_line(n: int, device) -> str:
    """The transport of an n-rank group on `device`, in words."""
    backend = transport(n, device)
    staged = (backend == "gloo" and resolve_device(device).type == "cuda")
    return (f"{backend} ({n} ranks"
            + (", sharing one card; CUDA tensors staged through pinned "
               "host memory" if staged else "") + ")")


def _join(rank: int, n: int, device, timeout_s: float, local: int,
          **rendezvous) -> torch.device:
    """Join an n-rank group as `rank` (`local`: its index on this host,
    which picks its card); one CPU thread a CPU rank."""
    dev = rank_device(local, n, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        transport(n, device), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s), **rendezvous)
    return dev


def init_from_env(device, timeout_s: float = DEFAULT_TIMEOUT_S
                  ) -> torch.device:
    """Join the group `torchrun` describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns the
    rank's device."""
    rank = int(os.environ["RANK"])
    return _join(rank, int(os.environ["WORLD_SIZE"]), device, timeout_s,
                 int(os.environ.get("LOCAL_RANK", rank)),
                 init_method="env://")


def leave() -> None:
    """End this rank's group once every rank has reached here (a rank
    that ended it first would close connections another still reads).
    What no longer has a reference but still holds the group (an
    engine's backend, in a reference cycle) is collected first: a
    group freed during the interpreter's exit aborts the process."""
    gc.collect()
    dist.barrier()
    dist.destroy_process_group()


def _result_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"rank{rank}.pkl")


def _rank_main(rank, n, tmp, device, timeout_s) -> None:
    """A spawned rank: join the group, run the task, write what it
    returned (or the exception it raised) for the parent."""
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), n)
        dev = _join(rank, n, device, timeout_s, rank, store=store)
        with open(os.path.join(tmp, "task.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        out = ("ok", fn(dev, *args))
    except BaseException as e:   # reported to the parent, then re-raised
        try:
            blob = pickle.dumps(("error", e, traceback.format_exc()))
        except (pickle.PicklingError, TypeError, AttributeError):
            blob = pickle.dumps(("error", RuntimeError(repr(e)),
                                 traceback.format_exc()))
        with open(_result_path(tmp, rank), "wb") as f:
            f.write(blob)
        raise
    with open(_result_path(tmp, rank), "wb") as f:
        pickle.dump(out, f)
    leave()


def _failure(tmp: str, rank: int, code: int) -> BaseException:
    path = _result_path(tmp, rank)
    if os.path.exists(path):
        with open(path, "rb") as f:
            status = pickle.load(f)
        if status[0] == "error":
            _, exc, tb = status
            exc.add_note(f"raised in rank {rank}:\n{tb}")
            return exc
    return RuntimeError(f"rank {rank} exited with code {code}")


def spawn(fn, n: int, *args, device="cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(device_of_the_rank, *args) in n spawned processes joined in
    one group; return their return values in rank order. The ranks
    compute on the card unless `device` asks for the CPU. `fn` and the
    arguments are pickled, so fn must be importable by name. The first
    rank to fail ends the others, and its exception is raised here."""
    if n < 1:
        raise ValueError(f"spawn needs n >= 1 ranks, got {n}")
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        # the task goes through a file: a process's start blocks until
        # the child has read its pickled arguments, which would start
        # the ranks one after another
        with open(os.path.join(tmp, "task.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, tmp, device, timeout_s))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise _failure(tmp, bad[0], codes[bad[0]])
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(n):
            with open(_result_path(tmp, r), "rb") as f:
                results.append(pickle.load(f)[1])
        return results
