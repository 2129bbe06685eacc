"""The sharding context (counterpart of `repro.parallel.context`): the
launcher installs (mesh, rules), and model code reads it without a mesh
threaded through every function.

The reference keeps it in a contextvar. Here it is process-wide, set on
entering `use_sharding` and restored on leaving it: autograd runs the
backward of CUDA tensors, and with it each remat recompute, on a
device thread of its own, which a contextvar set in the caller's thread
does not reach, so the recompute would read no context and quantize or
route differently from the forward it replays.

Here `mesh` is a rank's view of the mesh (`launch.mesh.RankMesh`): its
coordinates and the process group of each axis. Outside any context
(unit tests, single-device runs) every hook below is the identity.

The reference's `activation_constraint` and `attention_heads_constraint`
pin GSPMD's layout of an activation; they never change a value. In the
port each rank holds its own rows and its own part of the weights
explicitly (`parallel.data_parallel`, `parallel.tensor_parallel`), so
there is no layout to pin: both are identities, kept for the
reference's call sites.

What model code does read from the context is the data group, which
the reference's GSPMD reaches implicitly:

  data_absmax(x, policy)  a quantized product's per-tensor activation
                          absmax over the whole batch: the max over the
                          data ranks of each rank's own rows' absmax
  data_sum(x)             a sum over the data ranks, for statistics of
                          the whole batch (the MoE load-balance loss)
  data_size()             the number of data ranks (1 outside a mesh)
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import quantization as q
from repro_torch.parallel import comm

# (mesh, rules) of the innermost `use_sharding`, or None
_ctx = None


def sharding_ctx():
    """(mesh, rules) of the innermost `use_sharding`, or None."""
    return _ctx


@contextlib.contextmanager
def use_sharding(mesh, rules):
    global _ctx
    outer, _ctx = _ctx, (mesh, rules)
    try:
        yield
    finally:
        _ctx = outer


def activation_constraint(x: torch.Tensor, kind: str = "resid"
                          ) -> torch.Tensor:
    """The identity: a rank's activations are its own rows already."""
    return x


def attention_heads_constraint(x: torch.Tensor, n_q_heads: int
                               ) -> torch.Tensor:
    """The identity: a rank's attention runs on the heads it holds."""
    return x


def _data_group():
    ctx = _ctx
    if ctx is None:
        return None
    mesh, _ = ctx
    return mesh.group("data") if mesh.size("data") > 1 else None


def data_size() -> int:
    return 1 if _ctx is None else _ctx[0].size("data")


def data_absmax(x: torch.Tensor, policy) -> torch.Tensor | None:
    """The per-tensor absmax of x over every data rank's rows (f32, no
    gradient), or None outside a data-parallel mesh, where x's own is
    the whole batch's."""
    group = _data_group()
    if group is None:
        return None
    if policy.act_quant_axis is not None:
        raise ValueError("a data-parallel step takes per-tensor activation "
                         "scales; act_quant_axis must be None")
    return comm.all_reduce(q.absmax(x.detach()).float(), group, "max")


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data ranks, with the sum's own adjoint as its
    gradient (each rank's input gets the sum of every rank's output
    gradient); x itself outside a data-parallel mesh."""
    group = _data_group()
    if group is None:
        return x
    return comm.reduce_sum(comm.copy_sum_grad(x, group), group)
