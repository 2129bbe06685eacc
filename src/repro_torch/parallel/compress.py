"""Gradient all-reduce with compression and error feedback (counterpart
of `repro.parallel.compress`): the paper's inter-bank "transfer in
binary" (§III.D.1) applied to data-parallel gradients. A gradient is
cast to a narrow type before the sum over the ranks, and what the cast
lost is kept in an error-feedback buffer and added to the next step's
gradient, so the compression noise is unbiased over steps
(Karimireddy et al. 2019).

Modes: "none" | "bf16" | "int8" (per-tensor symmetric, like the ARTEMIS
quantizer; every rank quantizes with the group's largest scale, the
reference's `pmax`, so their int8 lanes sum meaningfully, in int32).

`compressed_psum(grads, state, group)` is the reference's
`compressed_psum(grads, state, axis_name)` over a process group: the
mean over the ranks, in the reference's arithmetic. The reference's
train step does not call it, and neither does the port's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.quantization import div_by
from repro_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class CompressionState:
    mode: str                 # none | bf16 | int8
    error: dict | None       # error-feedback buffers by name, f32


def init_compression(grads_like: dict, mode: str = "none") -> CompressionState:
    if mode == "none":
        return CompressionState("none", None)
    return CompressionState(mode, {
        name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for name, g in grads_like.items()})


def _compress(g: torch.Tensor, mode: str, group=None):
    """(compressed, dequantize)."""
    if mode == "bf16":
        return g.to(torch.bfloat16), lambda x: x.float()
    if mode == "int8":
        scale = div_by(torch.clamp_min(g.abs().amax(), 1e-12), 127.0)
        if group is not None:
            # every rank quantizes with the same scale, or the int32 sum
            # of their int8 lanes means nothing
            scale = comm.all_reduce(scale, group, "max")
        c = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return c, lambda x: x.float() * scale
    raise ValueError(mode)


def compressed_psum(grads: dict, state: CompressionState, group):
    """The mean of `grads` (by name) over the ranks of `group`, compressed
    by `state.mode` with error feedback: (mean grads, new state)."""
    n = dist.get_world_size(group)

    def mean(x):
        return x / torch.full((), n, dtype=x.dtype, device=x.device)

    if state.mode == "none":
        return {k: mean(comm.all_reduce(g, group))
                for k, g in grads.items()}, state
    out, err = {}, {}
    for name, g in grads.items():
        g32 = g.float() + state.error[name]          # error feedback
        c, deq = _compress(g32, state.mode, group)
        if state.mode == "int8":
            red = mean(deq(comm.all_reduce(c.to(torch.int32), group)))
            err[name] = g32 - deq(c.to(torch.int32))
        else:
            red = mean(deq(comm.all_reduce(c, group)))
            err[name] = g32 - deq(c)
        out[name] = red.to(g.dtype)
    return out, CompressionState(state.mode, err)
