"""The eager count of one step (the port's counterpart of the reference's
`compiled.cost_analysis()` and `compiled.memory_analysis()`).

`Count` is a `TorchDispatchMode`: every aten op run inside it, on any
device (meta tensors included, which is how the dry run counts a step
that allocates nothing), adds to three counts.

  flops  torch's FLOP formulas (`torch.utils.flop_counter`) over the
         ops that run: the matrix products, convolutions and attention
         ops it has formulas for; elementwise work is not counted.
  bytes  each op's tensor operands plus its outputs, as they are, once
         per op: the unfused traffic eager PyTorch moves. An in-place op
         counts its target as read and written; an operand is counted
         whole, so a lookup counts its whole table. Views, aliases,
         allocations and other metadata-only ops move nothing, and
         collectives are counted by `roofline.collectives`, not here.
         This is not XLA's post-fusion byte count, and the two are never
         compared.
  peak   the most storage bytes live at once on the inputs' device: the
         step's inputs (`inputs=`) live from the start, then every
         storage an op creates until it is freed (storages are tracked
         by weak reference). A kernel call holds only what it returns: a
         storage made inside a wrapper counts from the call's end if it
         is still live then, so neither the plain version's temporaries
         nor the kernel's scratch count.

A kernel wrapper (`kernels.build.kernel_call`) declares the work of
its call from the call's shapes and arguments, FLOPs and bytes each
read or written once, counting what these inputs need (masks,
`kv_len`); the count adds that work once and nothing of the ops inside,
whether the plain version, the CUDA kernel or a meta output runs, and
`kernel_calls` counts the calls by kernel. A kernel whose operands are
int8 (sc_matmul) says so, and its FLOPs are also counted in `int8_ops`,
which the roofline prices at the card's int8 rate.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

# ops that move no bytes: aliases and allocation (views are found by
# their schema)
_NO_TRAFFIC = frozenset({
    "detach", "alias", "_unsafe_view", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "set_", "resize_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_local_scalar_dense", "record_stream"})
# collectives: bytes on the link, not in HBM
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional",
                                    "c10d_functional"})


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _moves_bytes(func) -> bool:
    return not (func.is_view or func.namespace in _COLLECTIVE_NAMESPACES
                or func.overloadpacket.__name__ in _NO_TRAFFIC)


class Count(TorchDispatchMode):
    """The counts of the ops run inside the block (module docstring).
    `inputs`: the step's inputs (any nest of tensors), live from the
    start; their device is the one whose storage the peak counts (all
    devices without inputs). The count holds no tensor once its block
    ends."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0
        self.int8_ops = 0            # the part of `flops` on int8 operands
        self.bytes = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._inputs = _tensors(inputs)
        self._device = (self._inputs[0].device.type if self._inputs
                        else None)
        self._storages: dict[int, int] = {}
        self._finalizers: list = []
        self._in_kernel = 0
        self._made: list = []        # tensors made inside a kernel call
        self.input_bytes = 0

    def __enter__(self):
        self._track(self._inputs)
        self._inputs = None
        self.input_bytes = self.live
        build.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.COUNTERS.remove(self)
        # the counts are final: let go of every storage the block saw
        for finalizer in self._finalizers:
            finalizer.detach()
        self._finalizers, self._storages, self._made = [], {}, []
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, work, int8: bool = False):
        """One call of kernel `name` whose function does `work()` ->
        (FLOPs, bytes), on int8 operands if `int8`; the ops inside count
        nothing."""
        if not self._in_kernel:
            with _disable_current_modes():
                flops, n_bytes = work()
            self.kernel_calls[name] += 1
            self.flops += flops
            self.int8_ops += flops if int8 else 0
            self.bytes += n_bytes
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1
            if not self._in_kernel:
                made, self._made = self._made, []
                self._track([t for t in (ref() for ref in made)
                             if t is not None])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._in_kernel:
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if _moves_bytes(func):
                self.bytes += (_nbytes(_tensors((args, kwargs)))
                               + _nbytes(_tensors(out)))
        self._track(_tensors(out))
        return out

    def _track(self, tensors) -> None:
        for t in tensors:
            if self._device is not None and t.device.type != self._device:
                continue
            if self._in_kernel:
                self._made.append(weakref.ref(t))
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._storages:
                continue
            n = storage.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            self._finalizers.append(weakref.finalize(storage, self._free,
                                                     key))

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)
