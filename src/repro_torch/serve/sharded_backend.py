"""Tensor-parallel paged serving, `ShardedPagedBackend` (counterpart of
`repro.serve.sharded_backend`).

The multi-device sibling of `PagedKVBackend`, reached only through the
`serve.mesh` seam (`make_backend` routes paged families here when the
engine's `ServeMesh` has more than one shard). Every rank runs the same
host engine, scheduler, prefix index and sampler lanes, and holds 1/n
of the weights; everything host-side is INHERITED UNCHANGED: the page
allocator, block tables, PrefixIndex matching, COW forks, eviction and
the scheduler's `PagedBudget` operate on LOGICAL page ids, the same on
every rank. What this subclass changes is the step factory (`_steps`)
and the per-shard accounting.

Device layout (one "model" axis of n ranks,
`parallel.tensor_parallel.placement`):

  parameters   each rank's part, cut by the base class's
               `_place_params` (or built as a part already:
               `tensor_parallel.init_shard`, `bridge.params_from_numpy(
               mesh=)`)
  KV pool      split on the KV-HEAD axis when n divides the KV heads,
               replicated otherwise (`mesh.kv_pool_sharding`)
  page tables  host-side numpy, never sharded

The ranks exchange activations through the collectives of
`parallel.comm`, where the reference's GSPMD inserts them: the
vocab-parallel embedding, the output projections, the expert outputs
and the logits, which every rank then holds whole and the same, so
every rank's sampler and scheduler take the same decisions.

With the pool head-partitioned, each rank attends over its KV heads
with the default core (a quantized policy's per-tensor scales taking
the group's max). When n does NOT divide the KV heads, the pool and
the attention weights stay whole on every rank and, where the geometry
allows (no window, n divides the chunk and the table's slots), the
attention core runs the ARTEMIS token dataflow over the ranks: decode
merges each rank's slice of the gathered KV view with
`parallel.split_kv_attention`'s LSE reduction, and prefill chunks ring
those slices past the sequence-sharded queries with
`parallel.ring_attention` (paper Fig 5(b), banks -> ranks). Those two
cores score in f32 under every policy, as the reference's do.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.ring_attention import ring_attention
from repro_torch.parallel.split_kv import split_kv_attention
from repro_torch.parallel.tensor_parallel import TensorParallel
from repro_torch.serve.backend import EngineConfig, PagedKVBackend
from repro_torch.serve.mesh import ServeMesh, make_serve_mesh
from repro_torch.serve.obs import ShardStepEvent, Tracer
from repro_torch.serve.paged_model import (
    _attn_core,
    make_paged_chunked_prefill,
    make_paged_decode,
)
from repro_torch.serve.request import Request

__all__ = ["ShardedPagedBackend", "dataflow_attn_core"]


def dataflow_attn_core(tp: TensorParallel):
    """An `attn_core` for `paged_model`'s seam that runs the token
    dataflow over the ranks of `tp`, each holding the whole gathered KV
    view: rank r takes the r-th of n equal slices of its sequence axis.

    The gathered view's kv position IS its slot index t (page j of a
    block table covers positions [j*page, (j+1)*page)), and every valid
    query position is >= its own written slots, so the plain causal
    mask q_pos >= kv_pos is the default core's `t <= positions`: trash
    page and padding slots all sit at t > position for every valid
    query. Scores and softmax in f32 whatever the policy."""

    def core(qg, kall, vall, positions, cfg: ModelConfig, policy):
        b, s, kvh, g, hd = qg.shape
        smax = kall.shape[1]
        # merged head index kv*g + j, so q head i reads kv head i // g,
        # the grouping ring_attention's _repeat_kv applies
        q = qg.reshape(b, s, kvh * g, hd)
        kv_pos = torch.arange(smax, dtype=torch.int32,
                              device=q.device)[None].expand(b, smax)
        ks = smax // tp.n
        kv = slice(tp.rank * ks, (tp.rank + 1) * ks)
        if s > 1:
            # prefill chunk: queries sequence-sharded, each rank's KV
            # slice travels the ring past every query slice (its
            # positions ride along); the slices of the output gathered
            qs = s // tp.n
            ql = slice(tp.rank * qs, (tp.rank + 1) * qs)
            part = ring_attention(q[:, ql], kall[:, kv], vall[:, kv],
                                  group=tp.group, causal=True,
                                  q_positions=positions[:, ql],
                                  kv_positions=kv_pos[:, kv])
            ctx = tp.gather(part, dim=1)
        else:
            # decode: one query a lane on every rank; each scores its KV
            # slice and one max and two sums merge the statistics
            ctx = split_kv_attention(q, kall[:, kv], vall[:, kv],
                                     group=tp.group, q_positions=positions,
                                     kv_positions_local=kv_pos[:, kv])
        return ctx.reshape(b, s, kvh, g, hd)

    return core


def sharded_paged_steps(cfg: ModelConfig, policy: ArithmeticPolicy,
                        tp: TensorParallel, chunk: int, smax: int):
    """The (prefill, decode) steps of a rank: the paged steps with the
    rank's seams, and the attention core its layout takes (module
    docstring)."""
    n = tp.n
    if cfg.n_kv_heads % n == 0:
        core = functools.partial(_attn_core, amax=tp.all_max)
    elif not cfg.attn_window and smax % n == 0 and chunk % n == 0:
        core = dataflow_attn_core(tp)
    else:
        core = None
    return (make_paged_chunked_prefill(cfg, policy, attn_core=core, tp=tp),
            make_paged_decode(cfg, policy, attn_core=core, tp=tp))


class ShardedPagedBackend(PagedKVBackend):
    """Tensor-parallel paged KV backend (see the module docstring).

    Inherits the whole `SequenceBackend` protocol from `PagedKVBackend`:
    admission, sharing, COW, funding, release and invariants are
    logical-page operations that never see the mesh. Overrides `_steps`
    (the rank's steps) and the two execution entry points, which also
    account per-shard work (`backend/shard_*` registry counters and one
    `ShardStepEvent` per shard per forward for the Chrome trace's shard
    tracks)."""

    families = ("dense", "moe")

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 policy: ArithmeticPolicy, params, obs: Tracer, clock,
                 mesh: ServeMesh | None = None):
        mesh = mesh if mesh is not None \
            else make_serve_mesh(ecfg.mesh_shards)
        if mesh.is_single:
            raise ValueError(
                "ShardedPagedBackend needs a multi-shard ServeMesh; "
                "single-device serving uses PagedKVBackend "
                "(mesh_shards=1)")
        if ecfg.attn_impl != "gather":
            raise ValueError(
                f"attn_impl={ecfg.attn_impl!r} has no multi-device "
                f"path (the fused paged kernel is single-device; the "
                f"mesh cores own the sharded gather view) — set "
                f"attn_impl='gather' or mesh_shards=1")
        super().__init__(cfg, ecfg, policy, params, obs, clock, mesh=mesh)
        reg = obs.registry
        reg.set_gauge("backend/shard_count", mesh.n_shards)
        reg.set_gauge(
            "backend/shard_kv_heads",
            cfg.n_kv_heads // mesh.n_shards
            if cfg.n_kv_heads % mesh.n_shards == 0 else cfg.n_kv_heads)

    def _steps(self, policy: ArithmeticPolicy):
        # called once the parameters are the rank's part (`_place_params`)
        self.tp = TensorParallel(self.mesh.handle.group,
                                 self.mesh.handle.rank, self.mesh.n_shards,
                                 self.cfg, self.params)
        smax = self.ecfg.max_pages_per_seq * self.ecfg.page_size
        return sharded_paged_steps(self.cfg, policy, self.tp,
                                   self.ecfg.prefill_chunk, smax)

    # -- execution (adds per-shard accounting) ------------------------------

    def prefill_step(self, chunks: list[tuple[Request, int]]):
        logits = super().prefill_step(chunks)
        self._note_shard_step("prefill", sum(n for _, n in chunks))
        return logits

    def decode_step(self, reqs: list[Request]):
        logits = super().decode_step(reqs)
        self._note_shard_step("decode", len(reqs))
        return logits

    def _note_shard_step(self, phase: str, n_tokens: int) -> None:
        reg = self._obs.registry
        reg.inc("backend/shard_steps")
        reg.inc("backend/shard_tokens", n_tokens)
        now = self._now()
        for shard in range(self.mesh.n_shards):
            self._obs.emit(ShardStepEvent(
                ts=now, shard=shard, n_shards=self.mesh.n_shards,
                phase=phase, n_tokens=n_tokens))

    def snapshot_metrics(self) -> dict:
        m = super().snapshot_metrics()
        reg = self._obs.registry
        m["n_shards"] = self.mesh.n_shards
        m["shard_steps"] = int(reg.count("backend/shard_steps"))
        return m
