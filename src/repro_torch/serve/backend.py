"""Backend-agnostic sequence-memory API for the serving engine
(counterpart of `repro.serve.backend`).

The engine, scheduler, and request lifecycle never touch pages, block
tables, prefix hashes or copy-on-write directly: they talk to a
`SequenceBackend` through the narrow protocol below, whose contract is
the reference's, method for method (see `repro.serve.backend`'s module
docstring for the full text). Both single-device backends are ported:

  PagedKVBackend   — attention families (dense and MoE): K/V in a
                     pool of fixed-size
                     token pages with a refcounting allocator,
                     PrefixIndex admission matching, copy-on-write forks
                     and trash page 0 for idle lanes.
  StateSlotBackend — recurrent families (rwkv6 / zamba2): a fixed pool
                     of whole per-sequence state slots
                     (`serve.state_model`), one per in-flight request,
                     trash slot 0 for idle lanes.

Every arithmetic policy mode runs (the quantized ones through the
sc_matmul kernel and the gather core). Not ported yet, and refused by
`make_backend` with a message that says so: the tensor-parallel mesh
(`mesh_shards > 1`) and the analog readout noise of the artemis mode
(`sigma_analog > 0`).

The steps run on the device of the model's weights. The pool is owned
by the backend and updated in place (the reference donates it to its
jitted steps and rebinds the result); the allocator, the block tables
and the prefix index stay host-side, so everything the scheduler sees
— and the virtual clock — is the reference's arithmetic exactly.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import FAMILIES, torch_dtype
from repro_torch.serve.obs import CowForkEvent, ShareEvent, Tracer
from repro_torch.serve.paged_cache import (
    TRASH_PAGE,
    PageAllocator,
    PrefixIndex,
    cow_copy_page,
    init_paged_cache,
)
from repro_torch.serve.paged_model import (
    make_fused_paged_core,
    make_paged_chunked_prefill,
    make_paged_decode,
)
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.state_model import (
    TRASH_SLOT,
    chunk_steps,
    init_slot_pool,
    make_slot_decode,
    make_slot_prefill_chunk,
    reset_slot,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serve configuration: engine-level knobs (batch lanes, chunk
    size, scheduler policy) plus the memory-pool geometry each backend
    interprets — paged backends read the page_* fields, state-slot
    backends read n_slots/max_seq_len."""
    page_size: int = 8
    n_pages: int = 128             # includes the reserved trash page 0
    max_batch: int = 4             # batch lanes
    max_pages_per_seq: int = 16    # block-table width
    prefill_chunk: int = 32        # prompt tokens per prefill chunk
    cache_dtype: str = "float32"
    scheduler: str = "cost"        # "cost" | "fcfs"
    scheme: str = "token_PP"       # hwsim dataflow used for pricing
    prefix_sharing: bool = True    # COW page sharing for common prefixes
    n_slots: int = 0               # state-slot pool size incl. trash
    #                                slot 0 (0 = auto: max_batch + 1)
    max_seq_len: int = 512         # per-sequence prompt+gen cap for
    #                                state-slot backends
    observability: str = "metrics"   # "metrics" = counters/histograms
    #                                  only; "trace" = keep the full
    #                                  typed event log
    mesh_shards: int = 1             # tensor-parallel degree (only 1 is
    #                                  ported)
    attn_impl: str = "gather"        # paged attention core: "gather"
    #                                  materializes the block table into
    #                                  a contiguous KV view (reference
    #                                  path); "fused" walks the block
    #                                  table inside the paged-attention
    #                                  kernel (exact policy)

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved trash "
                f"page), got {self.n_pages}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_pages_per_seq < 1:
            raise ValueError(
                f"max_pages_per_seq must be >= 1, got "
                f"{self.max_pages_per_seq}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.scheduler not in ("cost", "fcfs"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.n_slots != 0 and self.n_slots < 2:
            raise ValueError(
                f"n_slots must be 0 (auto) or >= 2 (slot 0 is the "
                f"reserved trash slot), got {self.n_slots}")
        if self.max_seq_len < 2:
            raise ValueError(
                f"max_seq_len must be >= 2, got {self.max_seq_len}")
        if self.observability not in Tracer.LEVELS:
            raise ValueError(
                f"observability must be one of {Tracer.LEVELS}, got "
                f"{self.observability!r}")
        if self.mesh_shards < 1:
            raise ValueError(
                f"mesh_shards must be >= 1, got {self.mesh_shards}")
        if self.attn_impl not in ("gather", "fused"):
            raise ValueError(
                f"attn_impl must be 'gather' or 'fused', got "
                f"{self.attn_impl!r}")
        torch_dtype(self.cache_dtype)   # raises on nonsense dtypes


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """What admission bought: `shared_tokens` effective-prompt tokens
    were already resident (the prefix-share discount)."""
    shared_tokens: int = 0


class BudgetProbe(abc.ABC):
    """One scheduler decide()'s worth of free-capacity planning. The
    probe is a SNAPSHOT: granting decrements the probe's own budget,
    never the backend's real allocator."""

    @abc.abstractmethod
    def grant_continue(self, req: Request, want: int,
                       forced: bool = False) -> int:
        """Tokens (<= want) a mid-prefill request's next chunk can
        absorb within the remaining budget (`forced` plans it
        regardless)."""

    @abc.abstractmethod
    def grant_admit(self, req: Request, want: int) -> int:
        """Tokens (<= want) a queued request's FIRST chunk can absorb
        if admitted now; 0 means not fundable this step."""


class SequenceBackend(abc.ABC):
    """The reference's protocol (see the module docstring)."""

    families: tuple[str, ...] = ()

    @abc.abstractmethod
    def validate(self, prompt_len: int, max_new_tokens: int) -> None: ...

    @abc.abstractmethod
    def admit(self, req: Request) -> AdmitPlan: ...

    @abc.abstractmethod
    def probe_shared(self, req: Request) -> int: ...

    @abc.abstractmethod
    def budget(self) -> BudgetProbe: ...

    @abc.abstractmethod
    def can_fund(self, req: Request, n_tokens: int) -> bool: ...

    @abc.abstractmethod
    def prepare_decode(self, reqs: list[Request], evict) -> None: ...

    @abc.abstractmethod
    def fund_prefill(self, req: Request, want: int, evict) -> int: ...

    @abc.abstractmethod
    def prefill_step(self, chunks: list[tuple[Request, int]]): ...

    @abc.abstractmethod
    def decode_step(self, reqs: list[Request]): ...

    @abc.abstractmethod
    def release(self, req: Request) -> None: ...

    @abc.abstractmethod
    def utilization(self) -> tuple[float, float]: ...

    @abc.abstractmethod
    def snapshot_metrics(self) -> dict: ...

    @abc.abstractmethod
    def check_invariants(self) -> None: ...


# ---------------------------------------------------------------------------
# paged KV backend (attention families)
# ---------------------------------------------------------------------------


def _paged_steps(cfg: ModelConfig, policy: ArithmeticPolicy,
                 attn_impl: str = "gather"):
    """(prefill, decode) step pair; attn_impl="fused" puts the
    paged-attention kernel into the steps' `paged_core` seam."""
    paged_core = (make_fused_paged_core(cfg, policy)
                  if attn_impl == "fused" else None)
    return (make_paged_chunked_prefill(cfg, policy, paged_core=paged_core),
            make_paged_decode(cfg, policy, paged_core=paged_core))


@dataclasses.dataclass
class PagedSeqState:
    """PagedKVBackend's per-request `req.mem`."""
    pages: list[int] = dataclasses.field(default_factory=list)
    shared_len: int = 0          # leading tokens resident via prefix
    #                              sharing at admission: prefill skips
    #                              their writes, seq_len covers them


class PagedBudget(BudgetProbe):
    """Page-pool planning: charges whole pages, prefix-sharing aware —
    an admission is billed only for the UNSHARED pages of its first
    chunk."""

    def __init__(self, page_size: int, free_pages: int, probe=None):
        self.page_size = page_size
        self.free = free_pages
        self.probe = probe or (lambda r: 0)

    def grant_continue(self, req: Request, want: int,
                       forced: bool = False) -> int:
        page = self.page_size
        pos = req.prefill_pos
        shared = req.mem.shared_len if req.mem is not None else 0
        # resident coverage: chunks written so far plus any shared
        # prefix (a sharer's cursor can sit BELOW its resident tokens
        # while it reruns the last prompt token for logits)
        covered = max(pos, shared)
        held = -(-covered // page)       # pages already allocated
        headroom = held * page - pos     # free slots in held pages
        n = want if forced else min(want, headroom + self.free * page)
        if n <= 0:
            return 0
        self.free -= max(0, -(-(pos + n) // page) - held)
        self.free = max(self.free, 0)
        return n

    def grant_admit(self, req: Request, want: int) -> int:
        page = self.page_size
        ep_len = len(req.effective_prompt())
        shared = min(self.probe(req), ep_len)
        # at least the last prompt token must run for its logits, so a
        # full prefix hit still admits a 1-token rerun chunk
        start = min(shared, ep_len - 1)
        held = -(-shared // page)        # pages sharing will grant
        n = min(want, ep_len - start,
                held * page + self.free * page - start)
        if n <= 0:
            return 0
        self.free -= max(0, -(-(start + n) // page) - held)
        return n


class PagedKVBackend(SequenceBackend):
    """Paged KV cache with refcounted copy-on-write prefix sharing.

    Memory = fixed-size token pages (`paged_cache.PageAllocator` +
    `PrefixIndex`); forwards = the chunked-prefill / decode steps of
    `paged_model`, on the device of `params` (the port's
    `Transformer`). At admission the effective prompt is matched
    against the index of already-resident pages: matched pages are
    SHARED (refcount + 1) instead of re-prefilled, prefill skips their
    writes via the chunk's write_from mask, and a write landing in a
    co-owned page COW-forks it to a private device copy first.
    `n_forwards` counts the step calls (prefill chunks + decode
    rounds) that ran a model forward, `n_prefill_forwards` the prefill
    chunks among them.
    """

    families = FAMILIES

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 policy: ArithmeticPolicy, params, obs: Tracer, clock):
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = params.device
        self.cache = init_paged_cache(
            cfg, ecfg.n_pages, ecfg.page_size,
            dtype=torch_dtype(ecfg.cache_dtype), device=self.device)
        self.prefix = PrefixIndex(ecfg.page_size)
        self._prefill_fn, self._decode_fn = _paged_steps(
            cfg, policy, ecfg.attn_impl)
        self._obs = obs             # Tracer: events + metrics registry
        self._now = clock           # virtual-clock read: now() -> float
        # rid -> (index generation, matched, pages): memoized prefix
        # matches, invalidated when the index mutates or on release
        self._match_memo: dict[int, tuple[int, int, list[int]]] = {}
        self.n_forwards = 0
        self.n_prefill_forwards = 0

    # -- admission ----------------------------------------------------------

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        # last cache write lands at position prompt+gen-2 (the final
        # sampled token is never fed back), so this bounds page usage
        worst_pages = self.cache.allocator.pages_for(
            prompt_len + max_new_tokens - 1)
        if worst_pages > self.ecfg.max_pages_per_seq:
            raise ValueError(
                f"request needs up to {worst_pages} pages, block table "
                f"holds {self.ecfg.max_pages_per_seq}")
        if worst_pages > self.ecfg.n_pages - 1:
            raise ValueError(
                f"request needs up to {worst_pages} pages, pool has "
                f"{self.ecfg.n_pages - 1}")

    def _match_prefix(self, req: Request) -> tuple[int, list[int]]:
        """Memoized PrefixIndex.match for a queued request."""
        gen = self.prefix.generation
        hit = self._match_memo.get(req.rid)
        if hit is None or hit[0] != gen:
            matched, pages = self.prefix.match(req.effective_prompt())
            hit = (gen, matched, pages)
            self._match_memo[req.rid] = hit
        return hit[1], hit[2]

    def probe_shared(self, req: Request) -> int:
        if not self.ecfg.prefix_sharing:
            return 0
        return self._match_prefix(req)[0]

    def admit(self, req: Request) -> AdmitPlan:
        """Attach a page table; share every resident page covering a
        leading run of the effective prompt, start the prefill cursor
        past the shared tokens (capped so the last prompt token always
        reruns for its logits), and count the hit."""
        req.mem = PagedSeqState()
        ep = req.effective_prompt()
        reg = self._obs.registry
        reg.inc("backend/n_admissions")
        reg.inc("backend/prompt_tokens", len(ep))
        if not self.ecfg.prefix_sharing:
            return AdmitPlan()
        matched, spages = self._match_prefix(req)
        self._match_memo.pop(req.rid, None)   # ep changes once laned
        if matched <= 0:
            return AdmitPlan()
        self.cache.allocator.share(spages, req.rid)
        req.mem.pages = list(spages)
        req.mem.shared_len = matched
        req.seq_len = matched
        req.prefill_pos = min(matched, len(ep) - 1)
        reg.inc("backend/n_prefix_hits")
        reg.inc("backend/shared_tokens", matched)
        self._obs.emit(ShareEvent(ts=self._now(), rid=req.rid,
                                  matched=matched))
        return AdmitPlan(shared_tokens=matched)

    def budget(self) -> PagedBudget:
        return PagedBudget(self.ecfg.page_size,
                           self.cache.allocator.n_free,
                           probe=self.probe_shared)

    def can_fund(self, req: Request, n_tokens: int) -> bool:
        page = self.ecfg.page_size
        held = len(req.mem.pages) if req.mem is not None else 0
        pos = max(req.prefill_pos, req.seq_len)
        need = -(-(pos + n_tokens) // page) - held
        return need <= self.cache.allocator.n_free

    # -- memory pressure ----------------------------------------------------

    def _forget_released(self, pages: list[int], rid: int) -> None:
        """Drop `rid`'s ownership of `pages`; pages whose last owner
        left go back to the pool AND out of the prefix index."""
        released = self.cache.allocator.free(pages, owner=rid)
        self.prefix.forget(released)

    def _make_room(self, req: Request, evict) -> bool:
        """Free at least one page via the engine's eviction policy.
        False if req itself was evicted."""
        alloc = self.cache.allocator
        while not alloc.can_alloc(1):
            if not evict():
                raise MemoryError("page pool dry with no evictable lane")
            if req.mem is None:
                return False      # req itself was the victim
        return True

    def _grow(self, req: Request, evict) -> bool:
        """Give `req` one more page, evicting under cache pressure.
        False if req itself was evicted."""
        if not self._make_room(req, evict):
            return False
        req.mem.pages.extend(self.cache.allocator.alloc(1, req.rid))
        return True

    def _divert_write(self, req: Request, j: int, evict) -> bool:
        """req is about to write into its page j: COW-fork it when
        co-owned; when sole-owned but still indexed, drop the index
        entry before the write diverges it. False if req itself was
        evicted while making room for a fork."""
        if self.cache.allocator.refcount(req.mem.pages[j]) <= 1:
            self.prefix.forget([req.mem.pages[j]])
            return True
        return self._cow_fork(req, j, evict)

    def _cow_fork(self, req: Request, j: int, evict) -> bool:
        """Copy-on-write: replace `req`'s shared page j with a private
        device copy. False if req itself was evicted while making
        room."""
        if not self._make_room(req, evict):
            return False
        alloc = self.cache.allocator
        old = req.mem.pages[j]
        if alloc.refcount(old) <= 1:
            # co-owners were evicted while making room; the page may
            # still be indexed, and the write is about to diverge it
            self.prefix.forget([old])
            return True
        [new] = alloc.alloc(1, req.rid)
        self.cache.kv = cow_copy_page(self.cache.kv, old, new)
        req.mem.pages[j] = new
        self._forget_released([old], req.rid)
        self._obs.registry.inc("backend/n_cow_forks")
        self._obs.emit(CowForkEvent(ts=self._now(), rid=req.rid,
                                    old_page=old, new_page=new))
        return True

    def prepare_decode(self, reqs: list[Request], evict) -> None:
        """Prepare every decode lane's write target, oldest admissions
        first: lanes at a page boundary get a fresh page; lanes about
        to write into a SHARED page COW-fork it first."""
        page = self.ecfg.page_size
        for req in reqs:
            if req.state is not RequestState.DECODE:
                continue   # evicted earlier in this very loop
            if req.seq_len >= len(req.mem.pages) * page:
                self._grow(req, evict)
            else:
                self._divert_write(req, req.seq_len // page, evict)

    def fund_prefill(self, req: Request, want: int, evict) -> int:
        """Allocate pages so `req` can absorb `want` more prompt
        tokens, evicting only requests admitted AFTER `req`. Returns
        the granted token count (possibly < want, or 0)."""
        page = self.ecfg.page_size
        alloc = self.cache.allocator
        end = req.prefill_pos + want
        while len(req.mem.pages) * page < end:
            if alloc.can_alloc(1):
                req.mem.pages.extend(alloc.alloc(1, req.rid))
                continue
            if not evict(exclude=req, newer_than=req):
                break
        n = min(want, len(req.mem.pages) * page - req.prefill_pos)
        if n <= 0:
            return 0
        # copy-on-write: this chunk WRITES positions [ws, we); any of
        # those pages still co-owned must be forked before the scatter
        ws = max(req.prefill_pos, req.mem.shared_len)
        we = req.prefill_pos + n
        if ws < we:
            for j in range(ws // page, -(-we // page)):
                if not self._divert_write(req, j, evict):
                    return 0       # req itself evicted making room
        return n

    # -- forwards -----------------------------------------------------------

    def _register_full_pages(self, req: Request, from_seq: int) -> None:
        """Index every page that BECAME full while req's resident
        coverage grew from from_seq to req.seq_len (prefill only)."""
        if not self.ecfg.prefix_sharing:
            return
        page = self.ecfg.page_size
        ep = req.effective_prompt()
        for j in range(from_seq // page, req.seq_len // page):
            self.prefix.register(ep[:(j + 1) * page], req.mem.pages[j])

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def prefill_step(self, chunks: list[tuple[Request, int]]):
        b, c = self.ecfg.max_batch, self.ecfg.prefill_chunk
        pmax = self.ecfg.max_pages_per_seq
        tokens = np.zeros((b, c), np.int32)
        tables = np.full((b, pmax), TRASH_PAGE, np.int32)
        start = np.zeros((b,), np.int32)
        lens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        wfrom = np.zeros((b,), np.int32)
        for i, (req, n) in enumerate(chunks):
            ep = req.effective_prompt()
            tokens[i, :n] = ep[req.prefill_pos:req.prefill_pos + n]
            tables[i, :len(req.mem.pages)] = req.mem.pages
            start[i] = req.prefill_pos
            lens[i] = n
            active[i] = True
            # positions below shared_len are resident in (possibly
            # shared) pages: rerun the query, skip the write
            wfrom[i] = req.mem.shared_len
        logits, kv = self._prefill_fn(
            self.params, self._dev(tokens), self.cache.kv,
            self._dev(tables), self._dev(start), self._dev(lens),
            self._dev(active), self._dev(wfrom))
        self.cache.kv = kv
        self.n_forwards += 1
        self.n_prefill_forwards += 1
        for req, n in chunks:
            old_seq = req.seq_len
            req.prefill_pos += n
            # a sharer rerunning inside its shared prefix already has
            # seq_len past the cursor — coverage never shrinks
            req.seq_len = max(req.seq_len, req.prefill_pos)
            self._register_full_pages(req, old_seq)
        return logits

    def decode_step(self, reqs: list[Request]):
        b, pmax = self.ecfg.max_batch, self.ecfg.max_pages_per_seq
        tokens = np.zeros((b, 1), np.int32)
        tables = np.full((b, pmax), TRASH_PAGE, np.int32)
        seq_lens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for req in reqs:
            tokens[req.lane, 0] = req.generated[-1]
            tables[req.lane, :len(req.mem.pages)] = req.mem.pages
            seq_lens[req.lane] = req.seq_len
            active[req.lane] = True
        logits, kv = self._decode_fn(
            self.params, self._dev(tokens), self.cache.kv,
            self._dev(tables), self._dev(seq_lens), self._dev(active))
        self.cache.kv = kv
        self.n_forwards += 1
        return logits

    # -- release / accounting -----------------------------------------------

    def release(self, req: Request) -> None:
        """Drop req's page references; co-owned pages stay resident
        for the other sharers."""
        if req.mem is None:
            return
        if req.mem.pages:
            self._forget_released(req.mem.pages, req.rid)
        req.mem = None
        # the effective prompt grows with generated tokens, so any
        # memoized prefix match is stale even at the same generation
        self._match_memo.pop(req.rid, None)

    def utilization(self) -> tuple[float, float]:
        return self.cache.utilization(), self.cache.logical_utilization()

    def snapshot_metrics(self) -> dict:
        reg = self._obs.registry
        return {
            "n_prefix_hits": int(reg.count("backend/n_prefix_hits")),
            "prefix_hit_rate": (
                reg.count("backend/shared_tokens")
                / max(reg.count("backend/prompt_tokens"), 1)),
            "n_cow_forks": int(reg.count("backend/n_cow_forks")),
            "physical_pages_allocated":
                self.cache.allocator.total_allocated,
        }

    def check_invariants(self) -> None:
        self.cache.allocator.check_invariants()
        for p in self.prefix.pages():
            assert self.cache.allocator.refcount(p) >= 1, \
                f"prefix index advertises non-resident page {p}"


# ---------------------------------------------------------------------------
# state-slot backend (recurrent families)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotSeqState:
    """StateSlotBackend's per-request `req.mem`."""
    slot: int


class SlotBudget(BudgetProbe):
    """Slot-pool planning: a sequence costs exactly ONE slot for its
    whole lifetime, so continuing chunks are free (the slot is already
    held) and an admission charges one slot."""

    def __init__(self, free_slots: int):
        self.free = free_slots

    def grant_continue(self, req: Request, want: int,
                       forced: bool = False) -> int:
        return want

    def grant_admit(self, req: Request, want: int) -> int:
        if self.free <= 0:
            return 0
        self.free -= 1
        return min(want, len(req.effective_prompt()))


class StateSlotBackend(SequenceBackend):
    """Fixed pool of per-lane recurrent state slots.

    A request holds exactly one slot from admission to release; the
    slot is reset to the family's pristine initial cache on
    allocation, chunked prefill absorbs the effective prompt into it
    token by token, and decode advances it one token per step (the
    steps of `serve.state_model`, on the device of `params`). State is
    a dense mixture of the whole history, so there is nothing to
    prefix-share (probe_shared == 0) and nothing to grow: once
    admitted, a request can always decode to completion, so the only
    eviction this backend sees is externally forced, and preemption
    recovers by recompute into a fresh slot. `n_forwards` counts the
    step calls (`n_prefill_forwards` the prefill chunks among them),
    `n_applies` the single-token model applies they ran.
    """

    families = ("rwkv6", "zamba2")

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 policy: ArithmeticPolicy, params, obs: Tracer, clock):
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = params.device
        self.n_slots = ecfg.n_slots or ecfg.max_batch + 1
        # the page allocator is a generic refcounting free list over
        # ids [1, n); reused as the slot allocator (slot "size" 1,
        # refcounts stay at 1: slots are never shared)
        self.allocator = PageAllocator(self.n_slots, 1)
        self.pool, self.init_slot = init_slot_pool(
            cfg, self.n_slots, ecfg.max_seq_len,
            dtype=torch_dtype(ecfg.cache_dtype), device=self.device)
        self._prefill_fn = make_slot_prefill_chunk(cfg, policy)
        self._decode_fn = make_slot_decode(cfg, policy)
        self._obs = obs
        self._now = clock
        self.n_forwards = 0
        self.n_prefill_forwards = 0
        self.n_applies = 0

    # -- admission ----------------------------------------------------------

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        # the final sampled token is never fed back into the state
        total = prompt_len + max_new_tokens - 1
        if total > self.ecfg.max_seq_len:
            raise ValueError(
                f"request absorbs up to {total} tokens, max_seq_len "
                f"is {self.ecfg.max_seq_len}")

    def admit(self, req: Request) -> AdmitPlan:
        if not self.allocator.can_alloc(1):
            # unreachable from engine flow: the scheduler budgets
            # admissions against free slots via SlotBudget
            raise MemoryError("state-slot pool dry at admission")
        [slot] = self.allocator.alloc(1, req.rid)
        # a freed slot holds its previous occupant's state; reset to
        # the pristine initial cache before the new prompt lands
        reset_slot(self.pool, self.init_slot, slot)
        req.mem = SlotSeqState(slot=slot)
        reg = self._obs.registry
        reg.inc("backend/n_admissions")
        reg.inc("backend/prompt_tokens", len(req.effective_prompt()))
        return AdmitPlan()

    def probe_shared(self, req: Request) -> int:
        return 0

    def budget(self) -> SlotBudget:
        return SlotBudget(self.allocator.n_free)

    def can_fund(self, req: Request, n_tokens: int) -> bool:
        if req.mem is not None:
            return True          # the slot absorbs any token count
        return self.allocator.can_alloc(1)

    def prepare_decode(self, reqs: list[Request], evict) -> None:
        pass                     # fixed-size state never grows

    def fund_prefill(self, req: Request, want: int, evict) -> int:
        return want              # the slot was funded at admission

    # -- forwards -----------------------------------------------------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def prefill_step(self, chunks: list[tuple[Request, int]]):
        b, c = self.ecfg.max_batch, self.ecfg.prefill_chunk
        tokens = np.zeros((b, c), np.int32)
        slot_ids = np.full((b,), TRASH_SLOT, np.int64)
        lens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for i, (req, n) in enumerate(chunks):
            ep = req.effective_prompt()
            tokens[i, :n] = ep[req.prefill_pos:req.prefill_pos + n]
            slot_ids[i] = req.mem.slot
            lens[i] = n
            active[i] = True
        logits, self.pool = self._prefill_fn(
            self.params, self._dev(tokens), self.pool, self._dev(slot_ids),
            lens, active)
        self.n_forwards += 1
        self.n_prefill_forwards += 1
        self.n_applies += chunk_steps(lens, active)
        for req, n in chunks:
            req.prefill_pos += n
            req.seq_len = req.prefill_pos
        return logits

    def decode_step(self, reqs: list[Request]):
        b = self.ecfg.max_batch
        tokens = np.zeros((b, 1), np.int32)
        slot_ids = np.full((b,), TRASH_SLOT, np.int64)
        for req in reqs:
            tokens[req.lane, 0] = req.generated[-1]
            slot_ids[req.lane] = req.mem.slot
        logits, self.pool = self._decode_fn(
            self.params, self._dev(tokens), self.pool, self._dev(slot_ids))
        self.n_forwards += 1
        self.n_applies += 1
        return logits

    # -- release / accounting -----------------------------------------------

    def release(self, req: Request) -> None:
        if req.mem is None:
            return
        self.allocator.free([req.mem.slot], owner=req.rid)
        req.mem = None

    def utilization(self) -> tuple[float, float]:
        u = self.allocator.n_used / max(self.n_slots - 1, 1)
        return u, u              # slots are never shared

    def snapshot_metrics(self) -> dict:
        return {
            "n_state_slots": self.n_slots - 1,
            "state_slots_allocated": self.allocator.total_allocated,
        }

    def check_invariants(self) -> None:
        self.allocator.check_invariants()
        assert self.allocator.n_logical == self.allocator.n_used, \
            "state slots must never be shared across requests"


# ---------------------------------------------------------------------------
# family routing
# ---------------------------------------------------------------------------


def make_backend(cfg: ModelConfig, ecfg: EngineConfig,
                 policy: ArithmeticPolicy, params, obs: Tracer,
                 clock) -> SequenceBackend:
    """Route a model family to its sequence backend; refuse, by name,
    what is not ported yet."""
    if ecfg.mesh_shards > 1:
        raise NotImplementedError(
            f"mesh_shards={ecfg.mesh_shards}: the tensor-parallel serve "
            f"mesh is not ported yet (set mesh_shards=1)")
    if policy.mode == "artemis" and policy.sigma_analog > 0.0:
        raise NotImplementedError(
            f"sigma_analog={policy.sigma_analog}: the analog readout "
            f"noise of the artemis mode is not ported yet")
    for backend_cls in (PagedKVBackend, StateSlotBackend):
        if cfg.family in backend_cls.families:
            return backend_cls(cfg, ecfg, policy, params, obs, clock)
    served = PagedKVBackend.families + StateSlotBackend.families
    raise ValueError(
        f"no sequence backend serves family {cfg.family!r} "
        f"(available: {served})")
