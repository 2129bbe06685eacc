"""Continuous-batching serving engine: submit() / step() / drain()
(counterpart of `repro.serve.engine`; the host logic is the
reference's line for line, the forwards run on the model's device).

The engine is BACKEND-AGNOSTIC: every model family is served through
the same request lifecycle, scheduler, and step loop, and all
sequence-memory mechanics (how K/V or recurrent state is stored,
shared, grown, and reclaimed) live behind the `SequenceBackend`
protocol (repro.serve.backend) — attention families get the paged-KV
backend, recurrent families get the state-slot backend, and this
module never branches on either.

One `step()` executes one scheduler action on the device:

  prefill — one fixed-size chunk of prompt tokens for up to max_batch
            requests AT ONCE through the backend's single compiled
            chunk step ((B, C) shapes are engine constants, so chunked
            prefill compiles exactly once). A request whose prompt
            exceeds the chunk size sits in PREFILL across steps,
            `prefill_pos` marking its cursor; memory is funded
            chunk-by-chunk. When a chunk completes the prompt, the
            first token is sampled from the last valid chunk logit and
            the request flips to DECODE on the lane it reserved at
            admission.
  decode  — every decode lane advances one token through the backend's
            single compiled decode step (fixed max-batch shape; idle
            lanes are backend-masked). The backend first makes every
            lane's write target safe; if that needs memory the pool
            doesn't have, the latest-admitted request is preempted
            (memory released, recompute-style requeue) until it fits.
  mixed   — prefill chunks AND a decode round in the same step, priced
            as ONE pass over the composed token count — the ARTEMIS
            token-parallel dataflow prices a batch by its total
            concurrent tokens, so sharing a pass is exactly where the
            hardware model wins. The two halves touch disjoint memory,
            so execution order inside the step is irrelevant to the
            results.

Admission may come with a PREFIX-SHARE DISCOUNT: a backend that can
recognize an already-resident leading run of the prompt (the paged-KV
backend's copy-on-write prefix index) starts the new request past it,
and the scheduler's budget probe charges admission only for the
unshared remainder. Backends without shareable memory report a zero
discount and everything still composes.

The engine keeps a VIRTUAL clock priced by the ARTEMIS cost model
(`hwsim.simulate_model`, token_PP dataflow): every executed step
advances time by the simulated latency of its composed batch, so
arrival interleaving, latency percentiles and the scheduler's
decisions are deterministic functions of (trace, seed) — wall-clock
throughput is measured separately by the benchmark.

SAMPLING: every token the engine emits — decode rounds and
prefill-completion first tokens alike — goes through the one batched
sampler (`repro_torch.serve.sampler.sample_tokens`) at the
(max_batch, vocab) shape, on the RNG lane of each request (its seed
and its position, nothing else), so a request's sampled stream is
batch-invariant and replays through preemption; greedy lanes
(`temperature=0`) are the argmax over the raw logits.

OBSERVABILITY: everything the engine publishes flows through one
`repro.serve.obs.Tracer` — typed lifecycle events (queued / admit /
prefill chunk / decode round / preempt / COW fork / finish, plus the
scheduler's decision audit) and a metrics registry of counters and
exact-percentile streaming histograms. At the default
`EngineConfig.observability="metrics"` only the registry is fed and no
per-event objects are retained; `observability="trace"` keeps the full
event log for span assembly and Chrome trace export
(`repro.serve.obs.export_chrome_trace`). Every executed step's ARTEMIS
price/energy is split across its participating lanes into each
request's `PhaseAttribution`, so per-request joules and
virtual-seconds by phase sum back to the run's total simulated energy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig
from repro_torch.serve import sampler
from repro_torch.serve.backend import EngineConfig, make_backend
from repro_torch.serve.cost import ArtemisCostModel
from repro_torch.serve.obs import (
    PHASES,
    AdmitEvent,
    AdvanceEvent,
    DecodeStepEvent,
    FinishEvent,
    MixedStepEvent,
    PreemptAllEvent,
    PreemptEvent,
    PrefillStepEvent,
    QueuedEvent,
    Tracer,
    percentile,
)
from repro_torch.serve.request import Request, RequestState, SamplingParams
from repro_torch.serve.scheduler import Action, Scheduler, SchedulerConfig
from repro_torch.serve.traffic import TraceItem

__all__ = ["ServeEngine", "percentile"]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params=None,
                 policy: ArithmeticPolicy = ArithmeticPolicy(),
                 ecfg: EngineConfig = EngineConfig(), seed: int = 0,
                 device="cuda"):
        """`params` is the port's model (`models.model`; see
        `repro_torch.bridge` for reference weights); None draws seeded random weights on
        `device` (a torch stream, so not the reference's values).
        Steps run on the device of the weights."""
        self.cfg = cfg
        self.ecfg = ecfg
        self.policy = policy
        if params is None:
            params = modellib.init(cfg, seed=seed, device=device)
        self.params = params
        self.cost = ArtemisCostModel(cfg, scheme=ecfg.scheme,
                                     n_shards=ecfg.mesh_shards)
        self.obs = Tracer(level=ecfg.observability)
        self.now = 0.0
        self.backend = make_backend(
            cfg, ecfg, policy, params,
            obs=self.obs, clock=lambda: self.now)
        self.scheduler = Scheduler(
            SchedulerConfig(policy=ecfg.scheduler),
            self.cost, ecfg.prefill_chunk,
            obs=self.obs, clock=lambda: self.now)
        self.requests: dict[int, Request] = {}
        self.lanes: list[Request | None] = [None] * ecfg.max_batch
        self._next_rid = 0
        self._admit_seq = 0
        self._admit_order: dict[int, int] = {}   # rid -> admission counter

    @property
    def events(self) -> list:
        """The retained structured event log — populated only at
        `observability="trace"`; empty at the default metrics level
        (the whole point: a metrics-level drain keeps no per-event
        objects)."""
        return self.obs.events

    # -- submission ---------------------------------------------------------

    def _validate_prompt(self, prompt) -> np.ndarray:
        """Accept np.ndarray or list/tuple of ints; reject non-integer
        dtypes (a float array used to silently round-trip into the
        cache) and out-of-vocab token ids."""
        if isinstance(prompt, np.ndarray):
            if not np.issubdtype(prompt.dtype, np.integer):
                raise ValueError(
                    f"prompt array must have an integer dtype, got "
                    f"{prompt.dtype}")
            arr = prompt.reshape(-1)
        elif isinstance(prompt, (list, tuple)):
            bad = [t for t in prompt
                   if not isinstance(t, (int, np.integer))
                   or isinstance(t, bool)]
            if bad:
                raise ValueError(
                    f"prompt list must contain only ints, got "
                    f"{type(bad[0]).__name__} {bad[0]!r}")
            try:
                arr = np.asarray(prompt, np.int64).reshape(-1)
            except OverflowError as e:
                raise ValueError(
                    f"prompt token out of any integer token range: "
                    f"{e}") from e
        else:
            raise TypeError(
                f"prompt must be an np.ndarray or a list of ints, got "
                f"{type(prompt).__name__}")
        if arr.size < 1:
            raise ValueError("prompt must have at least one token")
        # range-check BEFORE the int32 cast so a wide-dtype token can't
        # wrap into the valid range
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt tokens must satisfy 0 <= t < vocab_size "
                f"({self.cfg.vocab_size}), got range [{lo}, {hi}]")
        return arr.astype(np.int32)

    def submit(self, prompt, max_new_tokens: int,
               arrival_time: float = 0.0,
               sampling: SamplingParams | None = None) -> int:
        prompt = self._validate_prompt(prompt)
        sampling = sampling if sampling is not None else SamplingParams()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.backend.validate(len(prompt), max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            arrival_time=float(arrival_time), sampling=sampling)
        if self.obs.tracing:
            self.obs.emit(QueuedEvent(
                ts=float(arrival_time), rid=rid,
                prompt_len=len(prompt), max_new_tokens=max_new_tokens))
        return rid

    def submit_trace(self, items: list[TraceItem]) -> list[int]:
        return [self.submit(it.prompt, it.max_new_tokens, it.arrival_time,
                            sampling=it.sampling)
                for it in items]

    # -- stepping -----------------------------------------------------------

    def _queued_visible(self) -> list[Request]:
        qs = [r for r in self.requests.values()
              if r.state is RequestState.QUEUED
              and r.arrival_time <= self.now]
        return sorted(qs, key=lambda r: (r.arrival_time, r.rid))

    def _next_arrival(self) -> float | None:
        future = [r.arrival_time for r in self.requests.values()
                  if r.state is RequestState.QUEUED
                  and r.arrival_time > self.now]
        return min(future) if future else None

    def _laned(self) -> list[Request]:
        return [r for r in self.lanes if r is not None]

    def _decoding(self) -> list[Request]:
        return [r for r in self.lanes
                if r is not None and r.state is RequestState.DECODE]

    def _prefilling(self) -> list[Request]:
        pf = [r for r in self.lanes
              if r is not None and r.state is RequestState.PREFILL]
        return sorted(pf, key=lambda r: self._admit_order[r.rid])

    def step(self):
        """Execute one scheduler action; returns the event (a typed
        `repro.serve.obs` event, tuple-compatible with the legacy log)
        or None when there is nothing left to do."""
        action = self.scheduler.decide(
            self._queued_visible(), self._next_arrival(),
            self._prefilling(), self._decoding(),
            self.lanes.count(None), self.backend.budget())
        if action.kind == "idle":
            return None
        if action.kind == "advance":
            self.now = action.next_time
            return self.obs.emit(AdvanceEvent(ts=action.next_time))
        ev = self._do_mixed(action)
        if ev is not None and ev.kind != "preempt_all":
            # utilization of EXECUTED batches
            phys, logical = self.backend.utilization()
            reg = self.obs.registry
            reg.inc("engine/util_phys_sum", phys)
            reg.inc("engine/util_logical_sum", logical)
            reg.inc("engine/util_samples")
        return ev

    def drain(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if all(r.state is RequestState.DONE
                   for r in self.requests.values()):
                return
            # a ("preempt_all", ...) step executes nothing but DOES
            # make progress (the released memory re-admits the evicted
            # requests), so only a genuinely idle None stalls
            if self.step() is None:
                break
        undone = [r.rid for r in self.requests.values()
                  if r.state is not RequestState.DONE]
        if undone:
            raise RuntimeError(f"drain stalled with requests {undone}")

    # -- actions ------------------------------------------------------------

    def _evict_newest(self, exclude: Request | None = None,
                      newer_than: Request | None = None,
                      reason: str = "memory_pressure") -> bool:
        """Backend eviction hook: preempt the latest-admitted laned
        request (optionally excluding one, optionally only requests
        admitted after `newer_than`). Returns False when no such
        victim exists — the backend decides what that means."""
        victims = [r for r in self._laned() if r is not exclude]
        if newer_than is not None:
            bar = self._admit_order[newer_than.rid]
            victims = [r for r in victims
                       if self._admit_order[r.rid] > bar]
        if not victims:
            return False
        self._preempt(max(victims,
                          key=lambda r: self._admit_order[r.rid]),
                      reason=reason)
        return True

    def _preempt(self, req: Request,
                 reason: str = "memory_pressure") -> None:
        phase = "prefill" if req.state is RequestState.PREFILL else "decode"
        # the backend drops only THIS request's memory (anything shared
        # with other requests stays resident)
        self.backend.release(req)
        req.seq_len = 0
        req.prefill_pos = 0
        self.lanes[req.lane] = None
        req.lane = -1
        req.state = RequestState.QUEUED
        req.n_preemptions += 1
        self.obs.registry.inc("engine/n_preemptions")
        self.obs.emit(PreemptEvent(ts=self.now, rid=req.rid,
                                   phase=phase, reason=reason))

    def _decode_growth_order(self) -> list[Request]:
        """Decode lanes oldest-admission first, so the backend's
        memory-pressure eviction lands on the newest request."""
        return sorted(self._decoding(),
                      key=lambda r: self._admit_order[r.rid])

    # -- sampling -----------------------------------------------------------

    def _sample_rows(self, logits, rows: list[tuple[int, Request]]
                     ) -> np.ndarray:
        """Sample one token per (row, request) from `(max_batch, V)`
        logits through the batched fixed-shape sampler. Each request
        draws on its own RNG lane keyed by (its seed, its token count
        so far) — never the engine step or the row — so its stream is
        batch-invariant and preemption-replayable; greedy lanes reduce
        to argmax, bit-identical to the pre-sampling greedy path.
        Unlisted rows are sampled as greedy garbage and ignored."""
        b = self.ecfg.max_batch
        temp = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        top_p = np.ones((b,), np.float32)
        seed = np.zeros((b,), np.uint32)
        pos = np.zeros((b,), np.int32)
        reg = self.obs.registry
        for row, req in rows:
            sp = req.sampling
            temp[row] = sp.temperature
            top_k[row] = sp.top_k
            top_p[row] = sp.top_p
            seed[row] = sp.seed
            pos[row] = len(req.generated)
            if sp.greedy:
                reg.inc(sampler.N_GREEDY_KEY)
            else:
                reg.inc(sampler.N_SAMPLED_KEY)
                # the virtual clock prices only the model forward, so
                # the sampling phase carries the token mix at zero
                # energy/time (see PhaseAttribution)
                req.attr.add("sampling", 1, 0.0, 0.0)
        return sampler.sample_tokens(logits, temp, top_k, top_p, seed, pos)

    def _do_mixed(self, action: Action):
        """Execute a prefill / decode / mixed step: fund all memory
        first (decode write targets, then prefill chunks — preemption
        between the halves is resolved before anything runs), then the
        decode and chunked-prefill forwards, then advance the clock
        ONCE by the price of the composed token count."""
        preempted_before = sum(r.n_preemptions
                               for r in self.requests.values())

        def evict_decode(**kw):
            return self._evict_newest(reason="decode_pressure", **kw)

        def evict_prefill(**kw):
            return self._evict_newest(reason="prefill_funding", **kw)

        # 1. make decode write targets safe, oldest admissions first
        #    so eviction pressure lands on the newest request
        if action.decode:
            self.backend.prepare_decode(self._decode_growth_order(),
                                        evict_decode)

        # 2. prefill chunk funding (plan order = admission order, then
        #    FCFS admissions); a request that was evicted after the
        #    plan was made is skipped
        chunks: list[tuple[Request, int]] = []
        for rid, want in action.prefill:
            req = self.requests[rid]
            if req.state is RequestState.QUEUED and req.lane < 0:
                if None not in self.lanes:
                    continue   # lanes filled by an earlier admission
                lane = self.lanes.index(None)
                req.lane = lane
                self.lanes[lane] = req
                req.state = RequestState.PREFILL
                self._admit_order[req.rid] = self._admit_seq
                self._admit_seq += 1
                plan = self.backend.admit(req)
                if self.obs.tracing:
                    self.obs.emit(AdmitEvent(
                        ts=self.now, rid=req.rid, lane=lane,
                        shared_tokens=plan.shared_tokens))
            elif req.state is not RequestState.PREFILL:
                continue       # preempted between plan and execution
            remaining = len(req.effective_prompt()) - req.prefill_pos
            n = self.backend.fund_prefill(req, min(want, remaining),
                                          evict_prefill)
            if n <= 0:
                continue
            chunks.append((req, n))
        # funding a later chunk may have evicted an earlier member of
        # this very batch — never run a chunk on released memory
        chunks = [(r, n) for r, n in chunks
                  if r.state is RequestState.PREFILL]

        # 3. decode forward over the lanes that survived funding. If
        #    the planned chunks could not be funded at all — the
        #    missing memory is held by OLDER requests, which eviction
        #    never touches — fall back to a decode round so those
        #    holders keep progressing and eventually release what the
        #    chunk is waiting on (drain must never stall while
        #    runnable lanes exist)
        run_decode = bool(action.decode)
        if not chunks and not run_decode and self._decoding():
            self.backend.prepare_decode(self._decode_growth_order(),
                                        evict_decode)
            run_decode = True
        dec_batch: list[Request] = []
        dec_next = None
        if run_decode:
            dec_batch = self._decoding()
        if dec_batch:
            logits = self.backend.decode_step(dec_batch)
            dec_next = self._sample_rows(
                logits, [(r.lane, r) for r in dec_batch])

        # 4. chunked + batched prefill forward (the backend advances
        #    each request's prefill_pos / seq_len)
        chunk_logits = None
        if chunks:
            chunk_logits = self.backend.prefill_step(chunks)

        # 5. one clock advance for the whole composed step, priced and
        #    energy-attributed once over the composed token count
        n_total = len(dec_batch) + sum(n for _, n in chunks)
        if n_total == 0:
            preempted = sum(r.n_preemptions
                            for r in self.requests.values())
            if preempted > preempted_before:
                # nothing ran, but the released memory makes the
                # re-queued requests immediately prefillable —
                # progress, not a stall (drain keeps going)
                return self.obs.emit(PreemptAllEvent(ts=self.now))
            return None
        price_ns = self.cost.price(n_total)
        energy_pj = self.cost.energy(n_total)
        dur_s = price_ns * 1e-9
        self.now += dur_s
        reg = self.obs.registry
        reg.inc("engine/busy_virtual_s", dur_s)
        reg.inc("engine/energy_pj", energy_pj)
        reg.observe("engine/step_tokens", n_total)
        # split the step's price/energy across participating lanes by
        # token share — summed over all requests this reproduces the
        # run's total simulated energy exactly (modulo fp)
        e_tok_J = energy_pj * 1e-12 / n_total
        t_tok_s = dur_s / n_total
        for req in dec_batch:
            req.attr.add("decode", 1, e_tok_J, t_tok_s)
        for req, n in chunks:
            req.attr.add("prefill", n, n * e_tok_J, n * t_tok_s)

        # the step event is emitted BEFORE results apply, so in the
        # trace its execution slices precede the finish/preempt marks
        # they lead to (span assembly relies on that nesting)
        dec_rids = tuple(r.rid for r in dec_batch)
        chunk_plan = tuple((req.rid, n) for req, n in chunks)
        fields = dict(ts=self.now, chunks=chunk_plan,
                      decode_rids=dec_rids, n_tokens=n_total,
                      dur_s=dur_s, price_ns=price_ns,
                      energy_pj=energy_pj)
        if action.kind == "decode" or not chunk_plan:
            ev = DecodeStepEvent(**fields)
        elif action.kind == "prefill" or not dec_rids:
            ev = PrefillStepEvent(**fields)
        else:
            ev = MixedStepEvent(**fields)
        self.obs.emit(ev)

        # 6. apply decode results
        for req in dec_batch:
            req.generated.append(int(dec_next[req.lane]))
            req.seq_len += 1
            if req.done:
                self._finish(req)

        # 7. apply prefill results: a chunk that completes its prompt
        #    samples the next token from the last VALID chunk position
        #    and flips the request to DECODE. The completing rows'
        #    last-position logits are gathered into one (max_batch, V)
        #    buffer so prefill first-tokens go through the SAME
        #    compiled sampler shape as decode rounds.
        completing = [(i, req) for i, (req, n) in enumerate(chunks)
                      if req.prefill_pos >= len(req.effective_prompt())]
        if completing:
            # device-side gather of row i's last valid position (only
            # the completing rows matter; the rest sample as ignored
            # greedy garbage) — never pull the whole (B, C, V) chunk
            # logits to host for a handful of rows
            b = self.ecfg.max_batch
            pos = np.zeros((b,), np.int32)
            for i, req in completing:
                pos[i] = chunks[i][1] - 1
            dev = chunk_logits.device
            last = chunk_logits[torch.arange(b, device=dev),
                                torch.from_numpy(pos).to(dev)]
            nxts = self._sample_rows(last, completing)
            for i, req in completing:
                req.generated.append(int(nxts[i]))
                if req.t_first_token is None:
                    req.t_first_token = self.now
                if req.done:
                    self._finish(req)
                else:
                    req.state = RequestState.DECODE

        return ev

    def _finish(self, req: Request) -> None:
        self.backend.release(req)
        if req.lane >= 0:
            self.lanes[req.lane] = None
            req.lane = -1
        req.state = RequestState.DONE
        req.t_done = self.now
        reg = self.obs.registry
        reg.inc("engine/n_done")
        reg.inc("engine/n_generated_tokens", len(req.generated))
        reg.observe("engine/latency_s", req.latency())
        ttft = req.ttft()
        if ttft is not None:
            reg.observe("engine/ttft_s", ttft)
        if self.obs.tracing:
            a = req.attr
            self.obs.emit(FinishEvent(
                ts=self.now, rid=req.rid,
                n_generated=len(req.generated),
                prefill_energy_J=a.energy_J["prefill"],
                decode_energy_J=a.energy_J["decode"],
                sampling_energy_J=a.energy_J["sampling"],
                prefill_s=a.virtual_s["prefill"],
                decode_s=a.virtual_s["decode"]))

    # -- results ------------------------------------------------------------

    def results(self) -> dict[int, np.ndarray]:
        return {rid: np.asarray(r.generated, np.int32)
                for rid, r in sorted(self.requests.items())}

    def attribution(self) -> dict[int, dict]:
        """Per-request energy/cost attribution: rid -> the request's
        `PhaseAttribution.summary()` (tokens / joules / virtual-seconds
        split over prefill, decode, and sampling). Covers every
        submitted request, finished or not; summing `total_energy_J`
        over all rids reproduces `metrics()["total_energy_J"]` within
        fp tolerance."""
        return {rid: r.attr.summary()
                for rid, r in sorted(self.requests.items())}

    def metrics(self) -> dict:
        """Aggregate run metrics, read back from the obs registry
        (every pre-obs key keeps its exact value — the registry's
        histograms are exact under their bin budget, and counters
        accumulate in the same order the old ad-hoc fields did)."""
        reg = self.obs.registry
        lat_h = reg.hist("engine/latency_s")
        ttft_h = reg.hist("engine/ttft_s")
        # every request the engine admits generates >= 1 token (submit
        # rejects max_new_tokens < 1), so done requests always have a
        # first-token time — ttft_h simply has no entry otherwise
        ttfts = ttft_h.values() if ttft_h is not None else []
        n_tok = int(reg.count("engine/n_generated_tokens"))
        samples = reg.count("engine/util_samples")
        total_energy_J = reg.count("engine/energy_pj") * 1e-12
        phase_energy_J = {p: 0.0 for p in PHASES}
        phase_virtual_s = {p: 0.0 for p in PHASES}
        for r in self.requests.values():
            for p in PHASES:
                phase_energy_J[p] += r.attr.energy_J[p]
                phase_virtual_s[p] += r.attr.virtual_s[p]
        return {
            "n_done": int(reg.count("engine/n_done")),
            "n_generated_tokens": n_tok,
            "virtual_time_s": self.now,
            "virtual_tok_per_s": n_tok / max(self.now, 1e-12),
            "p50_latency_s": (lat_h.percentile(50) if lat_h else 0.0),
            "p99_latency_s": (lat_h.percentile(99) if lat_h else 0.0),
            "mean_ttft_s": (float(np.mean(ttfts)) if ttfts else 0.0),
            "p50_ttft_s": (ttft_h.percentile(50) if ttft_h else 0.0),
            "p99_ttft_s": (ttft_h.percentile(99) if ttft_h else 0.0),
            "n_preemptions": int(reg.count("engine/n_preemptions")),
            "n_sampled_tokens": int(reg.count(sampler.N_SAMPLED_KEY)),
            "cache_utilization": (reg.count("engine/util_phys_sum")
                                  / max(samples, 1)),
            "logical_cache_utilization": (
                reg.count("engine/util_logical_sum") / max(samples, 1)),
            # observability additions (PR 6)
            "n_events": int(reg.count("engine/n_events")),
            "busy_virtual_s": reg.count("engine/busy_virtual_s"),
            "total_energy_J": total_energy_J,
            "prefill_energy_J": phase_energy_J["prefill"],
            "decode_energy_J": phase_energy_J["decode"],
            "sampling_energy_J": phase_energy_J["sampling"],
            "prefill_virtual_s": phase_virtual_s["prefill"],
            "decode_virtual_s": phase_virtual_s["decode"],
            "energy_per_token_J": total_energy_J / max(n_tok, 1),
            **self.backend.snapshot_metrics(),
        }
