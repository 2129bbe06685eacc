"""Serve-layer observability: typed lifecycle events, a metrics
registry, span assembly, and Chrome trace-event export — all over the
VIRTUAL ARTEMIS clock.

Everything the engine knows about a run flows through two channels:

  Tracer     — the structured-event log. Every lifecycle transition
               (queued / admit / prefill chunk / decode round /
               preempt / COW fork / finish) and every scheduler
               decision is a frozen dataclass event carrying the
               request id, virtual timestamps, token counts, and the
               ARTEMIS cost/energy of the step that produced it. At
               `level="metrics"` (the default) events are counted but
               NOT retained — a drain allocates no per-event history;
               `level="trace"` retains the full log for span assembly
               and Perfetto export.
  MetricsRegistry — counters, gauges, and streaming histograms the
               engine, scheduler, both sequence backends, and the
               sampler publish into. Histograms tally values in a
               bounded value -> count map: percentiles are EXACT
               (nearest-rank over the multiset) while the number of
               distinct values stays under `max_bins`, after which the
               map collapses into log-spaced bins (~1.8% relative
               error at the default 64 bins/decade) — never an
               unbounded sample list.

Events remain BACKWARD-COMPATIBLE with the tuple event log they
replace: each event indexes and iterates like its legacy tuple
(`ev[0]` is the kind, `("share", rid, matched, ts)` unpacks as
before), so pre-obs consumers keep working unchanged.

Span assembly (`assemble_spans`) folds a trace-level event log into
per-request span trees — queued wait, each admit->finish/preempt
lifecycle attempt, and the per-step prefill/decode execution slices —
validating on the way that every admit is closed by a finish or
preempt, that slices nest inside their attempt, and that per-request
virtual timestamps are monotone. `to_chrome_trace` turns the same log
into Chrome trace-event JSON (one Perfetto thread per request over
the virtual clock); `validate_chrome_trace` checks the required
`ph`/`ts`/`pid`/`tid` fields, and

    python -m repro.serve.obs serve_trace.json

validates an exported file from the command line (CI runs this on the
per-run trace artifact).
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import ClassVar


def percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence:
    element ceil(p/100 * n) of the 1-indexed list (so p50 of two values
    is the LOWER one, and p100 is the max — no off-by-one upward)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    k = min(max(math.ceil(p / 100.0 * n), 1), n)
    return float(sorted_vals[k - 1])


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Histogram:
    """Streaming histogram with exact nearest-rank percentiles under a
    bounded memory budget.

    Observations are tallied in a value -> count map. While the number
    of DISTINCT values stays at or under `max_bins`, percentiles are
    exact over the full multiset (identical to sorting every sample —
    virtual-clock latencies repeat heavily thanks to the simulator's
    round-based plateaus, so this is the common regime). Past the
    budget the map collapses once into log-spaced bins
    (`bins_per_decade` per decade, sign-preserving, 0 kept exact) and
    later observations land in bins too; count/sum/min/max stay exact
    forever, percentiles become bin-representative (~1.8% relative
    error at the default 64/decade). Memory is O(max_bins) always."""

    def __init__(self, max_bins: int = 4096, bins_per_decade: int = 64):
        if max_bins < 1:
            raise ValueError(f"max_bins must be >= 1, got {max_bins}")
        if bins_per_decade < 1:
            raise ValueError(
                f"bins_per_decade must be >= 1, got {bins_per_decade}")
        self.max_bins = max_bins
        self.bins_per_decade = bins_per_decade
        self.exact = True
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._counts: dict[float, int] = {}

    def _bin(self, v: float) -> float:
        if v == 0.0 or not math.isfinite(v):
            return v
        exp = round(math.log10(abs(v)) * self.bins_per_decade)
        return math.copysign(10.0 ** (exp / self.bins_per_decade), v)

    def observe(self, v, n: int = 1) -> None:
        v = float(v)
        n = int(n)
        if n < 1:
            raise ValueError(f"observation count must be >= 1, got {n}")
        self.n += n
        self.total += v * n
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        key = v if self.exact else self._bin(v)
        self._counts[key] = self._counts.get(key, 0) + n
        if self.exact and len(self._counts) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        binned: dict[float, int] = {}
        for v, c in self._counts.items():
            key = self._bin(v)
            binned[key] = binned.get(key, 0) + c
        self._counts = binned
        self.exact = False

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the tallied multiset — exact
        while `exact` holds, bin-representative after a collapse."""
        if self.n == 0:
            return 0.0
        k = min(max(math.ceil(p / 100.0 * self.n), 1), self.n)
        run = 0
        for v in sorted(self._counts):
            run += self._counts[v]
            if run >= k:
                return float(v)
        return float(self.vmax)   # unreachable; counts sum to n

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def values(self) -> list[float]:
        """The full sorted multiset (exact mode only — the collapsed
        map no longer knows the original samples)."""
        if not self.exact:
            raise RuntimeError(
                "histogram collapsed to bins; exact samples are gone")
        out: list[float] = []
        for v in sorted(self._counts):
            out.extend([v] * self._counts[v])
        return out

    def snapshot(self) -> dict:
        return {
            "count": self.n,
            "mean": self.mean(),
            "min": self.vmin if self.n else 0.0,
            "max": self.vmax if self.n else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "exact": self.exact,
        }


class MetricsRegistry:
    """Counters, gauges, and streaming histograms under dotted/slashed
    names. Conventions used by the serve layer: `engine/...` for
    engine-level series, `scheduler/...`, `sampler/...`, and
    `backend/...` for backend-specific series (the only namespace
    allowed to differ between sequence backends — the conformance
    suite pins that every other key set is backend-independent)."""

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    # counters ---------------------------------------------------------------

    def inc(self, name: str, v: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + v

    def count(self, name: str, default: float = 0) -> float:
        return self._counters.get(name, default)

    # gauges -----------------------------------------------------------------

    def set_gauge(self, name: str, v: float) -> None:
        self._gauges[name] = float(v)

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # histograms -------------------------------------------------------------

    def observe(self, name: str, v, n: int = 1) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        h.observe(v, n)
        return h

    def hist(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    # introspection ----------------------------------------------------------

    def keys(self) -> list[str]:
        return sorted(set(self._counters) | set(self._gauges)
                      | set(self._hists))

    def snapshot(self) -> dict:
        out: dict = {}
        for k, v in self._counters.items():
            out[k] = v
        for k, v in self._gauges.items():
            out[k] = v
        for k, h in self._hists.items():
            out[k] = h.snapshot()
        return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# typed lifecycle events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Event:
    """Base structured event. `ts` is VIRTUAL-clock seconds (the
    ARTEMIS cost model's simulated time), never wall time.

    Events index/iterate like the legacy tuples they replaced
    (`ev[0]` is the kind string, `("share", rid, matched, ts)` unpacks
    as before), so pre-obs consumers of the engine event log keep
    working. `counted` marks the kinds the legacy log retained — they
    increment the `engine/n_events` counter at every level, keeping
    step-count metrics identical whether or not events are kept."""

    ts: float
    kind: ClassVar[str] = "event"
    counted: ClassVar[bool] = True

    def legacy(self) -> tuple:
        return (self.kind, self.ts)

    def __getitem__(self, i):
        return self.legacy()[i]

    def __iter__(self):
        return iter(self.legacy())

    def __len__(self) -> int:
        return len(self.legacy())


@dataclasses.dataclass(frozen=True)
class QueuedEvent(Event):
    """Request entered the queue; `ts` is its ARRIVAL time (which may
    lie ahead of the clock at submission)."""
    rid: int = -1
    prompt_len: int = 0
    max_new_tokens: int = 0
    kind: ClassVar[str] = "queued"
    counted: ClassVar[bool] = False

    def legacy(self) -> tuple:
        return (self.kind, self.rid, self.ts)


@dataclasses.dataclass(frozen=True)
class AdmitEvent(Event):
    """Request took a batch lane and backend memory. One lifecycle
    attempt runs from here to the matching finish or preempt."""
    rid: int = -1
    lane: int = -1
    shared_tokens: int = 0       # prefix-share discount at admission
    kind: ClassVar[str] = "admit"
    counted: ClassVar[bool] = False

    def legacy(self) -> tuple:
        return (self.kind, self.rid, self.lane, self.ts)


@dataclasses.dataclass(frozen=True)
class ShareEvent(Event):
    """Admission matched `matched` resident prefix tokens (paged-KV
    backend). Legacy tuple: ("share", rid, matched, ts)."""
    rid: int = -1
    matched: int = 0
    kind: ClassVar[str] = "share"

    def legacy(self) -> tuple:
        return (self.kind, self.rid, self.matched, self.ts)


@dataclasses.dataclass(frozen=True)
class CowForkEvent(Event):
    """A write into a co-owned page forked it to a private copy.
    Legacy tuple: ("cow", rid, old_page, new_page, ts)."""
    rid: int = -1
    old_page: int = -1
    new_page: int = -1
    kind: ClassVar[str] = "cow"

    def legacy(self) -> tuple:
        return (self.kind, self.rid, self.old_page, self.new_page, self.ts)


@dataclasses.dataclass(frozen=True)
class PreemptEvent(Event):
    """Recompute-style preemption: memory released, request requeued.
    `reason` is the audit code for WHY ("decode_pressure" — a decode
    lane needed a write target; "prefill_funding" — an older prefill
    chunk claimed the memory). Legacy: ("preempt", rid, phase, ts)."""
    rid: int = -1
    phase: str = ""              # "prefill" | "decode"
    reason: str = "memory_pressure"
    kind: ClassVar[str] = "preempt"

    def legacy(self) -> tuple:
        return (self.kind, self.rid, self.phase, self.ts)


@dataclasses.dataclass(frozen=True)
class PreemptAllEvent(Event):
    """A step that executed nothing but preempted every lane — progress
    (the freed memory re-admits the victims), not a stall."""
    kind: ClassVar[str] = "preempt_all"


@dataclasses.dataclass(frozen=True)
class AdvanceEvent(Event):
    """Nothing runnable: the clock jumped to the next arrival (`ts` is
    the time jumped TO). Legacy tuple: ("advance", ts)."""
    kind: ClassVar[str] = "advance"


@dataclasses.dataclass(frozen=True)
class ExecStepEvent(Event):
    """One executed engine step. `ts` is the clock AFTER the step's
    advance; the step ran over [ts - dur_s, ts]. `price_ns` and
    `energy_pj` are the ArtemisCostModel's price for the step's
    composed `n_tokens` — the numbers per-request attribution splits
    across the participating lanes."""
    chunks: tuple = ()           # ((rid, n_tokens), ...) prefill plan
    decode_rids: tuple = ()      # rids that decoded one token
    n_tokens: int = 0
    dur_s: float = 0.0
    price_ns: float = 0.0
    energy_pj: float = 0.0

    @property
    def t_start(self) -> float:
        return self.ts - self.dur_s


@dataclasses.dataclass(frozen=True)
class PrefillStepEvent(ExecStepEvent):
    kind: ClassVar[str] = "prefill"

    def legacy(self) -> tuple:
        return (self.kind, self.chunks, self.ts)


@dataclasses.dataclass(frozen=True)
class DecodeStepEvent(ExecStepEvent):
    kind: ClassVar[str] = "decode"

    def legacy(self) -> tuple:
        return (self.kind, self.decode_rids, self.ts)


@dataclasses.dataclass(frozen=True)
class MixedStepEvent(ExecStepEvent):
    kind: ClassVar[str] = "mixed"

    def legacy(self) -> tuple:
        return (self.kind, self.chunks, self.decode_rids, self.ts)


@dataclasses.dataclass(frozen=True)
class ShardStepEvent(Event):
    """One mesh shard's share of an executed backend forward (sharded
    backends emit one per shard per prefill/decode forward, stamped
    with the clock at step START — the engine's exec-step event that
    follows carries the step's duration, so trace export renders the
    shard slices against that step's [t_start, ts] window). Span
    assembly ignores these (they are per-shard, not per-request);
    they surface as per-shard tracks in the Chrome trace."""
    shard: int = -1
    n_shards: int = 1
    phase: str = ""              # "prefill" | "decode"
    n_tokens: int = 0            # tokens this shard processed (TP:
    #                              every shard sees the full token
    #                              batch, a head/sequence slice each)
    kind: ClassVar[str] = "shard_step"
    counted: ClassVar[bool] = False

    def legacy(self) -> tuple:
        return (self.kind, self.shard, self.phase, self.ts)


@dataclasses.dataclass(frozen=True)
class FinishEvent(Event):
    """Request completed. Carries its final per-phase energy/time
    attribution so a trace alone reconstructs the cost story."""
    rid: int = -1
    n_generated: int = 0
    prefill_energy_J: float = 0.0
    decode_energy_J: float = 0.0
    sampling_energy_J: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    kind: ClassVar[str] = "finish"
    counted: ClassVar[bool] = False

    def legacy(self) -> tuple:
        return (self.kind, self.rid, self.ts)


@dataclasses.dataclass(frozen=True)
class DecisionEvent(Event):
    """Scheduler audit record for one decide(): the candidate
    compositions it priced (kind, n_tokens, price/token ns,
    energy/token pJ), what it chose and why, the chunk plan, and the
    admit/defer outcomes with the budget-probe numbers that drove
    them. Emitted at level="trace" only."""
    chosen: str = "idle"
    reason: str = ""
    candidates: tuple = ()       # ((kind, n_tokens, ns/tok, pJ/tok), ...)
    plan: tuple = ()             # ((rid, n_tokens), ...) chunk plan
    n_decode: int = 0
    admitted: tuple = ()         # ((rid, n_first_chunk), ...)
    deferred: tuple = ()         # ((rid, reason_code), ...)
    budget_free: int | None = None   # probe's free units before planning
    kind: ClassVar[str] = "decision"
    counted: ClassVar[bool] = False

    def legacy(self) -> tuple:
        return (self.kind, self.chosen, self.ts)


class Tracer:
    """One engine's observability hub: the metrics registry plus the
    level-gated structured event log.

    level="metrics" (default) — counters/gauges/histograms only; every
        emitted event is counted (legacy kinds bump `engine/n_events`)
        and immediately dropped, so a drain retains no per-event
        objects.
    level="trace" — additionally retains every event in order for span
        assembly and Chrome trace export.
    """

    LEVELS = ("metrics", "trace")

    def __init__(self, level: str = "metrics",
                 registry: MetricsRegistry | None = None):
        if level not in self.LEVELS:
            raise ValueError(
                f"observability level must be one of {self.LEVELS}, "
                f"got {level!r}")
        self.level = level
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events: list[Event] = []

    @property
    def tracing(self) -> bool:
        return self.level == "trace"

    def emit(self, ev: Event) -> Event:
        if ev.counted:
            self.registry.inc("engine/n_events")
        if self.level == "trace":
            self.events.append(ev)
        return ev


# ---------------------------------------------------------------------------
# per-request energy / cost attribution
# ---------------------------------------------------------------------------

PHASES = ("prefill", "decode", "sampling")


@dataclasses.dataclass
class PhaseAttribution:
    """Per-request split of the ArtemisCostModel's step prices. Each
    executed step's energy (pJ) and latency (ns) is divided across the
    participating lanes proportionally to their token share (chunks
    contribute their chunk length, decode lanes one token), so summing
    attribution over all requests reproduces the run's total simulated
    energy and busy time exactly (modulo fp). "sampling" counts the
    tokens drawn on non-greedy RNG lanes; the virtual clock prices
    only the model forward, so its energy/time stay zero — the phase
    exists so the token mix is visible per request."""

    tokens: dict = dataclasses.field(
        default_factory=lambda: {p: 0 for p in PHASES})
    energy_J: dict = dataclasses.field(
        default_factory=lambda: {p: 0.0 for p in PHASES})
    virtual_s: dict = dataclasses.field(
        default_factory=lambda: {p: 0.0 for p in PHASES})

    def add(self, phase: str, tokens: int, energy_J: float,
            virtual_s: float) -> None:
        self.tokens[phase] += tokens
        self.energy_J[phase] += energy_J
        self.virtual_s[phase] += virtual_s

    @property
    def total_energy_J(self) -> float:
        return sum(self.energy_J.values())

    @property
    def total_virtual_s(self) -> float:
        return sum(self.virtual_s.values())

    def summary(self) -> dict:
        return {
            "phases": {p: {"tokens": self.tokens[p],
                           "energy_J": self.energy_J[p],
                           "virtual_s": self.virtual_s[p]}
                       for p in PHASES},
            "total_energy_J": self.total_energy_J,
            "total_virtual_s": self.total_virtual_s,
        }


# ---------------------------------------------------------------------------
# span assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """A closed interval on one request's virtual timeline."""
    name: str
    rid: int
    t0: float
    t1: float
    args: tuple = ()             # ((key, value), ...) — kept hashable


@dataclasses.dataclass
class RequestTrace:
    """One request's assembled span tree: the queued wait, each
    admit -> finish/preempt lifecycle attempt, and the per-step
    prefill/decode execution slices nested inside the attempts."""
    rid: int
    queued_at: float | None = None
    attempts: list[Span] = dataclasses.field(default_factory=list)
    slices: list[Span] = dataclasses.field(default_factory=list)
    instants: list[tuple] = dataclasses.field(default_factory=list)
    finished_at: float | None = None
    open_attempt_at: float | None = None   # admit ts of an unclosed attempt


def assemble_spans(events) -> dict[int, RequestTrace]:
    """Fold a trace-level event log into per-request span trees,
    validating well-formedness on the way:

      * an admit may not land while the previous attempt is open;
      * finish/preempt must close an OPEN attempt;
      * execution slices must nest inside an open attempt;
      * each request's event timestamps are monotone non-decreasing.

    Raises ValueError on any violation. A trailing open attempt (log
    exported mid-run) is legal and left in `open_attempt_at`."""
    traces: dict[int, RequestTrace] = {}
    last_ts: dict[int, float] = {}

    def trace(rid: int) -> RequestTrace:
        if rid not in traces:
            traces[rid] = RequestTrace(rid=rid)
        return traces[rid]

    def touch(rid: int, ts: float, what: str) -> None:
        prev = last_ts.get(rid)
        if prev is not None and ts < prev - 1e-12:
            raise ValueError(
                f"request {rid}: {what} at ts {ts} precedes earlier "
                f"event at {prev} — virtual timestamps must be monotone")
        last_ts[rid] = ts

    def close_attempt(tr: RequestTrace, ts: float, how: str,
                      args: tuple) -> None:
        if tr.open_attempt_at is None:
            raise ValueError(
                f"request {tr.rid}: {how} at ts {ts} without an open "
                f"admit — every finish/preempt must close an attempt")
        tr.attempts.append(Span(how, tr.rid, tr.open_attempt_at, ts, args))
        tr.open_attempt_at = None

    def add_slice(rid: int, name: str, t0: float, t1: float,
                  args: tuple) -> None:
        tr = trace(rid)
        if tr.open_attempt_at is None:
            raise ValueError(
                f"request {rid}: {name} slice at [{t0}, {t1}] outside "
                f"any admitted lifecycle attempt")
        if t0 < tr.open_attempt_at - 1e-12:
            raise ValueError(
                f"request {rid}: {name} slice starts at {t0}, before "
                f"its attempt's admit at {tr.open_attempt_at}")
        touch(rid, t1, name)
        tr.slices.append(Span(name, rid, t0, t1, args))

    for ev in events:
        if isinstance(ev, QueuedEvent):
            trace(ev.rid).queued_at = ev.ts
            touch(ev.rid, ev.ts, "queued")
        elif isinstance(ev, AdmitEvent):
            tr = trace(ev.rid)
            touch(ev.rid, ev.ts, "admit")
            if tr.open_attempt_at is not None:
                raise ValueError(
                    f"request {ev.rid}: admit at ts {ev.ts} while the "
                    f"attempt from {tr.open_attempt_at} is still open")
            tr.open_attempt_at = ev.ts
        elif isinstance(ev, PreemptEvent):
            touch(ev.rid, ev.ts, "preempt")
            tr = trace(ev.rid)
            close_attempt(tr, ev.ts, "preempted",
                          (("phase", ev.phase), ("reason", ev.reason)))
            tr.instants.append(("preempt", ev.ts, ev.reason))
        elif isinstance(ev, FinishEvent):
            touch(ev.rid, ev.ts, "finish")
            tr = trace(ev.rid)
            close_attempt(
                tr, ev.ts, "completed",
                (("n_generated", ev.n_generated),
                 ("energy_J", ev.prefill_energy_J + ev.decode_energy_J
                  + ev.sampling_energy_J)))
            tr.finished_at = ev.ts
        elif isinstance(ev, ExecStepEvent):
            for rid, n in ev.chunks:
                add_slice(rid, "prefill_chunk", ev.t_start, ev.ts,
                          (("tokens", n),))
            for rid in ev.decode_rids:
                add_slice(rid, "decode", ev.t_start, ev.ts,
                          (("tokens", 1),))
        elif isinstance(ev, (ShareEvent, CowForkEvent)):
            trace(ev.rid).instants.append((ev.kind, ev.ts))
            touch(ev.rid, ev.ts, ev.kind)
    for tr in traces.values():
        if tr.queued_at is not None and tr.attempts:
            first = min(s.t0 for s in tr.attempts)
            if first < tr.queued_at - 1e-12:
                raise ValueError(
                    f"request {tr.rid}: admitted at {first} before its "
                    f"arrival at {tr.queued_at}")
    return traces


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

_ENGINE_TID = 0
_SHARD_PID = 1      # Chrome-trace process grouping per-shard tracks


def _us(t_s: float) -> float:
    return t_s * 1e6


def to_chrome_trace(events, metadata: dict | None = None) -> dict:
    """Render a trace-level event log as a Chrome trace-event JSON
    object (the `{"traceEvents": [...]}` object form) over the VIRTUAL
    clock, loadable in Perfetto / chrome://tracing. One thread (tid)
    per request plus tid 0 for engine-level events; complete events
    (ph "X") for steps/attempts/queued waits, instants (ph "i") for
    preemptions, shares, COW forks, and scheduler decisions."""
    traces = assemble_spans(events)   # validates well-formedness
    te: list[dict] = []

    def meta(tid: int, name: str, pid: int = 0) -> None:
        te.append({"ph": "M", "pid": pid, "tid": tid,
                   "name": "thread_name", "args": {"name": name}})

    te.append({"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
               "args": {"name": "repro.serve (virtual ARTEMIS clock)"}})
    meta(_ENGINE_TID, "engine")
    for rid in sorted(traces):
        meta(rid + 1, f"request {rid}")
    shard_ids = sorted({ev.shard for ev in events
                        if isinstance(ev, ShardStepEvent)})
    if shard_ids:
        te.append({"ph": "M", "pid": _SHARD_PID, "tid": 0,
                   "name": "process_name",
                   "args": {"name": "backend shards"}})
        for s in shard_ids:
            meta(s, f"shard {s}", pid=_SHARD_PID)

    # shard slices emitted DURING a step carry only its start time; the
    # engine's exec-step event that follows carries the duration, so
    # pending shard events render against that step's window
    pending_shards: list[ShardStepEvent] = []
    for ev in events:
        if isinstance(ev, ShardStepEvent):
            pending_shards.append(ev)
        elif isinstance(ev, ExecStepEvent):
            te.append({
                "ph": "X", "pid": 0, "tid": _ENGINE_TID,
                "name": f"step:{ev.kind}", "cat": "step",
                "ts": _us(ev.t_start), "dur": _us(ev.dur_s),
                "args": {"n_tokens": ev.n_tokens,
                         "price_ns": ev.price_ns,
                         "energy_pj": ev.energy_pj}})
            for sev in pending_shards:
                te.append({
                    "ph": "X", "pid": _SHARD_PID, "tid": sev.shard,
                    "name": f"shard{sev.shard}:{sev.phase}",
                    "cat": "backend",
                    "ts": _us(ev.t_start), "dur": _us(ev.dur_s),
                    "args": {"n_tokens": sev.n_tokens,
                             "n_shards": sev.n_shards}})
            pending_shards.clear()
        elif isinstance(ev, AdvanceEvent):
            te.append({"ph": "i", "pid": 0, "tid": _ENGINE_TID,
                       "name": "advance", "cat": "engine", "s": "g",
                       "ts": _us(ev.ts), "args": {}})
        elif isinstance(ev, PreemptAllEvent):
            te.append({"ph": "i", "pid": 0, "tid": _ENGINE_TID,
                       "name": "preempt_all", "cat": "engine", "s": "g",
                       "ts": _us(ev.ts), "args": {}})
        elif isinstance(ev, DecisionEvent):
            te.append({
                "ph": "i", "pid": 0, "tid": _ENGINE_TID,
                "name": f"decide:{ev.chosen}", "cat": "scheduler",
                "s": "t", "ts": _us(ev.ts),
                "args": {"reason": ev.reason,
                         "candidates": [list(c) for c in ev.candidates],
                         "plan": [list(c) for c in ev.plan],
                         "n_decode": ev.n_decode,
                         "admitted": [list(a) for a in ev.admitted],
                         "deferred": [list(d) for d in ev.deferred],
                         "budget_free": ev.budget_free}})
        elif isinstance(ev, PreemptEvent):
            te.append({"ph": "i", "pid": 0, "tid": ev.rid + 1,
                       "name": "preempt", "cat": "lifecycle", "s": "t",
                       "ts": _us(ev.ts),
                       "args": {"phase": ev.phase, "reason": ev.reason}})
        elif isinstance(ev, ShareEvent):
            te.append({"ph": "i", "pid": 0, "tid": ev.rid + 1,
                       "name": "prefix_share", "cat": "lifecycle",
                       "s": "t", "ts": _us(ev.ts),
                       "args": {"matched_tokens": ev.matched}})
        elif isinstance(ev, CowForkEvent):
            te.append({"ph": "i", "pid": 0, "tid": ev.rid + 1,
                       "name": "cow_fork", "cat": "lifecycle", "s": "t",
                       "ts": _us(ev.ts),
                       "args": {"old_page": ev.old_page,
                                "new_page": ev.new_page}})
        elif isinstance(ev, FinishEvent):
            te.append({
                "ph": "i", "pid": 0, "tid": ev.rid + 1, "name": "finish",
                "cat": "lifecycle", "s": "t", "ts": _us(ev.ts),
                "args": {"n_generated": ev.n_generated,
                         "prefill_energy_J": ev.prefill_energy_J,
                         "decode_energy_J": ev.decode_energy_J,
                         "sampling_energy_J": ev.sampling_energy_J,
                         "prefill_s": ev.prefill_s,
                         "decode_s": ev.decode_s}})

    for rid in sorted(traces):
        tr = traces[rid]
        tid = rid + 1
        ends = [s.t1 for s in tr.attempts]
        if tr.open_attempt_at is not None:
            ends.append(tr.open_attempt_at)
        if tr.queued_at is not None and tr.attempts:
            te.append({"ph": "X", "pid": 0, "tid": tid, "name": "queued",
                       "cat": "lifecycle", "ts": _us(tr.queued_at),
                       "dur": _us(tr.attempts[0].t0 - tr.queued_at),
                       "args": {}})
        for sp in tr.attempts:
            te.append({"ph": "X", "pid": 0, "tid": tid, "name": sp.name,
                       "cat": "lifecycle", "ts": _us(sp.t0),
                       "dur": _us(sp.t1 - sp.t0),
                       "args": dict(sp.args)})
        for sp in tr.slices:
            te.append({"ph": "X", "pid": 0, "tid": tid, "name": sp.name,
                       "cat": "exec", "ts": _us(sp.t0),
                       "dur": _us(sp.t1 - sp.t0),
                       "args": dict(sp.args)})

    out = {"traceEvents": te, "displayTimeUnit": "ns",
           "metadata": {"clock": "virtual (ARTEMIS cost model)",
                        "n_requests": len(traces)}}
    if metadata:
        out["metadata"].update(metadata)
    return out


def dumps_chrome_trace(obj: dict) -> str:
    """Deterministic serialization: same trace object -> identical
    bytes (sorted keys, fixed separators) — pinned by the export
    determinism test."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def export_chrome_trace(events, path: str,
                        metadata: dict | None = None) -> str:
    """Assemble, serialize, and write a Chrome trace-event JSON file.
    Returns the path. Open it at https://ui.perfetto.dev (or
    chrome://tracing) — the timeline is the VIRTUAL ARTEMIS clock in
    microseconds."""
    with open(path, "w") as f:
        f.write(dumps_chrome_trace(to_chrome_trace(events, metadata)))
    return path


_PHASES_OK = {"X", "i", "M", "B", "E", "C"}


def validate_chrome_trace(obj) -> dict:
    """Check a loaded Chrome trace-event object for the fields the
    format requires (`ph`/`pid`/`tid` everywhere, numeric `ts` on
    non-metadata events, non-negative `dur` on complete events).
    Raises ValueError with the first violation; returns a small
    summary dict on success."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace-event object: no 'traceEvents' key")
    evs = obj["traceEvents"]
    if not isinstance(evs, list) or not evs:
        raise ValueError("'traceEvents' must be a non-empty list")
    n_spans = n_instants = 0
    tids = set()
    t_lo, t_hi = math.inf, -math.inf
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for field in ("ph", "pid", "tid"):
            if field not in e:
                raise ValueError(f"traceEvents[{i}] missing {field!r}")
        ph = e["ph"]
        if ph not in _PHASES_OK:
            raise ValueError(f"traceEvents[{i}] has unknown ph {ph!r}")
        if ph == "M":
            continue
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}] ({ph}) needs numeric 'ts'")
        tids.add(e["tid"])
        t_lo = min(t_lo, e["ts"])
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"traceEvents[{i}] (X) needs non-negative 'dur'")
            n_spans += 1
            t_hi = max(t_hi, e["ts"] + dur)
        else:
            n_instants += 1
            t_hi = max(t_hi, e["ts"])
    return {"n_events": len(evs), "n_spans": n_spans,
            "n_instants": n_instants, "n_tracks": len(tids),
            "span_us": (t_hi - t_lo) if n_spans + n_instants else 0.0}


def _main(argv: list[str]) -> int:
    if len(argv) != 1:
        print("usage: python -m repro.serve.obs <trace.json>",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        obj = json.load(f)
    try:
        info = validate_chrome_trace(obj)
    except ValueError as e:
        print(f"INVALID {argv[0]}: {e}", file=sys.stderr)
        return 1
    print(f"OK {argv[0]}: {info['n_events']} events "
          f"({info['n_spans']} spans, {info['n_instants']} instants) "
          f"on {info['n_tracks']} tracks over {info['span_us']:.3f} "
          f"virtual us")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
