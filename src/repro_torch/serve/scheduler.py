"""Continuous-batching scheduler — admission control + step composition.

Each engine step the scheduler composes ONE action:

  prefill — run one fixed-size chunk (<= prefill_chunk tokens) for a
            BATCH of requests: every request already mid-prefill
            continues its next chunk, and head-of-line queued requests
            (strict FCFS) are admitted into free lanes while the
            memory budget lasts. A prompt longer than the chunk size
            spans multiple steps instead of stalling the decode lanes.
  decode  — one token for every active decode lane.
  mixed   — prefill chunks AND decode composed into a single step,
            priced as one pass over the combined token count — the
            ARTEMIS token-parallel dataflow spreads all concurrent
            tokens over the banks, so heterogeneous compositions are
            exactly what the hardware model rewards.
  advance — nothing runnable now; jump the virtual clock to the next
            arrival.

Two policies:

  fcfs — prefill chunks whenever any exist, else decode (vLLM's
         default prompt-first ordering, never mixing).
  cost — price every candidate composition (decode-only, prefill-only,
         mixed) with the ARTEMIS cost model over its TOTAL token count
         and take the cheapest per token; exact latency ties (the
         simulator's round-based latency plateaus make them real) break
         toward lower simulated energy per token, then toward the
         composition that makes more progress. The simulated per-token
         price is U-shaped in tokens-per-pass, so small chunks ride the
         falling edge and mixing usually wins — while an UNCHUNKED
         giant prompt (prefill_chunk >= prompt) still prices worse per
         token than a busy decode batch and is deferred, preserving
         the original head-of-line guarantee when chunking is off.

AUDIT TRAIL: when the engine runs at `observability="trace"` the
scheduler emits one `DecisionEvent` (repro.serve.obs) per decide() —
the candidate compositions it priced with their per-token cost/energy,
what it chose and the reason code, the chunk plan, and every
admit/defer outcome with the budget-probe numbers that drove it — so
"why was this request deferred" is answerable from the event log
alone. At the default metrics level no audit objects are built.

The scheduler is a pure function of its inputs — determinism under a
fixed trace is a test invariant. It knows NOTHING about how sequence
memory is organized: each decide() receives a fresh `BudgetProbe` from
the engine's `SequenceBackend` (see repro.serve.backend) and charges
candidate chunks and admissions against it — page math, state-slot
counting, and the prefix-share discount (an admission is billed only
for memory its shared prefix doesn't already cover) all live behind
the probe. Eviction under memory pressure lives in the engine. One
exception to the budget: the OLDEST mid-prefill request is always
planned (`forced=True`), because the engine funds it by evicting newer
requests (mirroring decode-growth eviction order), so a tight pool can
never deadlock a half-prefilled request. When even that fails — the
missing memory is held by requests OLDER than the prefiller, which
eviction never touches — the engine executes a decode round in the
chunk batch's place so the holders keep progressing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.cost import ArtemisCostModel
from repro_torch.serve.obs import DecisionEvent, Tracer
from repro_torch.serve.request import Request


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str            # "prefill" | "decode" | "mixed" | "advance" | "idle"
    # (rid, n_tokens) chunk plan, in execution order: continuing
    # mid-prefill requests first (oldest admission first), then new
    # FCFS admissions
    prefill: tuple[tuple[int, int], ...] = ()
    decode: bool = False
    next_time: float | None = None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "cost"       # "cost" | "fcfs"

    def __post_init__(self):
        if self.policy not in ("cost", "fcfs"):
            raise ValueError(f"unknown scheduler policy {self.policy!r}")


class Scheduler:
    def __init__(self, sched_cfg: SchedulerConfig,
                 cost: ArtemisCostModel | None, prefill_chunk: int = 32,
                 obs: Tracer | None = None, clock=None):
        """`obs`/`clock` (the engine's Tracer and virtual-clock read)
        enable the per-decide() audit trail; without them — or at the
        default metrics level — decide() builds no audit objects."""
        if sched_cfg.policy == "cost" and cost is None:
            raise ValueError("cost policy needs a cost model")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.cfg = sched_cfg
        self.cost = cost
        self.prefill_chunk = prefill_chunk
        self.obs = obs
        self.clock = clock or (lambda: 0.0)

    @property
    def _auditing(self) -> bool:
        return self.obs is not None and self.obs.tracing

    def _plan_chunks(self, queued: list[Request],
                     prefilling: list[Request], free_lanes: int,
                     budget, audit: dict | None = None
                     ) -> tuple[tuple[int, int], ...]:
        """Compose this step's prefill chunk batch within the lane
        budget and the backend's memory budget. Continuing requests
        already own a lane; queued admissions consume one free lane
        each. When `audit` is given, record each admit/defer outcome
        into it (keys "admitted"/"deferred") with a reason code."""
        chunk = self.prefill_chunk
        plan: list[tuple[int, int]] = []
        for i, r in enumerate(prefilling):
            remaining = len(r.effective_prompt()) - r.prefill_pos
            n = budget.grant_continue(r, min(chunk, remaining),
                                      forced=(i == 0))
            if n <= 0:
                if audit is not None:
                    audit["deferred"].append((r.rid, "budget_exhausted"))
                continue
            plan.append((r.rid, n))
        lanes_left = free_lanes
        blocked = None               # FCFS head that failed admission
        for r in queued:
            if lanes_left <= 0:
                if audit is not None:
                    audit["deferred"].append((r.rid, "no_free_lane"))
                    continue         # keep auditing the rest
                break
            if blocked is not None:
                # strict FCFS: the head is stuck, so is everyone behind
                audit["deferred"].append((r.rid, "fcfs_head_blocked"))
                continue
            n = budget.grant_admit(r, chunk)
            if n <= 0:
                if audit is None:
                    break   # never skip the head to admit later
                audit["deferred"].append((r.rid, "budget_exhausted"))
                blocked = r.rid
                continue
            lanes_left -= 1
            plan.append((r.rid, n))
            if audit is not None:
                audit["admitted"].append((r.rid, n))
        return tuple(plan)

    def decide(self, queued: list[Request], next_arrival: float | None,
               prefilling: list[Request], decoding: list[Request],
               free_lanes: int, budget) -> Action:
        """queued: arrived, FCFS-ordered QUEUED requests; prefilling:
        mid-prefill requests in admission order; decoding: active
        decode-lane requests; budget: a fresh BudgetProbe from the
        engine's backend (consumed by this decide())."""
        audit = ({"admitted": [], "deferred": []}
                 if self._auditing else None)
        budget_free = getattr(budget, "free", None) if audit else None
        plan = self._plan_chunks(queued, prefilling, free_lanes, budget,
                                 audit)
        n_chunk = sum(n for _, n in plan)
        n_dec = len(decoding)

        def _record(chosen: str, reason: str,
                    scored: tuple = ()) -> None:
            if audit is None:
                return
            self.obs.emit(DecisionEvent(
                ts=self.clock(), chosen=chosen, reason=reason,
                candidates=scored, plan=plan, n_decode=n_dec,
                admitted=tuple(audit["admitted"]),
                deferred=tuple(audit["deferred"]),
                budget_free=budget_free))

        if not n_chunk and not n_dec:
            if next_arrival is not None:
                _record("advance", "nothing_runnable_before_arrival")
                return Action("advance", next_time=next_arrival)
            _record("idle", "no_work")
            return Action("idle")

        if self.cfg.policy == "fcfs":
            if n_chunk:
                _record("prefill", "fcfs_prompt_first")
                return Action("prefill", prefill=plan)
            _record("decode", "fcfs_no_prefill_work")
            return Action("decode", decode=True)

        # cost: rank candidate compositions by simulated price per
        # token, tie-broken by energy per token, then by progress
        candidates = []
        if n_chunk and n_dec:
            candidates.append((0, "mixed", n_chunk + n_dec))
        if n_chunk:
            candidates.append((1, "prefill", n_chunk))
        if n_dec:
            candidates.append((2, "decode", n_dec))
        kind = min(
            candidates,
            key=lambda c: (self.cost.price_per_token(c[2]),
                           self.cost.energy_per_token(c[2]), c[0]))[1]
        if audit is not None:
            scored = tuple(
                (name, n, self.cost.price_per_token(n),
                 self.cost.energy_per_token(n))
                for _, name, n in candidates)
            _record(kind, "only_candidate" if len(candidates) == 1
                    else "cheapest_per_token", scored)
        if kind == "mixed":
            return Action("mixed", prefill=plan, decode=True)
        if kind == "prefill":
            return Action("prefill", prefill=plan)
        return Action("decode", decode=True)
