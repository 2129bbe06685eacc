"""Request lifecycle for the serving engine.

State machine:

    QUEUED -> PREFILL -> DECODE -> DONE
       ^                   |
       +---- (preempt) ----+

Prefill is CHUNKED: a request can sit in PREFILL across many engine
steps, `prefill_pos` marking how many tokens of its effective prompt
the backend has absorbed (written to paged K/V, or folded into a
recurrent state slot). `seq_len` counts the tokens the backend's
device state currently covers. Everything else the backend needs to
serve the request — page tables, refcounted shared prefixes, a state
slot id — lives in `mem`, an opaque object owned by the engine's
`SequenceBackend` (see repro.serve.backend): the engine and scheduler
never look inside it.

A preempted request (from either PREFILL or DECODE) is re-queued in
*recompute* style: its prompt becomes original-prompt +
tokens-generated-so-far, the backend releases its `mem`, and a later
admission re-prefills from scratch — token-identical to never having
been preempted for greedy AND sampled requests alike (a sampled
request's RNG lane is keyed by `(seed, tokens generated so far)`, so
replay re-draws the same tokens — see repro.serve.sampler).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.serve.obs import PhaseAttribution


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration, threaded through
    `ServeEngine.submit()` into the `Request` and consumed by
    `repro.serve.sampler`.

    `temperature=0.0` is the greedy fast path: plain argmax, no RNG,
    `top_k`/`top_p` irrelevant — the semantics every pre-sampling
    token-identity suite pins. Any `temperature > 0` samples from the
    temperature-scaled, top-k- then top-p-truncated distribution on a
    per-request RNG lane keyed by `(seed, tokens generated so far)`,
    so a request's sampled stream is deterministic and independent of
    batch composition, chunking, scheduling, and preemption (the
    contract `sampler.py` documents and tests pin over both backends).
    """
    temperature: float = 0.0     # 0.0 = greedy argmax
    top_k: int = 0               # 0 = no truncation
    top_p: float = 1.0           # nucleus mass; 1.0 = no truncation
    seed: int = 0                # RNG-lane seed for sampled decode

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")
        if not 0 <= self.seed < 2 ** 32:
            raise ValueError(
                f"seed must be a uint32 (0 <= seed < 2**32), got "
                f"{self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) i32 — original prompt
    max_new_tokens: int
    arrival_time: float = 0.0
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    state: RequestState = RequestState.QUEUED
    generated: list[int] = dataclasses.field(default_factory=list)
    mem: object | None = None        # backend-owned sequence memory
    #                                  (page table / state slot / ...)
    seq_len: int = 0                 # tokens covered by device state
    prefill_pos: int = 0             # effective-prompt tokens prefilled
    lane: int = -1                   # batch lane (prefill or decode), -1 = none
    n_preemptions: int = 0
    # metrics (virtual-clock seconds)
    t_first_token: float | None = None
    t_done: float | None = None
    # per-phase energy/time attribution: each executed step's ARTEMIS
    # price is split across participating lanes by token share
    # (repro.serve.obs.PhaseAttribution); recompute after preemption
    # re-attributes — energy spent is energy spent
    attr: PhaseAttribution = dataclasses.field(
        default_factory=PhaseAttribution)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def effective_prompt(self) -> np.ndarray:
        """Prompt for (re-)prefill: original prompt plus everything
        generated so far (recompute-style preemption recovery)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def latency(self) -> float | None:
        if self.t_done is None:
            return None
        return self.t_done - self.arrival_time

    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time
