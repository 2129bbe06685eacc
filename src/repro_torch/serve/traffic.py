"""Synthetic traffic for the serving engine.

Poisson arrivals (exponential inter-arrival gaps) with configurable
prompt/generation length distributions — the many-concurrent-requests
regime the ROADMAP north-star targets, in deterministic, seedable form
so scheduler tests can replay the exact same trace.

Two prompt modes:

  independent (n_prefix_groups == 0) — every prompt fully random.
  shared-prefix (n_prefix_groups > 0) — `n_prefix_groups` random
      prefixes of `prefix_len` tokens are drawn once; each request
      picks a group and appends a per-request random suffix of
      [prompt_len_min, prompt_len_max] tokens. This is the few-shot /
      system-prompt traffic shape that prefix sharing in the paged KV
      cache multiplies capacity on.

Orthogonally, SAMPLED-DECODE traffic (sampled_fraction > 0): each
request is independently marked sampled with that probability and
carries `SamplingParams(temperature, top_k, top_p)` plus a
per-request RNG seed drawn from the trace rng (or the fixed
`sample_seed` when >= 0) — the mixed greedy/sampled composition real
serving sees. With sampled_fraction == 0 the trace stream is
byte-identical to the pre-sampling generator, so every greedy
token-identity suite replays unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.request import SamplingParams


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 16
    arrival_rate: float = 50.0       # requests / virtual second
    prompt_len_min: int = 4          # suffix bounds in shared-prefix mode
    prompt_len_max: int = 48
    gen_len_min: int = 4
    gen_len_max: int = 24
    vocab_size: int = 256
    seed: int = 0
    n_prefix_groups: int = 0         # 0 = independent prompts
    prefix_len: int = 0              # tokens shared within a group
    sampled_fraction: float = 0.0    # P(request decodes sampled)
    temperature: float = 0.8         # SamplingParams for sampled reqs
    top_k: int = 0
    top_p: float = 1.0
    sample_seed: int = -1            # -1 = per-request seed from the
    #                                  trace rng; >= 0 = every sampled
    #                                  request uses exactly this seed

    def __post_init__(self):
        # mirror EngineConfig: bad bounds used to fail deep inside
        # np.random with confusing errors
        if self.n_requests < 1:
            raise ValueError(
                f"n_requests must be >= 1, got {self.n_requests}")
        if not self.arrival_rate > 0:
            raise ValueError(
                f"arrival_rate must be > 0, got {self.arrival_rate}")
        if self.prompt_len_min < 1:
            raise ValueError(
                f"prompt_len_min must be >= 1, got {self.prompt_len_min}")
        if self.prompt_len_min > self.prompt_len_max:
            raise ValueError(
                f"prompt_len_min {self.prompt_len_min} > prompt_len_max "
                f"{self.prompt_len_max}")
        if self.gen_len_min < 1:
            raise ValueError(
                f"gen_len_min must be >= 1, got {self.gen_len_min}")
        if self.gen_len_min > self.gen_len_max:
            raise ValueError(
                f"gen_len_min {self.gen_len_min} > gen_len_max "
                f"{self.gen_len_max}")
        if self.vocab_size < 3:
            raise ValueError(
                f"vocab_size must be >= 3 (ids start at 2), got "
                f"{self.vocab_size}")
        if self.n_prefix_groups < 0:
            raise ValueError(
                f"n_prefix_groups must be >= 0, got "
                f"{self.n_prefix_groups}")
        if self.n_prefix_groups > 0 and self.prefix_len < 1:
            raise ValueError(
                f"prefix_len must be >= 1 when n_prefix_groups > 0, "
                f"got {self.prefix_len}")
        if self.n_prefix_groups == 0 and self.prefix_len != 0:
            raise ValueError(
                f"prefix_len {self.prefix_len} needs n_prefix_groups > 0")
        if not 0.0 <= self.sampled_fraction <= 1.0:
            raise ValueError(
                f"sampled_fraction must be in [0, 1], got "
                f"{self.sampled_fraction}")
        if self.sampled_fraction > 0:
            if self.temperature <= 0:
                raise ValueError(
                    f"sampled traffic needs temperature > 0, got "
                    f"{self.temperature}")
            # surface bad top_k/top_p/sample_seed at config time, not
            # per-item deep inside synth_trace
            SamplingParams(temperature=self.temperature,
                           top_k=self.top_k, top_p=self.top_p,
                           seed=max(self.sample_seed, 0))


@dataclasses.dataclass(frozen=True)
class TraceItem:
    arrival_time: float
    prompt: np.ndarray               # (S,) i32
    max_new_tokens: int
    prefix_group: int = -1           # -1 = independent prompt
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)


def trace_stats(items: list[TraceItem]) -> dict:
    """Summary statistics of a trace — the workload-shape metadata the
    launch CLI stamps into exported Chrome traces so a serve_trace.json
    is self-describing."""
    if not items:
        return {"n_requests": 0}
    return {
        "n_requests": len(items),
        "total_prompt_tokens": int(sum(len(it.prompt) for it in items)),
        "total_max_new_tokens": int(sum(it.max_new_tokens
                                        for it in items)),
        "n_sampled_requests": int(sum(1 for it in items
                                      if not it.sampling.greedy)),
        "first_arrival_s": float(min(it.arrival_time for it in items)),
        "last_arrival_s": float(max(it.arrival_time for it in items)),
    }


def synth_trace(tc: TrafficConfig) -> list[TraceItem]:
    """Deterministic Poisson trace; sorted by arrival time."""
    rng = np.random.default_rng(tc.seed)
    gaps = rng.exponential(1.0 / tc.arrival_rate, size=tc.n_requests)
    arrivals = np.cumsum(gaps)
    # token ids start at 2 (0/1 conventionally pad/bos in the repo's
    # synthetic batches — see launch/serve.py)
    prefixes = [
        rng.integers(2, tc.vocab_size, size=tc.prefix_len).astype(np.int32)
        for _ in range(tc.n_prefix_groups)]
    items = []
    for i in range(tc.n_requests):
        plen = int(rng.integers(tc.prompt_len_min, tc.prompt_len_max + 1))
        glen = int(rng.integers(tc.gen_len_min, tc.gen_len_max + 1))
        suffix = rng.integers(2, tc.vocab_size, size=plen).astype(np.int32)
        group = -1
        if tc.n_prefix_groups:
            group = int(rng.integers(0, tc.n_prefix_groups))
            prompt = np.concatenate([prefixes[group], suffix])
        else:
            prompt = suffix
        # sampled_fraction == 0 draws nothing, keeping the pre-sampling
        # trace stream byte-identical for the greedy suites; above 0
        # the draws are unconditional so neither the sampled coin nor
        # a fixed sample_seed shifts the stream for later requests —
        # the SAME prompts/lengths are emitted either way
        sampling = SamplingParams()
        if tc.sampled_fraction > 0:
            sampled = rng.random() < tc.sampled_fraction
            seed = int(rng.integers(0, 2 ** 31))
            if tc.sample_seed >= 0:
                seed = tc.sample_seed
            if sampled:
                sampling = SamplingParams(
                    temperature=tc.temperature, top_k=tc.top_k,
                    top_p=tc.top_p, seed=seed)
        items.append(TraceItem(float(arrivals[i]), prompt, glen, group,
                               sampling))
    return items
