"""ARTEMIS-cost-aware batch pricing — the hwsim bridge.

The scheduler doesn't invent its own latency heuristics: it prices each
candidate batch with the SAME simulator the paper's evaluation uses
(`hwsim.simulate_model` under the token_PP dataflow, i.e. the ARTEMIS
scheme of Fig 8). Token-based sharding spreads the in-flight tokens
over all banks, so batches with more concurrent tokens amortize the
ring K/V broadcast better — which is exactly the signal continuous
batching needs: a full decode lane-set prices cheaper per token than a
lone straggler, and a prefill's big token count competes on equal
footing.

The hook is pluggable: anything with `price(n_tokens) -> ns` (and
`energy(n_tokens) -> pJ` for tiebreaks) works; `None` disables
cost-aware ordering (pure FCFS).
"""
from __future__ import annotations

import collections
import dataclasses

from repro_torch.hwsim import DataflowConfig, DramGeometry, simulate_model
from repro_torch.hwsim.workloads import Workload
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArtemisCostModel:
    """Prices a candidate batch of `n_tokens` concurrent tokens through
    one full model pass on the ARTEMIS hardware model.

    Mesh-aware: with `n_shards > 1` (the engine's tensor-parallel serve
    mesh) each shard simulates only ITS slice of the model — heads and
    FFN width divided when divisible, parameters always — plus a priced
    all-reduce term for the two per-layer activation reductions TP
    inserts (attention output + FFN output), costed through the same
    `hwsim` link model the dataflow simulator uses. `n_shards == 1`
    contributes exactly 0.0 extra, so single-device pricing is
    bit-identical to the pre-mesh cost model."""
    cfg: ModelConfig
    scheme: str = "token_PP"
    n_shards: int = 1
    # bounded LRU memo over n_tokens (excluded from eq/hash; dies with
    # the instance): chunk sizes and decode batch widths repeat
    # constantly during a drain, but an adversarial token-count stream
    # must not grow the map without bound
    memo_size: int = 128
    _memo: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict, repr=False,
        compare=False)

    def __post_init__(self):
        if self.memo_size < 1:
            raise ValueError(
                f"memo_size must be >= 1, got {self.memo_size}")
        if self.n_shards < 1:
            raise ValueError(
                f"n_shards must be >= 1, got {self.n_shards}")

    def _workload(self, n_tokens: int) -> Workload:
        """One SHARD's slice of the model pass (the whole model at
        n_shards == 1): TP splits heads and FFN columns when they
        divide, and always holds 1/n of the parameters."""
        cfg, n = self.cfg, self.n_shards
        d_ff = cfg.d_ff
        if cfg.family == "moe" and cfg.d_ff_expert:
            # active FFN width per token (routed experts + shared)
            d_ff = cfg.d_ff_expert * (max(cfg.top_k, 1)
                                      + cfg.n_shared_experts)
        n_heads = cfg.n_heads // n if cfg.n_heads % n == 0 else cfg.n_heads
        if d_ff % n == 0:
            d_ff //= n
        return Workload(
            name=f"serve-{cfg.name}", params=float(cfg.param_count()) / n,
            n_layers=cfg.n_layers, n_tokens=int(n_tokens),
            n_heads=n_heads, d_model=cfg.d_model, d_ff=max(d_ff, 1))

    def _tp_collective(self, n_tokens: int) -> tuple[float, float]:
        """(latency_ns, energy_pj) of the TP all-reduces one model pass
        inserts: 2 per layer (attention output + FFN output), each over
        the (n_tokens, d_model) fp32 activation, ring-reduced so every
        shard moves 2*(n-1)/n of the tensor's bits over the inter-bank
        link. Exactly (0.0, 0.0) at n_shards == 1."""
        n = self.n_shards
        if n == 1:
            return (0.0, 0.0)
        geom = DramGeometry(DataflowConfig(scheme=self.scheme).hw)
        bits = int(n_tokens) * self.cfg.d_model * 32
        ring_bits = 2.0 * (n - 1) / n * bits
        lat = 2 * self.cfg.n_layers * geom.transfer_latency_ns(ring_bits)
        # every shard moves its ring share concurrently: latency is one
        # shard's serialization, energy is all n shards' traffic
        energy = 2 * self.cfg.n_layers \
            * geom.transfer_energy_pj(ring_bits) * n
        return (lat, energy)

    def _simulate(self, n_tokens: int):
        n = int(n_tokens)
        if n < 1:
            # an empty composition has no price; silently clamping to a
            # 1-token pass used to mask scheduler bugs that priced
            # nothing-to-run candidates
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        if n in self._memo:
            self._memo.move_to_end(n)
            return self._memo[n]
        res = simulate_model(
            self._workload(n), DataflowConfig(scheme=self.scheme))
        self._memo[n] = res
        while len(self._memo) > self.memo_size:
            self._memo.popitem(last=False)
        return res

    def price(self, n_tokens: int) -> float:
        """Latency (ns) of one model pass over n_tokens concurrent
        tokens under the configured dataflow scheme: one shard's slice
        plus the TP all-reduce term (both 0-extra at n_shards == 1)."""
        return (self._simulate(n_tokens).latency_ns
                + self._tp_collective(n_tokens)[0])

    def energy(self, n_tokens: int) -> float:
        """Energy (pJ) of the same pass — the scheduler's tiebreak when
        two candidate compositions price identically (the simulator's
        round-based latency plateaus make exact ties real). Mesh-aware:
        all n shards' compute plus the collective traffic."""
        return (self._simulate(n_tokens).energy_pj * self.n_shards
                + self._tp_collective(n_tokens)[1])

    def price_per_token(self, n_tokens: int) -> float:
        return self.price(n_tokens) / int(n_tokens)

    def energy_per_token(self, n_tokens: int) -> float:
        return self.energy(n_tokens) / int(n_tokens)
