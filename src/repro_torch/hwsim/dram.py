"""DRAM geometry helpers — what fits where, and how fast it moves.

Maps matrix work onto the ARTEMIS hierarchy:
  stack > channel > bank > subarray (128/bank, half active) > tile (32).

Throughput primitives (all per the paper's §III):
  * A tile holds two 128-bit operand rows + computational rows; processes
    2 multiplies at a time; 40 MACs per readout round via 2 MOMCAPs.
  * A subarray = 32 tiles -> 64 concurrent MACs; the paper's headline
    "64 MACs in 48 ns per subarray".
  * A bank = 64 active subarrays -> 4096 concurrent MACs.
  * Banks run independently (token parallelism); the shared intra-channel
    bus serializes inter-bank transfers (ring + broadcast, §III.D.1).
"""
from __future__ import annotations

import dataclasses

from repro_torch.hwsim.constants import ArtemisConfig


@dataclasses.dataclass(frozen=True)
class DramGeometry:
    cfg: ArtemisConfig

    @property
    def macs_per_subarray(self) -> int:
        """Concurrent MACs per subarray (2 per tile x 32 tiles)."""
        return 2 * self.cfg.tiles_per_subarray

    @property
    def macs_per_bank(self) -> int:
        return self.macs_per_subarray * self.cfg.active_subarrays_per_bank

    @property
    def total_concurrent_macs(self) -> int:
        return self.macs_per_bank * self.cfg.n_banks

    def mac_round_latency_ns(self) -> float:
        """One 40-MAC accumulation round in a tile: 40 sequential SC
        multiplies (2 MOCs each, tiles pipelined two-at-a-time) + the
        A_to_B readout. Matches the paper's 64 MACs / 48 ns per-subarray
        number when amortized across the 32 tiles' parallel operation."""
        c = self.cfg
        t_mults = c.momcap_depth * c.t_mul_ns / c.caps_per_tile
        return t_mults + c.t_s_to_b_ns

    def dot_product_latency_ns(self, k: int) -> float:
        """Latency of one length-k dot product mapped across tiles
        (paper Fig 5(a)): ceil(k / 40) rounds + the NSC reduction tree."""
        c = self.cfg
        rounds = -(-k // self.cfg.momcap_depth) / c.caps_per_tile
        t_reduce = (c.t_latch_ps + c.t_addsub_ps) / 1000.0 * 2
        return rounds * self.mac_round_latency_ns() + t_reduce

    def matmul_macs(self, m: int, k: int, n: int) -> int:
        return m * k * n

    def matmul_latency_ns(self, m: int, k: int, n: int,
                          banks: int | None = None) -> float:
        """Blocked matmul latency on `banks` banks (default: all)."""
        banks = banks or self.cfg.n_banks
        total = self.matmul_macs(m, k, n)
        per_round = banks * self.macs_per_bank * self.cfg.momcap_depth \
            * self.cfg.caps_per_tile
        rounds = -(-total // per_round)
        return rounds * self.mac_round_latency_ns()

    # -- energy -------------------------------------------------------------
    def mac_energy_pj(self, n_macs: int) -> float:
        """SC MAC energy: 2 MOCs (operand copies) per multiply, amortized
        over the bank-wide activation. As in Ambit/DRISA-style in-DRAM
        compute, one ACTIVATE command drives one row in EVERY active
        subarray of the bank simultaneously (e_act is per bank-level
        ACTIVATE, Table I), so an activate pair feeds
        active_subarrays x tiles x 2 concurrent products
        (= 64 x 32 x 2 = 4096). This is what keeps ARTEMIS inside its
        60 W budget (sanity check in tests/test_hwsim.py)."""
        c = self.cfg
        macs_per_act_pair = (c.active_subarrays_per_bank
                             * c.tiles_per_subarray * 2)
        return 2.0 * c.e_act_pj * n_macs / macs_per_act_pair

    def transfer_energy_pj(self, bits: int, hops: int = 1) -> float:
        """Inter-bank transfer over the shared bus (binary format)."""
        c = self.cfg
        return bits * (c.e_pre_gsa_pj_b + c.e_post_gsa_pj_b) * hops

    def transfer_latency_ns(self, bits: int) -> float:
        return bits * self.cfg.t_link_ns_per_bit
