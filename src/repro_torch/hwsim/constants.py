"""ARTEMIS device/circuit constants — paper Tables I & III + §III/§IV text.

Every number is traceable to the paper:
  * Table I: HBM configuration (1 stack, 8 channels, 4 banks/channel,
    128 subarrays/bank, 32 tiles/subarray, 256 rows, 256 bits/row) and
    energies (e_act = 909 pJ, e_pre_gsa = 1.51 pJ/b, e_post_gsa = 1.17
    pJ/b, e_io = 0.80 pJ/b).
  * Table III: per-subarray NSC component latency/power/area.
  * §III/§IV text: 17 ns per MOC; SC multiply = 2 MOCs = 34 ns; S_to_B
    (A_to_B ladder) = 31 ns (vs AGNI's 56 ns); 64 MACs / 48 ns per
    subarray; MOMCAP depth 20 (2 caps -> 40 MACs per operational tile);
    128-bit streams + sign; 60 W power budget; 256-bit inter-bank links;
    256 GB/s per-stack bandwidth; DRISA MUL = 1600 ns (Fig 2 baseline).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArtemisConfig:
    # ---- DRAM geometry (Table I) ----
    n_stacks: int = 1
    channels_per_stack: int = 8
    banks_per_channel: int = 4
    subarrays_per_bank: int = 128
    tiles_per_subarray: int = 32
    rows_per_tile: int = 256
    bits_per_row: int = 256

    # ---- timing (§III / §IV) ----
    t_moc_ns: float = 17.0          # one memory operation cycle
    mul_mocs: int = 2               # SC multiply = 2 MOCs (copy operands)
    t_mul_ns: float = 34.0          # = mul_mocs * t_moc_ns
    t_s_to_b_ns: float = 31.0       # A_to_B ladder (refined from AGNI 56)
    t_macs_64_ns: float = 48.0      # 64 MACs per subarray (§II.E, §IV.D)
    momcap_depth: int = 20          # accumulations per MOMCAP
    caps_per_tile: int = 2          # own + idle neighbour -> 40 MACs
    open_bitline_frac: float = 0.5  # half the subarrays active at a time

    # ---- stochastic representation ----
    sc_bits: int = 128              # 8-bit magnitude -> 128-bit stream
    value_bits: int = 8

    # ---- NSC per-subarray circuits (Table III) ----
    t_s_to_b_circ_ps: float = 20000.0
    t_comparator_ps: float = 623.7
    t_addsub_ps: float = 719.95
    t_lut_ps: float = 222.5
    t_b_to_tcu_ps: float = 530.2
    t_latch_ps: float = 77.7
    p_s_to_b_mw: float = 0.053
    p_comparator_mw: float = 0.055
    p_addsub_mw: float = 0.0028
    p_lut_mw: float = 4.21
    p_b_to_tcu_mw: float = 0.021
    p_latch_mw: float = 0.028

    # ---- energies (Table I) ----
    e_act_pj: float = 909.0         # one row ACTIVATE in one bank
    e_pre_gsa_pj_b: float = 1.51    # row buffer -> global S/As, per bit
    e_post_gsa_pj_b: float = 1.17   # GSAs -> DRAM I/O, per bit
    e_io_pj_b: float = 0.80         # I/O channel, per bit

    # ---- interconnect / system ----
    link_bits: int = 256            # inter-bank link width (§III.D.3)
    stack_bw_gbps: float = 256.0    # HBM per-stack bandwidth (§IV.C)
    power_budget_w: float = 60.0    # §IV

    # -- derived -----------------------------------------------------------
    @property
    def n_banks(self) -> int:
        return self.n_stacks * self.channels_per_stack \
            * self.banks_per_channel

    @property
    def active_subarrays_per_bank(self) -> int:
        return int(self.subarrays_per_bank * self.open_bitline_frac)

    @property
    def macs_per_tile_round(self) -> int:
        """MACs accumulated per operational tile before an A_to_B readout
        (2 multiplies at a time x 20-deep MOMCAPs x 2 caps)."""
        return self.momcap_depth * self.caps_per_tile

    @property
    def t_link_ns_per_bit(self) -> float:
        """Inter-bank link: 256 bits/cycle at the DRAM I/O clock; the
        paper's 256 GB/s stack bandwidth over 8 channels gives the
        effective per-bank-link rate."""
        bytes_per_ns = self.stack_bw_gbps / self.channels_per_stack
        return 1.0 / (bytes_per_ns * 8.0)


DEFAULT = ArtemisConfig()


# DRISA-style conventional PIM (Fig 2 comparison): digital bit-serial MAC,
# a single MUL takes 1600 ns (§II.E), additions ~8 MOCs per bit-serial add.
@dataclasses.dataclass(frozen=True)
class DrisaConfig:
    t_mul_ns: float = 1600.0
    t_add_ns: float = 8 * 17.0
    t_moc_ns: float = 17.0


DRISA_CONFIG = DrisaConfig()
