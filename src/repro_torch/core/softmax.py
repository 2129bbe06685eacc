"""Log-sum-exp softmax, paper Eq. (5) and §III.C.2 / §III.D.3
(counterpart of `repro.core.softmax`).

ARTEMIS avoids in-DRAM division and numerical overflow by computing

  softmax(y)_i = exp(y_i - y_max - ln(sum_j exp(y_j - y_max)))

with three hardware tricks mirrored here:
  1. y_max is tracked *online* by a comparator as the QK^T MatMul streams
     out (the flash-attention online max, `online_max_sum`);
  2. exp and ln are 8-bit NSC LUTs (`core.lut`);
  3. the form is division-free.

exp and log are XLA's (`repro_torch.xla_math`), so that each value
equals the reference's, but for sums: torch reduces in another order
than XLA, which may move a sum's last bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch import xla_math
from repro_torch.core import lut


def lse_softmax(y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exact division-free log-sum-exp softmax (Eq. 5)."""
    shifted = y - y.amax(dim=axis, keepdim=True)
    lse = xla_math.log(xla_math.exp(shifted).sum(dim=axis, keepdim=True))
    return xla_math.exp(shifted - lse)


def artemis_softmax(y: torch.Tensor, axis: int = -1, n_in: int = 256,
                    out_bits: int | None = 8) -> torch.Tensor:
    """Eq. 5 with the exp/ln steps routed through NSC LUT emulation.

    The exp LUT's low end `lo` is the minimum of the shifted scores over
    the whole tensor, not per row, as in the reference."""
    y = y.float()
    shifted = y - y.amax(dim=axis, keepdim=True)                # <= 0
    lo = torch.clamp_max(shifted.detach().min(), -1.0)
    n = y.shape[axis]
    e = lut.lut_exp(shifted, lo, n_in=n_in, out_bits=out_bits)
    s = e.sum(dim=axis, keepdim=True)
    ln = lut.lut_ln(torch.clamp_min(s, 1.0), float(n), n_in=n_in,
                    out_bits=out_bits)
    log_n = xla_math.log(torch.tensor(float(n), device=y.device))
    return lut.lut_exp(shifted - ln, lo - log_n, n_in=n_in,
                       out_bits=out_bits)


def online_max_sum(y_blocks: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming (max, sum-exp) over blocks along axis 0: the comparator
    pipeline of §III.D.3, the reference for the flash kernel and the
    ring-attention merge rule.

    y_blocks: (n_blocks, ..., block); returns (max, sumexp) over all
    blocks, in f32. Each step is s * exp(m - m_new) + sum(exp(blk -
    m_new)), the product fused into the add as XLA compiles the
    reference's scan body.
    """
    first = y_blocks[0]
    m = torch.full(first.shape[:-1], -math.inf, dtype=torch.float32,
                   device=y_blocks.device)
    s = torch.zeros(first.shape[:-1], dtype=torch.float32,
                    device=y_blocks.device)
    for blk in y_blocks:
        m_new = torch.maximum(m, blk.amax(dim=-1))
        block_sum = xla_math.exp(blk - m_new[..., None]).sum(dim=-1)
        s = xla_math.fma(s, xla_math.exp(m - m_new), block_sum)
        m = m_new
    return m, s
