"""The ARTEMIS matmul ladder, the paper's MAC pipeline end to end
(counterpart of `repro.core.artemis_matmul`).

For one output element ARTEMIS (paper §III.A, §III.C.1):
  1. quantizes the operands to signed 8-bit;
  2. multiplies magnitudes with the deterministic TCU AND
     -> floor(m_a * m_b / 128);
  3. accumulates products on MOMCAPs in groups of `acc_depth` (20),
     positives and negatives apart;
  4. reads each group out through the quantizing A_to_B ladder;
  5. reduces the group readouts (pos - neg) in the NSC adders;
  6. dequantizes: signed_sum * 128 * s_a * s_b.

Four modes (ArithmeticPolicy.mode):
  exact        a @ b in float32
  int8         quantize, exact integer dot, dequantize
  artemis      the full pipeline above
  artemis_mxu  (a.b - rbar * sign(a).sign(b)) / 128: the floor truncation
               approximated by a calibrated constant (see the reference)

The quantized modes quantize the whole (..., M, K) activation tensor and
the (K, N) weight as the reference does, flatten the leading dimensions
and hand the int8 operands to `kernels.sc_matmul.sc_matmul_quantized`:
its plain version on the CPU, the hand-written Hopper kernel on CUDA.
With policy.ste the forward value is exact + (out - exact).detach(), so
gradients are those of the exact product. The analog noise path
(sigma_analog > 0 in artemis mode) is not ported and raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as q
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.core.quantization import SC_LEVELS
from repro_torch.kernels.sc_matmul.sc_matmul import sc_matmul_quantized


def _quantize_pair(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy):
    """Per-tensor (activations) / per-column (weights) symmetric int8:
    (aq, bq, sa, sb)."""
    sa = q.quant_scale(a, 8, policy.act_quant_axis)
    sb = q.quant_scale(b, 8, policy.weight_quant_axis)
    return q.quantize(a, sa), q.quantize(b, sb), sa, sb


def artemis_matmul(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy = ArithmeticPolicy(),
                   key=None) -> torch.Tensor:
    """Matmul through the ARTEMIS arithmetic ladder.

    a: (..., M, K) float; b: (K, N) float. Returns float32 (..., M, N).
    `key` exists for the reference's signature; the noise path that
    would use it is not ported.
    """
    a = a.float()
    b = b.float()
    if policy.mode == "exact":
        return torch.matmul(a, b)
    if policy.mode == "artemis" and policy.sigma_analog > 0.0:
        raise NotImplementedError(
            "artemis mode with analog readout noise (sigma_analog > 0) "
            "is not ported yet")
    aq, bq, sa, sb = _quantize_pair(a, b, policy)
    acc = sc_matmul_quantized(
        aq.reshape(-1, aq.shape[-1]), bq, mode=policy.mode,
        acc_depth=policy.acc_depth, readout_bits=policy.readout_bits,
        rbar=policy.rbar).reshape(*aq.shape[:-1], bq.shape[-1])
    if policy.mode == "int8":
        out = acc.float() * sa * sb
    else:
        out = acc * SC_LEVELS * sa * sb
    if policy.ste:
        exact = torch.matmul(a, b)
        out = exact + (out - exact).detach()
    return out


def calibrate_rbar(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy) -> float:
    """Exact E[(m_a*m_b) mod 128] over the operands' actual distribution,
    the per-layer refinement of the MXU correction constant."""
    aq, bq, _, _ = _quantize_pair(a, b, policy)
    ma, _ = q.magnitude_sign(aq)
    mb, _ = q.magnitude_sign(bq)
    r = (ma[..., :, :, None] * mb[None, :, :]) % SC_LEVELS
    return float(r.float().mean())
