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
gradients are those of the exact product.

The artemis mode with analog readout noise (sigma_analog > 0) runs the
reference's group scan (`_artemis_emulated`) in plain PyTorch on the
operands' device, with the noise drawn from a `repro_torch.prng` key:
the Pallas kernel has no noise, and the reference never sends noise
through it, so this path launches no sc_matmul. The choice is made by
sigma_analog, never by the device.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import quantization as q
from repro_torch.core.analog import MomcapConfig, readout_quantize
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.core.quantization import SC_LEVELS
from repro_torch.kernels.sc_matmul.sc_matmul import sc_matmul_quantized


def _quantize_pair(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy, b_absmax=None, a_absmax=None):
    """Per-tensor (activations) / per-column (weights) symmetric int8:
    (aq, bq, sa, sb). `b_absmax`: the whole weight's absmax when b is a
    rank's part of it; `a_absmax`: the whole batch's activation absmax
    when a is a data rank's rows of it (`quant_scale`'s absmax_of)."""
    sa = q.quant_scale(a, 8, policy.act_quant_axis, absmax_of=a_absmax)
    sb = q.quant_scale(b, 8, policy.weight_quant_axis, absmax_of=b_absmax)
    return q.quantize(a, sa), q.quantize(b, sb), sa, sb


def _artemis_noisy(aq: torch.Tensor, bq: torch.Tensor,
                   policy: ArithmeticPolicy,
                   key: torch.Tensor | None) -> torch.Tensor:
    """The reference's `_artemis_emulated` scan with readout noise, in
    SC product units. aq: (..., M, K) int8, bq: (K, N) int8. Each
    MOMCAP group splits its key three ways (the next group's key, the
    positive and the negative readout's) and draws (..., M, N) normals
    for each readout, in that order, through `analog.readout_quantize`
    as the reference's scan body calls it. The reference's jitted scan
    folds the noise's two constants and fuses its products into their
    adds, which op-by-op f32 here does not: an output parts from the
    reference's by a few ulps, and by one readout level only where a
    readout sits on a rounding tie (`tests/test_torch_noise.py` holds
    both, K up to 4096)."""
    if key is None:
        raise ValueError("artemis mode with sigma_analog > 0 needs a key")
    cfg = MomcapConfig(acc_depth=policy.acc_depth,
                       readout_bits=policy.readout_bits,
                       sigma_analog=policy.sigma_analog)
    ma, sga = q.magnitude_sign(aq)
    mb, sgb = q.magnitude_sign(bq)
    g = policy.acc_depth
    pad = (-ma.shape[-1]) % g
    if pad:
        ma = torch.nn.functional.pad(ma, (0, pad))
        sga = torch.nn.functional.pad(sga, (0, pad))
        mb = torch.nn.functional.pad(mb, (0, 0, 0, pad))
        sgb = torch.nn.functional.pad(sgb, (0, 0, 0, pad))
    kcur = torch.as_tensor(key, dtype=torch.int64).to(aq.device)
    zero = torch.zeros((), dtype=torch.float32, device=aq.device)
    acc = torch.zeros(ma.shape[:-1] + (mb.shape[-1],), dtype=torch.float32,
                      device=aq.device)
    for k0 in range(0, ma.shape[-1], g):
        sl = slice(k0, k0 + g)
        # one MOMCAP group: (..., M, g, N) SC products
        p = ((ma[..., sl, None] * mb[sl]) // SC_LEVELS).float()
        s = sga[..., sl, None] * sgb[sl]
        pos = torch.where(s > 0, p, zero).sum(dim=-2)
        neg = torch.where(s < 0, p, zero).sum(dim=-2)
        kcur, kp, kn = prng.split(kcur, 3).unbind(-2)
        acc = acc + readout_quantize(pos, cfg, kp) \
            - readout_quantize(neg, cfg, kn)
    return acc


def artemis_matmul(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy = ArithmeticPolicy(),
                   key: torch.Tensor | None = None,
                   b_absmax: torch.Tensor | None = None,
                   a_absmax: torch.Tensor | None = None) -> torch.Tensor:
    """Matmul through the ARTEMIS arithmetic ladder.

    a: (..., M, K) float; b: (K, N) float. Returns float32 (..., M, N).
    `key` (a `repro_torch.prng` key) draws the readout noise of the
    artemis mode with sigma_analog > 0, which needs one (ValueError
    without); the other modes ignore it. `b_absmax`: the absmax of the
    whole weight when b is a tensor-parallel rank's part of it;
    `a_absmax`: the absmax of the whole activation when a is a data
    rank's rows of it.
    """
    a = a.float()
    b = b.float()
    if policy.mode == "exact":
        return torch.matmul(a, b)
    aq, bq, sa, sb = _quantize_pair(a, b, policy, b_absmax, a_absmax)
    if policy.mode == "artemis" and policy.sigma_analog > 0.0:
        acc = _artemis_noisy(aq, bq, policy, key)
    else:
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
