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
The quantization itself is `kernels.sc_matmul.quantize_int8` (the
`sc_quantize` kernel on CUDA, `core.quantization` on the CPU), on the
operands as given: it computes in f32, and bf16 to f32 is exact, so
only the straight-through term's exact product casts them. With
policy.ste the forward value is exact + (out - exact).detach(), so
gradients are those of the exact product; without it the scales keep
their gradient, through `core.quantization`'s ops.

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
from repro_torch.kernels.sc_matmul.quantize import quantize_int8
from repro_torch.kernels.sc_matmul.sc_matmul import sc_matmul_quantized

# the dtypes the sc_quantize kernel reads; others are cast to f32 first
_KERNEL_FLOATS = (torch.float32, torch.bfloat16)


def _quantize_pair(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy, b_absmax=None, a_absmax=None):
    """Per-tensor (activations) / per-column (weights) symmetric int8 of
    the f32 of a and b: (aq, bq, sa, sb). `b_absmax`: the whole weight's
    absmax when b is a rank's part of it; `a_absmax`: the whole batch's
    activation absmax when a is a data rank's rows of it (`quant_scale`'s
    absmax_of). The int8 values come from `quantize_int8`; where the
    output differentiates through the scales (no STE), the scales come
    from `core.quantization`'s ops, whose values are the kernel's."""
    a32 = a if a.dtype in _KERNEL_FLOATS else a.float()
    b32 = b if b.dtype in _KERNEL_FLOATS else b.float()
    grads = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if grads:
        a32, b32 = a32.detach(), b32.detach()
    aq, sa = quantize_int8(a32, policy.act_quant_axis, a_absmax)
    bq, sb = quantize_int8(b32, policy.weight_quant_axis, b_absmax)
    if grads and not policy.ste:
        sa = q.quant_scale(a.float(), 8, policy.act_quant_axis,
                           absmax_of=a_absmax)
        sb = q.quant_scale(b.float(), 8, policy.weight_quant_axis,
                           absmax_of=b_absmax)
    return aq, bq, sa, sb


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
    if policy.mode == "exact":
        return torch.matmul(a.float(), b.float())
    aq, bq, sa, sb = _quantize_pair(a, b, policy, b_absmax, a_absmax)
    if policy.mode == "artemis" and policy.sigma_analog > 0.0:
        acc = _artemis_noisy(aq, bq, policy, key)
    else:
        acc = sc_matmul_quantized(
            aq.reshape(-1, aq.shape[-1]), bq, mode=policy.mode,
            acc_depth=policy.acc_depth, readout_bits=policy.readout_bits,
            rbar=policy.rbar).reshape(*aq.shape[:-1], bq.shape[-1])
    if policy.mode == "int8":
        # the int32 sums go to f32 inside the product, as .float() would
        out = acc * sa * sb
    else:
        out = acc * SC_LEVELS * sa * sb
    if policy.ste:
        exact = torch.matmul(a.float(), b.float())
        out = exact + (out - exact).detach()
    return out


def calibrate_rbar(a: torch.Tensor, b: torch.Tensor,
                   policy: ArithmeticPolicy) -> float:
    """Exact E[(m_a*m_b) mod 128] over the operands' actual distribution,
    the per-layer refinement of the MXU correction constant. Off every
    serve and train path, it quantizes in the operands' own dtype with
    `core.quantization`'s ops, as the reference does."""
    aq = q.quantize(a, q.quant_scale(a, 8, policy.act_quant_axis))
    bq = q.quantize(b, q.quant_scale(b, 8, policy.weight_quant_axis))
    ma, _ = q.magnitude_sign(aq)
    mb, _ = q.magnitude_sign(bq)
    r = (ma[..., :, :, None] * mb[None, :, :]) % SC_LEVELS
    return float(r.float().mean())
