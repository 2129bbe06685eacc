"""Float-level entry of the sc_matmul kernel (counterpart of
`repro.kernels.sc_matmul.ops`): quantize per the policy, run the ARTEMIS
MAC (`sc_matmul_quantized`, which pads what the kernel needs),
dequantize, apply the straight-through estimator.

It is `core.artemis_matmul` on 2-D operands in a quantized mode: the
reference pins its kernel wrapper to that function, and the port makes
them one code path. This module is not imported by the kernel package,
because `repro_torch.core` imports the package.
"""
from __future__ import annotations

import torch

from repro_torch.core.artemis_matmul import artemis_matmul
from repro_torch.core.policy import ArithmeticPolicy


def sc_matmul(a: torch.Tensor, b: torch.Tensor,
              policy: ArithmeticPolicy = ArithmeticPolicy(mode="artemis")
              ) -> torch.Tensor:
    """ARTEMIS matmul through the kernel. a: (M, K), b: (K, N) float.
    Returns float32 (M, N)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"sc_matmul takes 2-D operands, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if not policy.is_quantized():
        raise ValueError("sc_matmul runs the quantized modes (int8, "
                         "artemis, artemis_mxu), not 'exact'")
    return artemis_matmul(a, b, policy)
