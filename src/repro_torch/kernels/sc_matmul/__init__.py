"""The ARTEMIS MAC: the Hopper kernel's wrapper and its plain version
(see sc_matmul.py). The float-level entry `ops.sc_matmul` is imported
from `repro_torch.kernels.sc_matmul.ops`: it builds on
`repro_torch.core`, which itself imports this package."""
from repro_torch.kernels.sc_matmul.ref import sc_matmul_ref
from repro_torch.kernels.sc_matmul.sc_matmul import sc_matmul_quantized

__all__ = ["sc_matmul_quantized", "sc_matmul_ref"]
