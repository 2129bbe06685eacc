"""The ARTEMIS MAC: the Hopper kernel's wrapper and its plain version
(see sc_matmul.py), and the int8 quantization in front of it, the
`sc_quantize` kernel's wrapper and its plain version (see quantize.py).
The float-level entry `ops.sc_matmul` is imported from
`repro_torch.kernels.sc_matmul.ops`: it builds on `repro_torch.core`,
which itself imports this package."""
from repro_torch.kernels.sc_matmul.quantize import (quantize_int8,
                                                    quantize_int8_ref)
from repro_torch.kernels.sc_matmul.ref import sc_matmul_ref
from repro_torch.kernels.sc_matmul.sc_matmul import sc_matmul_quantized

__all__ = ["quantize_int8", "quantize_int8_ref", "sc_matmul_quantized",
           "sc_matmul_ref"]
