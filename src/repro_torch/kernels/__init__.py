"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU
kernel of `repro.kernels` on the ported path:

paged_attention   fused block-table-walking attention for the paged
                  serving stack (port of repro's Pallas `_paged_kernel`)
sc_matmul         the ARTEMIS MAC over int8 operands in the int8,
                  artemis_mxu and artemis modes (port of repro's Pallas
                  `_sc_matmul_kernel`); every dense projection of a
                  quantized policy runs through it; its library also
                  holds `sc_quantize`, the int8 quantization of both
                  operands in front of it (`quantize_int8`), which
                  replaces no Pallas kernel
flash_attention   causal / windowed GQA attention over contiguous
                  Q/K/V with an online LSE softmax (port of repro's
                  Pallas `_flash_kernel`); every attention of the exact
                  static path (`launch.serve --mode static`) runs it

Each kernel sits beside its plain PyTorch version (`ref.py`), which
its wrapper runs for CPU tensors; `build.launch_counts` counts the
kernel launches.
"""
from repro_torch.kernels.build import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.sc_matmul import (quantize_int8, quantize_int8_ref,
                                           sc_matmul_quantized, sc_matmul_ref)

__all__ = ["launch_counts", "reset_launch_counts", "flash_attention",
           "flash_attention_ref", "paged_attention",
           "paged_attention_ref", "quantize_int8", "quantize_int8_ref",
           "sc_matmul_quantized", "sc_matmul_ref"]
