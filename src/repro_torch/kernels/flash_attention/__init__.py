"""Flash attention: the Hopper kernel's wrappers and its plain versions
(see flash_attention.py)."""
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_all,
    flash_attention_block_counts,
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_attention_ref,
)

__all__ = ["flash_attention", "flash_attention_all",
           "flash_attention_block_counts", "flash_attention_kernel",
           "attention_ref", "flash_attention_ref"]
