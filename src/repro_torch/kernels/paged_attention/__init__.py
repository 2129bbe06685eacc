"""Paged attention: the Hopper kernel's wrapper and its plain version
(see paged_attention.py)."""
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref"]
