"""Batched token sampler (counterpart of `repro.serve.sampler`), greedy
lanes only.

A `temperature == 0` lane is the argmax over the RAW logits, exactly
the reference's greedy lane (`torch.argmax` and `jnp.argmax` both
return the first maximum). Sampled lanes need jax's threefry
`PRNGKey` / `fold_in` / `gumbel` bit for bit to stay token-identical
with the reference; they are not ported yet, and asking for one raises
instead of decoding greedy in its place.
"""
from __future__ import annotations

import numpy as np
import torch

# Metrics-registry keys the engine publishes sampler activity under
# (same names as the reference's).
N_SAMPLED_KEY = "sampler/n_sampled_tokens"
N_GREEDY_KEY = "sampler/n_greedy_tokens"


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  pos) -> np.ndarray:
    """Batched sampler: `(B, V)` logits + per-lane `(B,)` params ->
    `(B,)` int32 tokens on the host."""
    if np.any(np.asarray(temperature) > 0):
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet; only "
            "greedy lanes run")
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
