"""Modality frontends (counterpart of `repro.models.frontend`): stubs,
as in the reference.

The multimodal configs specify the transformer backbone only; the
frontend supplies precomputed patch or frame embeddings, and the data
pipeline and the static serve path synthesize deterministic stand-ins.

  vlm   (internvl2_1b): the vision tower and projector are stubbed by
        their output, `VLM_PREFIX_TOKENS` embeddings of the model width
        (B, 256, d), passed to the model as `prefix_embeds` and put
        before the token embeddings.
  audio (musicgen_large): the backbone reads `n_codebooks` parallel
        token streams, (B, S, C); their embeddings are summed inside
        the model (`transformer.Transformer.embed_tokens`).

`synth_prefix_embeds` draws through `repro_torch.prng.normal`, which is
`jax.random.normal` bit for bit, so a prefix equals the reference's for
the same key. The reference's `prefix_embed_spec` is the dry run's
meta tensor in `launch/specs.py` (`batch_shapes`).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype

# InternVL2-1B: a 448x448 image, 14x14 ViT patches -> 1024 tokens,
# pixel-shuffle x0.5 -> 256 visual tokens entering the LM
VLM_PREFIX_TOKENS = 256


def n_prefix_tokens(cfg: ModelConfig) -> int:
    return VLM_PREFIX_TOKENS if cfg.modality == "vlm" else 0


def synth_prefix_embeds(key: torch.Tensor, cfg: ModelConfig,
                        batch: int) -> torch.Tensor:
    """A deterministic stand-in for the ViT features: standard normals
    (unit RMS, like post-LN) drawn in f32 on key's device, cast to the
    compute dtype."""
    x = prng.normal(key, (batch, VLM_PREFIX_TOKENS, cfg.d_model))
    return x.to(torch_dtype(cfg.compute_dtype))


def token_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple[int, ...]:
    """The token input's shape for the config's modality."""
    if cfg.modality == "audio":
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)
