"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821; hf].

Modality frontend (InternViT-300M + pixel-shuffle + MLP projector) is a
STUB per the brief: `input_specs()` provides 256 precomputed patch
embeddings as `prefix_embeds` (repro.models.frontend).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-1b",
    family="dense",
    modality="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    act="silu",
    glu=True,
    tie_embeddings=True,      # Qwen2-0.5B ties embeddings
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="dense",
    modality="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="silu",
    glu=True,
    tie_embeddings=True,
    vocab_round_to=16,
)
