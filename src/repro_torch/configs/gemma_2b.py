"""gemma-2b [dense] — 18L d_model=2048 8H (GQA kv=1, i.e. MQA)
d_ff=16384 vocab=256000, GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    glu=True,                 # GeGLU
    tie_embeddings=True,      # gemma ties the LM head to the embedding
    scale_embeddings=True,    # embed * sqrt(d_model)
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    scale_embeddings=True,
    vocab_round_to=16,
)
