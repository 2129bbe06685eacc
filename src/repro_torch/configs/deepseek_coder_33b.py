"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256, llama-arch [arXiv:2401.14196; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    act="silu",
    glu=True,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=160,
    vocab_size=256,
    act="silu",
    glu=True,
    vocab_round_to=16,
)
