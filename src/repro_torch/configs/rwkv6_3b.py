"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    ssm_head_dim=64,          # 40 wkv heads
    chunk_size=128,
    act="relu2",
    glu=False,
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke",
    family="rwkv6",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=256,
    ssm_head_dim=32,
    chunk_size=16,
    act="relu2",
    glu=False,
    vocab_round_to=16,
)
