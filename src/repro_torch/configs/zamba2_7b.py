"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].

The shared transformer block is applied every 6 Mamba2 layers (13
invocations over 81 layers, 3-layer tail), weights reused across
invocations — the Zamba2 parameter-sharing scheme. Sliding-window
attention (4096) bounds the shared block's KV for the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    chunk_size=128,
    shared_attn_period=6,
    attn_window=4096,
    act="gelu",
    glu=True,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="zamba2",
    n_layers=5,               # 2 invocations of the shared block + tail
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    conv_width=4,
    chunk_size=16,
    shared_attn_period=2,
    attn_window=32,
    act="gelu",
    glu=True,
    vocab_round_to=16,
)
