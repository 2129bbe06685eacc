"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408,
MoE 60 routed experts top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

60 routed experts are padded to 64 (expert_round_to=16) so the expert
axis divides the model-parallel degree; the 4 pad experts are masked in
the router (zero routing mass) — repro.models.moe.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    act="silu",
    glu=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_ff_expert=1408,
    expert_round_to=16,      # 60 -> 64
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    act="silu",
    glu=True,
    n_experts=6,
    top_k=2,
    n_shared_experts=2,
    d_ff_expert=96,
    expert_round_to=4,       # 6 -> 8
    # generous capacity so smoke prefill/decode consistency is exact
    capacity_factor=8.0,
    vocab_round_to=16,
)
