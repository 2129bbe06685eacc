"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    act="silu",
    glu=True,
    n_experts=16,
    top_k=4,
    d_ff_expert=10752,
    expert_round_to=16,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="silu",
    glu=True,
    n_experts=4,
    top_k=2,
    d_ff_expert=128,
    expert_round_to=4,
    # generous capacity so smoke prefill/decode consistency is exact
    # (capacity drops are a batch-statistics behavior, exercised at the
    # FULL config's 1.25 in the dry-run, not in unit tests)
    capacity_factor=8.0,
    vocab_round_to=16,
)
