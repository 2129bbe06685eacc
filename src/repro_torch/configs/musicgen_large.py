"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32, i.e. MHA)
d_ff=8192 vocab=2048 — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

EnCodec frontend is stubbed (brief): the backbone consumes 4 parallel
codebook token streams (B, S, 4); codebook embeddings are summed, and the
head predicts all 4 codebooks (delay-pattern bookkeeping is a data-layer
concern, not a backbone one).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    family="dense",
    modality="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    glu=False,                # plain 2-layer MLP (T5/BART-style)
    n_codebooks=4,
    vocab_round_to=128,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="dense",
    modality="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    act="gelu",
    glu=False,
    n_codebooks=4,
    vocab_round_to=16,
)
