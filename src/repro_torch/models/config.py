"""ModelConfig — one dataclass covering every assigned architecture family.

Families:
  dense   — decoder-only transformer (GQA/MQA, GLU or plain FFN)
  moe     — dense backbone with the FFN replaced by a routed MoE layer
  rwkv6   — attention-free RWKV-6 "Finch" (data-dependent decay)
  zamba2  — Mamba2 (SSD) backbone + a shared transformer block applied
            every `shared_attn_period` layers

Modalities ("text" | "vlm" | "audio") only change the input plumbing:
vlm prepends precomputed patch embeddings (frontend stub per the brief),
audio consumes `n_codebooks` parallel EnCodec token streams.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv6 | zamba2
    n_layers: int
    d_model: int
    vocab_size: int
    modality: str = "text"         # text | vlm | audio
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_window: int = 0           # 0 = full causal; >0 = sliding window
    # --- FFN ---
    d_ff: int = 0
    act: str = "silu"              # silu | gelu | relu
    glu: bool = True               # gated (SwiGLU/GeGLU) vs plain 2-layer MLP
    # --- norm / embed ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)
    vocab_round_to: int = 128      # pad vocab so the TP axis divides it
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    expert_round_to: int = 0       # pad expert count to a TP multiple
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 within zamba2; rwkv6) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128          # chunked-scan block length
    # --- zamba2 hybrid ---
    shared_attn_period: int = 0    # shared block every k mamba layers
    # --- audio ---
    n_codebooks: int = 0
    # --- numerics ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.family not in ("dense", "moe", "rwkv6", "zamba2"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family in ("dense", "moe") and self.n_heads == 0:
            raise ValueError(f"{self.name}: attention family needs n_heads")
        if self.family == "moe" and not (self.n_experts and self.top_k):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")

    # -- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round_to or 1
        return -(-self.vocab_size // r) * r

    @property
    def padded_experts(self) -> int:
        r = self.expert_round_to or 1
        return -(-self.n_experts // r) * r

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d if self.tie_embeddings else 2 * v * d
        if self.family in ("dense", "moe"):
            hd = self.resolved_head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
            if self.family == "dense":
                ffn = d * self.d_ff * (3 if self.glu else 2)
            else:
                e = d * self.d_ff_expert * (3 if self.glu else 2)
                ffn = (self.n_experts + self.n_shared_experts) * e + \
                    d * self.n_experts
            n += self.n_layers * (attn + ffn + 2 * d)
        elif self.family == "rwkv6":
            per = 4 * d * d + 2 * d * self.d_ff + 13 * d  # approx
            n += self.n_layers * per
        elif self.family == "zamba2":
            di = self.d_inner
            g = 1  # B/C groups
            per = d * (2 * di + 2 * g * self.ssm_state + self.ssm_heads) \
                + di * d + 2 * d
            n += self.n_layers * per
            if self.shared_attn_period:
                hd = self.resolved_head_dim
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Per-token active params (= total except for MoE routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        e = d * self.d_ff_expert * (3 if self.glu else 2)
        inactive = (self.n_experts - self.top_k) * e * self.n_layers
        return self.param_count() - inactive
