"""Paper Table II workloads in hwsim form."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    params: float
    n_layers: int
    n_tokens: int
    n_heads: int
    d_model: int
    d_ff: int
    decoder: bool = False   # encoder-decoder (transformer-base) vs enc-only


# paper Table II
_MODELS = {
    "transformer_base": Workload("transformer-base", 52e6, 2, 128, 8, 512,
                                 2048, decoder=True),
    "bert_base": Workload("bert-base", 108e6, 12, 128, 12, 768, 3072),
    "albert_base": Workload("albert-base", 12e6, 12, 128, 12, 768, 3072),
    "vit_base": Workload("vit-base", 86e6, 12, 256, 12, 768, 3072),
    "opt_350": Workload("opt-350", 350e6, 12, 2048, 12, 768, 3072),
}


def paper_models() -> dict:
    return dict(_MODELS)
