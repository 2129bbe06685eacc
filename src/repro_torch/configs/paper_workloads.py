"""Paper Table II transformer workloads (ARTEMIS' own evaluation set).

These drive the hwsim benchmarks (Figs 2, 8-12) and — in reduced form —
the Table IV accuracy ladder. N is the paper's input token count.
"""
from repro_torch.models.config import ModelConfig


def _enc(name, layers, n, heads, d_model, d_ff, vocab=30522, params=0):
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=d_ff,
        vocab_size=vocab,
        act="gelu",
        glu=False,
        vocab_round_to=2,
    )


# name -> (config, N tokens, params as reported)
TABLE_II = {
    "transformer_base": (_enc("transformer-base", 2, 128, 8, 512, 2048,
                              37000), 128, 52e6),
    "bert_base": (_enc("bert-base", 12, 128, 12, 768, 3072), 128, 108e6),
    "albert_base": (_enc("albert-base", 12, 128, 12, 768, 3072), 128, 12e6),
    "vit_base": (_enc("vit-base", 12, 256, 12, 768, 3072, 1000), 256, 86e6),
    "opt_350": (_enc("opt-350", 12, 2048, 12, 768, 3072, 50272), 2048,
                350e6),
}


def get_workload(name: str):
    cfg, n_tokens, params = TABLE_II[name]
    return cfg, n_tokens, params
