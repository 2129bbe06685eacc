"""Deterministic synthetic data pipeline (counterpart of
`repro.data.pipeline`), bit for bit: the same seeds give the same
tokens in both packages, through `repro_torch.prng`.

  * stateless-deterministic: batch t is a pure function of (seed, t,
    host), so a restarted job regenerates the identical stream;
  * per-host sharding: host h takes its rows of the global batch from
    fold_in(key, h).

Two generators:
  * `make_batch`: language-model-shaped random tokens with a Zipf-ish
    marginal;
  * `synthetic_task_batch`: learnable tasks (copy, reverse, sort,
    modular addition) for the accuracy ladder of Table IV
    (`benchmarks/torch_table4_accuracy.py`).

Text only: the reference's audio token shape and vlm prefix embeddings
wait for the multimodal slice (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 1024
    global_batch: int = 8
    task: str = "lm"            # lm | copy | reverse | sort | modadd
    host_id: int = 0
    n_hosts: int = 1


def _zipf_r(key: torch.Tensor, shape: tuple[int, ...],
            vocab: int) -> torch.Tensor:
    """exp(u * log V) - 1 in f32, u uniform in [1e-6, 1)."""
    u = prng.uniform(key, shape, 1e-6, 1.0)
    log_v = torch.log(torch.tensor(float(vocab), dtype=torch.float32,
                                   device=key.device))
    return torch.exp(u * log_v) - 1.0


def _zipf_tokens(key: torch.Tensor, shape: tuple[int, ...],
                 vocab: int) -> torch.Tensor:
    """Zipf-ish marginal over the vocab (heavy head, long tail): `_zipf_r`
    truncated to int32. XLA's exp and torch's part in the last bit for
    some inputs, which moves a token only where r lies within an ulp of
    an integer (about 6 tokens in 100000)."""
    return torch.clamp(_zipf_r(key, shape, vocab).to(torch.int32), 0,
                       vocab - 1)


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
               device="cuda") -> dict:
    """Batch t as a pure function of (seed, step, host): {"tokens",
    "labels"}, (global_batch / n_hosts, seq_len) int32 on `device`."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported yet (ROADMAP Queue 1 "
            f"item 7, multimodal static paths)")
    dev = resolve_device(device)
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(dcfg.seed, dev), step),
                       dcfg.host_id)
    rows = dcfg.global_batch // dcfg.n_hosts
    kt, _ = prng.split(key).unbind(-2)
    tokens = _zipf_tokens(kt, (rows, dcfg.seq_len), cfg.vocab_size)
    return {"tokens": tokens, "labels": _shift_labels(tokens)}


def _shift_labels(tokens: torch.Tensor) -> torch.Tensor:
    """Next-token labels (last position predicts a pad 0)."""
    return torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                     dim=1)


# ---------------------------------------------------------------------------
# learnable tasks for the accuracy ladder
# ---------------------------------------------------------------------------

SEP = 1  # separator token id; 0 is pad
TASKS = ("copy", "reverse", "sort", "modadd")


def synthetic_task_batch(key: torch.Tensor, task: str, batch: int, n: int,
                         vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, 2n+1) int32, loss_mask (B, 2n+1) f32) on key's
    device. Layout: [src tokens, SEP, tgt tokens]; the mask covers the
    tgt span. Payload tokens are drawn from [2, vocab)."""
    src = prng.randint(key, (batch, n), 2, vocab)
    if task == "copy":
        tgt = src
    elif task == "reverse":
        tgt = torch.flip(src, dims=(1,))
    elif task == "sort":
        tgt = torch.sort(src, dim=1).values
    elif task == "modadd":
        # tgt_i = (src_i + src_{i-1}) mod (vocab-2) + 2
        prev = torch.roll(src, 1, dims=1)
        prev[:, 0] = 0
        tgt = torch.remainder(src - 2 + prev - 2, vocab - 2) + 2
    else:
        raise ValueError(task)
    sep = torch.full((batch, 1), SEP, dtype=torch.int32, device=key.device)
    tokens = torch.cat([src, sep, tgt], dim=1)
    mask = torch.cat([torch.zeros((batch, n + 1), device=key.device),
                      torch.ones((batch, n), device=key.device)], dim=1)
    return tokens, mask


def batch_iterator(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
                   device="cuda"):
    """Infinite deterministic batch stream, resumable at any step."""
    step = start_step
    while True:
        yield step, make_batch(cfg, dcfg, step, device=device)
        step += 1
