"""Recurrent-state forward passes for the serving engine (counterpart
of `repro.serve.state_model`).

The recurrent families (rwkv6 / zamba2) carry FIXED-SIZE per-sequence
state (a wkv matrix and token-shift rows, or Mamba SSD and conv states
plus a bounded attention ring), so the serve-side pool is a stack of
whole state SLOTS, one per in-flight sequence, and allocation is
picking a free slot index. Slot 0 is the trash slot: idle lanes gather
and scatter it, so shapes never depend on how many lanes are live, and
no live lane ever reads it.

Layout: the pool is the family's decode cache at batch `n_slots`
(`model.init_cache`), the slot axis where the cache has its batch
axis, with `index` a (n_slots,) tensor of per-slot indices. A step
gathers its lanes' slots into a batch-B cache, runs ONE batched
`model.apply` over it (a (B,) tensor index: each lane at its own
positions and ring slot, and under a quantized policy its own
activation scales), and scatters the lanes back into the pool, which
is updated in place. The reference vmaps `model.apply` over the lanes
at batch 1 instead; the batched step computes the same function of
each lane, with one launch per projection.

  make_slot_decode(cfg, policy) ->
      (model, tokens (B, 1), pool, slot_ids (B,)) -> (logits (B, V), pool)

  make_slot_prefill_chunk(cfg, policy) ->
      (model, tokens (B, C), pool, slot_ids (B,), chunk_lens (B,),
       active (B,)) -> (logits (B, C, V), pool)
    Row b absorbs chunk_lens[b] prompt tokens into its slot through a
    loop of single-token applies, never the chunked-parallel scans
    (their sums run in another order). chunk_lens and active are host
    numpy arrays (int and bool). The loop stops after max(chunk_lens) positions of the
    active rows (`chunk_steps`); a row whose chunk ends earlier has its
    state set aside when it ends and put back after the loop, which
    keeps it where the reference keeps it. Logits are those of every
    position the loop ran (zero past it); the engine samples the last
    valid one of a row whose chunk completes its prompt.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.device import resolve_device
from repro_torch.models import model as modellib
from repro_torch.models.config import ModelConfig

TRASH_SLOT = 0

RECURRENT_FAMILIES = ("rwkv6", "zamba2")

# cache leaves whose lane (batch) axis is the first; the stacked layer
# and ring leaves carry it second, after the layer / invocation axis
_LANE_FIRST = ("index", "attn_pos")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in RECURRENT_FAMILIES:
        raise ValueError(
            f"state-slot serving supports recurrent families "
            f"{RECURRENT_FAMILIES}, got {cfg.family!r}")
    if cfg.modality != "text":
        raise ValueError(
            f"state-slot serving supports text modality, got "
            f"{cfg.modality!r}")


def lane_leaves(cache: dict, prefix=()):
    """(path, tensor, lane axis) of every leaf of a recurrent cache."""
    for key, val in cache.items():
        if isinstance(val, dict):
            yield from lane_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val, 0 if key in _LANE_FIRST else 1


def _build(pairs) -> dict:
    """A nested dict from (path, value) pairs."""
    tree: dict = {}
    for path, val in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def init_slot_pool(cfg: ModelConfig, n_slots: int, max_seq_len: int,
                   dtype=torch.float32, device="cuda"):
    """(pool, init_slot): `pool` holds `n_slots` slots (slot 0 the trash
    slot); `init_slot` is the pristine single cache, kept so freed slots
    can be reset on re-allocation (a zeroed slot is NOT pristine for
    every family: zamba2's ring positions start at int32 max)."""
    _check_family(cfg)
    if n_slots < 2:
        raise ValueError("need >= 2 slots (slot 0 is the trash slot)")
    if max_seq_len < 2:
        raise ValueError(f"max_seq_len must be >= 2, got {max_seq_len}")
    dev = resolve_device(device)

    def slots(n):
        cache = modellib.init_cache(cfg, n, max_seq_len, dtype=dtype,
                                    device=dev)
        return dict(cache, index=torch.zeros((n,), dtype=torch.int32,
                                             device=dev))

    return slots(n_slots), slots(1)


@torch.no_grad()
def reset_slot(pool: dict, init_slot: dict, slot: int) -> dict:
    """Restore `slot` to the pristine initial cache, in place."""
    for (_, leaf, axis), (_, ini, _) in zip(lane_leaves(pool),
                                            lane_leaves(init_slot)):
        leaf.select(axis, slot).copy_(ini.select(axis, 0))
    return pool


def gather_lanes(pool: dict, slot_ids: torch.Tensor) -> dict:
    """The batch-B cache of the lanes' slots (a copy)."""
    return _build((path, leaf.index_select(axis, slot_ids))
                  for path, leaf, axis in lane_leaves(pool))


def scatter_lanes(pool: dict, slot_ids: torch.Tensor, lanes: dict) -> dict:
    """Write the lanes back into their slots, in place. Duplicate ids
    (idle lanes on the trash slot) leave any one of their values."""
    for (_, leaf, axis), (_, new, _) in zip(lane_leaves(pool),
                                            lane_leaves(lanes)):
        leaf.index_copy_(axis, slot_ids, new)
    return pool


def chunk_steps(chunk_lens: np.ndarray, active: np.ndarray) -> int:
    """Single-token applies a prefill chunk runs: the longest active
    row's chunk (host arrays in, a host int out)."""
    lens = chunk_lens[active]
    # the port's steps run eagerly; the analyzer takes this factory's
    # inner for a jitted one by the reference's name
    # repro: allow[host-sync-in-jit]
    return int(lens.max()) if lens.size else 0


def make_slot_decode(cfg: ModelConfig,
                     policy: ArithmeticPolicy = ArithmeticPolicy()):
    """Returns decode(model, tokens, pool, slot_ids) -> (logits (B, V),
    pool). tokens: (B, 1) int; slot_ids: (B,) int, the slot each lane
    owns (idle lanes: TRASH_SLOT)."""
    _check_family(cfg)

    @torch.no_grad()
    def decode(model, tokens, pool, slot_ids):
        st = gather_lanes(pool, slot_ids)
        logits, _, st = modellib.apply(model, cfg, {"tokens": tokens},
                                       policy=policy, cache=st)
        return logits[:, -1], scatter_lanes(pool, slot_ids, st)

    return decode


def make_slot_prefill_chunk(cfg: ModelConfig,
                            policy: ArithmeticPolicy = ArithmeticPolicy()):
    """Returns chunk(model, tokens, pool, slot_ids, chunk_lens, active)
    -> (logits (B, C, V), pool); see the module docstring."""
    _check_family(cfg)

    @torch.no_grad()
    def chunk(model, tokens, pool, slot_ids, chunk_lens, active):
        lens, live = chunk_lens, active
        n_steps = chunk_steps(lens, live)
        b, c = tokens.shape
        st = gather_lanes(pool, slot_ids)
        logits = torch.zeros((b, c, cfg.padded_vocab),
                             dtype=model.compute_dtype, device=tokens.device)
        held = []           # (rows, their leaves when their chunk ended)
        for t in range(n_steps):
            ended = np.flatnonzero(live & (lens == t))
            if ended.size:
                rows = torch.from_numpy(ended).to(tokens.device)
                held.append((rows, [leaf.index_select(axis, rows)
                                    for _, leaf, axis in lane_leaves(st)]))
            out, _, st = modellib.apply(model, cfg,
                                        {"tokens": tokens[:, t:t + 1]},
                                        policy=policy, cache=st)
            logits[:, t] = out[:, 0]
        for rows, saved in held:
            for (_, leaf, axis), old in zip(lane_leaves(st), saved):
                leaf.index_copy_(axis, rows, old)
        return logits, scatter_lanes(pool, slot_ids, st)

    return chunk
