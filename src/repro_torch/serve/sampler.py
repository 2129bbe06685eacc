"""Per-request stochastic sampling with batch-invariant RNG lanes
(counterpart of `repro.serve.sampler`).

One batched sampler serves every token the engine samples, decode
rounds and prefill-completion first tokens alike, at the engine's
`(max_batch, vocab)` shape. Per lane it applies the reference's chain

    temperature scaling -> top-k mask -> top-p (nucleus) mask
    -> Gumbel-max draw

and a `temperature == 0` lane is the argmax over the RAW logits,
exactly the reference's greedy lane (`torch.argmax` and `jnp.argmax`
both return the first maximum).

The key of a draw is `fold_in(PRNGKey(request seed), position)` and
nothing else, where the position is how many tokens the request has
generated so far: a request samples the same tokens whatever batch,
lane or chunk it runs in, and a preempted request replays its stream
(see the reference's module docstring for the whole contract).
`repro_torch.prng` computes jax's threefry bits and uniforms bit for
bit, so a lane draws the reference's noise up to the last bit of the
Gumbel transform's two logs.

Everything runs on the logits' device; the (B,) tokens come back to
the host in one copy per call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng

# Metrics-registry keys the engine publishes sampler activity under
# (same names as the reference's).
N_SAMPLED_KEY = "sampler/n_sampled_tokens"
N_GREEDY_KEY = "sampler/n_greedy_tokens"


def lane_key(seed, pos, device=None) -> torch.Tensor:
    """RNG key (..., 2) for a request's `pos`-th sampled token: a pure
    function of (request seed, request-local position)."""
    return prng.fold_in(prng.PRNGKey(seed, device=device), pos)


def perturbed_scores(logits: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     seed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The reference's `_sample_lane` over every lane at once, up to its
    last argmax: (B, V) logits and (B,) parameters on one device -> the
    (B, V) f32 scores a sampled lane takes the argmax of (the truncated
    scaled logits, -inf outside the top-k/top-p set, plus the lane's
    Gumbel noise)."""
    v = logits.shape[-1]
    greedy = temperature <= 0.0
    # greedy lanes still run the sampled chain on a safe divisor
    t = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits.float() / t[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: keep every scaled logit >= the k-th largest (0 = keep all)
    keff = torch.clamp(torch.where(top_k > 0, top_k, v) - 1, 0, v - 1)
    kth = torch.gather(desc, 1, keff[:, None].long())
    keep = scaled >= kth
    # top-p on the top-k-masked distribution: keep the minimal
    # descending-probability set whose mass reaches top_p (the top
    # token's exclusive mass is 0, so it always survives)
    masked = torch.where(keep, scaled, -torch.inf)
    e = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    sp = torch.sort(probs, dim=-1, descending=True).values
    exclusive = torch.cumsum(sp, dim=-1) - sp
    cutoff = torch.where(exclusive < top_p[:, None], sp,
                         torch.inf).amin(dim=-1, keepdim=True)
    keep = keep & (probs >= cutoff)
    g = prng.gumbel(lane_key(seed, pos), (v,))
    return torch.where(keep, scaled, -torch.inf) + g


def lane_tensors(device, temperature, top_k, top_p, seed, pos) -> tuple:
    """The (B,) host parameters of `sample_tokens` as tensors on
    `device`, in the dtypes `perturbed_scores` takes."""
    def put(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    return (put(np.asarray(temperature, np.float32), torch.float32),
            put(top_k, torch.int64), put(top_p, torch.float32),
            put(np.asarray(seed, np.uint32), torch.int64),
            put(np.asarray(pos, np.int32), torch.int64))


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  pos) -> np.ndarray:
    """Batched sampler: `(B, V)` logits + per-lane `(B,)` host
    parameters -> `(B,)` int32 tokens on the host. Rows the caller does
    not use (idle lanes, non-completing chunks) are drawn and ignored;
    every lane's draw is independent. A call whose lanes are all greedy
    takes the argmax alone, the value the chain gives them."""
    greedy = torch.argmax(logits, dim=-1)
    if not np.any(np.asarray(temperature) > 0):
        return greedy.to(torch.int32).cpu().numpy()
    lanes = lane_tensors(logits.device, temperature, top_k, top_p, seed, pos)
    sampled = torch.argmax(perturbed_scores(logits, *lanes), dim=-1)
    toks = torch.where(lanes[0] <= 0.0, greedy, sampled)
    return toks.to(torch.int32).cpu().numpy()
