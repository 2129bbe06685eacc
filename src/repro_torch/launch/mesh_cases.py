"""What a rank of a tensor-parallel group runs when the port is checked:
drains through the serve engine, the collective attention cores on
given inputs, the refusals of the sharded backend, the sharded train
step and the compressed gradient all-reduce. `launch.mesh.
spawn(run, n, cases, device=...)` runs a list of cases in every rank
and returns each rank's results; `drain` also runs in a single process
(one device, no group), so a check can hold the ranks against it. The
module imports no jax and nothing of the JAX package: the tests hand it
numpy weights and the port's trace items.

Cases are (kind, keyword arguments) pairs:

  ("drain", {...})      `drain`'s arguments
  ("attention", {...})  `attention`'s arguments
  ("refusals", {})      `refusals`
  ("serve_steps", {...})  `serve_steps`'s arguments
  ("train", {...})      `train`'s arguments
  ("train_refusal", {...})  `train_refusal`'s arguments
  ("compress", {...})   `compress`'s arguments
  ("lanes", {})         `lanes`
  ("backend", {})       the transport of the rank's group
  ("modules", {})       the top-level packages the rank imported
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import model as modellib
from repro_torch.serve import EngineConfig, ServeEngine, Tracer
from repro_torch.serve.backend import make_backend
from repro_torch.serve.mesh import make_serve_mesh
from repro_torch.serve.obs import to_chrome_trace
from repro_torch.serve.request import RequestState


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def params_for(cfg, weights, policy: ArithmeticPolicy, device):
    """The model a rank serves (its part of it on a multi-rank mesh):
    weights = ("numpy", tree) a reference parameter tree through the
    bridge; ("seed", s) `modellib.init(cfg, s)`'s weights, a rank
    drawing only its part (`tensor_parallel.init_shard`); ("whole", s)
    the whole seeded model, which the backend cuts; ("model", m) the
    model m, built already."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.parallel.tensor_parallel import init_shard
    kind, value = weights
    rank, n = _world()
    if kind == "numpy":
        return params_from_numpy(value, cfg, device=device,
                                 mesh=make_serve_mesh(n), policy=policy)
    if kind == "seed" and n > 1:
        return init_shard(cfg, rank, n, policy, seed=value, device=device)
    if kind in ("seed", "whole"):
        return modellib.init(cfg, seed=value, device=device)
    if kind == "model":
        return value
    raise ValueError(f"unknown weights kind {kind!r}")


def _top2_margin(row: torch.Tensor) -> float:
    """(top1 - top2) / max |row| of one logits row."""
    top = torch.topk(row.float(), 2).values
    return float((top[0] - top[1]) / torch.clamp_min(row.abs().max(), 1e-30))


def drain(device, *, cfg, weights, trace, ecfg: dict, policy: str = "exact",
          preempt: bool = False, record_logits: bool = False,
          observability: str = "metrics", attn_core=None) -> dict:
    """Drain `trace` (the port's TraceItems) through a fresh engine over
    all ranks of the group (or one device without one), every launch
    count zeroed just before the drain and read just after. `preempt`
    forces the preemption of the first decoding request, as the
    reference's conformance pin does. `attn_core` replaces a
    single-device engine's attention core (the seam of
    `paged_model`). Returns the token streams, each emitted token's
    top-2 logit margin, the metrics and counts, and with
    `record_logits` every step's logits (on the CPU)."""
    from repro_torch.serve.paged_model import (make_paged_chunked_prefill,
                                               make_paged_decode)
    rank, n = _world()
    pol = ArithmeticPolicy(mode=policy)
    params = params_for(cfg, weights, pol, device)
    eng = ServeEngine(cfg, params=params, policy=pol,
                      ecfg=EngineConfig(mesh_shards=n,
                                        observability=observability,
                                        **ecfg), device=device)
    del params
    backend = eng.backend
    if attn_core is not None:
        if n > 1:
            raise ValueError("attn_core replaces a single device's core")
        backend._prefill_fn = make_paged_chunked_prefill(cfg, pol,
                                                         attn_core=attn_core)
        backend._decode_fn = make_paged_decode(cfg, pol, attn_core=attn_core)
    logits, rows = [], {}
    prefill_step, decode_step = backend.prefill_step, backend.decode_step

    def prefill(chunks):
        out = prefill_step(chunks)
        for i, (req, k) in enumerate(chunks):
            rows[req.rid] = out[i, k - 1]
        if record_logits:
            logits.append(out.cpu())
        return out

    def decode(reqs):
        out = decode_step(reqs)
        for req in reqs:
            rows[req.rid] = out[req.lane]
        if record_logits:
            logits.append(out.cpu())
        return out

    backend.prefill_step, backend.decode_step = prefill, decode
    eng.submit_trace(trace)
    margins: dict[int, list[float]] = {}
    _sync(device)
    reset_launch_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    preempted = False
    for _ in range(100_000):
        if preempt and not preempted:
            decoding = [r for r in eng.requests.values()
                        if r.state is RequestState.DECODE]
            if decoding:
                eng._preempt(decoding[0])
                preempted = True
        seen = {rid: len(r.generated) for rid, r in eng.requests.items()}
        if eng.step() is None:
            break
        for rid, r in eng.requests.items():
            if len(r.generated) > seen[rid]:
                margins.setdefault(rid, []).append(_top2_margin(rows[rid]))
    eng.drain()
    _sync(device)
    wall = time.perf_counter() - t0
    if preempt and not preempted:
        raise AssertionError("the trace never reached a preemptable decode")
    backend.check_invariants()
    out = dict(
        rank=rank, n=n,
        tokens={i: r.tolist() for i, r in eng.results().items()},
        margins=margins, metrics=eng.metrics(),
        snapshot=backend.snapshot_metrics(), counts=dict(launch_counts),
        wall_s=wall, n_forwards=backend.n_forwards,
        n_prefill_forwards=backend.n_prefill_forwards,
        gauges={k: eng.obs.registry.gauge(f"backend/{k}")
                for k in ("shard_count", "shard_kv_heads")},
        shard_counts={k: eng.obs.registry.count(f"backend/{k}")
                      for k in ("shard_steps", "shard_tokens")})
    if record_logits:
        out["logits"] = logits
    if observability == "trace":
        out["chrome"] = to_chrome_trace(eng.events)
        out["events"] = [(type(e).__name__, dataclasses.asdict(e))
                         for e in eng.events]
    if torch.device(device).type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def attention(device, *, fn: str, q, k, v, q_positions=None,
              kv_positions=None, causal: bool = True) -> np.ndarray:
    """One collective attention call on whole numpy inputs, each rank
    taking its slice: "ring" and "layer" split q, k, v (and their
    positions) on the sequence axis and return the rank's slice of the
    output; "split_kv" takes q whole and splits k, v and kv_positions,
    returning the whole output. f32 on `device`."""
    from repro_torch.parallel.ring_attention import (layer_dataflow_attention,
                                                     ring_attention)
    from repro_torch.parallel.split_kv import split_kv_attention
    rank, n = _world()
    group = dist.group.WORLD

    def part(x):
        if x is None:
            return None
        x = torch.from_numpy(np.asarray(x)).to(device)
        size = x.shape[1] // n
        return x[:, rank * size:(rank + 1) * size]

    def whole(x):
        return None if x is None else torch.from_numpy(np.asarray(x)).to(
            device)

    if fn == "ring":
        out = ring_attention(part(q), part(k), part(v), group=group,
                             causal=causal, q_positions=part(q_positions),
                             kv_positions=part(kv_positions))
    elif fn == "layer":
        out = layer_dataflow_attention(part(q), part(k), part(v),
                                       group=group, causal=causal)
    elif fn == "split_kv":
        out = split_kv_attention(whole(q), part(k), part(v), group=group,
                                 q_positions=whole(q_positions),
                                 kv_positions_local=part(kv_positions),
                                 causal=causal)
    else:
        raise ValueError(f"unknown attention fn {fn!r}")
    return out.cpu().numpy()


def refusals(device) -> dict:
    """The messages the sharded serve path raises on a multi-rank mesh:
    the fused attention core, a state-slot family, a rank's part cut
    for another placement (int8's, served exact), and the
    tensor-parallel serving steps' refusals of a cache holding every KV
    head and of per-channel scales."""
    from repro_torch import configs
    from repro_torch.parallel.tensor_parallel import init_shard
    from repro_torch.serve.sharded_backend import ShardedPagedBackend
    rank, n = _world()
    mesh = make_serve_mesh(n)
    cfg = configs.get_config("qwen3_8b", smoke=True)
    out = {}
    part = init_shard(cfg, rank, n, ArithmeticPolicy(mode="int8"),
                      device=device)
    try:
        ShardedPagedBackend(cfg, EngineConfig(mesh_shards=n),
                            ArithmeticPolicy(), part, Tracer(), lambda: 0.0,
                            mesh=mesh)
    except ValueError as e:
        out["placement"] = str(e)
    try:
        ShardedPagedBackend(cfg, EngineConfig(mesh_shards=mesh.n_shards,
                                              attn_impl="fused"),
                            ArithmeticPolicy(), None, Tracer(),
                            lambda: 0.0, mesh=mesh)
    except ValueError as e:
        out["fused"] = str(e)
    rw = configs.get_config("rwkv6_3b", smoke=True)
    try:
        make_backend(rw, EngineConfig(mesh_shards=mesh.n_shards),
                     ArithmeticPolicy(), None, obs=Tracer(),
                     clock=lambda: 0.0, mesh=mesh)
    except ValueError as e:
        out["state_slot"] = str(e)
    out.update(_step_refusals(cfg, rank, n, device))
    return out


def _step_refusals(cfg, rank: int, n: int, device) -> dict:
    from repro_torch import configs
    from repro_torch.launch.mesh import make_smoke_mesh, rank_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.parallel.tensor_parallel import init_shard
    rmesh = rank_mesh(make_smoke_mesh(1, n))
    pol = ArithmeticPolicy()
    out = {}
    part = init_shard(cfg, rank, n, pol, device=device)
    whole = modellib.init_cache(cfg, 1, 8, dtype=torch.float32,
                                device=device)
    tokens = torch.zeros((1, 4), dtype=torch.int32, device=device)
    try:
        make_prefill_step(cfg, pol, mesh=rmesh)(part, {"tokens": tokens},
                                                whole)
    except ValueError as e:
        out["whole_cache"] = str(e)
    try:
        make_prefill_step(configs.get_config("musicgen_large", smoke=True),
                          ArithmeticPolicy(mode="int8", act_quant_axis=-1),
                          mesh=rmesh)
    except ValueError as e:
        out["per_channel"] = str(e)
    return out


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def serve_steps(device, *, cfg, tokens, policy: str = "exact",
                seed: int = 0, weights=None, prefix=None, decode=None,
                max_len: int | None = None) -> dict:
    """One prefill of `tokens` (numpy (B, S) [audio: (B, S, C)], after a
    vlm's `prefix` embeddings (B, P, d) when given) and decode steps
    through `launch.steps`' serving steps over a (data 1, model n) mesh
    of the group's ranks (`mesh=`): the rank's part of
    `modellib.init(cfg, seed)` (`tensor_parallel.init_shard`) or of the
    reference tree `weights` (numpy, through the bridge), and an f32
    cache of its part (`tensor_parallel.rank_cache`, `max_len` slots,
    default every token). `decode`: the tokens of each decode step
    (numpy (T, B, 1[, C])); default one greedy step. Returns every
    step's logits, the rank's cache leaves after the last step
    (`cache`, by dotted path, on the CPU; a dense cache's K and V also
    as `k` and `v`), its KV heads, the kernel calls the steps made
    (`roofline.count.Count`'s) and the launch counts."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_smoke_mesh, rank_mesh
    from repro_torch.parallel.data_parallel import tensor_parallel
    from repro_torch.parallel.tensor_parallel import init_shard, rank_cache
    from repro_torch.roofline.count import Count
    rank, n = _world()
    pol = ArithmeticPolicy(mode=policy)
    rmesh = rank_mesh(make_smoke_mesh(1, n))
    if weights is None:
        part = init_shard(cfg, rank, n, pol, seed=seed, device=device)
    else:
        part = params_from_numpy(weights, cfg, device=device,
                                 mesh=make_serve_mesh(n), policy=pol)
    dims = tensor_parallel(part, cfg, rmesh).attn_dims
    tok = torch.from_numpy(np.asarray(tokens)).to(device)
    batch = {"tokens": tok}
    if prefix is not None:
        batch["prefix_embeds"] = torch.from_numpy(np.asarray(prefix)).to(
            device)
    b, s = tok.shape[:2]
    p = 0 if prefix is None else batch["prefix_embeds"].shape[1]
    n_dec = 1 if decode is None else len(decode)
    cache = rank_cache(cfg, n, b, max_len or p + s + n_dec,
                       dtype=torch.float32, device=device)
    prefill = steps.make_prefill_step(cfg, pol, mesh=rmesh)
    decode_step = steps.make_decode_step(cfg, pol, mesh=rmesh)
    reset_launch_counts()
    with Count() as count:
        out, cache = prefill(part, batch, cache)
        logits = [out]
        for i in range(n_dec):
            nxt = (steps.greedy_sample(out)[:, None] if decode is None
                   else torch.from_numpy(np.asarray(decode[i])).to(device))
            out, cache = decode_step(part, nxt, cache)
            logits.append(out)
    flat = {k: v.cpu() for k, v in flatten(cache).items() if k != "index"}
    return dict(rank=rank, n=n,
                kv_heads=None if dims is None else dims.n_kv_heads,
                counts=dict(launch_counts),
                kernel_calls=dict(count.kernel_calls),
                logits=[x.cpu() for x in logits], cache=flat,
                **{k: flat[k] for k in ("k", "v") if k in flat},
                index=cache["index"])


def train(device, *, cfg, mesh: tuple, weights: dict, batches: list,
          policy: str = "exact", opt: dict | None = None,
          round_trip: bool = False) -> dict:
    """The sharded train step over a `make_smoke_mesh(*mesh)` of this
    group's ranks, from a reference parameter tree (`weights`, numpy):
    each rank cuts its part (`data_parallel.shard_train_state`), takes
    the gradients of the first batch (`steps.sharded_loss_and_grads`,
    what the step runs) and then one step a batch. Returns the
    gradients and the parameters after the steps, gathered whole, as
    reference-layout trees, every step's metrics, and with `round_trip`
    whether cutting and gathering back the start's model and state
    gives them bit for bit."""
    from repro_torch import bridge
    from repro_torch.launch.mesh import make_smoke_mesh, rank_mesh
    from repro_torch.launch.steps import (make_train_step,
                                          sharded_loss_and_grads)
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.parallel.context import use_sharding
    from repro_torch.parallel.sharding import ShardingRules
    rmesh = rank_mesh(make_smoke_mesh(*mesh))
    pol, rules = ArithmeticPolicy(mode=policy), ShardingRules()
    full = bridge.params_from_numpy(weights, cfg, device=device, train=True)
    opt_state = adamw_init(full)
    model, state = dp.shard_train_state(full, opt_state, cfg, rmesh, pol,
                                        rules)
    out = {}
    if round_trip:
        params, st = dp.gather_train_state(model, state, rmesh)
        out["round_trip"] = all(
            torch.equal(params[name], p) and
            torch.equal(st["m"][name], opt_state["m"][name]) and
            torch.equal(st["v"][name], opt_state["v"][name])
            for name, p in full.named_parameters())
    del full, opt_state

    def to_torch(batch):
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in batch.items()}

    with use_sharding(rmesh, rules):
        loss, aux, grads = sharded_loss_and_grads(
            model, cfg, to_torch(batches[0]), rmesh, pol)
    out.update(loss=float(loss), aux=float(aux), grads=bridge.named_to_numpy(
        (name, dp.whole(g, model.placement[name], rmesh))
        for name, g in grads.items()))
    step_fn = make_train_step(cfg, OptimizerConfig(**(opt or {})), pol,
                              mesh=rmesh, rules=rules)
    reset_launch_counts()
    metrics = []
    for batch in batches:
        model, state, m = step_fn(model, state, to_torch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    params, _ = dp.gather_train_state(model, None, rmesh)
    out.update(metrics=metrics, counts=dict(launch_counts),
               params=bridge.named_to_numpy(params.items()))
    return out


def train_refusal(device, *, cfg, mesh: tuple, rules: dict | None = None,
                  policy: dict | None = None) -> str:
    """The message of the sharded train step's refusal of `cfg` on a
    `make_smoke_mesh(*mesh)` under `ShardingRules(**rules)` and
    `ArithmeticPolicy(**policy)`, or "" where it takes them."""
    from repro_torch.launch.mesh import make_smoke_mesh, rank_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.parallel.sharding import ShardingRules
    rmesh = rank_mesh(make_smoke_mesh(*mesh))
    try:
        make_train_step(cfg, OptimizerConfig(),
                        ArithmeticPolicy(**(policy or {})), mesh=rmesh,
                        rules=ShardingRules(**(rules or {})))
    except ValueError as e:
        return str(e)
    return ""


def compress(device, *, grads: list, mode: str, steps: int = 3) -> list:
    """`compressed_psum` over the group, `steps` times: rank r sums
    grads[r] (numpy by name), the error feedback carried from step to
    step. Returns each step's (mean, error buffers) as numpy."""
    from repro_torch.parallel.compress import (compressed_psum,
                                               init_compression)
    rank, _ = _world()
    g = {k: torch.from_numpy(np.array(v)).to(device)
         for k, v in grads[rank].items()}
    state = init_compression(g, mode)
    out = []
    for _ in range(steps):
        mean, state = compressed_psum(g, state, dist.group.WORLD)
        out.append(({k: v.cpu().numpy() for k, v in mean.items()},
                    None if state.error is None else
                    {k: v.cpu().numpy() for k, v in state.error.items()}))
    return out


def lanes(device) -> dict:
    """Each collective of `parallel.comm` over the group split over 3
    extra lanes (every size split: `comm.LANE_MIN_BYTES` set to 0 for
    the case) against the same collective on one lane, on
    integer-valued f32 tensors (their sums are exact in any order):
    {case: equal}."""
    from repro_torch.parallel import comm
    rank, n = _world()
    one = dist.new_group(list(range(n)))
    split, *extra = [dist.new_group(list(range(n))) for _ in range(4)]
    comm.add_lanes(split, extra)
    gen = torch.Generator().manual_seed(rank)
    x = torch.randint(-1000, 1000, (4 * n, 6, 2 * n), generator=gen).float()
    x = x.to(device)
    min_bytes, comm.LANE_MIN_BYTES = comm.LANE_MIN_BYTES, 0
    try:
        return _lane_cases(x, split, one)
    finally:
        comm.LANE_MIN_BYTES = min_bytes


def _lane_cases(x, split, one) -> dict:
    from repro_torch.parallel import comm
    out = {}
    for op in ("sum", "max"):
        out[f"all_reduce {op}"] = torch.equal(comm.all_reduce(x, split, op),
                                              comm.all_reduce(x, one, op))
    for dim in (0, 1):
        out[f"all_gather {dim}"] = torch.equal(
            comm.all_gather(x, split, dim), comm.all_gather(x, one, dim))
    for dim in (0, 2):
        out[f"reduce_scatter {dim}"] = torch.equal(
            comm.reduce_scatter(x, split, dim),
            comm.reduce_scatter(x, one, dim))
    return out


def backend(device) -> str:
    """The transport of this rank's group ("nccl" or "gloo")."""
    return dist.get_backend()


def modules(device) -> list[str]:
    """The top-level packages this rank has imported."""
    import sys
    return sorted({m.split(".")[0] for m in sys.modules})


_CASES = {"drain": drain, "attention": attention, "refusals": refusals,
          "serve_steps": serve_steps,
          "train": train, "train_refusal": train_refusal,
          "compress": compress, "lanes": lanes, "backend": backend,
          "modules": modules}


def run(device, cases: list) -> list:
    """Run each (kind, kwargs) case in order on this rank."""
    return [_CASES[kind](device, **kwargs) for kind, kwargs in cases]
