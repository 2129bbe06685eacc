"""The port's tensor-parallel serving (`--mesh-shards N`) against the
JAX package's single-device engine.

The reference's own sharded drains raise on this jax (its
vocab-sharded embedding gather), so the port is held to the reference's
acceptance pin instead: a sharded drain equals the single-device
`PagedKVBackend` drain. One spawned gloo group of 2 ranks and one of 4
run every drain of this module once (module fixture, the rank workers
of `repro_torch.launch.mesh_cases`, which import no jax); the parent
compares every rank's results:

  * f32 smoke qwen3_8b, the mixed greedy/sampled trace of the
    reference's pin with its forced mid-flight preemption, at N 2 (the
    pool split on the 2 KV heads) and N 4 (the dataflow cores: ring
    prefill, split-KV decode): tokens equal to the reference's
    single-device drain, on every rank;
  * int8, artemis_mxu and artemis at N 2: tokens and every step's
    logits equal to the port's single-device drain bit for bit; at N 4
    the tokens equal a single-device drain whose attention core is the
    dataflow's unquantized one (the reference's cores score in f32
    under every policy);
  * a shared-prefix trace with COW forks at N 2 and 4: tokens equal
    to the reference's drain, pages shared and forked on every rank;
  * f32 smoke qwen2_moe_a2_7b at N 2 (expert parallel: 4 of the 8
    padded experts a rank): tokens equal to the reference's drain;
  * the shard gauges and counts, `snapshot_metrics`, the Chrome trace's
    shard tracks, and each step's price against the reference's
    `ArtemisCostModel(n_shards=N)`;
  * `launch.steps`' prefill and decode steps with `mesh=` at N 2 (the
    rank's part of the weights, a cache of its KV heads, flash for
    exact): exact and int8 logits and cache against the single-device
    steps';
  * the refusals (the fused core, a state-slot family, a part cut for
    another placement, a tensor-parallel step given every KV head or
    per-channel scales), and the CLI with `--mesh-shards 2`.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ArtemisCostModel as JCost  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402
from repro.serve.request import RequestState as JRequestState  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import mesh_cases  # noqa: E402
from repro_torch.models import model as modellib  # noqa: E402
from repro_torch.parallel import tensor_parallel as tpl  # noqa: E402
from repro_torch.parallel.ring_attention import _chunk_attn, _repeat_kv  # noqa: E402
from repro_torch.serve import ArtemisCostModel, EngineConfig, Tracer  # noqa: E402
from repro_torch.serve import TrafficConfig, synth_trace  # noqa: E402
from repro_torch.serve import validate_chrome_trace  # noqa: E402
from repro_torch.serve.mesh import (MeshHandle, ServeMesh,  # noqa: E402
                                    kv_pool_sharding, make_serve_mesh,
                                    param_shardings, replicated,
                                    seq_sharded_spec)
from repro_torch.serve.sharded_backend import ShardedPagedBackend  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANT = ["int8", "artemis_mxu", "artemis"]
STEP_MODES = ["exact", "int8"]
# the reference pin's engine geometry (tests/test_serve_backend.py)
ECFG = dict(page_size=8, n_pages=64, max_batch=3, max_pages_per_seq=8,
            prefill_chunk=8, max_seq_len=64, cache_dtype="float32")
# the reference pin's mixed greedy/sampled trace
TRAFFIC = dict(n_requests=5, arrival_rate=1e8, prompt_len_min=3,
               prompt_len_max=18, gen_len_min=2, gen_len_max=8, seed=61,
               sampled_fraction=0.5, temperature=0.9, top_k=24, top_p=0.95)
# shared prefixes (2 groups of 16 tokens) with mid-page sharers, whose
# first decode write COW-forks a co-owned page (tests/test_torch_engine.py)
PREFIX_TRAFFIC = dict(n_requests=8, arrival_rate=1e6, prompt_len_min=4,
                      prompt_len_max=12, gen_len_min=3, gen_len_max=8,
                      seed=1, n_prefix_groups=2, prefix_len=16)
PREFIX_ECFG = dict(page_size=8, n_pages=64, max_batch=4, max_pages_per_seq=6,
                   prefill_chunk=8, cache_dtype="float32")
# the tensor-parallel serving steps' prompt, and the exact logits' and
# cache's tolerance against one device's (f32: the row-parallel
# products' partial sums are added across the ranks in another order;
# int8's integer dots make them bit-equal)
STEP_TOKENS = np.random.default_rng(27).integers(2, 200, (2, 12),
                                                 dtype=np.int32)
STEP_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference cfg, port cfg, reference params, numpy tree)."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, params, jax.tree.map(np.asarray, params)


def _trace(cfg):
    return synth_trace(TrafficConfig(vocab_size=cfg.vocab_size, **TRAFFIC))


def _prefix_trace(synth, traffic_config, item_cls, vocab_size):
    """The prefix-sharing trace, built with one package's traffic
    module: 2 us after each group's first request, a request whose
    prompt is that one's first 13 tokens shares its pages up to
    mid-page."""
    items = synth(traffic_config(vocab_size=vocab_size, **PREFIX_TRAFFIC))
    for g in (0, 1):
        src = next(it for it in items if it.prefix_group == g)
        items.append(item_cls(src.arrival_time + 2e-6,
                              src.prompt[:13].copy(), 6, g))
    items.sort(key=lambda it: it.arrival_time)
    return items


@functools.lru_cache(maxsize=None)
def _reference_prefix_drain():
    """The reference's single-device drain of the prefix trace: tokens
    and the sharing metrics."""
    from repro.serve.traffic import TraceItem as JTraceItem
    jcfg, _, params, _ = _setup("qwen3_8b")
    eng = JServeEngine(jcfg, params=params,
                       ecfg=JEngineConfig(**PREFIX_ECFG))
    eng.submit_trace(_prefix_trace(jsynth_trace, JTrafficConfig, JTraceItem,
                                   jcfg.vocab_size))
    eng.drain()
    m = eng.metrics()
    return ({i: r.tolist() for i, r in eng.results().items()},
            {k: m[k] for k in ("n_prefix_hits", "n_cow_forks")})


@functools.lru_cache(maxsize=None)
def _reference_drain(arch):
    """The reference's single-device PagedKVBackend drain of the pin's
    trace, preempting the first decoding request as its pin does."""
    jcfg, _, params, _ = _setup(arch)
    eng = JServeEngine(jcfg, params=params, ecfg=JEngineConfig(**ECFG))
    eng.submit_trace(jsynth_trace(JTrafficConfig(vocab_size=jcfg.vocab_size,
                                                 **TRAFFIC)))
    preempted = False
    for _ in range(600):
        if not preempted:
            decoding = [r for r in eng.requests.values()
                        if r.state is JRequestState.DECODE]
            if decoding:
                eng._preempt(decoding[0])
                preempted = True
        if eng.step() is None:
            break
    eng.drain()
    assert preempted
    eng.backend.check_invariants()
    return {i: r.tolist() for i, r in eng.results().items()}


def _drain_case(arch, policy="exact", **kw):
    _, cfg, _, tree = _setup(arch)
    return ("drain", dict(cfg=cfg, weights=("numpy", tree),
                          trace=_trace(cfg), ecfg=ECFG, policy=policy,
                          preempt=True, **kw))


def _cases(n):
    from repro_torch.serve import TraceItem
    _, cfg, _, tree = _setup("qwen3_8b")
    cases = {"f32": _drain_case("qwen3_8b", observability="trace"),
             "prefix": ("drain", dict(
                 cfg=cfg, weights=("numpy", tree), ecfg=PREFIX_ECFG,
                 trace=_prefix_trace(synth_trace, TrafficConfig, TraceItem,
                                     cfg.vocab_size)))}
    for mode in QUANT:
        cases[mode] = _drain_case("qwen3_8b", mode, record_logits=n == 2)
    if n == 2:
        cases["moe"] = _drain_case("qwen2_moe_a2_7b")
        cases["refusals"] = ("refusals", {})
        for mode in STEP_MODES:
            cases[f"steps {mode}"] = ("serve_steps", dict(
                cfg=cfg, tokens=STEP_TOKENS, policy=mode))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """{n: {case: [every rank's result]}} for n = 2 and 4."""
    out = {}
    for n in (2, 4):
        cases = _cases(n)
        per_rank = meshlib.spawn(mesh_cases.run, n, list(cases.values()),
                                 device="cpu", timeout_s=60)
        out[n] = {name: [r[i] for r in per_rank]
                  for i, name in enumerate(cases)}
    return out


def _f32_core(qg, kall, vall, positions, cfg, policy):
    """What the dataflow cores compute, on one device: f32 scores and
    softmax over the whole gathered view (ring and split-KV at n = 1)."""
    b, s, kvh, g, hd = qg.shape
    q = qg.reshape(b, s, kvh * g, hd)
    k, v = _repeat_kv(kvh * g, kall, vall)
    kv_pos = torch.arange(kall.shape[1], dtype=torch.int32)[None].expand(
        b, -1)
    o, _, l = _chunk_attn(q.float(), k.float(), v.float(), positions, kv_pos,
                          hd ** -0.5, True)
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    return o.to(q.dtype).reshape(b, s, kvh, g, hd)


@functools.lru_cache(maxsize=None)
def _port_single(mode, core=None):
    kind, kw = _drain_case("qwen3_8b", mode, record_logits=core is None)
    return mesh_cases.drain("cpu", attn_core=core, **kw)


# ---------------------------------------------------------------------------
# token identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_f32_sharded_drain_matches_reference_single_device(ranks, n):
    want = _reference_drain("qwen3_8b")
    for r in ranks[n]["f32"]:
        assert r["tokens"] == want, f"rank {r['rank']} of {n}"
        assert r["metrics"]["n_preemptions"] >= 1


@pytest.mark.parametrize("n", [2, 4])
def test_prefix_sharing_and_cow_forks_on_the_mesh(ranks, n):
    """Shared prefixes and COW forks act on logical pages, the same on
    every rank: the greedy tokens equal the reference's single-device
    drain, and every rank shares and forks pages, the same ones (how
    many follows the schedule, which the mesh's cost model prices
    apart from one device's)."""
    tokens, sharing = _reference_prefix_drain()
    assert sharing["n_prefix_hits"] > 0 and sharing["n_cow_forks"] > 0
    runs = ranks[n]["prefix"]
    got = [{k: r["metrics"][k] for k in sharing} for r in runs]
    assert got[0]["n_prefix_hits"] > 0 and got[0]["n_cow_forks"] > 0
    for r, m in zip(runs, got):
        assert r["tokens"] == tokens, f"rank {r['rank']} of {n}"
        assert m == got[0]


def test_moe_sharded_drain_matches_reference_single_device(ranks):
    want = _reference_drain("qwen2_moe_a2_7b")
    for r in ranks[2]["moe"]:
        assert r["tokens"] == want, f"rank {r['rank']}"


@pytest.mark.parametrize("mode", QUANT)
def test_quantized_sharded_drain_is_bit_equal_to_single_device(ranks, mode):
    single = _port_single(mode)
    for r in ranks[2][mode]:
        assert r["tokens"] == single["tokens"]
        assert len(r["logits"]) == len(single["logits"])
        for step, (a, b) in enumerate(zip(r["logits"], single["logits"])):
            assert torch.equal(a, b), f"rank {r['rank']} step {step}"


@pytest.mark.parametrize("mode", QUANT)
def test_quantized_dataflow_drain_matches_its_single_device_core(ranks,
                                                                 mode):
    single = _port_single(mode, _f32_core)
    for r in ranks[4][mode]:
        assert r["tokens"] == single["tokens"], f"rank {r['rank']}"


# ---------------------------------------------------------------------------
# observability and the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_drain_emits_shard_metrics_and_trace_tracks(ranks, n):
    r = ranks[n]["f32"][0]
    prompts = sum(len(it.prompt) for it in _trace(_setup("qwen3_8b")[1]))
    assert r["gauges"]["shard_count"] == n
    assert r["gauges"]["shard_kv_heads"] == (1 if n == 2 else 2)
    assert r["shard_counts"]["shard_steps"] > 0
    assert r["shard_counts"]["shard_tokens"] >= prompts
    assert r["snapshot"]["n_shards"] == n
    assert r["snapshot"]["shard_steps"] == r["shard_counts"]["shard_steps"]
    validate_chrome_trace(r["chrome"])
    slices = [e for e in r["chrome"]["traceEvents"]
              if e.get("cat") == "backend" and e.get("ph") == "X"]
    assert {e["tid"] for e in slices} == set(range(n))
    assert {e["args"]["n_shards"] for e in slices} == {n}


@pytest.mark.parametrize("n", [2, 4])
def test_virtual_clock_prices_match_reference_cost_model(ranks, n):
    jcfg, cfg, _, _ = _setup("qwen3_8b")
    ref, port = JCost(jcfg, n_shards=n), ArtemisCostModel(cfg, n_shards=n)
    for k in (1, 3, 8, 24):
        assert port.price(k) == ref.price(k)
        assert port.energy(k) == ref.energy(k)
        assert port._tp_collective(k) == ref._tp_collective(k)
    r = ranks[n]["f32"][0]
    steps = [e for kind, e in r["events"] if kind.endswith("StepEvent")
             and "price_ns" in e]
    assert steps
    for e in steps:
        assert e["price_ns"] == ref.price(e["n_tokens"])
        assert e["energy_pj"] == ref.energy(e["n_tokens"])
    busy = sum(e["price_ns"] for e in steps) * 1e-9
    assert r["metrics"]["busy_virtual_s"] == pytest.approx(busy, rel=1e-12)


# ---------------------------------------------------------------------------
# the seam, the placement and the refusals
# ---------------------------------------------------------------------------


def test_single_mesh_is_strict_noop():
    mesh = make_serve_mesh(1)
    assert mesh == ServeMesh() and mesh.is_single and mesh.handle is None
    cfg = _setup("qwen3_8b")[1]
    assert param_shardings(mesh, cfg, None, ArithmeticPolicy()) is None
    assert kv_pool_sharding(mesh, cfg) is None
    assert replicated(mesh) is None and seq_sharded_spec(mesh) is None
    with pytest.raises(ValueError, match="handle is None iff"):
        ServeMesh(n_shards=2)
    with pytest.raises(ValueError, match="handle is None iff"):
        ServeMesh(n_shards=1, handle=MeshHandle(None, 0))
    with pytest.raises(ValueError, match="no process group"):
        make_serve_mesh(2)
    with pytest.raises(ValueError, match="needs a multi-shard ServeMesh"):
        ShardedPagedBackend(cfg, EngineConfig(**ECFG), ArithmeticPolicy(),
                            None, Tracer(), lambda: 0.0, mesh=ServeMesh())


def test_refusals_on_a_mesh(ranks):
    for r in ranks[2]["refusals"]:
        assert "has no multi-device path" in r["fused"]
        assert "has no multi-device backend" in r["state_slot"]
        assert "another placement" in r["placement"]
        assert "holds its 1 KV heads, got 2" in r["whole_cache"]
        assert "keep per-tensor scales" in r["per_channel"]


@pytest.mark.parametrize("mode", STEP_MODES)
def test_tensor_parallel_serve_steps_match_single_device(ranks, mode):
    """`make_prefill_step` / `make_decode_step(mesh=)` on 2 ranks: every
    rank's logits of the prefill and of one greedy decode step, and its
    cache, which holds its KV heads, equal the single-device steps'
    (exact within STEP_TOL, int8 bit for bit); exact calls flash (the
    kernel's plain version here) once a layer a step, int8 sc_matmul
    once a projection."""
    from repro_torch.launch import steps
    cfg = _setup("qwen3_8b")[1]
    pol = ArithmeticPolicy(mode=mode)
    model = modellib.init(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(STEP_TOKENS)
    b, s = tok.shape
    cache = modellib.init_cache(cfg, b, s + 1, dtype=torch.float32,
                                device="cpu")
    first, cache = steps.make_prefill_step(cfg, pol)(model, {"tokens": tok},
                                                     cache)
    second, cache = steps.make_decode_step(cfg, pol)(
        model, steps.greedy_sample(first)[:, None], cache)
    want_calls = {"flash_attention": 2 * cfg.n_layers} if mode == "exact" \
        else {"sc_matmul": 2 * 7 * cfg.n_layers,
              "sc_quantize": 2 * 2 * 7 * cfg.n_layers}
    tol = STEP_TOL if mode == "exact" else 0.0
    for r in ranks[2][f"steps {mode}"]:
        kv = r["kv_heads"]
        assert kv * 2 == cfg.n_kv_heads and r["index"] == s + 1
        heads = slice(r["rank"] * kv, (r["rank"] + 1) * kv)
        pairs = [*zip(r["logits"], (first, second)),
                 *((r[key], cache[key][..., heads, :]) for key in ("k", "v"))]
        for got, want in pairs:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        assert r["kernel_calls"] == want_calls


def test_rank_parts_are_cut_from_the_single_device_weights():
    """A rank's part drawn leaf by leaf (`init_shard`) or built from a
    reference tree (`params_from_numpy(mesh=)`) is the single-device
    model's leaves cut by the placement, bit for bit; a quantized
    placement splits wo and w_down by columns and keeps the whole
    leaves' absmax."""
    from repro_torch.bridge import params_from_numpy
    _, cfg, _, tree = _setup("qwen3_8b")
    whole = modellib.init(cfg, seed=3, device="cpu")
    from_tree = params_from_numpy(tree, cfg, device="cpu")
    for policy in (ArithmeticPolicy(), ArithmeticPolicy(mode="int8")):
        for rank in (0, 1):
            mesh = ServeMesh(n_shards=2, handle=MeshHandle(None, rank))
            drawn = tpl.init_shard(cfg, rank, 2, policy, seed=3,
                                   device="cpu")
            cut = tpl.shard_of(whole, cfg, rank, 2, policy)
            bridged = params_from_numpy(tree, cfg, device="cpu", mesh=mesh,
                                        policy=policy)
            bridged_cut = tpl.shard_of(from_tree, cfg, rank, 2, policy)
            for (name, a), b, c, d in zip(
                    drawn.named_parameters(), cut.parameters(),
                    bridged.parameters(), bridged_cut.parameters()):
                assert torch.equal(a, b) and torch.equal(c, d), name
            wo = drawn.layers[0].attn.wo
            assert wo.shape == ((64, 32) if policy.is_quantized()
                                else (32, 64))
            for leaf in ("attn.wo", "attn.wq", "ffn.w_down", "ffn.w_up"):
                assert torch.equal(
                    drawn.leaf_absmax[f"layers.0.{leaf}"],
                    whole.get_parameter(f"layers.0.{leaf}").abs().amax())
            assert not any(k.endswith(("norm", "scale"))
                           for k in drawn.leaf_absmax)


@pytest.mark.parametrize("mode", QUANT)
def test_tp_products_take_the_whole_leaf_scale(mode):
    """`TensorParallel.mm` scales a rank's cut weight by its whole leaf's
    absmax: each rank's columns of a quantized product equal the
    single-device product's bit for bit. A quantized product on a
    slice of a weight (not one the rank holds) is refused, and so is a
    part whose cut matrix has no whole-leaf absmax kept."""
    from repro_torch.models import layers as L
    _, cfg, _, _ = _setup("qwen3_8b")
    policy = ArithmeticPolicy(mode=mode)
    whole = modellib.init(cfg, seed=3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, cfg.d_model)).astype(np.float32))
    want = L.mm(x, whole.layers[0].ffn.w_up, policy)
    for rank in (0, 1):
        part = tpl.init_shard(cfg, rank, 2, policy, seed=3, device="cpu")
        tp = tpl.TensorParallel(None, rank, 2, cfg, part)
        w = part.layers[0].ffn.w_up
        cols = slice(rank * w.shape[1], (rank + 1) * w.shape[1])
        assert torch.equal(tp.mm(x, w, policy), want[:, cols])
        with pytest.raises(ValueError, match="as they are held"):
            tp.mm(x, w[:, :4], policy)
        del part.leaf_absmax["layers.0.ffn.w_up"]
        with pytest.raises(ValueError, match="absmax is not kept"):
            tpl.TensorParallel(None, rank, 2, cfg, part)


def test_engine_and_scheduler_have_no_mesh_branches():
    """The mesh is threaded as a value: the engine builds it once and
    hands it to make_backend; neither engine.py nor scheduler.py
    branches on it or names the sharded backend."""
    import inspect

    import repro_torch.serve.engine as eng_mod
    import repro_torch.serve.scheduler as sched_mod
    for src in (inspect.getsource(eng_mod), inspect.getsource(sched_mod)):
        for banned in ("is_single", "ShardedPagedBackend", "n_shards >"):
            assert banned not in src
    assert "make_serve_mesh(ecfg.mesh_shards)" in inspect.getsource(eng_mod)
    assert "mesh" not in inspect.getsource(sched_mod)


def test_cli_mesh_shards_prints_the_summary_once():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "engine", "--mesh-shards", "2", "--device", "cpu", "--n-requests",
         "4", "--gen-len", "6"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(ln.startswith("engine: 4 requests") for ln in lines) == 1
    assert sum(ln.startswith("energy: ") for ln in lines) == 1
