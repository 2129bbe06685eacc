"""The port's serve engine against the JAX package's.

One greedy `synth_trace` drains through the reference `ServeEngine`
(gather core) and through the port's (gather and fused cores), with
the reference's `model.init` weights carried over by the numpy bridge,
at float32 on the CPU. The token streams must be identical, `metrics()`
equal key for key, and at observability="trace" the whole event log —
scheduler decisions, lifecycle events and every virtual timestamp —
equal field for field. Three traces: prompts spanning prefill chunks,
cache pressure with preemptions, and shared prefixes with COW forks.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402
from repro.serve.traffic import TraceItem as JTraceItem  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine, TrafficConfig  # noqa: E402
from repro_torch.serve import TraceItem, synth_trace  # noqa: E402


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


# (traffic, engine) keyword sets: prompts that span chunks; the cache
# pressure probe of the verify recipe (`--page-size 4 --n-pages 12
# --batch 3 --prompt-len 12 --gen-len 16 --arrival-rate 1e9`); shared
# prefixes (2 groups of 16 tokens), plus mid-page sharers (below)
TRACES = {
    "chunked": (
        dict(n_requests=6, arrival_rate=2e5, prompt_len_min=3,
             prompt_len_max=20, gen_len_min=2, gen_len_max=8, seed=3),
        dict(page_size=8, n_pages=64, max_batch=3, max_pages_per_seq=8,
             prefill_chunk=8)),
    "cache_pressure": (
        dict(n_requests=16, arrival_rate=1e9, prompt_len_min=6,
             prompt_len_max=12, gen_len_min=8, gen_len_max=16, seed=0),
        dict(page_size=4, n_pages=12, max_batch=3, max_pages_per_seq=8,
             prefill_chunk=32)),
    "prefix_sharing": (
        dict(n_requests=8, arrival_rate=1e6, prompt_len_min=4,
             prompt_len_max=12, gen_len_min=3, gen_len_max=8, seed=1,
             n_prefix_groups=2, prefix_len=16),
        dict(page_size=8, n_pages=64, max_batch=4, max_pages_per_seq=6,
             prefill_chunk=8)),
}


def _trace(name, synth, traffic_config, item_cls, vocab_size):
    """The named trace, built with one package's traffic module. The
    prefix trace gains, 2 us after each group's first request, a
    request whose prompt is that one's first 13 tokens: it shares the
    group's resident pages up to mid-page, and its first decode write
    COW-forks the co-owned page."""
    items = synth(traffic_config(vocab_size=vocab_size, **TRACES[name][0]))
    if name == "prefix_sharing":
        for g in (0, 1):
            src = next(it for it in items if it.prefix_group == g)
            items.append(item_cls(src.arrival_time + 2e-6,
                                  src.prompt[:13].copy(), 6, g))
        items.sort(key=lambda it: it.arrival_time)
    return items


def _events(events):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


def _drain_jax(name):
    cfg, params, _ = _weights()
    ekw = TRACES[name][1]
    eng = JServeEngine(cfg, params=params, ecfg=JEngineConfig(
        observability="trace", **ekw))
    eng.submit_trace(_trace(name, jsynth_trace, JTrafficConfig,
                            JTraceItem, cfg.vocab_size))
    eng.drain()
    return eng


def _drain_port(name, attn_impl):
    cfg, _, model = _weights()
    ekw = TRACES[name][1]
    eng = ServeEngine(cfg, params=model, ecfg=EngineConfig(
        observability="trace", attn_impl=attn_impl, **ekw), device="cpu")
    eng.submit_trace(_trace(name, synth_trace, TrafficConfig, TraceItem,
                            cfg.vocab_size))
    reset_launch_counts()
    eng.drain()
    assert launch_counts["paged_attention"] == 0   # CPU: plain version
    eng.backend.check_invariants()
    return eng


@functools.lru_cache(maxsize=None)
def _reference(name):
    eng = _drain_jax(name)
    return (eng.results(), eng.metrics(), _events(eng.events))


@pytest.mark.parametrize("attn_impl", ["gather", "fused"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_drain_matches_reference(name, attn_impl):
    results, metrics, events = _reference(name)
    eng = _drain_port(name, attn_impl)
    got = eng.results()
    assert sorted(got) == sorted(results)
    for rid in results:
        np.testing.assert_array_equal(got[rid], results[rid],
                                      err_msg=f"request {rid}")
    assert eng.metrics() == metrics
    assert _events(eng.events) == events


def test_traces_exercise_what_they_name():
    assert _reference("cache_pressure")[1]["n_preemptions"] > 0
    m = _reference("prefix_sharing")[1]
    assert m["n_prefix_hits"] > 0 and m["n_cow_forks"] > 0
    ev = _reference("chunked")[2]
    chunks = [n for kind, e in ev if kind.endswith("StepEvent")
              for _, n in e["chunks"]]
    assert max(chunks) == 8 and len(chunks) > 6


def test_multi_device_mesh_is_refused():
    """A multi-shard engine serves only as a rank of a process group
    (tests/test_torch_serve_mesh.py drives those); outside one it is
    refused, before any weight is cut."""
    cfg, _, model = _weights()
    with pytest.raises(ValueError, match="2-way serve mesh: this process "
                                         "is in no process group"):
        ServeEngine(cfg, params=model, ecfg=EngineConfig(mesh_shards=2),
                    device="cpu")


def test_unported_families_and_policies_are_refused():
    """Every family the reference serves has its backend now (the
    recurrent ones the state-slot backend, tests/test_torch_state_engine
    .py); a family no backend serves is refused as the reference refuses
    it, and so is the artemis readout noise."""
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.serve.backend import make_backend
    cfg, _, model = _weights()

    class _NoSuchFamily:
        family = "no_such_family"

    with pytest.raises(ValueError, match="no sequence backend"):
        make_backend(_NoSuchFamily(), EngineConfig(), ArithmeticPolicy(),
                     model, obs=None, clock=None)
    # the quantized policies run; the artemis readout noise does not
    with pytest.raises(NotImplementedError, match="sigma_analog"):
        ServeEngine(cfg, params=model,
                    policy=ArithmeticPolicy("artemis", sigma_analog=0.01),
                    device="cpu")


@pytest.mark.parametrize("name", sorted(TRACES))
def test_backend_counts_prefill_forwards(name):
    """`n_prefill_forwards` counts the step calls that ran a prefill
    chunk (a mixed step runs one of each), the rest of `n_forwards` the
    decode forwards: the chip smoke holds the paged_attention tile
    instance's launches to layers x prefill forwards."""
    eng = _drain_port(name, "fused")
    steps = [e for e in eng.events if hasattr(e, "chunks")]
    n_chunk = sum(1 for e in steps if e.chunks)
    n_decode = sum(1 for e in steps if e.decode_rids)
    assert eng.backend.n_prefill_forwards == n_chunk > 0
    assert eng.backend.n_forwards == n_chunk + n_decode
