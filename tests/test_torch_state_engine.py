"""The port's state-slot serving (rwkv6 and zamba2) against the JAX
package's.

Weights come from the reference's `model.init` through the numpy
bridge, at float32 on the CPU:

- engine drains equal the reference engine's on the same trace: the
  token streams, `metrics()` key for key and the event log field for
  field (the virtual clock included), greedy and with half of the
  requests sampled; and, where the prompts fit zamba2's ring, each
  greedy request's tokens equal the port's sequential static path of
  that request alone (whole-prompt prefill, then one token a step),
  also when decode wraps the ring;
- a prompt longer than zamba2's ring: the engine absorbs it token by
  token, and its drain is held against the reference engine's, path
  for path (the static whole-prompt path is held in
  tests/test_torch_zamba2.py);
- forced preemption recomputes into a fresh slot, `validate` refuses a
  request past `max_seq_len`, admissions stop at the free slots, the
  invariants hold, the pool is empty after a drain;
- the slot steps: a prefill chunk with ragged per-lane lengths and idle
  rows equals the reference's, and a batched decode step under int8 and
  artemis equals the reference's per-lane vmap and, bit for bit, each
  lane stepped alone (a per-tensor scale over the batch would part
  them);
- the CLI's `--mode engine --n-slots` and `--mode static` print the
  reference CLI's lines, wall numbers aside.
"""
import dataclasses
import functools
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import state_model as jsm  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine, TrafficConfig  # noqa: E402
from repro_torch.serve import state_model as tsm  # noqa: E402
from repro_torch.serve import synth_trace  # noqa: E402
from repro_torch.serve.backend import StateSlotBackend  # noqa: E402
from repro_torch.serve.request import RequestState  # noqa: E402

ARCHS = ["rwkv6_3b", "zamba2_7b"]
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch=3, prefill_chunk=8, max_seq_len=64,
              cache_dtype="float32", observability="trace")
SAMPLED = dict(sampled_fraction=0.5, temperature=0.8, top_k=20, top_p=0.9)
# prompts spanning chunks and idle lanes, within zamba2's ring of 32
SHORT = dict(n_requests=4, arrival_rate=1e8, prompt_len_min=3,
             prompt_len_max=18, gen_len_min=2, gen_len_max=8, seed=3)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _events(events):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


def _port_engine(arch, traffic, **ekw):
    cfg, _, model = _weights(arch)
    eng = ServeEngine(cfg, params=model,
                      ecfg=EngineConfig(**{**ENGINE, **ekw}), device="cpu")
    trace = synth_trace(TrafficConfig(vocab_size=cfg.vocab_size, **traffic))
    eng.submit_trace(trace)
    return eng, trace


def _drain_port(arch, traffic, **ekw):
    eng, trace = _port_engine(arch, traffic, **ekw)
    reset_launch_counts()
    eng.drain()
    assert not launch_counts                  # CPU: the plain versions
    eng.backend.check_invariants()
    return eng, trace


@functools.lru_cache(maxsize=None)
def _reference(arch, traffic_items):
    cfg, params, _ = _weights(arch)
    eng = JServeEngine(cfg, params=params, ecfg=JEngineConfig(**ENGINE))
    eng.submit_trace(jsynth_trace(JTrafficConfig(vocab_size=cfg.vocab_size,
                                                 **dict(traffic_items))))
    eng.drain()
    return eng.results(), eng.metrics(), _events(eng.events)


def _assert_matches_reference(arch, eng, traffic):
    results, metrics, events = _reference(arch, tuple(sorted(traffic.items())))
    got = eng.results()
    assert sorted(got) == sorted(results)
    for rid in results:
        np.testing.assert_array_equal(got[rid], results[rid],
                                      err_msg=f"request {rid}")
    assert eng.metrics() == metrics
    assert _events(eng.events) == events


def _sequential(arch, prompt, n_new):
    """Greedy decode of one request alone on the port's static path."""
    cfg, _, model = _weights(arch)
    prefill, decode = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(
        cfg)
    cache = tmodel.init_cache(cfg, 1, len(prompt) + n_new,
                              dtype=torch.float32, device="cpu")
    logits, cache = prefill(model, {"tokens": torch.from_numpy(
        np.asarray(prompt)[None])}, cache)
    out = [tsteps.greedy_sample(logits)]
    for _ in range(n_new - 1):
        logits, cache = decode(model, out[-1][:, None], cache)
        out.append(tsteps.greedy_sample(logits))
    return torch.cat(out).tolist()


def _assert_matches_sequential(arch, eng, trace):
    for rid, item in enumerate(trace):
        if item.sampling.temperature > 0:
            continue
        assert eng.results()[rid].tolist() == _sequential(
            arch, item.prompt, item.max_new_tokens), f"request {rid}"


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_drain_matches_reference_and_sequential_static(arch, sampled):
    traffic = {**SHORT, **(SAMPLED if sampled else {})}
    eng, trace = _drain_port(arch, traffic)
    assert isinstance(eng.backend, StateSlotBackend)
    _assert_matches_reference(arch, eng, traffic)
    _assert_matches_sequential(arch, eng, trace)
    assert (eng.metrics()["n_sampled_tokens"] > 0) == sampled
    assert eng.backend.utilization() == (0.0, 0.0)
    assert set(eng.backend.snapshot_metrics()) == {
        "n_state_slots", "state_slots_allocated"}


def test_zamba2_decode_past_the_wrap_engine_equals_static():
    """Prompts of 16-24 and up to 16 new tokens over a ring of 32: decode
    wraps the ring, no prompt outruns it."""
    traffic = dict(SHORT, prompt_len_min=16, prompt_len_max=24,
                   gen_len_min=12, gen_len_max=16, seed=5)
    eng, trace = _drain_port("zamba2_7b", traffic)
    assert max(len(it.prompt) + it.max_new_tokens for it in trace) > 33
    _assert_matches_reference("zamba2_7b", eng, traffic)
    _assert_matches_sequential("zamba2_7b", eng, trace)


def test_zamba2_prompt_longer_than_the_ring_matches_reference_engine():
    """Prompts of 34-40 over a ring of 32: the engine absorbs them token
    by token, the ring wrapping during the prefill, as the reference's
    engine does (its whole-prompt static path keeps the last 32 tokens
    in sequence order instead, and the two paths part)."""
    traffic = dict(SHORT, n_requests=2, prompt_len_min=34,
                   prompt_len_max=40, gen_len_min=3, gen_len_max=5, seed=6)
    eng, _ = _drain_port("zamba2_7b", traffic)
    _assert_matches_reference("zamba2_7b", eng, traffic)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_preemption_recomputes_into_a_fresh_slot(arch):
    eng, trace = _port_engine(arch, dict(SHORT, n_requests=3, seed=5,
                                         prompt_len_min=6, gen_len_min=4))
    preempted = set()
    for _ in range(400):
        laned = [r for r in eng.requests.values()
                 if r.state in (RequestState.PREFILL, RequestState.DECODE)]
        fresh = [r for r in laned if r.rid not in preempted]
        if fresh and len(preempted) < 2:
            victim = fresh[0]
            eng._preempt(victim)
            preempted.add(victim.rid)
            assert victim.mem is None
            assert victim.state is RequestState.QUEUED
            eng.backend.check_invariants()
        if eng.step() is None:
            break
    eng.drain()
    assert len(preempted) == 2
    m = eng.metrics()
    assert m["n_preemptions"] >= 2 and m["n_done"] == 3
    # each preempted request took a slot again, reset on admission
    assert m["state_slots_allocated"] == 3 + len(preempted)
    _assert_matches_sequential(arch, eng, trace)
    eng.backend.check_invariants()


def test_validate_refuses_past_max_seq_len():
    eng, _ = _port_engine("rwkv6_3b", dict(SHORT, n_requests=1),
                          max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.arange(2, 16, dtype=np.int32), max_new_tokens=8)
    eng.submit(np.arange(2, 10, dtype=np.int32), max_new_tokens=8)


def test_admissions_stop_at_the_free_slots():
    eng, _ = _port_engine("rwkv6_3b", dict(SHORT, n_requests=5, seed=7),
                          n_slots=3)                 # 2 usable slots
    peak = 0
    for _ in range(10_000):
        laned = sum(1 for r in eng.lanes if r is not None)
        peak = max(peak, laned)
        assert laned <= 2
        eng.backend.check_invariants()
        if eng.step() is None:
            break
    assert eng.metrics()["n_done"] == 5 and peak == 2
    assert eng.backend.snapshot_metrics()["n_state_slots"] == 2


# ---------------------------------------------------------------------------
# the slot steps
# ---------------------------------------------------------------------------


def _ref_leaf(leaf, path):
    """A reference pool leaf (n_slots, *single cache leaf) in the
    port's layout, the lane axis first: the single cache's batch axis
    of 1 dropped."""
    leaf = np.asarray(leaf)
    if path[-1] == "index":
        return leaf
    return np.squeeze(leaf, axis=1 if path[-1] == "attn_pos" else 2)


def _assert_pools_close(tpool, jpool, slots):
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jpool)[0])
    jleaves = {tuple(k.key for k in path): v for path, v in jleaves.items()}
    for path, leaf, axis in tsm.lane_leaves(tpool):
        got = np.moveaxis(leaf.numpy(), axis, 0)[slots]
        want = _ref_leaf(jleaves[path], path)[slots]
        np.testing.assert_allclose(got, want, **STEP_TOL,
                                   err_msg="/".join(path))


def _pools(arch, n_slots=5, max_len=48):
    cfg, _, _ = _weights(arch)
    jpool, _ = jsm.init_slot_pool(cfg, n_slots, max_len)
    tpool, _ = tsm.init_slot_pool(cfg, n_slots, max_len, device="cpu")
    return jpool, tpool


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_with_ragged_lanes_matches_reference(arch):
    """Rows of 6, 2 and 0 (idle) tokens of a chunk of 8 into slots 3, 1
    and the trash slot: the port's loop stops after 6 applies and puts
    the row of 2 back where its chunk ended."""
    cfg, params, model = _weights(arch)
    jpool, tpool = _pools(arch)
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (3, 8)).astype(np.int32)
    slots = np.array([3, 1, 0], np.int32)
    lens = np.array([6, 2, 0], np.int32)
    active = np.array([True, True, False])
    want, jpool = jsm.make_slot_prefill_chunk(cfg)(
        params, jnp.asarray(toks), jpool, jnp.asarray(slots),
        jnp.asarray(lens), jnp.asarray(active))
    got, tpool = tsm.make_slot_prefill_chunk(cfg)(
        model, torch.from_numpy(toks), tpool,
        torch.from_numpy(slots.astype(np.int64)), lens, active)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(got[row, :n].numpy(),
                                   np.asarray(want)[row, :n], **STEP_TOL)
    _assert_pools_close(tpool, jpool, [1, 2, 3, 4])


def _absorbed(arch, policy_mode):
    """Both packages' pools after the same prefill chunk of 5 lanes
    into slots 1..5 under `policy_mode`."""
    cfg, params, model = _weights(arch)
    jpool, tpool = _pools(arch, n_slots=6)
    toks = np.random.default_rng(2).integers(
        2, cfg.vocab_size, (5, 6)).astype(np.int32)
    slots = np.arange(1, 6, dtype=np.int32)
    lens, active = np.full(5, 6, np.int32), np.ones(5, bool)
    _, jpool = jsm.make_slot_prefill_chunk(cfg, JPolicy(mode=policy_mode))(
        params, jnp.asarray(toks), jpool, jnp.asarray(slots),
        jnp.asarray(lens), jnp.asarray(active))
    _, tpool = tsm.make_slot_prefill_chunk(cfg, TPolicy(mode=policy_mode))(
        model, torch.from_numpy(toks), tpool,
        torch.from_numpy(slots.astype(np.int64)), lens, active)
    return jpool, tpool


@pytest.mark.parametrize("mode", ["int8", "artemis"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_quantized_decode_equals_the_per_lane_vmap(arch, mode,
                                                          monkeypatch):
    """One decode step of 5 live lanes under a quantized policy, batched
    with per-lane scales: within 1e-4 of the reference's per-lane vmap,
    and bit for bit each lane stepped alone (the other lanes idle on
    the trash slot); with one scale over the batch the lanes part."""
    cfg, params, model = _weights(arch)
    jpool, tpool = _absorbed(arch, mode)
    tok = np.random.default_rng(3).integers(
        2, cfg.vocab_size, (5, 1)).astype(np.int32)
    slots = np.arange(1, 6)
    tslots = torch.from_numpy(slots)
    want, _ = jsm.make_slot_decode(cfg, JPolicy(mode=mode))(
        params, jnp.asarray(tok), jpool, jnp.asarray(slots, jnp.int32))
    decode = tsm.make_slot_decode(cfg, TPolicy(mode=mode))

    def copy():
        return tsm.gather_lanes(tpool, torch.arange(6))

    got, _ = decode(model, torch.from_numpy(tok), copy(), tslots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    for i in range(5):
        ids = torch.full_like(tslots, tsm.TRASH_SLOT)
        ids[i] = tslots[i]
        alone, _ = decode(model, torch.from_numpy(tok), copy(), ids)
        assert torch.equal(alone[i], got[i]), f"lane {i}"
    # one activation scale over all the lanes (the trash lanes in it):
    # the lane stepped alone then differs from its batched self
    monkeypatch.setattr(TL, "per_lane", lambda policy: policy)
    shared, _ = decode(model, torch.from_numpy(tok), copy(), tslots)
    ids = torch.full_like(tslots, tsm.TRASH_SLOT)
    ids[0] = tslots[0]
    alone, _ = decode(model, torch.from_numpy(tok), copy(), ids)
    assert not torch.equal(alone[0], shared[0])


def test_reset_slot_restores_the_pristine_cache():
    """zamba2's pristine ring positions are int32 max, not zero."""
    cfg, _, _ = _weights("zamba2_7b")
    pool, init = tsm.init_slot_pool(cfg, 3, 40, device="cpu")
    for _, leaf, _ in tsm.lane_leaves(pool):
        leaf.fill_(7)
    tsm.reset_slot(pool, init, 2)
    assert (pool["attn_pos"][2] == np.iinfo(np.int32).max).all()
    assert not pool["mamba"]["ssd"][:, 2].any() and pool["index"][2] == 0
    assert (pool["attn_pos"][1] == 7).all()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _strip_wall(lines):
    return [re.sub(r"[\d.]+ tok/s wall|prefill \d+ms \| decode [\d.]+ tok/s",
                   "", ln) for ln in lines]


@pytest.mark.parametrize("flags", [
    ["--mode", "engine", "--arch", "rwkv6_3b", "--n-slots", "3"],
    ["--mode", "engine", "--arch", "zamba2_7b"],
    ["--mode", "static", "--arch", "rwkv6_3b"],
    ["--mode", "static", "--arch", "zamba2_7b"],
], ids=["rwkv6_engine", "zamba2_engine", "rwkv6_static", "zamba2_static"])
def test_cli_prints_the_reference_lines(flags, monkeypatch, capsys):
    flags = [*flags, "--n-requests", "4", "--prompt-len", "12",
             "--gen-len", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jcli.main()
    want = capsys.readouterr().out.strip().splitlines()
    tcli.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) >= 1
    assert _strip_wall(got) == _strip_wall(want)
    if "engine" in flags:
        assert "state slots" in got[0]
