"""The port's serve engine on the MoE family against the JAX package's.

A short `synth_trace` drains through the reference `ServeEngine` and
the port's on the smoke `qwen2_moe_a2_7b` and `dbrx_132b` configs, at
float32 on the CPU, with the reference's `model.init` weights carried
over by the numpy bridge: all greedy, and with half of the requests
sampled (temperature 0.8, top-k 20, top-p 0.9 on per-request RNG
lanes), under every arithmetic policy. The tokens must be identical
(artemis aside, below), `metrics()` equal key for key and the event logs equal field for
field. A qwen2_moe drain at the full config's capacity factor (1.25)
drops routing choices at decode, as the reference does, and still
matches it. The CLI's `--mode engine` and `--mode static` on
qwen2_moe print the reference CLI's lines, wall numbers aside.

Under a quantized policy the drains run with the router's weights set
to zero. A quantized policy turns a last-bit difference of an f32
reduction into another int8 value or artemis readout level now and
then, and XLA's CPU reductions and torch's round apart (the RMS norm's
mean and rsqrt, the router's product): the tokens of whole quantized
drains part even between the reference jitted and op by op
(scripts/reference_jit_divergence.py shows it on this trace). A zero
router gives every token the same logits, which every implementation
computes exactly, so the routing (uniform, ties to the lower ids, gates
exactly 1/k) is the same bit for bit and the rest of the layer (the
dispatch, each expert quantized alone, the pad experts, the combine,
the shared experts) is held to token identity under int8 and
artemis_mxu. The trained router under each quantized policy is held
layer by layer in tests/test_torch_moe.py: on the hidden states the
reference's own forward feeds each layer, routing choices and
destinations equal exactly and outputs within 1e-5. Whole int8 and
artemis_mxu drains with the trained router are held teacher-forced (the
port's engine fed the reference's tokens): each step's logits against
the reference's, tightly where no int8 value flips and within the
reference's own jit-against-op-by-op spread where one does (the last
test's docstring).

artemis amplifies such a difference through its floored products and
8-bit group readouts into a jump of a whole readout level
(tests/test_torch_moe.py shows a norm two ulps apart doing it to the
reference's own attention), and that parts the tokens of this trace
even with the zero router. Its drains are held to the reference's
schedule (every metric and every event, which no token value enters)
and their tokens to the vocabulary.
"""
import dataclasses
import functools
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine, TrafficConfig  # noqa: E402
from repro_torch.serve import synth_trace  # noqa: E402

POLICIES = ["exact", "int8", "artemis_mxu", "artemis"]
# prompts spanning prefill chunks, idle lanes and padding
TRAFFIC = dict(n_requests=4, arrival_rate=2e5, prompt_len_min=3,
               prompt_len_max=12, gen_len_min=2, gen_len_max=5, seed=3)
SAMPLED = dict(sampled_fraction=0.5, temperature=0.8, top_k=20, top_p=0.9)
ENGINE = dict(page_size=8, n_pages=48, max_batch=3, max_pages_per_seq=4,
              prefill_chunk=8, observability="trace")


@functools.lru_cache(maxsize=None)
def _weights(arch, capacity_factor=None, zero_router=False):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              compute_dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    if zero_router:
        moe = params["layers"]["moe"]
        moe["router"] = jax.numpy.zeros_like(moe["router"])
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _events(events):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


def _drain_both(arch, mode, sampled, capacity_factor=None):
    cfg, params, model = _weights(arch, capacity_factor,
                                  zero_router=mode != "exact")
    tkw = dict(TRAFFIC, vocab_size=cfg.vocab_size, **(SAMPLED if sampled
                                                       else {}))
    jeng = JServeEngine(cfg, params=params, policy=JPolicy(mode=mode),
                        ecfg=JEngineConfig(**ENGINE))
    jeng.submit_trace(jsynth_trace(JTrafficConfig(**tkw)))
    jeng.drain()
    eng = ServeEngine(cfg, params=model, policy=TPolicy(mode=mode),
                      ecfg=EngineConfig(**ENGINE), device="cpu")
    eng.submit_trace(synth_trace(TrafficConfig(**tkw)))
    reset_launch_counts()
    eng.drain()
    assert not launch_counts                 # CPU: the plain versions
    eng.backend.check_invariants()
    return jeng, eng


def _assert_same(jeng, eng, tokens=True):
    want, got = jeng.results(), eng.results()
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].shape == want[rid].shape
        assert 0 <= got[rid].min() and got[rid].max() < eng.cfg.padded_vocab
        if tokens:
            np.testing.assert_array_equal(got[rid], want[rid],
                                          err_msg=f"request {rid}")
    assert eng.metrics() == jeng.metrics()
    assert _events(eng.events) == _events(jeng.events)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
@pytest.mark.parametrize("mode", POLICIES)
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "dbrx_132b"])
def test_moe_drain_matches_reference(arch, mode, sampled):
    jeng, eng = _drain_both(arch, mode, sampled)
    _assert_same(jeng, eng, tokens=mode != "artemis")
    n_sampled = eng.metrics()["n_sampled_tokens"]
    assert (n_sampled > 0) == sampled


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_moe_drain_with_decode_drops_matches_reference(sampled, monkeypatch):
    """capacity_factor 1.25 (the full config's): at a decode of 3 lanes
    the capacity is max(int(1.25 * 3 * 2 / 8), 1) = 1 slot an expert,
    so lanes (idle ones included) compete for slots and choices drop."""
    from repro_torch.models import moe as TM
    kept = []
    route = TM.route

    def spy(p, xt, cfg, policy):
        out = route(p, xt, cfg, policy)
        kept.append(bool(out[5].all()))
        return out

    monkeypatch.setattr(TM, "route", spy)
    jeng, eng = _drain_both("qwen2_moe_a2_7b", "exact", sampled, 1.25)
    _assert_same(jeng, eng)
    assert not all(kept)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _strip_wall(lines):
    return [re.sub(r"[\d.]+ tok/s wall|prefill \d+ms \| decode [\d.]+ tok/s",
                   "", ln) for ln in lines]


@pytest.mark.parametrize("flags", [
    ["--mode", "engine", "--temperature", "0.8", "--top-k", "50",
     "--top-p", "0.9", "--sampled-fraction", "0.5"],
    ["--mode", "static"],
], ids=["engine_sampled", "static"])
def test_cli_moe_prints_the_reference_lines(flags, monkeypatch, capsys):
    flags = [*flags, "--arch", "qwen2_moe_a2_7b", "--n-requests", "4",
             "--prompt-len", "12", "--gen-len", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jcli.main()
    want = capsys.readouterr().out.strip().splitlines()
    tcli.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) >= 1
    assert _strip_wall(got) == _strip_wall(want)
    if "engine" in flags:
        assert re.search(r"\(([1-9]\d*) sampled\)", got[0]), got[0]


# ---------------------------------------------------------------------------
# quantized drains with the trained router, teacher-forced
# ---------------------------------------------------------------------------

# a step's logits against the reference's, of their max abs: where no
# int8 value flips (TIGHT_STEP), and the bound of a step where one does
# (FORCED_TOL); the docstring of the test below
TIGHT_STEP = 1e-5
FORCED_TOL = 0.25


def _forced_drains(arch, mode):
    """The reference engine drains the greedy trace with the trained
    router, recording each request's logits at each of its tokens; the
    port's engine drains the same trace fed the reference's tokens
    (teacher-forced: each of its choices is replaced by the reference's
    token at that position), recording its logits the same way."""
    cfg, params, model = _weights(arch)
    tkw = dict(TRAFFIC, vocab_size=cfg.vocab_size)
    want_logits, got_logits = {}, {}

    def recording(engine, into, tokens=None):
        sample = engine._sample_rows

        def sample_rows(logits, rows):
            out = np.array(sample(logits, rows))
            lg = np.asarray(logits, np.float32)
            for row, req in rows:
                pos = len(req.generated)
                into[req.rid, pos] = lg[row].copy()
                if tokens is not None:
                    out[row] = tokens[req.rid][pos]
            return out

        engine._sample_rows = sample_rows

    jeng = JServeEngine(cfg, params=params, policy=JPolicy(mode=mode),
                        ecfg=JEngineConfig(**ENGINE))
    recording(jeng, want_logits)
    jeng.submit_trace(jsynth_trace(JTrafficConfig(**tkw)))
    jeng.drain()
    eng = ServeEngine(cfg, params=model, policy=TPolicy(mode=mode),
                      ecfg=EngineConfig(**ENGINE), device="cpu")
    recording(eng, got_logits, jeng.results())
    eng.submit_trace(synth_trace(TrafficConfig(**tkw)))
    eng.drain()
    eng.backend.check_invariants()
    return jeng, eng, want_logits, got_logits


@pytest.mark.parametrize("mode", ["int8", "artemis_mxu"])
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "dbrx_132b"])
def test_quantized_drain_with_trained_router_teacher_forced(arch, mode):
    """The trained router under int8 and artemis_mxu, whole drains: fed
    the reference's tokens (teacher-forced), the port's engine gives
    each step's logits within TIGHT_STEP of the reference's max abs at
    that step where no int8 value flips, and within FORCED_TOL where one
    does. A last-bit difference of an f32 reduction (XLA's fusions
    against torch's ops) flips an int8 value at a rounding tie now and
    then, and the K/V cache carries it to the request's later steps. The
    reference parts from itself the same way: jitted against
    `jax.disable_jit`, forced to the same tokens, its qwen2_moe int8
    drain differs by 0.174 of a step's max abs at request 3's third
    token and 1.8e-2 to 2.2e-2 at its others, and the port by the same
    amounts at the same steps (and dbrx int8 by up to 1.8e-2 at three
    steps of request 1); artemis_mxu stays within 4.4e-7 throughout.
    Most steps must be tight, every quantized policy's, and a wrong
    routing or a missing quantization parts every step. The greedy
    choices agree wherever the reference's top-2 margin is above
    FORCED_TOL of its max abs. The schedule, metrics and events equal
    the reference's: no token value enters them under forcing."""
    jeng, eng, want, got = _forced_drains(arch, mode)
    assert sorted(got) == sorted(want)
    assert len(want) == sum(len(t) for t in jeng.results().values())
    n_tight = 0
    for key, w in want.items():
        g = got[key]
        scale = np.abs(w).max()
        err = np.abs(g - w).max() / scale
        assert err <= FORCED_TOL, (key, err)
        n_tight += err <= TIGHT_STEP
        if g.argmax() != w.argmax():
            top2 = np.sort(w)[-2:]
            assert (top2[1] - top2[0]) / scale < FORCED_TOL, key
    assert n_tight >= (len(want) if mode == "artemis_mxu"
                       else len(want) // 2), n_tight
    for rid, toks in jeng.results().items():
        np.testing.assert_array_equal(eng.results()[rid], toks)
    assert eng.metrics() == jeng.metrics()
    assert _events(eng.events) == _events(jeng.events)
