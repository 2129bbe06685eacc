"""The port's serve path under the quantized arithmetic policies (int8,
artemis_mxu, artemis) against the JAX package's.

Weights come from the reference's `model.init` through the numpy
bridge, at float32 on the CPU, where every dense projection runs the
sc_matmul kernel's plain version:

- `mm` and `qeinsum` within rtol=atol=1e-5 (the straight-through term
  adds the exact f32 product, summed in another order);
- chunked-prefill and decode logits within 1e-4, and every page of the
  pool, trash page included;
- engine drains token-identical, with equal metrics and event logs;
- the serve CLI's `--policy` summary lines equal the reference CLI's.

Trash page 0, slot 0 takes a scatter with duplicate indices (every idle
and padding token). A quantized policy quantizes the whole gathered
K/V view with one scale, trash row included, so which duplicate lands
there can move every valid lane's attention: the port gives all
duplicates the last writer's values, which is what jax's CPU scatter
keeps (`paged_model.last_writers`).
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import paged_model as jpm  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine, TrafficConfig  # noqa: E402
from repro_torch.serve import paged_model as tpm  # noqa: E402
from repro_torch.serve import synth_trace  # noqa: E402
from repro_torch.serve.backend import make_backend  # noqa: E402

MODES = ["int8", "artemis_mxu", "artemis"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_mm_matches_reference(mode):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 40)) * 0.1).astype(np.float32)
    want = JL.mm(jnp.asarray(x), jnp.asarray(w), JPolicy(mode=mode))
    got = TL.mm(torch.from_numpy(x), torch.from_numpy(w), TPolicy(mode=mode))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # bf16 activations come back in bf16, as the reference's
    got16 = TL.mm(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(w), TPolicy(mode=mode))
    assert got16.dtype == torch.bfloat16


# the two contractions of the attention core, at the gather view's shapes
SPECS = {
    "scores": ("bskgd,btkd->bkgst", (2, 5, 2, 2, 16), (2, 24, 2, 16)),
    "context": ("bkgst,btkd->bskgd", (2, 2, 2, 5, 24), (2, 24, 2, 16)),
}


@pytest.mark.parametrize("ste", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("mode", ["exact"] + MODES)
def test_qeinsum_matches_reference(mode, spec, ste):
    """artemis maps to a plain int8 contraction here, as in the
    reference's code (its docstring says artemis_mxu)."""
    eq, a_shape, b_shape = SPECS[spec]
    rng = np.random.default_rng(len(eq))
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    want = JL.qeinsum(eq, jnp.asarray(a), jnp.asarray(b),
                      JPolicy(mode=mode, ste=ste))
    got = TL.qeinsum(eq, torch.from_numpy(a), torch.from_numpy(b),
                     TPolicy(mode=mode, ste=ste))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    if mode == "artemis":
        np.testing.assert_array_equal(
            got.numpy(), TL.qeinsum(eq, torch.from_numpy(a),
                                    torch.from_numpy(b),
                                    TPolicy(mode="int8", ste=ste)).numpy())


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

PAGE, N_PAGES, B, CHUNK = 4, 16, 2, 6


def _schedule(cfg):
    """Two prefill chunks and one decode round. Chunk 2 has row 0's 3
    last prompt tokens and 3 padding slots, and row 1 idle: 9 tokens
    write the trash row, each with another K/V."""
    rng = np.random.default_rng(0)
    toks = [rng.integers(2, cfg.vocab_size, (B, CHUNK)).astype(np.int32)
            for _ in range(2)]
    dtok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    steps = [
        ("prefill", (toks[0], bt, i32([0, 0]), i32([6, 5]),
                     np.asarray([True, True]), i32([0, 0]))),
        ("prefill", (toks[1], bt, i32([6, 0]), i32([3, 0]),
                     np.asarray([True, False]), i32([0, 0]))),
        ("decode", (dtok, bt, i32([9, 5]), np.asarray([True, True]))),
    ]
    valid = [[(0, 6), (1, 5)], [(0, 3)], None]
    return steps, valid


def _pool_shape(cfg):
    return (cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads,
            cfg.resolved_head_dim)


def _run_jax(cfg, params, steps, mode):
    pol = JPolicy(mode=mode)
    prefill = jpm.make_paged_chunked_prefill(cfg, pol)
    decode = jpm.make_paged_decode(cfg, pol)
    zeros = np.zeros(_pool_shape(cfg), np.float32)
    kv = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    out = []
    for kind, args in steps:
        fn = prefill if kind == "prefill" else decode
        logits, kv = fn(params, jnp.asarray(args[0]), kv,
                        *(jnp.asarray(a) for a in args[1:]))
        out.append(np.asarray(logits))
    return out, {n: np.asarray(a) for n, a in kv.items()}


def _run_port(cfg, model, steps, mode):
    pol = TPolicy(mode=mode)
    prefill = tpm.make_paged_chunked_prefill(cfg, pol)
    decode = tpm.make_paged_decode(cfg, pol)
    kv = {n: torch.zeros(_pool_shape(cfg)) for n in ("k", "v")}
    out = []
    for kind, args in steps:
        fn = prefill if kind == "prefill" else decode
        logits, kv = fn(model, torch.from_numpy(args[0]), kv,
                        *(torch.from_numpy(a) for a in args[1:]))
        out.append(logits.numpy())
    return out, {n: a.numpy() for n, a in kv.items()}


@pytest.mark.parametrize("mode", MODES)
def test_steps_match_reference(mode):
    cfg, params, model = _weights()
    steps, valid = _schedule(cfg)
    (got, got_kv) = _run_port(cfg, model, steps, mode)
    (want, want_kv) = _run_jax(cfg, params, steps, mode)
    for g, w, rows in zip(got, want, valid):
        if rows is None:
            np.testing.assert_allclose(g, w, **STEP_TOL)
        else:
            for r, n in rows:
                np.testing.assert_allclose(g[r, :n], w[r, :n], **STEP_TOL)
    for name in ("k", "v"):    # every page, the trash page included
        np.testing.assert_allclose(got_kv[name], want_kv[name], **STEP_TOL)


def test_last_writers():
    page_idx = torch.tensor([[3, 0, 0], [0, 5, 0]])
    offset = torch.tensor([[1, 0, 0], [0, 2, 0]])
    got = tpm.last_writers(page_idx, offset, page=8)
    assert got.tolist() == [0, 5, 5, 5, 4, 5]


def test_trash_row_is_the_last_writers():
    """After chunk 2 the trash row holds the K of the last of its nine
    writers (row 1, slot 5: its token at position 5), as the reference's
    does, and not that of the first (row 0, slot 3: its token at
    position 9). At the exact policy layer 0's K of a token depends on
    the token and its position only, so a solo prefill of each token
    gives the value to expect."""
    cfg, params, model = _weights()
    steps, _ = _schedule(cfg)
    _, kv = _run_port(cfg, model, steps[:2], "exact")
    _, want = _run_jax(cfg, params, steps[:2], "exact")
    trash = kv["k"][0, 0, 0]
    np.testing.assert_allclose(trash, want["k"][0, 0, 0], **STEP_TOL)
    toks = steps[1][1][0]
    i32 = functools.partial(np.asarray, dtype=np.int32)

    def solo_k(row, start, page, slot):
        args = (toks[row:row + 1], i32([[7, 8, 9, 0]]), i32([start]),
                i32([CHUNK]), np.asarray([True]), i32([0]))
        _, kv_solo = _run_port(cfg, model, [("prefill", args)], "exact")
        return kv_solo["k"][0, page, slot]

    last = solo_k(1, 0, 8, 1)             # position 5: page 8, slot 1
    first = solo_k(0, 6, 9, 1)            # position 9: page 9, slot 1
    np.testing.assert_allclose(trash, last, **STEP_TOL)
    assert not np.allclose(trash, first, atol=1e-3)


def test_trash_row_sets_kv_scales_in_a_smoke_drain(monkeypatch):
    """Counts, over a smoke drain under int8, the (step, layer, pool)
    triples where the trash row holds the strict absmax of the gathered
    K or V view, so that it alone sets that tensor's quantization
    scale. It does, in some of them."""
    cfg, _, model = _weights()
    hits = []
    block = tpm._paged_attn_block

    def spy(lp, x, cfg_, policy, positions, ckl, cvl, block_tables,
            page_idx, offset, writer, **kw):
        out = block(lp, x, cfg_, policy, positions, ckl, cvl, block_tables,
                    page_idx, offset, writer, **kw)
        real = block_tables != 0
        for pool in (ckl, cvl):
            others = pool[block_tables][real].abs().max()
            hits.append(bool(pool[0, 0].abs().max() > others))
        return out

    monkeypatch.setattr(tpm, "_paged_attn_block", spy)
    tkw, ekw = DRAIN
    eng = ServeEngine(cfg, params=model, policy=TPolicy(mode="int8"),
                      ecfg=EngineConfig(**ekw), device="cpu")
    eng.submit_trace(synth_trace(TrafficConfig(vocab_size=cfg.vocab_size,
                                               **tkw)))
    eng.drain()
    assert len(hits) > 0 and 0 < sum(hits) < len(hits)


# ---------------------------------------------------------------------------
# engine drains
# ---------------------------------------------------------------------------

# prompts spanning prefill chunks, with padding and idle lanes
DRAIN = (dict(n_requests=6, arrival_rate=2e5, prompt_len_min=3,
              prompt_len_max=20, gen_len_min=2, gen_len_max=8, seed=3),
         dict(page_size=8, n_pages=64, max_batch=3, max_pages_per_seq=8,
              prefill_chunk=8))


def _events(events):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


@pytest.mark.parametrize("mode", MODES)
def test_drain_matches_reference(mode):
    cfg, params, model = _weights()
    tkw, ekw = DRAIN
    jeng = JServeEngine(cfg, params=params, policy=JPolicy(mode=mode),
                        ecfg=JEngineConfig(observability="trace", **ekw))
    jeng.submit_trace(jsynth_trace(JTrafficConfig(
        vocab_size=cfg.vocab_size, **tkw)))
    jeng.drain()
    eng = ServeEngine(cfg, params=model, policy=TPolicy(mode=mode),
                      ecfg=EngineConfig(observability="trace", **ekw),
                      device="cpu")
    eng.submit_trace(synth_trace(TrafficConfig(vocab_size=cfg.vocab_size,
                                               **tkw)))
    reset_launch_counts()
    eng.drain()
    assert launch_counts["sc_matmul"] == 0      # CPU: the plain version
    want, got = jeng.results(), eng.results()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")
    assert eng.metrics() == jeng.metrics()
    assert _events(eng.events) == _events(jeng.events)


def test_fused_core_with_a_quantized_policy_raises_as_the_reference():
    cfg, params, model = _weights()
    with pytest.raises(ValueError) as want:
        JServeEngine(cfg, params=params, policy=JPolicy(mode="int8"),
                     ecfg=JEngineConfig(attn_impl="fused"))
    with pytest.raises(ValueError) as got:
        ServeEngine(cfg, params=model, policy=TPolicy(mode="int8"),
                    ecfg=EngineConfig(attn_impl="fused"), device="cpu")
    assert str(got.value) == str(want.value)


def test_analog_noise_policy_is_refused():
    cfg, _, model = _weights()
    with pytest.raises(NotImplementedError, match="sigma_analog"):
        make_backend(cfg, EngineConfig(),
                     TPolicy(mode="artemis", sigma_analog=0.01), model,
                     obs=None, clock=None)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _strip_wall(lines):
    return [re.sub(r"[\d.]+ tok/s wall", "", ln) for ln in lines]


@pytest.mark.parametrize("mode", MODES)
def test_cli_policy_prints_the_reference_summary(mode, monkeypatch, capsys):
    flags = ["--mode", "engine", "--policy", mode, "--n-requests", "4",
             "--prompt-len", "12", "--gen-len", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jcli.main()
    want = capsys.readouterr().out.strip().splitlines()
    tcli.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == 2 and _strip_wall(got) == _strip_wall(want)
