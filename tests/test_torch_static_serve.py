"""The port's static serve path (`--mode static`: dense-cache prefill
and lockstep greedy decode) against the JAX package's.

Weights come from the reference's `model.init` through the numpy
bridge, at float32 on the CPU, where the flash-attention wrapper runs
its plain version:

- `layers.attention` within rtol=atol=1e-5, with and without a cache,
  through both attention cores and with a sliding window;
- `transformer.apply` logits within 1e-4 and the written cache within
  1e-5; `init_cache` equal;
- the prefill and decode steps' logits within 1e-4 (XLA's CPU dot and
  torch's CPU GEMM sum in other orders);
- prefill-then-decode greedy loops on identical numpy tokens
  token-identical under every arithmetic policy;
- `make_paged_prefill` logits and pool pages within 1e-4;
- the CLI's `--mode static` line equal to the reference CLI's once the
  wall numbers are stripped;
- the refusals (the flash core with a quantized policy or with
  explicit positions).
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
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import paged_model as jpm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serve import make_paged_prefill  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
POLICIES = ["exact", "int8", "artemis_mxu", "artemis"]


@functools.lru_cache(maxsize=None)
def _weights(attn_window: int = 0):
    cfg = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                              compute_dtype="float32",
                              attn_window=attn_window)
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers.attention
# ---------------------------------------------------------------------------

# (S, Smax, cache_index): no cache; prefill into a longer cache; a
# decode step; a prefill as long as the cache (the reference's
# in-sequence ring branch)
ATTN_CASES = {"no_cache": (6, None, 0), "prefill": (6, 10, 0),
              "decode": (1, 10, 7), "ring": (6, 6, 0)}


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("impl", ["flash", "gather"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_layer_matches_reference(case, impl, window):
    cfg, params, model = _weights()
    s, smax, index = ATTN_CASES[case]
    b, kvh, hd = 2, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(index + np.arange(s, dtype=np.int32),
                                (b, s)).copy()
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    kw = dict(qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
              window=window, norm_eps=cfg.norm_eps)
    jcache = tcache = None
    if smax is not None:
        ck = np.zeros((b, smax, kvh, hd), np.float32)
        cv = np.zeros_like(ck)
        ck[:, :index] = rng.standard_normal(ck[:, :index].shape)
        cv[:, :index] = rng.standard_normal(cv[:, :index].shape)
        jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
        tcache = {"k": _t(ck), "v": _t(cv)}
    want, want_kv = JL.attention(
        jp, jnp.asarray(x), JL.AttnDims(cfg.n_heads, kvh, hd),
        positions=jnp.asarray(positions), policy=JPolicy(), cache=jcache,
        cache_index=index, **kw)
    reset_launch_counts()
    got, got_kv = TL.attention(
        model.layers[0].attn, _t(x), TL.AttnDims(cfg.n_heads, kvh, hd),
        positions=_t(positions), policy=TPolicy(), cache=tcache,
        cache_index=index, attn_impl=impl, **kw)
    assert not launch_counts                      # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    if smax is not None:
        assert got_kv is tcache                   # written in place
        for name in ("k", "v"):
            np.testing.assert_allclose(got_kv[name].numpy(),
                                       np.asarray(want_kv[name]),
                                       **LAYER_TOL)


def test_flash_and_gather_cores_agree_under_a_window_config():
    """The window comes from the config (`dataclasses.replace(cfg,
    attn_window=...)`) through a whole prefill and two decode steps."""
    cfg, _, model = _weights(attn_window=3)
    toks = _t(_tokens(cfg, 4, 2, 7))
    out = {}
    for impl in ("flash", "gather"):
        cache = ttransformer.init_cache(cfg, 2, 9, torch.float32,
                                        device="cpu")
        logits = []
        lg, _, cache = ttransformer.apply(model, cfg, {"tokens": toks},
                                          cache=cache, attn_impl=impl)
        logits.append(lg)
        for i in range(2):
            lg, _, cache = ttransformer.apply(
                model, cfg, {"tokens": toks[:, i:i + 1]}, cache=cache,
                attn_impl=impl)
            logits.append(lg)
        out[impl] = logits
    for a, b in zip(out["flash"], out["gather"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LAYER_TOL)


# ---------------------------------------------------------------------------
# transformer.apply / init_cache
# ---------------------------------------------------------------------------


def test_init_cache_matches_reference():
    cfg, _, _ = _weights()
    want = jtransformer.init_cache(cfg, 3, 11, jnp.float32)
    got = tmodel.init_cache(cfg, 3, 11, torch.float32, device="cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32
        assert not got[name].any()
    assert got["index"] == int(want["index"]) == 0


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("impl", ["flash", "gather"])
@pytest.mark.parametrize("cached", [False, True])
def test_apply_matches_reference(cached, impl, window):
    cfg, params, model = _weights(window)
    toks = _tokens(cfg, 5, 2, 6)
    jcache = tcache = None
    if cached:
        jcache = jtransformer.init_cache(cfg, 2, 10, jnp.float32)
        tcache = ttransformer.init_cache(cfg, 2, 10, torch.float32,
                                         device="cpu")
    want, want_aux, want_cache = jtransformer.apply(
        params, cfg, {"tokens": jnp.asarray(toks)}, cache=jcache,
        remat=False)
    got, got_aux, got_cache = tmodel.apply(
        model, cfg, {"tokens": _t(toks)}, cache=tcache, attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    assert float(got_aux) == float(want_aux) == 0.0
    if cached:
        assert got_cache["index"] == int(want_cache["index"]) == 6
        for name in ("k", "v"):
            np.testing.assert_allclose(got_cache[name].numpy(),
                                       np.asarray(want_cache[name]),
                                       **LAYER_TOL)


def test_apply_with_explicit_positions_gather_matches_reference():
    cfg, params, model = _weights()
    toks = _tokens(cfg, 6, 2, 5)
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 2, 4, 6, 8]], np.int32)
    want, _, _ = jtransformer.apply(
        params, cfg, {"tokens": jnp.asarray(toks),
                      "positions": jnp.asarray(pos)}, remat=False)
    got, _, _ = tmodel.apply(model, cfg, {"tokens": _t(toks),
                                          "positions": _t(pos)},
                             attn_impl="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


# ---------------------------------------------------------------------------
# prefill and decode steps, greedy loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["flash", "gather"])
def test_prefill_and_decode_steps_match_reference(impl):
    cfg, params, model = _weights()
    b, s, gen = 2, 7, 3
    toks = _tokens(cfg, 7, b, s)
    dtoks = _tokens(cfg, 8, b, gen)
    jpre = jax.jit(jsteps.make_prefill_step(cfg, JPolicy()))
    jdec = jax.jit(jsteps.make_decode_step(cfg, JPolicy()))
    tpre = tsteps.make_prefill_step(cfg, TPolicy(), impl)
    tdec = tsteps.make_decode_step(cfg, TPolicy(), impl)
    jcache = jmodel.init_cache(cfg, b, s + gen, dtype=jnp.float32)
    tcache = tmodel.init_cache(cfg, b, s + gen, torch.float32, device="cpu")
    want, jcache = jpre(params, {"tokens": jnp.asarray(toks)}, jcache)
    got, tcache = tpre(model, {"tokens": _t(toks)}, tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    for i in range(gen):
        step = dtoks[:, i:i + 1]
        want, jcache = jdec(params, jnp.asarray(step), jcache)
        got, tcache = tdec(model, _t(step), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STEP_TOL, err_msg=f"decode step {i}")
    assert tcache["index"] == int(jcache["index"]) == s + gen


def _greedy_loop(prefill, decode, sample, model, toks, cache, gen, wrap):
    logits, cache = prefill(model, {"tokens": wrap(toks)}, cache)
    nxt = sample(logits)
    out = []
    for _ in range(gen):
        logits, cache = decode(model, nxt[:, None], cache)
        nxt = sample(logits)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("mode", POLICIES)
def test_greedy_loop_token_identical_to_reference(mode):
    """serve()'s loop on identical numpy prompts, float32: the tokens
    of the port (flash core under exact, gather otherwise) equal the
    reference's."""
    cfg, params, model = _weights()
    b, s, gen = 3, 9, 6
    toks = _tokens(cfg, 9, b, s)
    jpol, tpol = JPolicy(mode=mode), TPolicy(mode=mode)
    want = _greedy_loop(
        jax.jit(jsteps.make_prefill_step(cfg, jpol)),
        jax.jit(jsteps.make_decode_step(cfg, jpol)), jsteps.greedy_sample,
        params, toks, jmodel.init_cache(cfg, b, s + gen, dtype=jnp.float32),
        gen, jnp.asarray)
    reset_launch_counts()
    got = _greedy_loop(
        tsteps.make_prefill_step(cfg, tpol),
        tsteps.make_decode_step(cfg, tpol), tsteps.greedy_sample, model,
        toks, tmodel.init_cache(cfg, b, s + gen, torch.float32,
                                device="cpu"), gen, _t)
    assert not launch_counts                      # CPU: the plain versions
    assert got.dtype == np.int32 and got.shape == (b, gen)
    np.testing.assert_array_equal(got, want)


def test_serve_static_on_cpu():
    out = tcli.serve(device="cpu", batch=2, prompt_len=5, gen_len=3)
    gen = out["generated"]
    assert tuple(gen.shape) == (2, 3) and gen.dtype == torch.int32
    assert out["cache_index"] == 5 + 3
    cfg = tconfigs.get_config("qwen3_8b", smoke=True)
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.padded_vocab
    # prompts come from a torch generator seeded seed + 1
    g = torch.Generator()
    g.manual_seed(1)
    want = torch.randint(2, cfg.vocab_size, (2, 5), generator=g,
                         dtype=torch.int32)
    assert torch.equal(out["prompt"], want)


def test_serve_static_runs_the_models_own_config():
    """Given a model, serve() runs under the config the model was built
    with (here f32 weights carried over from the reference) and reads
    no `arch`: its tokens equal the reference's greedy loop on the same
    prompt."""
    cfg, params, model = _weights()
    b, s, gen = 2, 5, 3
    out = tcli.serve(arch="not_a_config", params=model, device="cpu",
                     batch=b, prompt_len=s, gen_len=gen)
    jpol = JPolicy()
    want = _greedy_loop(
        jax.jit(jsteps.make_prefill_step(cfg, jpol)),
        jax.jit(jsteps.make_decode_step(cfg, jpol)), jsteps.greedy_sample,
        params, out["prompt"].numpy(),
        jmodel.init_cache(cfg, b, s + gen, dtype=jnp.float32), gen,
        jnp.asarray)
    np.testing.assert_array_equal(out["generated"].numpy(), want)


# ---------------------------------------------------------------------------
# make_paged_prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_make_paged_prefill_matches_reference(mode):
    cfg, params, model = _weights()
    page, n_pages, s_pad = 4, 8, 8
    toks = _tokens(cfg, 10, 1, s_pad)
    page_ids = np.asarray([5, 2], np.int32)
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    rng = np.random.default_rng(11)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jfn = jax.jit(jpm.make_paged_prefill(cfg, JPolicy(mode=mode)))
    want, want_kv = jfn(params, jnp.asarray(toks),
                        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                        jnp.asarray(page_ids))
    kv = {"k": _t(k0), "v": _t(v0)}
    got, got_kv = make_paged_prefill(cfg, TPolicy(mode=mode))(
        model, _t(toks), kv, _t(page_ids))
    assert got_kv is kv
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_kv[name].numpy(),
                                   np.asarray(want_kv[name]), **STEP_TOL)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _strip_wall(line):
    return re.sub(r"prefill \d+ms \| decode [\d.]+ tok/s", "", line)


@pytest.mark.parametrize("flags", [[], ["--policy", "int8"]],
                         ids=["exact", "int8"])
def test_cli_static_prints_the_reference_line(flags, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--mode", "static", *flags])
    jcli.main()
    want = capsys.readouterr().out.strip().splitlines()
    tcli.main(["--mode", "static", *flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 1
    assert re.fullmatch(r"prefill \d+ms \| decode [\d.]+ tok/s \| "
                        r"generated shape \(4, 16\)", got[0]), got
    assert _strip_wall(got[0]) == _strip_wall(want[0])


def test_cli_defaults_to_static(capsys):
    tcli.main(["--device", "cpu", "--batch", "2", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "generated shape (2, 3)" in out


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "artemis_mxu", "artemis"])
def test_flash_with_a_quantized_policy_raises(mode):
    cfg, _, model = _weights()
    msg = (f"attn_impl='flash' computes exact fp32 attention and cannot "
           f"reproduce quantized policy mode {mode!r}; use "
           f"attn_impl='gather'")
    with pytest.raises(ValueError) as err:
        tsteps.make_prefill_step(cfg, TPolicy(mode=mode), "flash")
    assert str(err.value) == msg
    with pytest.raises(ValueError, match="cannot reproduce"):
        tmodel.apply(model, cfg, {"tokens": _t(_tokens(cfg, 0, 1, 3))},
                     policy=TPolicy(mode=mode), attn_impl="flash")


def test_flash_with_explicit_positions_raises():
    cfg, _, model = _weights()
    toks = _t(_tokens(cfg, 0, 1, 3))
    pos = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous positions"):
        tmodel.apply(model, cfg, {"tokens": toks, "positions": pos})
    with pytest.raises(ValueError, match="kv_positions"):
        x = torch.zeros((1, 3, cfg.d_model))
        TL.attention(model.layers[0].attn, x,
                     TL.AttnDims(cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim),
                     positions=pos, kv_positions=pos, attn_impl="flash")


def test_unknown_attn_impl_raises():
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        TL.resolve_attn_impl("fused", TPolicy())
