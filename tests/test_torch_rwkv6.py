"""The port's rwkv6 family against the JAX package's.

Weights come from the reference's `model.init` through the numpy
bridge, inputs from a numpy seed, everything at float32 on the CPU:
the LayerNorm, the token shift, the chunked wkv (chunks that pad and
that do not, a nonzero initial state), the layer with and without a
state, and `apply` without a cache, with one (a whole prompt, then
token by token) and under the quantized policies, each within
rtol=atol=1e-5 of the reference (XLA's CPU ops and torch's round the
same f32 math in other orders). The quantized layers are held on the
reference's own hidden states, layer by layer, as
tests/test_torch_moe.py does for the MoE family.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = dataclasses.replace(configs.get_config("rwkv6_3b", smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# the reference layer jitted once per (config, policy) and shape
_jlayer = jax.jit(JR.rwkv6_layer, static_argnums=(2, 3))


def test_layernorm_uses_the_population_variance():
    rng = np.random.default_rng(0)
    d = 48
    x = _rand(rng, 3, 5, d, scale=3.0) + 2.0
    scale, bias = _rand(rng, d), _rand(rng, d)
    p = TR.LayerNorm(d, "cpu")
    with torch.no_grad():
        p.scale.copy_(_t(scale))
        p.bias.copy_(_t(bias))
    want = JR.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x))
    _close(TR.layernorm(p, _t(x)), want)


def test_shift():
    rng = np.random.default_rng(1)
    x, prev = _rand(rng, 2, 4, 6), _rand(rng, 2, 6)
    _close(TR._shift(_t(x), _t(prev)), JR._shift(jnp.asarray(x),
                                                jnp.asarray(prev)))
    _close(TR._shift(_t(x), None), JR._shift(jnp.asarray(x), None))


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8), (5, 16), (7, 1)],
                         ids=["whole", "padded", "short", "single"])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_chunked(s, chunk, with_state):
    rng = np.random.default_rng(s * 31 + chunk)
    b, h, n = 2, 3, 8
    r, k, v = (_rand(rng, b, s, h, n) for _ in range(3))
    log_w = -np.exp(_rand(rng, b, s, h, n, scale=0.5)).astype(np.float32)
    u = _rand(rng, h, n)
    s0 = (_rand(rng, b, h, n, n) if with_state
          else np.zeros((b, h, n, n), np.float32))
    args = (r, k, v, log_w, u, s0)
    want_o, want_s = JR._wkv_chunked(*map(jnp.asarray, args), chunk)
    got_o, got_s = TR._wkv_chunked(*map(_t, args), chunk)
    _close(got_o, want_o)
    _close(got_s, want_s)


@pytest.mark.parametrize("with_state", [False, True])
def test_layer(with_state):
    cfg, params, model = _weights()
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 11, cfg.d_model)
    lp = jax.tree.map(lambda a: a[1], params["layers"])
    st = None
    if with_state:
        h, n = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        st = {"x_tm": _rand(rng, 2, cfg.d_model),
              "x_cm": _rand(rng, 2, cfg.d_model),
              "wkv": _rand(rng, 2, h, n, n, scale=0.3)}
    want, want_st = _jlayer(
        lp, jnp.asarray(x), cfg, JPolicy(),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, got_st = TR.rwkv6_layer(
        model.layers[1], _t(x), cfg, TPolicy(),
        None if st is None else {k: _t(v) for k, v in st.items()})
    _close(got, want)
    assert (got_st is None) == (want_st is None)
    if st is not None:
        for key in st:
            _close(got_st[key], want_st[key])


def test_init_cache_matches_reference():
    cfg, _, _ = _weights()
    want = jmodel.init_cache(cfg, 3, 40, dtype=jnp.bfloat16)
    got = tmodel.init_cache(cfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    for key, leaf in want["layers"].items():
        assert tuple(got["layers"][key].shape) == leaf.shape
        assert got["layers"][key].dtype == torch.float32   # always f32
        assert not got["layers"][key].any()
    assert got["index"] == 0


def test_apply_without_cache():
    cfg, params, model = _weights()
    toks = _tokens(cfg, 3, 2, 21)
    want, aux, _ = jmodel.apply(params, cfg, {"tokens": jnp.asarray(toks)},
                                remat=False)
    got, taux, cache = tmodel.apply(model, cfg, {"tokens": _t(toks)})
    _close(got, want)
    assert cache is None and float(taux) == float(aux) == 0.0


def test_apply_prompt_then_token_by_token():
    """A whole prompt (chunked wkv over 2 chunks, one padded), then one
    token a step: logits and every state leaf within 1e-5."""
    cfg, params, model = _weights()
    toks = _tokens(cfg, 4, 2, 27)
    jc = jmodel.init_cache(cfg, 2, 27)
    tc = tmodel.init_cache(cfg, 2, 27, device="cpu")
    for lo, hi in [(0, 20)] + [(t, t + 1) for t in range(20, 27)]:
        want, _, jc = jmodel.apply(params, cfg,
                                   {"tokens": jnp.asarray(toks[:, lo:hi])},
                                   cache=jc, remat=False)
        got, _, tc = tmodel.apply(model, cfg, {"tokens": _t(toks[:, lo:hi])},
                                  cache=tc)
        _close(got, want)
        assert tc["index"] == int(jc["index"]) == hi
    for key in ("x_tm", "x_cm", "wkv"):
        _close(tc["layers"][key], jc["layers"][key])


def _reference_hidden(cfg, params, toks):
    """The reference's input to each layer for `toks`."""
    x = jnp.asarray(params["embed"])[jnp.asarray(toks)].astype(jnp.float32)
    x = JR.layernorm(params["ln0"], x)
    hidden = []
    for i in range(cfg.n_layers):
        hidden.append(np.asarray(x))
        lp = jax.tree.map(lambda a, i=i: a[i], params["layers"])
        x, _ = _jlayer(lp, x, cfg, JPolicy())
    return hidden


@pytest.mark.parametrize("mode", ["int8", "artemis_mxu", "artemis"])
def test_quantized_layers_on_the_reference_hidden_states(mode):
    """Each layer under a quantized policy, fed the reference's own
    hidden state, at a prompt and at a single token with a state: the
    nine projections quantized as the reference quantizes them."""
    cfg, params, model = _weights()
    toks = _tokens(cfg, 5, 2, 9)
    rng = np.random.default_rng(6)
    h, n = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    for i, x in enumerate(_reference_hidden(cfg, params, toks)):
        lp = jax.tree.map(lambda a, i=i: a[i], params["layers"])
        st = {"x_tm": _rand(rng, 2, cfg.d_model),
              "x_cm": _rand(rng, 2, cfg.d_model),
              "wkv": _rand(rng, 2, h, n, n, scale=0.3)}
        for xs, state in ((x, None), (x[:, -1:], st)):
            want, want_st = _jlayer(
                lp, jnp.asarray(xs), cfg, JPolicy(mode=mode),
                None if state is None else
                {k: jnp.asarray(v) for k, v in state.items()})
            got, got_st = TR.rwkv6_layer(
                model.layers[i], _t(xs), cfg, TPolicy(mode=mode),
                None if state is None else
                {k: _t(v) for k, v in state.items()})
            _close(got, want)
            if state is not None:
                _close(got_st["wkv"], want_st["wkv"])
