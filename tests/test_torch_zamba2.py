"""The port's zamba2 family (Mamba2 backbone + shared attention block)
against the JAX package's.

Weights come from the reference's `model.init` through the numpy
bridge, inputs from a numpy seed, at float32 on the CPU, within
rtol=atol=1e-5: the chunked SSD (chunks that pad and that do not, a
nonzero initial state), the causal conv with and without its tail, the
Mamba2 layer with and without a state. `apply`'s logits and cache,
five layers deep (f32 sums in another order, and an SSD state summed
over 46 tokens: up to 2.6e-5 apart here), are held at the repo's
step-logit bar of 1e-4, as the dense and MoE logits are. Under the
quantized policies the Mamba2 layers are held on the reference's own
hidden states, and the shared block's attention and FFN on the
reference's own normed inputs, against the reference op by op (a norm
a last bit apart, or XLA's fusions in a jitted forward, can move an
int8 value or an artemis readout level).

The attention ring (smoke `attn_window` 32) is held path for path: a
prompt longer than the ring (attended in-sequence, its last 32 tokens
kept in sequence order) and then decode, against the reference's same
path; a shorter prompt decoded past the wrap, against the reference.
The static shared-block core follows `zamba2.shared_attn_impl`: the
flash kernel (its plain version here) where the keys sit where the
kernel derives them, the gather core elsewhere; both branches are
pinned.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import zamba2 as JZ  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import zamba2 as TZ  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
INT32_MAX = np.iinfo(np.int32).max

_jmamba = jax.jit(JM2.mamba2_layer, static_argnums=(2, 3))
_jshared = jax.jit(JZ._shared_block, static_argnums=(2, 3))
_japply = jax.jit(jmodel.apply, static_argnums=(1,),
                  static_argnames=("policy", "remat"))


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = dataclasses.replace(configs.get_config("zamba2_7b", smoke=True),
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


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8), (5, 16), (7, 1)],
                         ids=["whole", "padded", "short", "single"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(s, chunk, with_state):
    rng = np.random.default_rng(s * 17 + chunk)
    b, h, p, n = 2, 3, 8, 5
    xbar = _rand(rng, b, s, h, p)
    bmat, cmat = _rand(rng, b, s, n), _rand(rng, b, s, n)
    log_a = -np.exp(_rand(rng, b, s, h, scale=0.5)).astype(np.float32)
    s0 = (_rand(rng, b, h, n, p) if with_state
          else np.zeros((b, h, n, p), np.float32))
    args = (xbar, bmat, cmat, log_a, s0)
    want_y, want_s = JM2._ssd_chunked(*map(jnp.asarray, args), chunk)
    got_y, got_s = TM2._ssd_chunked(*map(_t, args), chunk)
    _close(got_y, want_y)
    _close(got_s, want_s)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv(with_tail):
    rng = np.random.default_rng(3)
    x, w, b = _rand(rng, 2, 6, 10), _rand(rng, 4, 10), _rand(rng, 10)
    tail = _rand(rng, 2, 3, 10) if with_tail else None
    want, want_tail = JM2._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if tail is None else jnp.asarray(tail))
    got, got_tail = TM2._causal_conv(_t(x), _t(w), _t(b),
                                     None if tail is None else _t(tail))
    _close(got, want)
    _close(got_tail, want_tail)


def _mamba_state(cfg, rng, b):
    return {"ssd": _rand(rng, b, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_head_dim, scale=0.3),
            "conv": _rand(rng, b, cfg.conv_width - 1,
                          cfg.d_inner + 2 * cfg.ssm_state)}


def _mamba_both(params, model, i, x, state, mode="exact"):
    cfg = model.cfg
    want = _jmamba(_layer(params, i), jnp.asarray(x), cfg, JPolicy(mode=mode),
                   None if state is None else
                   {k: jnp.asarray(v) for k, v in state.items()})
    got = TM2.mamba2_layer(model.layers[i], _t(x), cfg, TPolicy(mode=mode),
                           None if state is None else
                           {k: _t(v) for k, v in state.items()})
    return got, want


@pytest.mark.parametrize("s", [11, 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_layer(s, with_state):
    cfg, params, model = _weights()
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, s, cfg.d_model)
    state = _mamba_state(cfg, rng, 2) if with_state else None
    (got, got_st), (want, want_st) = _mamba_both(params, model, 1, x, state)
    _close(got, want)
    if with_state:
        for key in state:
            _close(got_st[key], want_st[key])
    else:
        assert got_st is None and want_st is None


def test_init_cache_matches_reference():
    """The ring in the cache dtype with positions at int32 max (a zeroed
    cache is not pristine); the Mamba states f32."""
    cfg, _, _ = _weights()
    want = jmodel.init_cache(cfg, 3, 40, dtype=jnp.bfloat16)
    got = tmodel.init_cache(cfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    for key in ("ssd", "conv"):
        assert tuple(got["mamba"][key].shape) == want["mamba"][key].shape
        assert got["mamba"][key].dtype == torch.float32
    for key in ("attn_k", "attn_v"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.bfloat16
    assert tuple(got["attn_pos"].shape) == want["attn_pos"].shape == (3, 32)
    assert (got["attn_pos"] == INT32_MAX).all()
    assert got["index"] == 0


def test_apply_without_cache():
    cfg, params, model = _weights()
    toks = _tokens(cfg, 5, 2, 37)       # longer than the window
    want, aux, _ = _japply(params, cfg, {"tokens": jnp.asarray(toks)},
                           remat=False)
    got, taux, cache = tmodel.apply(model, cfg, {"tokens": _t(toks)})
    _close(got, want, LOGIT_TOL)
    assert cache is None and float(taux) == float(aux) == 0.0


def _run_both(toks, max_len, steps, attn_impl=None):
    """Prefill then decode `steps` ((lo, hi) token spans) through the
    reference and the port on fresh caches of `max_len`: every step's
    logits and the final cache within 1e-4, the ring positions equal."""
    cfg, params, model = _weights()
    jc = jmodel.init_cache(cfg, toks.shape[0], max_len, dtype=jnp.float32)
    tc = tmodel.init_cache(cfg, toks.shape[0], max_len, dtype=torch.float32,
                           device="cpu")
    for lo, hi in steps:
        want, _, jc = _japply(params, cfg,
                              {"tokens": jnp.asarray(toks[:, lo:hi])},
                              cache=jc, remat=False)
        got, _, tc = tmodel.apply(model, cfg, {"tokens": _t(toks[:, lo:hi])},
                                  cache=tc, attn_impl=attn_impl)
        _close(got, want, LOGIT_TOL)
        assert tc["index"] == int(jc["index"]) == hi
    np.testing.assert_array_equal(tc["attn_pos"].numpy(),
                                  np.asarray(jc["attn_pos"]))
    for key in ("attn_k", "attn_v"):
        _close(tc[key], jc[key], LOGIT_TOL)
    for key in ("ssd", "conv"):
        _close(tc["mamba"][key], jc["mamba"][key], LOGIT_TOL)
    return tc


@pytest.mark.parametrize("attn_impl", [None, "gather"])
def test_apply_prompt_then_token_by_token(attn_impl):
    """No wrap: a ring of 28 holds a prompt of 20 and 8 decodes."""
    toks = _tokens(_weights()[0], 6, 2, 28)
    _run_both(toks, 28, [(0, 20)] + [(t, t + 1) for t in range(20, 28)],
              attn_impl)


def test_ring_after_a_prompt_longer_than_the_window():
    """A prompt of 40 over a ring of 32 attends in-sequence and leaves
    its last 32 tokens in sequence order (slot j at position 8 + j);
    decode then writes at index % 32 (slots 8..13, whose keys 16..21
    were inside the window), the reference's own path."""
    toks = _tokens(_weights()[0], 7, 2, 46)
    tc = _run_both(toks, 48, [(0, 40)] + [(t, t + 1) for t in range(40, 46)])
    pos = tc["attn_pos"][0].tolist()
    assert pos == (list(range(8, 16)) + list(range(40, 46))
                   + list(range(22, 40)))


def test_decode_past_the_wrap(monkeypatch):
    """A prompt of 24 decoded to 44 over a ring of 32: the ring wraps at
    index 32 and the gather core masks by `attn_pos`. The static path
    runs each core where `shared_attn_impl` sends it: the prompt and
    the decodes at index 24..31 the flash core, those after the wrap
    the gather core."""
    cores = []
    flash = TL._flash_core

    def spy(*args, **kwargs):
        cores.append(args[0].shape[1])
        return flash(*args, **kwargs)

    monkeypatch.setattr(TL, "_flash_core", spy)
    cfg = _weights()[0]
    toks = _tokens(cfg, 8, 2, 44)
    tc = _run_both(toks, 48, [(0, 24)] + [(t, t + 1) for t in range(24, 44)])
    assert sorted(tc["attn_pos"][1].tolist()) == list(range(12, 44))
    n_inv = TZ.n_invocations(cfg)
    assert cores == [24] * n_inv + [1] * (8 * n_inv)


# ---------------------------------------------------------------------------
# the shared block's attention core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,want", [
    (dict(cached=False, index=0, s=40, sc=0), "flash"),
    (dict(cached=True, index=0, s=40, sc=32), "flash"),      # in-sequence
    (dict(cached=True, index=0, s=20, sc=32), "flash"),      # ring fits
    (dict(cached=True, index=31, s=1, sc=32), "flash"),      # last slot
    (dict(cached=True, index=32, s=1, sc=32), "gather"),     # wrapped
    (dict(cached=True, index=20, s=13, sc=32), "gather"),    # would wrap
    (dict(cached=True, index=torch.zeros(2, dtype=torch.int32), s=1,
          sc=32), "gather"),                                 # per lane
])
def test_shared_attn_impl_rule(case, want):
    policy = TPolicy()
    assert TZ.shared_attn_impl(None, policy, explicit_positions=False,
                               **case) == want
    assert TZ.shared_attn_impl("gather", policy, explicit_positions=False,
                               **case) == "gather"
    assert TZ.shared_attn_impl(None, TPolicy(mode="int8"),
                               explicit_positions=False, **case) == "gather"
    assert TZ.shared_attn_impl(None, policy, explicit_positions=True,
                               **case) == "gather"
    if want == "gather":
        with pytest.raises(ValueError, match="keys where the kernel"):
            TZ.shared_attn_impl("flash", policy, explicit_positions=False,
                                **case)


# ---------------------------------------------------------------------------
# quantized layers on the reference's hidden states
# ---------------------------------------------------------------------------


def _reference_inputs(cfg, params, toks):
    """(kind, index, input) of each Mamba2 layer and shared-block
    invocation of the reference's forward of `toks`."""
    x = jnp.asarray(params["embed"])[jnp.asarray(toks)].astype(jnp.float32)
    s = toks.shape[1]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None],
                                 toks.shape)
    out = []
    period = cfg.shared_attn_period
    n_inv = JZ.n_invocations(cfg)
    for i in range(cfg.n_layers):
        out.append(("mamba", i, np.asarray(x)))
        y, _ = _jmamba(_layer(params, i), x, cfg, JPolicy(), None)
        x = x + y
        if (i + 1) % period == 0 and (i + 1) // period <= n_inv:
            out.append(("shared", i, np.asarray(x)))
            x, _ = _jshared(params["shared"], x, cfg, JPolicy(), positions,
                            None, None, 0)
    return out


@pytest.mark.parametrize("mode", ["int8", "artemis_mxu", "artemis"])
def test_quantized_layers_on_the_reference_hidden_states(mode):
    cfg, params, model = _weights()
    toks = _tokens(cfg, 9, 2, 10)
    positions = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    rng = np.random.default_rng(10)
    sp, tsp = params["shared"], model.shared
    jpol, tpol = JPolicy(mode=mode), TPolicy(mode=mode)
    for kind, i, x in _reference_inputs(cfg, params, toks):
        if kind == "mamba":
            state = _mamba_state(cfg, rng, 2)
            (got, got_st), (want, want_st) = _mamba_both(
                params, model, i, x[:, -1:], state, mode)
            _close(got_st["ssd"], want_st["ssd"])
            _close(got, want)
            (got, _), (want, _) = _mamba_both(params, model, i, x, None, mode)
            _close(got, want)
            continue
        xn = JL.rmsnorm(sp["ln1"], jnp.asarray(x), cfg.norm_eps)
        want, _ = JL.attention(
            sp["attn"], xn, JZ._dims(cfg), positions=jnp.asarray(positions),
            policy=jpol, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            window=cfg.attn_window, norm_eps=cfg.norm_eps)
        got, _ = TL.attention(
            tsp.attn, _t(xn), TZ._dims(cfg), positions=_t(positions),
            policy=tpol, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            window=cfg.attn_window, norm_eps=cfg.norm_eps,
            attn_impl="gather")
        _close(got, want)
        fn_in = JL.rmsnorm(sp["ln2"], jnp.asarray(x) + want, cfg.norm_eps)
        _close(TL.ffn(tsp.ffn, _t(fn_in), cfg.act, cfg.glu, tpol),
               JL.ffn(sp["ffn"], fn_in, cfg.act, cfg.glu, jpol))
