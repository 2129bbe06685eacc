"""Every architecture of `configs.ARCHS` in the port against the JAX
package, on the CPU: the port's counterpart of `tests/test_smoke_archs.py`.
Each arch at its smoke config with f32 compute, weights from the
reference's `model.init` through the numpy bridge (`bridge.
params_from_numpy`), inputs from numpy (`tests/test_smoke_archs.py`'s
shapes: batch 2, 16 tokens, the vlm prefix cut to 4 rows):

- the forward (`model.apply` without a cache): logits within 1e-4
  (rtol and atol: f32 sums in another order), the aux loss within 1e-4
  relative (the MoE load-balance loss; 0 elsewhere);
- one train step's objective and gradients (`launch.steps.
  loss_and_grads` against `jax.value_and_grad` of the reference's
  `lm_loss + aux`): the loss within 1e-5 relative, the aux as above,
  every gradient within 1e-4 of its leaf's max abs (as
  `tests/test_torch_train.py` holds the exact policy);
- a prefill of 15 tokens then a decode step of the 16th on a cache of
  24 slots: the prefill's and the decode's logits within 1e-4, every
  cache leaf after each: K/V within 1e-5, the recurrent states (rwkv6's
  and zamba2's Mamba2 layers) within the step bar of 1e-4, as
  `tests/test_torch_zamba2.py` holds them (a state sums every token of
  the prompt in another order: zamba2's SSD state measured 3.0e-5
  apart), zamba2's ring positions exactly, the cache index equal; and
  the decode's logits within 1e-4 of the port's own whole-sequence
  forward at the last position.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import frontend as jfrontend  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

B, S, PREFIX = 2, 16, 4
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = LOGITS_TOL   # the recurrent states (module docstring)
RECURRENT_STATES = ("layers/", "mamba/")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of a leaf's max abs


def test_every_arch_is_covered():
    assert tuple(configs.ARCHS) == tuple(jconfigs.ARCHS)
    assert len(configs.ARCHS) == 10


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference cfg, port cfg, reference params, their numpy tree)."""
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(configs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), jc)
    return jc, tc, params, jax.tree.map(np.asarray, params)


def _inputs(jc, seed, seq=S):
    """Numpy inputs: tokens of the config's shape, and the vlm prefix
    (the reference's synthetic one, cut to PREFIX rows)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jc.vocab_size, jfrontend.token_shape(
        jc, B, seq)).astype(np.int32)}
    if jc.modality == "vlm":
        out["prefix_embeds"] = np.asarray(jfrontend.synth_prefix_embeds(
            jax.random.PRNGKey(seed), jc, B))[:, :PREFIX]
    return out


def _j(inp):
    return {k: jnp.asarray(v) for k, v in inp.items()}


def _t(inp):
    return {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}


def _cache_leaves(cache, prefix=""):
    """(path, value) of every leaf of a nested cache dict."""
    for key in sorted(cache):
        value = cache[key]
        if isinstance(value, dict):
            yield from _cache_leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _assert_caches_close(got, want):
    got, want = dict(_cache_leaves(got)), dict(_cache_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if path == "index":
            assert int(g) == int(w)
            continue
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape, path
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            tol = (STATE_TOL if path.startswith(RECURRENT_STATES)
                   else CACHE_TOL)
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), **tol,
                                       err_msg=path)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_forward_matches_reference(arch):
    jc, tc, params, tree = _setup(arch)
    inp = _inputs(jc, 1)
    want, want_aux, _ = jmodel.apply(params, jc, _j(inp), remat=False)
    model = bridge.params_from_numpy(tree, tc, device="cpu")
    got, aux, cache = tmodel.apply(model, tc, _t(inp))
    assert cache is None
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-4, abs=1e-7)
    if tc.family == "moe":
        assert float(want_aux) > 0


def _leaf_errors(want, got) -> dict:
    """Per leaf (jax keystr): max |want - got| over max |want|."""
    w_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in w_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in g_leaves]
    out = {}
    for (path, w), (_, g) in zip(w_leaves, g_leaves):
        w = np.asarray(w, np.float64)
        out[jax.tree_util.keystr(path)] = (
            np.abs(w - np.asarray(g, np.float64)).max()
            / max(np.abs(w).max(), 1e-30))
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_train_step_matches_reference(arch):
    jc, tc, params, tree = _setup(arch)
    inp = _inputs(jc, 2)
    labels = np.random.default_rng(3).integers(
        0, jc.vocab_size, inp["tokens"].shape).astype(np.int32)

    def loss_fn(p):
        logits, aux, _ = jmodel.apply(p, jc, _j(inp))
        if jc.modality == "vlm":
            logits = logits[:, -S:]
        loss = jmodel.lm_loss(logits, jnp.asarray(labels))
        return loss + aux, (loss, aux)

    (_, (want_loss, want_aux)), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    model = bridge.params_from_numpy(tree, tc, device="cpu", train=True)
    loss, aux, grads = tsteps.loss_and_grads(
        model, tc, _t(dict(inp, labels=labels)))
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-4, abs=1e-7)
    errs = _leaf_errors(want_grads, bridge.named_to_numpy(grads.items()))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    jc, tc, params, tree = _setup(arch)
    inp = _inputs(jc, 4)
    max_len = S + 8 + (PREFIX if jc.modality == "vlm" else 0)
    head = dict(inp, tokens=inp["tokens"][:, :-1])
    last = {"tokens": inp["tokens"][:, -1:]}
    model = bridge.params_from_numpy(tree, tc, device="cpu")

    jcache = jmodel.init_cache(jc, B, max_len, dtype=jnp.float32)
    want, _, jcache = jmodel.apply(params, jc, _j(head), cache=jcache,
                                   remat=False)
    cache = tmodel.init_cache(tc, B, max_len, torch.float32, device="cpu")
    got, _, cache = tmodel.apply(model, tc, _t(head), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_caches_close(cache, jcache)

    want, _, jcache = jmodel.apply(params, jc, _j(last), cache=jcache,
                                   remat=False)
    got, _, cache = tmodel.apply(model, tc, _t(last), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_caches_close(cache, jcache)
    assert int(cache["index"]) == S + (PREFIX if jc.modality == "vlm" else 0)

    whole, _, _ = tmodel.apply(model, tc, _t(inp))
    np.testing.assert_allclose(got[:, 0].numpy(), whole[:, -1].numpy(),
                               **LOGITS_TOL)
