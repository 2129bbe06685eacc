"""The port's NSC LUTs and Eq. 5 softmax (`repro_torch.core.lut`,
`core.softmax`) and XLA's elementary functions in torch
(`repro_torch.xla_math`) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both:

- `xla_math` exp, log, log1p, tanh and the logistic equal `jnp`'s
  bit for bit over their ranges, where torch's own exp, log1p and tanh
  round apart on a share of the inputs and move an 8-bit LUT;
- `binned_apply` (linear and log bins, `out_bits` None and 8), every
  `lut_activation` kind, `lut_exp`, `lut_ln` and `artemis_softmax`
  equal the reference bit for bit (`"gelu"` is jax's tanh form);
- `lse_softmax` and `online_max_sum`'s sums add in torch's order, not
  XLA's, so they are held within rtol 2e-6 (a few ulps; every exp and
  log in them is XLA's); `online_max_sum`'s maxima are bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lut as jlut  # noqa: E402
from repro.core import softmax as jsoftmax  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch import xla_math  # noqa: E402
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core import softmax as tsoftmax  # noqa: E402

SUM_TOL = dict(rtol=2e-6, atol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,lo,hi", [
    ("exp", -100.0, 100.0), ("log", 1e-30, 1e30), ("log1p", -1.0, 5.0),
    ("tanh", -12.0, 12.0), ("logistic", -100.0, 100.0)])
def test_xla_math_equals_jax(name, lo, hi):
    rng = np.random.default_rng(0)
    if name == "log":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi), 1 << 16))
    else:
        x = rng.uniform(lo, hi, 1 << 16)
    x = x.astype(np.float32)
    jfn = {"exp": jnp.exp, "log": jnp.log, "log1p": jnp.log1p,
           "tanh": jnp.tanh, "logistic": jax.nn.sigmoid}[name]
    _equal(getattr(xla_math, name)(_t(x)), jax.jit(jfn)(jnp.asarray(x)))


@pytest.mark.parametrize("name,lo,hi,tfn", [
    ("exp", -100.0, 100.0, torch.exp), ("log1p", -1.0, 5.0, torch.log1p),
    ("tanh", -12.0, 12.0, torch.tanh)])
def test_torch_functions_round_apart_from_xla(name, lo, hi, tfn):
    """Why `xla_math` exists: torch's own functions round the last bit
    apart from XLA's on a share of the inputs, and that moves stored
    8-bit LUT values (gelu's tanh here) off the reference's."""
    x = np.random.default_rng(0).uniform(lo, hi, 1 << 16).astype(
        np.float32)
    jfn = getattr(jnp, name)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    assert (tfn(_t(x)).numpy() != want).mean() > 1e-3
    if name == "tanh":
        g = np.random.default_rng(1).standard_normal((8, 512)).astype(
            np.float32) * 3
        m = float(np.abs(g).max())

        def torch_gelu(v):
            return v * (0.5 * (1.0 + torch.tanh(tlut._SQRT_2_OVER_PI * (
                v + 0.044715 * (v * v * v)))))

        got = tlut.binned_apply(torch_gelu, _t(g), -m, m)
        assert not np.array_equal(got.numpy(), np.asarray(
            jlut.lut_activation(jnp.asarray(g), "gelu")))


FNS = [("exp", jnp.exp, xla_math.exp), ("log", jnp.log, xla_math.log),
       ("relu", jax.nn.relu, torch.relu)]


@pytest.mark.parametrize("out_bits", [8, None])
@pytest.mark.parametrize("log_bins", [False, True])
@pytest.mark.parametrize("name,jfn,tfn", FNS, ids=[f[0] for f in FNS])
def test_binned_apply_equals_reference(name, jfn, tfn, log_bins, out_bits):
    rng = np.random.default_rng(len(name) + 2 * log_bins)
    lo, hi = (0.5, 40.0) if log_bins or name == "log" else (-6.0, 3.0)
    x = rng.uniform(lo - 1.0, hi + 1.0, 3000).astype(np.float32)
    if name == "log":
        x = np.abs(x) + 0.25
    for n_in in (256, 33):
        want = jlut.binned_apply(jfn, jnp.asarray(x), lo, hi, n_in=n_in,
                                 out_bits=out_bits, log_bins=log_bins)
        got = tlut.binned_apply(tfn, _t(x), lo, hi, n_in=n_in,
                                out_bits=out_bits, log_bins=log_bins)
        _equal(got, want)


@pytest.mark.parametrize("out_bits", [8, None, 4])
@pytest.mark.parametrize("kind", ["relu", "gelu", "silu", "gelu_tanh"])
def test_lut_activation_equals_reference(kind, out_bits):
    for seed in range(3):
        x = (np.random.default_rng(seed).standard_normal((8, 512))
             * (1 + 2 * seed)).astype(np.float32)
        _equal(T.lut_activation(_t(x), kind, out_bits=out_bits),
               jlut.lut_activation(jnp.asarray(x), kind, out_bits=out_bits))


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; torch's default
    erf GELU parts from it by up to 0.045 on the LUT's grid."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    _equal(tlut.ACTIVATIONS["gelu"](_t(x)), jax.nn.gelu(jnp.asarray(x)))
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


@pytest.mark.parametrize("out_bits", [8, None])
def test_lut_exp_and_ln_equal_reference(out_bits):
    rng = np.random.default_rng(3)
    x = -np.abs(rng.standard_normal(5000) * 5).astype(np.float32)
    for lo in (-1.0, -7.3, -20.0):
        _equal(tlut.lut_exp(_t(x), lo, out_bits=out_bits),
               jlut.lut_exp(jnp.asarray(x), lo, out_bits=out_bits))
    y = (1 + np.abs(rng.standard_normal(5000)) * 30).astype(np.float32)
    for hi in (64.0, 1040.0, 5.5):
        _equal(tlut.lut_ln(_t(y), hi, out_bits=out_bits),
               jlut.lut_ln(jnp.asarray(y), hi, out_bits=out_bits))
    assert tlut.EXP_LUT_FLOOR == jlut.EXP_LUT_FLOOR


SOFTMAX_CASES = [((64, 64), -1, 4.0), ((8, 32, 1, 1040), -1, 2.0),
                 ((5, 17), 0, 6.0), ((3, 40, 7), 1, 1.0)]


@pytest.mark.parametrize("out_bits", [8, None])
@pytest.mark.parametrize("shape,axis,scale", SOFTMAX_CASES, ids=str)
def test_artemis_softmax_equals_reference(shape, axis, scale, out_bits):
    y = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    got = T.artemis_softmax(_t(y), axis=axis, out_bits=out_bits)
    _equal(got, jsoftmax.artemis_softmax(jnp.asarray(y), axis=axis,
                                         out_bits=out_bits))


def test_artemis_softmax_on_table5_input():
    """Table V's 64 x 64 scores from jax's own normal(PRNGKey(1)) * 4."""
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 64))) * 4
    _equal(T.artemis_softmax(_t(y), axis=-1, n_in=256, out_bits=8),
           jsoftmax.artemis_softmax(jnp.asarray(y), axis=-1, n_in=256,
                                    out_bits=8))


@pytest.mark.parametrize("shape,axis,scale", SOFTMAX_CASES, ids=str)
def test_lse_softmax_matches_reference(shape, axis, scale):
    y = (np.random.default_rng(7).standard_normal(shape)
         * scale).astype(np.float32)
    np.testing.assert_allclose(
        T.lse_softmax(_t(y), axis=axis).numpy(),
        np.asarray(jsoftmax.lse_softmax(jnp.asarray(y), axis=axis)),
        **SUM_TOL)


@pytest.mark.parametrize("shape", [(6, 3, 5, 16), (4, 128), (1, 2, 64)],
                         ids=str)
def test_online_max_sum_matches_reference(shape):
    yb = (np.random.default_rng(11).standard_normal(shape)
          * 3).astype(np.float32)
    jm, js = jsoftmax.online_max_sum(jnp.asarray(yb))
    tm, ts = tsoftmax.online_max_sum(_t(yb))
    _equal(tm, jm)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SUM_TOL)
