"""The port's MOMCAP readout noise against the JAX package on the CPU.

- `prng.normal` against `jax.random.normal` over several seeds and
  shapes: its uniform's bits exact, and the normals equal bit for bit
  (the bar is 2 ulps; `erf_inv` and its log1p are XLA's algorithms,
  restated in `repro_torch.xla_math`, and `torch.erfinv` would part by
  up to 64 ulps);
- `readout_quantize` and `grouped_signed_accumulate` with a key, as the
  reference runs them op by op: the readouts equal, the group sums
  within 1e-5 (the sum over groups adds in another order);
- `artemis_matmul(key=)` in `artemis` mode against the reference's
  `_artemis_emulated` on shapes with K not a multiple of 20: a readout
  that sits on a rounding tie may part by one level, so the outputs
  may differ in at most 0.1 % of places, each by one readout level;
  elsewhere they agree within 1e-5 of the largest output (the port adds
  the noise and the readouts op by op, where XLA folds and fuses them
  in the scan);
- ValueError without a key; `ops.sc_matmul` ignores `sigma_analog`, as
  the reference's kernel wrapper does.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analog as janalog  # noqa: E402
from repro.core.artemis_matmul import _artemis_emulated  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.kernels.sc_matmul import ops as jops  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import analog as tanalog  # noqa: E402
from repro_torch.core import artemis_matmul  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels.sc_matmul import ops as tops  # noqa: E402

# Table V's calibrated readout noise: MAE 0.0085 of full scale
SIGMA_CAL = 0.0085 / math.sqrt(2.0 / math.pi)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", [(1 << 16,), (64, 64), (7, 3, 5), (1,)],
                         ids=str)
@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 - 1])
def test_normal_equals_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(seed), shape, prng.NORMAL_LO, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(key, shape))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulps(got, want).max() == 0


def test_normal_of_folded_and_split_keys():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 17)
    keys = jax.random.split(key, 3)
    tkeys = prng.split(prng.fold_in(prng.PRNGKey(3), 17), 3)
    for i in range(3):
        np.testing.assert_array_equal(
            prng.normal(tkeys[i], (33, 9)).numpy(),
            np.asarray(jax.random.normal(keys[i], (33, 9))))


def test_erf_inv_equals_xla():
    u = np.random.default_rng(0).uniform(-1, 1, 1 << 16).astype(np.float32)
    u[:4] = [0.0, np.nextafter(np.float32(-1), np.float32(0)),
             np.nextafter(np.float32(1), np.float32(0)), 1e-30]
    np.testing.assert_array_equal(prng.erf_inv(_t(u)).numpy(),
                                  np.asarray(jax.lax.erf_inv(u)))
    assert prng.erf_inv(_t(np.float32([1.0, -1.0]))).tolist() == \
        [math.inf, -math.inf]


@pytest.mark.parametrize("bits", [8, None, 4])
@pytest.mark.parametrize("sigma", [0.01, SIGMA_CAL, 0.2])
def test_readout_quantize_with_key_equals_reference(sigma, bits):
    x = np.random.default_rng(5).uniform(0, 2540, (33, 17)).astype(
        np.float32)
    jcfg = janalog.MomcapConfig(readout_bits=bits, sigma_analog=sigma)
    tcfg = tanalog.MomcapConfig(readout_bits=bits, sigma_analog=sigma)
    want = janalog.readout_quantize(jnp.asarray(x), jcfg,
                                    jax.random.PRNGKey(9))
    got = tanalog.readout_quantize(_t(x), tcfg, prng.PRNGKey(9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [37, 60, 101])
def test_grouped_signed_accumulate_with_key_matches_reference(k):
    rng = np.random.default_rng(k)
    products = rng.integers(0, 128, (6, 11, k)).astype(np.int32)
    signs = rng.integers(-1, 2, (6, 11, k)).astype(np.int32)
    jcfg = janalog.MomcapConfig(sigma_analog=SIGMA_CAL)
    tcfg = tanalog.MomcapConfig(sigma_analog=SIGMA_CAL)
    want = janalog.grouped_signed_accumulate(
        jnp.asarray(products), jnp.asarray(signs), jcfg,
        jax.random.PRNGKey(4))
    got = tanalog.grouped_signed_accumulate(_t(products), _t(signs), tcfg,
                                            prng.PRNGKey(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


NOISY = [((8, 45), 33, SIGMA_CAL, 8), ((3, 5, 37), 20, 0.05, 8),
         ((16, 130), 64, SIGMA_CAL, None), ((2, 9, 64), 12, 0.2, 4),
         ((8, 4096), 48, SIGMA_CAL, 8)]


@pytest.mark.parametrize("a_shape,n,sigma,bits", NOISY, ids=str)
def test_noisy_artemis_matmul_matches_reference_scan(a_shape, n, sigma,
                                                     bits):
    rng = np.random.default_rng(a_shape[-1])
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = (rng.standard_normal((a_shape[-1], n)) * 0.3).astype(np.float32)
    kw = dict(mode="artemis", ste=False, sigma_analog=sigma,
              readout_bits=bits)
    want = np.asarray(_artemis_emulated(jnp.asarray(a), jnp.asarray(b),
                                        JPolicy(**kw),
                                        jax.random.PRNGKey(5)))
    got = artemis_matmul(_t(a), _t(b), TPolicy(**kw),
                         key=prng.PRNGKey(5)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # one readout level in output units: delta * 128 * s_a * s_b
    sa = np.abs(a).max() / 127
    sb = np.abs(b).max() / 127
    level = (20 * 127 / (2**bits - 1) if bits else 1.0) * 128 * sa * sb
    diff = np.abs(got - want)
    parted = diff > 1e-5 * np.abs(want).max()
    assert parted.sum() <= max(1, want.size // 1000), parted.sum()
    np.testing.assert_allclose(diff[parted], level, rtol=1e-3)
    # a different key draws different noise
    other = artemis_matmul(_t(a), _t(b), TPolicy(**kw),
                           key=prng.PRNGKey(6)).numpy()
    assert not np.array_equal(other, got)


def test_noise_needs_a_key():
    """The reference's scan refuses noise without a key, as the port's
    does (tests/test_torch_arithmetic.py); the other modes take no
    noise and ignore a key."""
    with pytest.raises(ValueError, match="key"):
        _artemis_emulated(jnp.ones((2, 25)), jnp.ones((25, 3)),
                          JPolicy(mode="artemis", sigma_analog=0.01), None)
    for mode in ("int8", "artemis_mxu"):
        kw = dict(mode=mode, sigma_analog=0.01)
        assert torch.equal(
            artemis_matmul(torch.ones(2, 25), torch.ones(25, 3),
                           TPolicy(**kw), key=prng.PRNGKey(0)),
            artemis_matmul(torch.ones(2, 25), torch.ones(25, 3),
                           TPolicy(**kw)))


def test_ops_sc_matmul_ignores_sigma_analog():
    """The reference's kernel wrapper runs the noiseless kernel whatever
    sigma_analog says; so does the port's, with no key."""
    rng = np.random.default_rng(21)
    a = rng.standard_normal((24, 50)).astype(np.float32)
    b = (rng.standard_normal((50, 40)) * 0.2).astype(np.float32)
    pol = dict(mode="artemis", ste=False, sigma_analog=SIGMA_CAL)
    got = tops.sc_matmul(_t(a), _t(b), TPolicy(**pol))
    want = np.asarray(jops.sc_matmul(jnp.asarray(a), jnp.asarray(b),
                                     JPolicy(**pol), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    quiet = tops.sc_matmul(_t(a), _t(b), TPolicy(mode="artemis", ste=False))
    assert torch.equal(got, quiet)
