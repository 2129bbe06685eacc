"""The port's threefry random numbers (`repro_torch.prng`) against
`jax.random` (32-bit mode, `jax_threefry_partitionable` as configured
here): keys, `fold_in` and the random bits equal exactly, and so do
the uniforms; the Gumbel values pass through two logs, whose last bit
XLA's CPU `log` and torch's may round differently, so they are held
within rtol 1e-6 plus one ulp of 1.0 (a value near 0 is the log of a
number near 1, where one ulp of 1.0 is the least error there is)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = (0, 42, 2**32 - 1)
POSITIONS = (0, 1, 7, 1000, 2**31 - 1)
GUMBEL_TOL = dict(rtol=1e-6, atol=2.0**-23)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_threefry_partitionable_is_the_configured_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _u32(jax.random.PRNGKey(seed)))
    for pos in POSITIONS:
        np.testing.assert_array_equal(
            prng.fold_in(key, pos).numpy(),
            _u32(jax.random.fold_in(jax.random.PRNGKey(seed), pos)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (257,), (3, 5), (151936,)])
def test_bits_and_uniforms_equal(seed, shape):
    for pos in POSITIONS[:3]:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        key = prng.fold_in(prng.PRNGKey(seed), pos)
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy(),
            _u32(jax.random.bits(jkey, shape, np.uint32)))
        np.testing.assert_array_equal(
            prng.uniform(key, shape).numpy(),
            np.asarray(jax.random.uniform(jkey, shape)))
        lo = np.float32(np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(
            prng.uniform(key, shape, float(lo), 1.0).numpy(),
            np.asarray(jax.random.uniform(jkey, shape, minval=lo)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_close(seed):
    for pos in POSITIONS:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        key = prng.fold_in(prng.PRNGKey(seed), pos)
        got = prng.gumbel(key, (151936,)).numpy()
        want = np.asarray(jax.random.gumbel(jkey, (151936,)))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **GUMBEL_TOL)


def test_a_batch_of_keys_draws_each_lane_alone():
    """(B, 2) keys draw (B, V): row b is what key b draws by itself."""
    seeds = torch.tensor([0, 42, 2**32 - 1, 9], dtype=torch.int64)
    pos = torch.tensor([3, 0, 17, 3], dtype=torch.int64)
    keys = prng.fold_in(prng.PRNGKey(seeds), pos)
    bits = prng.random_bits(keys, (64,))
    g = prng.gumbel(keys, (64,))
    for b in range(4):
        one = prng.fold_in(prng.PRNGKey(int(seeds[b])), int(pos[b]))
        assert torch.equal(keys[b], one)
        assert torch.equal(bits[b], prng.random_bits(one, (64,)))
        assert torch.equal(g[b], prng.gumbel(one, (64,)))
