"""The port's ARTEMIS arithmetic (`repro_torch.core`) against the JAX
package's (`repro.core`).

The same numpy inputs go through both. Quantization, the TCU multiply
(exhaustively over the 128x128 operand square), the readout of every
possible group sum, and `artemis_matmul` without the straight-through
term are bit-equal. (In `artemis` mode that takes the reference's group
scan as XLA compiles it on the CPU, with each readout product fused
into its add: see `repro_torch.kernels.sc_matmul.ref`. Rounding them
apart moves single outputs by an ulp, and the readout's coarse steps
carry that far through a model.) With the straight-through term the
exact f32 product enters, summed in another order: rtol=atol=1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.core import analog as janalog  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import analog as tanalog  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _operands(seed, a_shape, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = (rng.standard_normal((a_shape[-1], n)) * 0.3).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("bits", [8, 4, 12])
def test_quantize_roundtrip_matches_reference(axis, bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((6, 40)) * 3).astype(np.float32)
    js = J.quant_scale(_j(x), bits, axis)
    ts = T.quant_scale(_t(x), bits, axis)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq = J.quantize(_j(x), js, bits)
    tq = T.quantize(_t(x), ts, bits)
    assert tq.dtype == (torch.int8 if bits <= 8 else torch.int32)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(T.dequantize(tq, ts).numpy(),
                                  np.asarray(J.dequantize(jq, js)))
    np.testing.assert_array_equal(T.fake_quant(_t(x), bits, axis).numpy(),
                                  np.asarray(J.fake_quant(_j(x), bits, axis)))


def test_quantize_rounds_half_to_even():
    """x/scale exactly at k + 1/2 rounds to the even neighbour, as
    jnp.round does (floor(x + 0.5) would round all of them up)."""
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                   np.float32)
    s = np.ones((1,), np.float32)
    got = T.quantize(_t(x), _t(s)).numpy()
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, -2, 126, 127])
    np.testing.assert_array_equal(got, np.asarray(J.quantize(_j(x), _j(s))))


def test_magnitude_sign_matches_reference():
    q = np.arange(-127, 128, dtype=np.int8)
    jm, js = J.magnitude_sign(_j(q))
    tm, ts = T.magnitude_sign(_t(q))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# stochastic multiply
# ---------------------------------------------------------------------------


def test_sc_multiply_exhaustive():
    """All 128x128 magnitude pairs: the bitstream emulation, the closed
    form and its float variant agree with each other and with the
    reference's, and the truncation error is the reference's."""
    a, b = np.meshgrid(np.arange(128, dtype=np.int32),
                       np.arange(128, dtype=np.int32), indexing="ij")
    ta, tb = _t(a), _t(b)
    closed = T.sc_multiply(ta, tb)
    np.testing.assert_array_equal(closed.numpy(), (a * b) // 128)
    np.testing.assert_array_equal(T.sc_multiply_bitstream(ta, tb).numpy(),
                                  closed.numpy())
    np.testing.assert_array_equal(
        closed.numpy(), np.asarray(J.sc_multiply(_j(a), _j(b))))
    np.testing.assert_array_equal(
        T.sc_multiply_bitstream(ta, tb).numpy(),
        np.asarray(J.sc_multiply_bitstream(_j(a), _j(b))))
    fa, fb = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_array_equal(
        T.sc_multiply_float(_t(fa), _t(fb)).numpy(),
        np.asarray(J.sc_multiply_float(_j(fa), _j(fb))))
    np.testing.assert_array_equal(
        T.sc_truncation_error(ta, tb).numpy(),
        np.asarray(J.sc_truncation_error(_j(a), _j(b))))


def test_stream_encoders_match_reference():
    m = np.arange(129, dtype=np.int32)
    np.testing.assert_array_equal(T.tcu_encode(_t(m)).numpy(),
                                  np.asarray(J.tcu_encode(_j(m))))
    np.testing.assert_array_equal(T.spread_encode(_t(m)).numpy(),
                                  np.asarray(J.spread_encode(_j(m))))
    assert T.SC_BITS == J.SC_BITS and T.SC_LEVELS == J.SC_LEVELS


# ---------------------------------------------------------------------------
# analog accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("acc_depth", [20, 16])
@pytest.mark.parametrize("readout_bits", [8, 4, 12, None])
def test_readout_of_every_group_sum(acc_depth, readout_bits):
    """Every integer sum a MOMCAP group can hold, read out by both."""
    jcfg = janalog.MomcapConfig(acc_depth=acc_depth,
                                readout_bits=readout_bits)
    tcfg = tanalog.MomcapConfig(acc_depth=acc_depth,
                                readout_bits=readout_bits)
    assert tcfg.full_scale == jcfg.full_scale
    x = np.arange(tcfg.full_scale + 1, dtype=np.float32)
    np.testing.assert_array_equal(
        T.readout_quantize(_t(x), tcfg).numpy(),
        np.asarray(J.readout_quantize(_j(x), jcfg)))


def test_grouped_signed_accumulate_matches_reference():
    rng = np.random.default_rng(5)
    products = rng.integers(0, 127, (7, 93)).astype(np.int32)
    signs = rng.integers(-1, 2, (7, 93)).astype(np.int32)
    for bits in (8, None):
        jcfg = janalog.MomcapConfig(readout_bits=bits)
        tcfg = tanalog.MomcapConfig(readout_bits=bits)
        # the final sum over groups runs in another order: 1e-5
        np.testing.assert_allclose(
            T.grouped_signed_accumulate(_t(products), _t(signs),
                                        tcfg).numpy(),
            np.asarray(J.grouped_signed_accumulate(_j(products), _j(signs),
                                                   jcfg)), **TOL)


def test_rc_model_matches_reference():
    for c_pf in (2.0, 8.0, 20.0):
        np.testing.assert_allclose(
            T.momcap_voltage_trace(c_pf, 40).numpy(),
            np.asarray(J.momcap_voltage_trace(c_pf, 40)), rtol=1e-6)
        assert T.max_linear_accumulations(c_pf) == \
            J.max_linear_accumulations(c_pf)


def test_noise_path_is_refused():
    """The noise path runs with a PRNG key (tests/test_torch_noise.py);
    without one it is refused with ValueError, as the reference refuses
    it."""
    noisy = tanalog.MomcapConfig(sigma_analog=0.01)
    x = torch.ones(4)
    with pytest.raises(ValueError, match="key"):
        T.readout_quantize(x, noisy)
    with pytest.raises(ValueError, match="key"):
        T.grouped_signed_accumulate(x, x, noisy)
    with pytest.raises(ValueError, match="key"):
        T.artemis_matmul(torch.ones(2, 3), torch.ones(3, 4),
                         T.ArithmeticPolicy("artemis", sigma_analog=0.01))
    with pytest.raises(ValueError, match="key"):
        J.readout_quantize(jnp.ones(4), janalog.MomcapConfig(
            sigma_analog=0.01))


# ---------------------------------------------------------------------------
# artemis_matmul
# ---------------------------------------------------------------------------

SHAPES = [(1, 5), (3, 5, 37), (64, 130), (2, 9, 64)]
POLICIES = [dict(), dict(readout_bits=None), dict(readout_bits=4),
            dict(acc_depth=16)]


@pytest.mark.parametrize("kw", POLICIES, ids=lambda kw: str(kw) or "default")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mode", ["int8", "artemis_mxu", "artemis"])
def test_artemis_matmul_matches_reference(mode, shape, kw):
    a, b = _operands(len(shape) * 100 + shape[-1], shape, 45)
    want = np.asarray(J.artemis_matmul(
        _j(a), _j(b), J.ArithmeticPolicy(mode=mode, ste=False, **kw)))
    got = T.artemis_matmul(
        _t(a), _t(b), T.ArithmeticPolicy(mode=mode, ste=False, **kw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # with the straight-through term: the exact f32 product enters
    want_ste = np.asarray(J.artemis_matmul(
        _j(a), _j(b), J.ArithmeticPolicy(mode=mode, **kw)))
    got_ste = T.artemis_matmul(_t(a), _t(b),
                               T.ArithmeticPolicy(mode=mode, **kw))
    np.testing.assert_allclose(got_ste.numpy(), want_ste, **TOL)


def test_artemis_matmul_exact_mode_and_inputs_in_bf16():
    a, b = _operands(7, (4, 6, 32), 16)
    np.testing.assert_allclose(
        T.artemis_matmul(_t(a), _t(b), T.EXACT).numpy(),
        np.asarray(J.artemis_matmul(_j(a), _j(b), J.EXACT)), **TOL)
    # bf16 operands are cast to f32 first, as the reference casts them
    ab = torch.from_numpy(a).to(torch.bfloat16)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    got = T.artemis_matmul(ab, bb, T.ArithmeticPolicy("int8", ste=False))
    want = J.artemis_matmul(_j(ab.float().numpy()).astype(jnp.bfloat16),
                            _j(bb.float().numpy()).astype(jnp.bfloat16),
                            J.ArithmeticPolicy("int8", ste=False))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["int8", "artemis"])
def test_ste_gradient_is_the_exact_gradient(mode):
    a, b = _operands(11, (5, 24), 8)
    ta = _t(a).requires_grad_(True)
    T.artemis_matmul(ta, _t(b), T.ArithmeticPolicy(mode=mode)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(J.artemis_matmul(
        x, _j(b), J.ArithmeticPolicy(mode=mode))))(_j(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), **TOL)


def test_calibrate_rbar_matches_reference():
    a, b = _operands(3, (12, 40), 9)
    pol = dict(mode="artemis_mxu")
    got = T.calibrate_rbar(_t(a), _t(b), T.ArithmeticPolicy(**pol))
    want = J.calibrate_rbar(_j(a), _j(b), J.ArithmeticPolicy(**pol))
    assert got == pytest.approx(want, rel=1e-6)
