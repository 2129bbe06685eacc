"""The port's paged attention against the JAX package's.

On the CPU the port's `paged_attention` runs its plain version
(`paged_attention_ref`); both are held here against the reference's
Pallas kernel (interpret mode, as tests/test_paged_kernel.py runs it)
and its oracle, on the same numpy inputs, over the reference suite's
cases. The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_ref as jax_paged_ref,
)
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_ref,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _operands(seed, *, b, s, h, kvh, hd, npages, page, pmax, starts):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), np.float32)
    kp = rng.standard_normal((npages, page, kvh, hd), np.float32)
    vp = rng.standard_normal((npages, page, kvh, hd), np.float32)
    bt = rng.integers(0, npages, (b, pmax)).astype(np.int32)
    pos = (np.asarray(starts, np.int32)[:, None]
           + np.arange(s, dtype=np.int32)[None])
    return q, kp, vp, bt, pos


def _port(args, window=None):
    return paged_attention(*(torch.from_numpy(a) for a in args),
                           window=window).numpy()


def _check_all(args, window=None):
    """Port wrapper, port plain version, reference kernel and reference
    oracle all agree."""
    jargs = [jnp.asarray(a) for a in args]
    want_kernel = np.asarray(jax_paged(*jargs, window=window))
    want_oracle = np.asarray(jax_paged_ref(*jargs, window=window))
    got = _port(args, window)
    got_ref = paged_attention_ref(*(torch.from_numpy(a) for a in args),
                                  window=window).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)
    np.testing.assert_allclose(got_ref, want_oracle, **TOL)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("window", [None, 3])
def test_matches_reference(page, h, kvh, window):
    # starts straddle page boundaries, rows at different table depths
    args = _operands(page * 31 + h, b=3, s=7, h=h, kvh=kvh, hd=16,
                     npages=12, page=page, pmax=5,
                     starts=[0, page - 1, 2 * page + 1])
    _check_all(args, window)


def test_decode_shape():
    args = _operands(5, b=3, s=1, h=8, kvh=2, hd=16, npages=10, page=4,
                     pmax=5, starts=[5, 0, 19])
    _check_all(args)


@pytest.mark.parametrize("window", [None, 2])
def test_chunk_straddles_page_boundary(window):
    page = 4
    args = _operands(7, b=2, s=6, h=4, kvh=2, hd=8, npages=8, page=page,
                     pmax=4, starts=[page - 2, 2 * page - 3])
    _check_all(args, window)


def test_trash_page_poisoning():
    """Two pools differing only in the trash page give identical valid
    rows, and the idle lane (all-trash table, positions 0) stays
    finite — in the port and in the reference alike."""
    b, s, h, kvh, hd, page = 2, 4, 4, 2, 8, 4
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, s, h, hd), np.float32)
    kp = rng.standard_normal((6, page, kvh, hd), np.float32)
    vp = rng.standard_normal((6, page, kvh, hd), np.float32)
    bt = np.asarray([[1, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([[4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e3
    vp2[0] = 1e3
    clean = _port((q, kp, vp, bt, pos))
    poisoned = _port((q, kp2, vp2, bt, pos))
    np.testing.assert_array_equal(clean[0], poisoned[0])
    assert np.isfinite(poisoned).all() and np.isfinite(clean).all()
    for pools in ((kp, vp), (kp2, vp2)):
        want = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                      (q, *pools, bt, pos))))
        got = _port((q, *pools, bt, pos))
        np.testing.assert_allclose(got[0], want[0], **TOL)
        assert np.isfinite(want[1]).all()


def test_cpu_tensors_take_the_plain_version():
    args = _operands(3, b=2, s=3, h=4, kvh=2, hd=8, npages=6, page=4,
                     pmax=3, starts=[0, 5])
    tensors = [torch.from_numpy(a) for a in args]
    reset_launch_counts()
    got = paged_attention(*tensors)
    assert launch_counts["paged_attention"] == 0
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  paged_attention_ref(*tensors).numpy())


def test_bf16_inputs_accumulate_in_f32():
    args = _operands(9, b=2, s=5, h=4, kvh=2, hd=16, npages=8, page=4,
                     pmax=4, starts=[1, 6])
    tensors = [torch.from_numpy(a) for a in args]
    lo = [t.to(torch.bfloat16) if t.is_floating_point() else t
          for t in tensors]
    got = paged_attention(*lo)
    want = paged_attention(*(t.float() if t.is_floating_point() else t
                             for t in lo))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_shape_validation():
    args = _operands(3, b=2, s=4, h=4, kvh=2, hd=8, npages=6, page=4,
                     pmax=3, starts=[0, 1])
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="multiple"):
        paged_attention(q[:, :, :3], kp, vp, bt, pos)
    with pytest.raises(ValueError, match="batch mismatch"):
        paged_attention(q, kp, vp, bt[:1], pos)
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kp, vp, bt, pos, window=0)
