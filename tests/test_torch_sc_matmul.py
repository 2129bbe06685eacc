"""The port's sc_matmul kernel module against the JAX package's.

On the CPU the wrapper runs the kernel's plain version (`ref.py`); the
CUDA kernel itself is held against that plain version on the card by
`chip_smoke.py`. Here, with the same int8 operands made by numpy:

- the plain version against the reference's oracle
  (`repro.kernels.sc_matmul.sc_matmul_ref`): bit-equal in `int8` and
  `artemis_mxu`; in `artemis` within rtol=1e-5, atol=1e-3 (SC product
  units), because the oracle sums the group readouts with one
  `jnp.sum` where the plain version (like `artemis_matmul`) scans them
  in order in f32;
- the plain version against the Pallas kernel in interpret mode within
  the reference's own rtol=atol=2e-4, on outputs dequantized at unit
  operand scale (sa = sb = 1/127), as the reference's sweep compares
  them: the Pallas body multiplies by 1/delta and sums block by block,
  and outputs that cancel to about 0 from partial sums in the
  thousands keep f32 residues of a few 1e-4 SC units;
- the wrapper's device dispatch, padding and launch count, and the
  float-level `ops.sc_matmul` against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.kernels.sc_matmul import ops as jops  # noqa: E402
from repro.kernels.sc_matmul.ref import sc_matmul_ref as jref  # noqa: E402
from repro.kernels.sc_matmul.sc_matmul import (  # noqa: E402
    sc_matmul_quantized as jpallas,
)
from repro_torch.core import artemis_matmul  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.sc_matmul import (  # noqa: E402
    sc_matmul_quantized,
    sc_matmul_ref,
)
from repro_torch.kernels.sc_matmul import ops as tops  # noqa: E402
from repro_torch.kernels.sc_matmul.sc_matmul import (  # noqa: E402
    DOT_K_GRANULE,
    DOT_N_GRANULE,
    SOURCE,
    granules,
    pad_operands,
)

MODES = ["int8", "artemis_mxu", "artemis"]
ORACLE_TOL = dict(rtol=1e-5, atol=1e-3)
PALLAS_TOL = dict(rtol=2e-4, atol=2e-4)
UNIT_SCALE = 128 / 127**2      # SC product units -> dequantized, |a|,|b|<=1


def _int8(seed, m, k, n, lo=-127):
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, 128, (m, k)).astype(np.int8)
    b = rng.integers(lo, 128, (k, n)).astype(np.int8)
    return a, b


def _plain(a, b, mode, **kw):
    return sc_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                         mode=mode, **kw).numpy()


@pytest.mark.parametrize("mkn", [(1, 20, 4), (37, 60, 45), (64, 100, 96),
                                 (8, 320, 130)], ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_reference_oracle(mode, mkn):
    """The oracle takes whole MOMCAP groups of 20: K is a multiple."""
    a, b = _int8(sum(mkn), *mkn)
    got = _plain(a, b, mode)
    want = np.asarray(jref(jnp.asarray(a), jnp.asarray(b), mode=mode))
    assert got.dtype == want.dtype
    if mode == "artemis":
        np.testing.assert_allclose(got, want, **ORACLE_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("readout_bits", [8, 4, None])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_kernel_in_interpret_mode(mode, readout_bits):
    """Block shapes of the Pallas kernel: M, N multiples of 128, K of
    bk=160 (two K blocks, so its block-by-block sum runs)."""
    a, b = _int8(3, 128, 320, 128)
    got = _plain(a, b, mode, readout_bits=readout_bits)
    want = np.asarray(jpallas(jnp.asarray(a), jnp.asarray(b), mode=mode,
                              readout_bits=readout_bits, bk=160,
                              interpret=True))
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got * UNIT_SCALE, want * UNIT_SCALE,
                                   **PALLAS_TOL)


def test_int8_dot_is_exact_beyond_float32():
    """K=2048 of +-127: sums reach 3.3e7 > 2**24, where an f32 product
    would round; the plain version's f64 product stays exact."""
    rng = np.random.default_rng(4)
    a = rng.choice(np.asarray([-127, 127], np.int8), (4, 2048))
    b = rng.choice(np.asarray([-127, 127], np.int8), (2048, 6))
    b[:, 0] = a[0]                      # one output is 2048 * 127**2
    got = _plain(a, b, "int8")
    np.testing.assert_array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    assert got[0, 0] == 2048 * 127**2


# (mode, acc_depth, (K, N)): K = 37, N = 45 at every depth, then K and N
# below, at and above the dot modes' granules (32, 16) at depth 20
PADDING_CASES = (
    [pytest.param(mode, d, (37, 45), id=f"{mode}-{d}")
     for mode in MODES for d in (20, 16, 7)]
    + [pytest.param(mode, 20, kn, id=f"{mode}-20-K{kn[0]}xN{kn[1]}")
       for mode in MODES
       for kn in ((1, 1), (31, 15), (32, 16), (33, 17), (200, 130))])


@pytest.mark.parametrize("mode,acc_depth,kn", PADDING_CASES)
def test_kernel_padding_leaves_the_product(mode, acc_depth, kn):
    """The zero padding the wrapper gives the kernel (K and N to the
    mode's granules: whole mma depths and 16-byte rows of B for the
    integer dots, whole groups and 4-byte words for artemis) changes no
    entry of the (M, N) corner."""
    k, n = kn
    a, b = _int8(acc_depth + k + n, 5, k, n)
    ta, tb = pad_operands(torch.from_numpy(a), torch.from_numpy(b), mode,
                          acc_depth)
    gk, gn = granules(mode, acc_depth)
    assert (gk, gn) == ((acc_depth, 4) if mode == "artemis" else (32, 16))
    kp, np_ = ta.shape[1], tb.shape[1]
    assert kp % gk == 0 and np_ % gn == 0 and tb.shape[0] == kp
    assert k <= kp < k + gk and n <= np_ < n + gn
    if mode != "artemis":   # cp.async copies rows 16 bytes at a time
        assert kp % 16 == 0 and np_ % 16 == 0
    assert ta.is_contiguous() and tb.is_contiguous()
    assert ta.data_ptr() % 16 == 0 and tb.data_ptr() % 16 == 0
    want = _plain(a, b, mode, acc_depth=acc_depth)
    got = sc_matmul_ref(ta, tb, mode=mode, acc_depth=acc_depth).numpy()
    np.testing.assert_array_equal(got[:, :n], want)


@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 1024), (4096, 12288),
                                (12288, 4096)], ids=str)
@pytest.mark.parametrize("mode", ["int8", "artemis_mxu"])
def test_serve_shapes_reach_the_kernel_without_a_copy(mode, kn):
    """qwen3_8b's projections are whole granules: the wrapper hands the
    kernel the operands themselves."""
    a = torch.empty((8, kn[0]), dtype=torch.int8)
    b = torch.empty(kn, dtype=torch.int8)
    ta, tb = pad_operands(a, b, mode, 20)
    assert ta.data_ptr() == a.data_ptr() and tb.data_ptr() == b.data_ptr()


def test_granules_are_the_kernels():
    """The wrapper's dot granules are the ones the CUDA entry checks."""
    src = SOURCE.read_text()
    assert f"constexpr int kKGranule = {DOT_K_GRANULE};" in src
    assert f"constexpr int kNGranule = {DOT_N_GRANULE};" in src
    assert "K % kKGranule != 0" in src and "N % kNGranule != 0" in src


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_runs_the_plain_version_for_cpu_tensors(mode):
    a, b = _int8(9, 6, 41, 10)
    reset_launch_counts()
    got = sc_matmul_quantized(torch.from_numpy(a), torch.from_numpy(b),
                              mode=mode, acc_depth=16, readout_bits=4)
    assert launch_counts["sc_matmul"] == 0
    np.testing.assert_array_equal(
        got.numpy(), _plain(a, b, mode, acc_depth=16, readout_bits=4))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a, b = (torch.from_numpy(x) for x in _int8(0, 4, 8, 4))
    with pytest.raises(TypeError, match="int8"):
        sc_matmul_quantized(a.float(), b)
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        sc_matmul_quantized(a, b[:5])
    with pytest.raises(ValueError, match="mode"):
        sc_matmul_quantized(a, b, mode="exact")
    with pytest.raises(ValueError, match="acc_depth"):
        sc_matmul_quantized(a, b, acc_depth=0)
    with pytest.raises(ValueError, match="readout_bits"):
        sc_matmul_quantized(a, b, readout_bits=0)
    # no device but the CPU's plain version and the CUDA kernel
    with pytest.raises(ValueError, match="one device"):
        sc_matmul_quantized(a, b.to("meta"))
    reset_launch_counts()
    with pytest.raises(ValueError, match="one device"):
        sc_matmul_quantized(a.to("meta"), b.to("meta"))
    assert launch_counts["sc_matmul"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_ops_sc_matmul_matches_reference_ops(mode):
    """Float in, quantize, MAC, dequantize, STE; against the reference's
    Pallas path in interpret mode within its own 3e-4 (its sweep)."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((64, 100)).astype(np.float32)
    b = (rng.standard_normal((100, 96)) * 0.2).astype(np.float32)
    pol = dict(mode=mode, ste=False)
    got = tops.sc_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         TPolicy(**pol))
    want = np.asarray(jops.sc_matmul(jnp.asarray(a), jnp.asarray(b),
                                     JPolicy(**pol), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    # one code path with artemis_matmul
    assert torch.equal(got, artemis_matmul(torch.from_numpy(a),
                                           torch.from_numpy(b),
                                           TPolicy(**pol)))


def test_ops_sc_matmul_refuses_exact_and_batched_operands():
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    with pytest.raises(ValueError, match="exact"):
        tops.sc_matmul(a, b, TPolicy())
    with pytest.raises(ValueError, match="2-D"):
        tops.sc_matmul(a[None], b, TPolicy(mode="int8"))
