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
    ARTEMIS_K_GRANULE,
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
# below, at and above the granules (K 32 for the dots, 16 for artemis; N
# 16) at depth 20
PADDING_CASES = (
    [pytest.param(mode, d, (37, 45), id=f"{mode}-{d}")
     for mode in MODES for d in (20, 16, 7)]
    + [pytest.param(mode, 20, kn, id=f"{mode}-20-K{kn[0]}xN{kn[1]}")
       for mode in MODES
       for kn in ((1, 1), (31, 15), (32, 16), (33, 17), (200, 130))])


@pytest.mark.parametrize("mode,acc_depth,kn", PADDING_CASES)
def test_kernel_padding_leaves_the_product(mode, acc_depth, kn):
    """The zero padding the wrapper gives the kernel (K and N to the
    mode's granules: whole mma depths for the integer dots, 16-byte rows
    of A for artemis whatever its depth, 16-byte rows of B for all)
    changes no entry of the (M, N) corner, even where it adds a MOMCAP
    group of zeros."""
    k, n = kn
    a, b = _int8(acc_depth + k + n, 5, k, n)
    ta, tb = pad_operands(torch.from_numpy(a), torch.from_numpy(b), mode,
                          acc_depth)
    gk, gn = granules(mode, acc_depth)
    assert (gk, gn) == ((16, 16) if mode == "artemis" else (32, 16))
    kp, np_ = ta.shape[1], tb.shape[1]
    assert kp % gk == 0 and np_ % gn == 0 and tb.shape[0] == kp
    assert k <= kp < k + gk and n <= np_ < n + gn
    # cp.async copies rows 16 bytes at a time
    assert kp % 16 == 0 and np_ % 16 == 0
    assert ta.is_contiguous() and tb.is_contiguous()
    assert ta.data_ptr() % 16 == 0 and tb.data_ptr() % 16 == 0
    want = _plain(a, b, mode, acc_depth=acc_depth)
    got = sc_matmul_ref(ta, tb, mode=mode, acc_depth=acc_depth).numpy()
    np.testing.assert_array_equal(got[:, :n], want)


@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 1024), (4096, 12288),
                                (12288, 4096)], ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_serve_shapes_reach_the_kernel_without_a_copy(mode, kn):
    """qwen3_8b's projections are whole granules: the wrapper hands the
    kernel the operands themselves."""
    a = torch.empty((8, kn[0]), dtype=torch.int8)
    b = torch.empty(kn, dtype=torch.int8)
    ta, tb = pad_operands(a, b, mode, 20)
    assert ta.data_ptr() == a.data_ptr() and tb.data_ptr() == b.data_ptr()


def test_granules_are_the_kernels():
    """The wrapper's granules are the ones the CUDA entry checks."""
    src = SOURCE.read_text()
    assert f"constexpr int kKGranule = {DOT_K_GRANULE};" in src
    assert f"constexpr int kNGranule = {DOT_N_GRANULE};" in src
    assert f"constexpr int kArtKGranule = {ARTEMIS_K_GRANULE};" in src
    assert "K % kKGranule != 0" in src and "N % kNGranule != 0" in src
    assert "K % kArtKGranule != 0" in src


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


# ---------------------------------------------------------------------------
# artemis with -128, the CUDA kernel's lane arithmetic, and its K split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("readout_bits", [8, None])
def test_plain_matches_pallas_kernel_with_minus_128(readout_bits):
    """Operands that reach -128 (quantize never makes one, but the
    kernels take any int8): floor(128 * 128 / 128) = 128 and group sums
    past the readout's full scale, in the Pallas kernel's depth 20."""
    a, b = _int8(21, 128, 320, 128, lo=-128)
    a[3] = -128
    b[:, 5] = -128
    got = _plain(a, b, "artemis", readout_bits=readout_bits)
    want = np.asarray(jpallas(jnp.asarray(a), jnp.asarray(b), mode="artemis",
                              readout_bits=readout_bits, bk=160,
                              interpret=True))
    np.testing.assert_allclose(got * UNIT_SCALE, want * UNIT_SCALE,
                               **PALLAS_TOL)
    if readout_bits is None:   # 320 products of 128, exact in both
        assert got[3, 5] == want[3, 5] == 320 * 128


def _jax_groups_oracle(a, b, acc_depth, readout_bits):
    """The reference oracle's computation (`repro.kernels.sc_matmul.ref`)
    at any MOMCAP depth, from the same reference primitives."""
    from repro.core.analog import MomcapConfig, readout_quantize
    from repro.core.quantization import magnitude_sign
    from repro.core.stochastic import sc_multiply
    ma, sa = magnitude_sign(jnp.asarray(a))
    mb, sb = magnitude_sign(jnp.asarray(b))
    m, k = a.shape
    g = k // acc_depth
    cfg = MomcapConfig(acc_depth=acc_depth, readout_bits=readout_bits)
    p = sc_multiply(ma[:, :, None], mb[None]).astype(jnp.float32)
    s = (sa[:, :, None] * sb[None]).astype(jnp.float32)
    p = p.reshape(m, g, acc_depth, -1)
    s = s.reshape(m, g, acc_depth, -1)
    pos = jnp.sum(jnp.where(s > 0, p, 0.0), axis=2)
    neg = jnp.sum(jnp.where(s < 0, p, 0.0), axis=2)
    return np.asarray(jnp.sum(readout_quantize(pos, cfg)
                              - readout_quantize(neg, cfg), axis=1))


@pytest.mark.parametrize("readout_bits", [8, None])
def test_plain_matches_reference_oracle_at_depth_16_with_minus_128(
        readout_bits):
    a, b = _int8(22, 24, 160, 40, lo=-128)
    a[0] = -128
    b[:, 1] = -128
    got = _plain(a, b, "artemis", acc_depth=16, readout_bits=readout_bits)
    want = _jax_groups_oracle(a, b, 16, readout_bits)
    np.testing.assert_allclose(got, want, **ORACLE_TOL)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of y:x."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        byte = (v >> np.uint64(8 * ((sel >> (4 * n)) & 7))) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def _negative_bytes(x):
    """prmt with the sign-replicating selectors 0xBA98: 0xFF in each
    negative byte."""
    out = np.zeros_like(x)
    for q in range(4):
        neg = ((x >> np.uint32(8 * q + 7)) & np.uint32(1)).astype(bool)
        out |= np.where(neg, np.uint32(0xFF << (8 * q)), np.uint32(0))
    return out


def _kernel_lanes(a, x):
    """The CUDA kernel's artemis inner step for int8 a (one row) against
    one word x of B (int8 columns c..c+3): for the column pairs (c, c+2)
    and (c+1, c+3), the 16-bit lanes of the positive and the negative
    floor products. a and x broadcast against each other."""
    s = _negative_bytes(x)
    mag = (x ^ s) + (s & np.uint32(0x01010101))
    am = (2 * np.abs(a.astype(np.int32))).astype(np.uint32)
    an = np.where(a < 0, np.uint32(0xFFFFFFFF), np.uint32(0))
    lanes = {}
    for name, m_sel, n_mask in (("02", 0x4240, s), ("13", 0x4341, s >> 8)):
        bm = _byte_perm(mag, np.uint32(0), m_sel)
        y = _byte_perm(am * bm, np.uint32(0), 0x4341)   # (x >> 8) & 0x00FF00FF
        neg = y & (an ^ n_mask)
        lanes[name] = (y - neg, neg)
    return lanes


def _every_int8_word():
    """256 words of B whose 4 bytes each run over all 256 int8 values."""
    v = np.arange(256, dtype=np.uint32)
    return v | (((v * 7 + 3) % 256) << 8) | (((v * 13 + 5) % 256) << 16) | (
        ((v * 29 + 11) % 256) << 24)


def test_kernel_lane_arithmetic_floors_every_int8_pair():
    """Every (a, b) of int8, -128 included, in each of a word's four
    columns: the lanes hold floor(|a||b| / 128), in pos when the signs
    agree, in neg when they differ; a group of 128 products of 128 fills
    a lane to 16384 without a carry."""
    a = np.arange(-128, 128, dtype=np.int32)[:, None]
    x = _every_int8_word()[None, :]
    lanes = _kernel_lanes(a, x)
    cols = [((x >> np.uint32(8 * c)) & np.uint32(0xFF)).astype(np.uint8)
            .view(np.int8).astype(np.int32) for c in range(4)]
    for name, (lo, hi) in (("02", (0, 2)), ("13", (1, 3))):
        pos, neg = lanes[name]
        for lane, c in ((0, lo), (1, hi)):
            prod = a * cols[c]
            want = np.abs(prod) // 128
            sh = np.uint32(16 * lane)
            got_pos = (pos >> sh) & np.uint32(0xFFFF)
            got_neg = (neg >> sh) & np.uint32(0xFFFF)
            np.testing.assert_array_equal(got_pos, np.where(prod > 0, want, 0))
            np.testing.assert_array_equal(got_neg, np.where(prod < 0, want, 0))
    pos, _ = _kernel_lanes(np.asarray([-128]), np.asarray([0x80808080],
                                                          np.uint32))["02"]
    assert int(pos[0]) * 128 == (16384 << 16) | 16384


def test_seven_bit_lanes_floor_128_by_128_to_zero():
    """The previous lanes (|a| undoubled, >> 7, masks 0x007F007F) keep 7
    bits of each floor: they lose exactly the products of 128 by 128."""
    a = np.arange(-128, 128, dtype=np.int64)[:, None]
    b = np.arange(-128, 128, dtype=np.int64)[None, :]
    packed = np.abs(b) | (np.abs(b) << 16)
    y = ((np.abs(a) * packed) >> 7) & 0x007F007F
    want = np.abs(a * b) // 128
    wrong = ((y & 0xFFFF) != want) | ((y >> 16) != want)
    np.testing.assert_array_equal(wrong, (np.abs(a) == 128) & (np.abs(b) == 128))


def test_lane_constants_are_the_kernels():
    """The selectors and masks the emulation above runs are the CUDA
    source's."""
    src = SOURCE.read_text()
    for needle in ("__byte_perm(am * bm, 0u, 0x4341)",
                   "(x ^ s) + (s & 0x01010101u)",
                   "__byte_perm(mag, 0u, 0x4240)",
                   "__byte_perm(mag, 0u, 0x4341)", "n13 = s >> 8;",
                   "2u * static_cast<uint32_t>(abs(a))",
                   'prmt.b32 %0, %1, 0, 0xBA98;'):
        assert needle in src, needle


def _split_emulation(a, b, acc_depth, readout_bits, splits, seed):
    """The CUDA kernel's algorithm in torch: every MOMCAP group's exact
    sums (pos, neg) formed by `splits` blocks of consecutive groups, the
    blocks and the groups in each taken in a random order, kept per
    group; then each output scans the table's readouts in group order,
    acc = fma(-neg_r, delta, fma(pos_r, delta, acc))."""
    from repro_torch.kernels.sc_matmul.ref import _fma, readout_table
    ta = torch.from_numpy(a).to(torch.int32)
    tb = torch.from_numpy(b).to(torch.int32)
    d = acc_depth
    groups = -(-a.shape[1] // d)
    pad = groups * d - a.shape[1]
    ma = torch.nn.functional.pad(ta.abs(), (0, pad))
    sa = torch.nn.functional.pad(torch.sign(ta), (0, pad))
    mb = torch.nn.functional.pad(tb.abs(), (0, 0, 0, pad))
    sb = torch.nn.functional.pad(torch.sign(tb), (0, 0, 0, pad))
    shape = (groups, a.shape[0], b.shape[1])
    pos = torch.full(shape, -1, dtype=torch.int64)
    neg = torch.full(shape, -1, dtype=torch.int64)
    rng = np.random.default_rng(seed)
    blocks = np.array_split(np.arange(groups), splits)
    for i in rng.permutation(len(blocks)):
        for g in rng.permutation(blocks[i]):
            sl = slice(g * d, (g + 1) * d)
            p = (ma[:, sl, None] * mb[None, sl, :]) // 128
            s = sa[:, sl, None] * sb[None, sl, :]
            pos[g] = torch.where(s > 0, p, 0).sum(1)
            neg[g] = torch.where(s < 0, p, 0).sum(1)
    assert int(pos.min()) >= 0 and int(neg.max()) <= d * 128
    table = readout_table(d, readout_bits)
    acc = torch.zeros(shape[1:], dtype=torch.float32)
    if readout_bits is not None:
        delta = torch.tensor(d * 127 / (2**readout_bits - 1),
                             dtype=torch.float32)
    for g in range(groups):
        pr, nr = table[pos[g]], table[neg[g]]
        if readout_bits is None:
            acc = (acc + pr) - nr
        else:
            acc = _fma(-nr, delta, _fma(pr, delta, acc))
    return acc.numpy()


SPLIT_KS = {"ragged": lambda d: 7 * d + 3,   # 8 groups, the last ragged
            "one_group": lambda d: d, "k1": lambda d: 1}


@pytest.mark.parametrize("kcase", list(SPLIT_KS))
@pytest.mark.parametrize("readout_bits", [1, 8, 12, None])
@pytest.mark.parametrize("acc_depth", [1, 16, 20, 128])
def test_split_group_sums_scanned_in_order_are_the_plain_version(
        acc_depth, readout_bits, kcase):
    """Any split of the groups' exact sums, in any order, then the scan
    in group order: bit-equal to the plain version (3 splits of 8 groups
    do not divide them; one group; K = 1)."""
    k = SPLIT_KS[kcase](acc_depth)
    a, b = _int8(acc_depth + k, 5, k, 7, lo=-128)
    want = _plain(a, b, "artemis", acc_depth=acc_depth,
                  readout_bits=readout_bits)
    for splits, seed in ((3, 0), (1, 1), (5, 2)):
        got = _split_emulation(a, b, acc_depth, readout_bits, splits, seed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("readout_bits", [1, 8, 12, None])
def test_split_group_sums_match_pallas_kernel(readout_bits):
    """The same algorithm against the Pallas kernel in interpret mode, at
    its depth of 20, within the reference's own tolerance (it multiplies
    by 1/delta and sums block by block)."""
    a, b = _int8(23, 128, 320, 128, lo=-128)
    got = _split_emulation(a, b, 20, readout_bits, 7, 3)
    want = np.asarray(jpallas(jnp.asarray(a), jnp.asarray(b), mode="artemis",
                              readout_bits=readout_bits, bk=160,
                              interpret=True))
    np.testing.assert_allclose(got * UNIT_SCALE, want * UNIT_SCALE,
                               **PALLAS_TOL)


@pytest.mark.parametrize("acc_depth,readout_bits",
                         [(20, 8), (16, 4), (128, 12), (1, None)])
def test_readout_table_is_the_plain_readout(acc_depth, readout_bits):
    """The table the kernel looks group sums up in covers every sum of
    int8 products (up to acc_depth * 128) with the plain version's
    readout."""
    from repro_torch.kernels.sc_matmul.ref import readout_table
    t = readout_table(acc_depth, readout_bits)
    assert t.dtype == torch.float32 and t.shape == (acc_depth * 128 + 1,)
    x = torch.arange(acc_depth * 128 + 1, dtype=torch.float32)
    if readout_bits is None:
        assert torch.equal(t, x)
        return
    levels = 2**readout_bits - 1
    delta = np.float32(acc_depth * 127 / levels)
    want = np.clip(np.round(x.numpy() / delta), 0, levels).astype(np.float32)
    np.testing.assert_array_equal(t.numpy(), want)
