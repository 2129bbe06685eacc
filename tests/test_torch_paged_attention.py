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
from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: E402
    VARIANTS,
    kernel_variant,
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


# ---------------------------------------------------------------------------
# The kernel's two instances: the choice, the validation, and the tile
# instance's arithmetic (3xTF32 on the tensor cores) emulated here
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,s,hd,want", [
    (4, 1, 128, "rows"),      # qwen3_8b decode: 4 rows per (lane, kv head)
    (4, 32, 128, "tile"),     # qwen3_8b prefill chunk: 128 rows
    (4, 4, 128, "tile"),      # 16 rows fill one mma tile
    (1, 15, 128, "rows"),
    (1, 16, 64, "tile"),
    (4, 7, 16, "tile"),       # 28 rows: a ragged 64-row block
    (4, 32, 256, "rows"),     # gemma_2b's Dh: no tile instance
    (4, 32, 8, "rows"),
    (4, 32, 96, "rows"),
])
def test_kernel_variant(group, s, hd, want):
    assert kernel_variant(group, s, hd) == want


def test_variant_is_validated_before_dispatch():
    """The variant the wrapper hands the C entry is checked on every
    device, before the CPU tensors take the plain version."""
    args = _operands(4, b=2, s=4, h=4, kvh=2, hd=16, npages=6, page=4,
                     pmax=3, starts=[0, 5])
    tensors = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="variant must be one of"):
        paged_attention(*tensors, variant="tiles")
    narrow = [tensors[0][..., :8], tensors[1][..., :8], tensors[2][..., :8],
              *tensors[3:]]
    with pytest.raises(ValueError, match="tile instance takes Dh"):
        paged_attention(*narrow, variant="tile")
    want = paged_attention_ref(*tensors).numpy()
    for variant in VARIANTS:
        np.testing.assert_array_equal(
            paged_attention(*tensors, variant=variant).numpy(), want)
    assert VARIANTS.index("rows") == 0 and VARIANTS.index("tile") == 1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as `cvt.rna.tf32.f32` rounds: add half of the 13 dropped
    bits to the magnitude, then drop them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor, exact: bool):
    """x as big + small tf32 halves; a bf16 value (exact) is its own
    big half."""
    x = x.float()
    if exact:
        return x, torch.zeros_like(x)
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm3(a, b, a_exact=False, b_exact=False):
    """a @ b as the tile instance's 3xTF32 passes compute it: big.big +
    big.small + small.big, the products exact and summed in f64, then
    f32."""
    (ab, as_), (bb, bs) = _split(a, a_exact), _split(b, b_exact)
    ab, as_, bb, bs = (t.double() for t in (ab, as_, bb, bs))
    return (ab @ bb + ab @ bs + as_ @ bb).float()


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10                                  # tf32 ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23,
                      1 + 1.5 * ulp, 1 + ulp / 2 + 2**-23, 3.0, -0.0],
                     dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1 + ulp, 3.0, -0.0]
    assert _tf32(x).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    big = _tf32(r)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - big).abs() <= big.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("n", [8, 128, 2000])
def test_3xtf32_dot_is_f32_accurate(n):
    """The compensated split keeps a dot within 1e-6 of sum |a||b| of
    the f64 dot (plain tf32 keeps about 5e-4), at every depth."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((64, n)).astype(np.float32)
    b = rng.standard_normal((n, 16)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = _mm3(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    assert (np.abs(got - exact) <= 1e-6 * scale).all()
    one = (_tf32(torch.from_numpy(a)).double()
           @ _tf32(torch.from_numpy(b)).double()).numpy()
    assert np.abs(one - exact).max() > 1e-6 * scale.max()   # the need


def _tile_emulation(q, kp, vp, bt, pos, *, window=None, scale=None,
                    rows=64, keys=32, warp_rows=16, split=2):
    """The tile instance's algorithm in torch: blocks of 64 query rows
    of one (lane, kv head) in (position, head-in-group) order; a walk
    over [first row's p - window + 1, last row's p] in stages of 32 keys
    clipped to the table (the whole table when a row of the block keeps
    no key); each 16-row tile taken by `split` warps, each on its part
    of every stage, skipping a part none of its rows keeps a key of; an
    online softmax per warp with -1e30 masking and absent keys past the
    walk; the warps' (m, l, o) merged at the end; Q.K and P.V in
    3xTF32."""
    b, s, h, hd = q.shape
    n_pages, page, kvh, _ = kp.shape
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    q_exact = q.dtype == torch.bfloat16
    kv_exact = kp.dtype == torch.bfloat16
    table_end = bt.shape[1] * page - 1
    part_keys = keys // split
    out = torch.zeros((b, s, h, hd))
    for bi in range(b):
        for kh in range(kvh):
            qr = q[bi, :, kh * g:(kh + 1) * g].reshape(s * g, hd)
            pr = pos[bi].long().repeat_interleave(g)
            for r0 in range(0, s * g, rows):
                p_blk = pr[r0:r0 + rows]
                q_lo, q_hi = int(p_blk[0]), int(p_blk[-1])
                blind = bool(window) and q_hi - window + 1 > table_end
                t_begin = (max(0, q_lo - window + 1)
                           if window and not blind else 0)
                t_end = min(q_hi, table_end)
                for w0 in range(0, len(p_blk), warp_rows):
                    pw = p_blk[w0:w0 + warp_rows]
                    qw = qr[r0 + w0:r0 + w0 + len(pw)]
                    w_lo, w_hi = int(pw[0]), int(pw[-1])
                    w_blind = bool(window) and w_hi - window + 1 > table_end
                    states = []
                    for part in range(split):
                        m = torch.full((len(pw),), -1e30)
                        lsum = torch.zeros(len(pw))
                        o = torch.zeros((len(pw), hd))
                        for st in range(t_begin, t_end + 1, keys):
                            t0 = st + part * part_keys
                            if t0 > w_hi or t0 > t_end or (
                                    window and not w_blind
                                    and t0 + part_keys - 1 <= w_lo - window):
                                continue
                            t = torch.arange(t0, t0 + part_keys)
                            present = t <= t_end
                            tc = t.clamp(max=t_end)
                            pid = bt[bi, tc // page].long().clamp(
                                0, n_pages - 1)
                            kk = kp[pid, tc % page, kh] * present[:, None]
                            vv = vp[pid, tc % page, kh] * present[:, None]
                            sc = _mm3(qw, kk.T, q_exact, kv_exact) * scale
                            keep = present & (t[None] <= pw[:, None])
                            if window:
                                keep &= t[None] > pw[:, None] - window
                            sc = torch.where(keep, sc, torch.tensor(-1e30))
                            m_new = torch.maximum(m, sc.amax(1))
                            alpha = torch.exp(m - m_new)
                            p = torch.where(present,
                                            torch.exp(sc - m_new[:, None]),
                                            torch.tensor(0.0))
                            lsum = lsum * alpha + p.sum(1)
                            o = o * alpha[:, None] + _mm3(p, vv, False,
                                                          kv_exact)
                            m = m_new
                        states.append((m, lsum, o))
                    mm = torch.stack([st[0] for st in states]).amax(0)
                    lsum = sum(st[1] * torch.exp(st[0] - mm)
                               for st in states)
                    o = sum(st[2] * torch.exp(st[0] - mm)[:, None]
                            for st in states)
                    res = o / lsum.clamp(min=1e-30)[:, None]
                    for i in range(len(pw)):
                        row = r0 + w0 + i
                        out[bi, row // g, kh * g + row % g] = res[i]
    return out


def _chunk_operands(seed, *, s, window):
    """A prefill-chunk step at G 4, Dh 128, page 8: lane 0 mid-table,
    lane 1 at its first chunk, lane 2 idle (all-trash table, positions
    0), lane 3 a chunk that runs past its table (padding positions; with
    a window its last rows keep no key)."""
    b, h, kvh, hd, page, npages = 4, 8, 2, 128, 8, 24
    pmax = -(-(9 + s) // page) + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), np.float32)
    kp = rng.standard_normal((npages, page, kvh, hd), np.float32)
    vp = rng.standard_normal((npages, page, kvh, hd), np.float32)
    bt = np.zeros((b, pmax), np.int32)
    for lane, used in ((0, -(-(9 + s) // page)), (1, -(-s // page)),
                       (3, pmax)):
        bt[lane, :used] = rng.integers(1, npages, used)
    starts = [9, 0, 0, pmax * page - s // 2]
    pos = (np.asarray(starts, np.int32)[:, None]
           + np.arange(s, dtype=np.int32)[None])
    pos[2] = 0
    return q, kp, vp, bt, pos


def _rows_emulation(q, kp, vp, bt, pos, *, window=None, rows=16, keys=32,
                    walk_blind=True):
    """The rows instance's algorithm in torch (f32): blocks of 16 query
    rows of one (lane, kv head) in (position, head-in-group) order; a walk
    over [first row's p - window + 1, last row's p] clipped to the table
    in tiles of 32 keys, the whole table when a row of the block keeps no
    key (`walk_blind`; without it, the walk before the fix); an online
    softmax per row with -1e30 masking, keys past the table counting for
    no row."""
    b, s, h, hd = q.shape
    n_pages, page, kvh, _ = kp.shape
    g = h // kvh
    scale = hd ** -0.5
    table_end = bt.shape[1] * page - 1
    out = torch.zeros((b, s, h, hd))
    for bi in range(b):
        for kh in range(kvh):
            qr = q[bi, :, kh * g:(kh + 1) * g].reshape(s * g, hd).float()
            pr = pos[bi].long().repeat_interleave(g)
            for r0 in range(0, s * g, rows):
                p_blk = pr[r0:r0 + rows]
                q_lo, q_hi = int(p_blk[0]), int(p_blk[-1])
                blind = (walk_blind and bool(window)
                         and q_hi - window + 1 > table_end)
                t_begin = (max(0, q_lo - window + 1)
                           if window and not blind else 0)
                t_end = min(q_hi, table_end)
                m = torch.full((len(p_blk),), -1e30)
                lsum = torch.zeros(len(p_blk))
                o = torch.zeros((len(p_blk), hd))
                for t0 in range(t_begin, t_end + 1, keys):
                    t = torch.arange(t0, t0 + keys)
                    present = t <= t_end
                    tc = t.clamp(max=t_end)
                    pid = bt[bi, tc // page].long().clamp(0, n_pages - 1)
                    kk = kp[pid, tc % page, kh].float() * present[:, None]
                    vv = vp[pid, tc % page, kh].float() * present[:, None]
                    keep = present & (t[None] <= p_blk[:, None])
                    if window:
                        keep &= t[None] > p_blk[:, None] - window
                    sc = torch.where(keep, (qr[r0:r0 + rows] @ kk.T) * scale,
                                     torch.tensor(-1e30))
                    m_new = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp(m - m_new)
                    pexp = torch.exp(sc - m_new[:, None])
                    if walk_blind:
                        pexp = torch.where(present, pexp, torch.tensor(0.0))
                    lsum = lsum * alpha + pexp.sum(1)
                    o = o * alpha[:, None] + pexp @ vv
                    m = m_new
                res = o / lsum.clamp(min=1e-30)[:, None]
                for i in range(len(p_blk)):
                    row = r0 + i
                    out[bi, row // g, kh * g + row % g] = res[i]
    return out


def _keeps_a_key(pos, pmax, page, window):
    """(B, S) bool: the query keeps at least one kv position of its
    table."""
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return lo <= np.minimum(pos, pmax * page - 1)


@pytest.mark.parametrize("q_bf16", [False, True])
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("s", [7, 32])
def test_tile_emulation_matches_reference(s, window, q_bf16):
    """The tile instance's algorithm and arithmetic, emulated, within
    2e-4 (the card's bound on the kernel) of the plain version and of
    the JAX oracle on every row, and of the JAX Pallas kernel on every
    row that keeps a key. A row that keeps no key has no agreed value in
    the reference: the Pallas kernel averages V over the pages its lane
    visits, the oracle over the whole table; the port's plain version
    and the tile instance follow the oracle."""
    q, kp, vp, bt, pos = _chunk_operands(s * 7 + (window or 0), s=s,
                                         window=window)
    if q_bf16:
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    tq = torch.from_numpy(q)
    if q_bf16:
        tq = tq.to(torch.bfloat16)
    tk, tv, tb, tp = (torch.from_numpy(a) for a in (kp, vp, bt, pos))
    got = _tile_emulation(tq, tk, tv, tb, tp, window=window).numpy()
    plain = paged_attention_ref(tq, tk, tv, tb, tp, window=window).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, pos)]
    oracle = np.asarray(jax_paged_ref(*jargs, window=window))
    pallas = np.asarray(jax_paged(*jargs, window=window))
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, **tol)
    np.testing.assert_allclose(got, oracle, **tol)
    keeps = _keeps_a_key(pos, bt.shape[1], kp.shape[1], window)
    np.testing.assert_allclose(got[keeps], pallas[keeps], **tol)
    assert keeps[3].any() and (window is None) == keeps.all()


def test_tile_emulation_long_table():
    """2000 keys behind a 32-token chunk: the compensated products keep
    the error flat with depth (f32 pool, bf16 queries, as the engine)."""
    b, s, h, kvh, hd, page = 1, 32, 8, 2, 128, 16
    pmax = 2000 // page + 1
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd), np.float32)
                         ).to(torch.bfloat16)
    kp = torch.from_numpy(rng.standard_normal((pmax + 1, page, kvh, hd),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((pmax + 1, page, kvh, hd),
                                              np.float32))
    bt = torch.from_numpy(rng.permutation(pmax).astype(np.int32) + 1)[None]
    pos = torch.arange(2000 - s, 2000, dtype=torch.int32)[None]
    got = _tile_emulation(q, kp, vp, bt, pos)
    want = paged_attention_ref(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("s", [1, 7, 32])
def test_rows_emulation_matches_reference_on_every_row(s, window):
    """The rows instance's algorithm, emulated, within 2e-4 of the plain
    version and of the JAX oracle on every row, those that keep no key
    (lane 3 past its table, with a window) included: its block walks the
    whole table, as the tile instance does. The walk before that fix
    gave those rows zero or a partial mean."""
    q, kp, vp, bt, pos = _chunk_operands(s * 11 + (window or 0), s=s,
                                         window=window)
    tq, tk, tv, tb, tp = (torch.from_numpy(a) for a in (q, kp, vp, bt, pos))
    got = _rows_emulation(tq, tk, tv, tb, tp, window=window).numpy()
    plain = paged_attention_ref(tq, tk, tv, tb, tp, window=window).numpy()
    oracle = np.asarray(jax_paged_ref(*[jnp.asarray(a) for a in
                                        (q, kp, vp, bt, pos)],
                                      window=window))
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, **tol)
    np.testing.assert_allclose(got, oracle, **tol)
    keeps = _keeps_a_key(pos, bt.shape[1], kp.shape[1], window)
    before = _rows_emulation(tq, tk, tv, tb, tp, window=window,
                             walk_blind=False).numpy()
    np.testing.assert_allclose(before[keeps], plain[keeps], **tol)
    if not keeps.all():
        assert not np.allclose(before[~keeps], plain[~keeps], **tol)
