"""The port's flash-attention wrappers and plain version against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

The same numpy inputs go through `repro.kernels.flash_attention` and
`repro_torch.kernels.flash_attention` (whose wrapper runs
`flash_attention_ref` for CPU tensors). o and lse agree within
rtol=atol=2e-5 (f32 sums in another order; the masked rows' -1e30
values agree exactly), and the visited-block counts are equal, for
the same (bq, bk). Cases: causal with Sq < Sk (the kernel's top-left
alignment), sliding windows, a key length short of Sk (rows that see
no key), GQA, bf16 inputs, ragged lengths through `ops`, and the
query offset that gives `attention_ref`'s bottom-right alignment.

The kernel's two instances: which one a call takes (`kernel_variant`),
the check of a forced `variant`, and the tile instance's algorithm and
arithmetic (bf16 passes, P split hi/lo, its masks and chunk skips)
emulated in torch and held within 2e-4 of the plain version and of the
Pallas kernel, block counts equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_kernel as jkernel  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_block_counts as jcounts,
)
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_attention_all,
    flash_attention_block_counts,
    flash_attention_kernel,
    flash_attention_ref,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, *, b=1, hq=4, hkv=2, sq=16, sk=16, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                               (b, hkv, sk, d)))


def _jax(arrs, bf16=False):
    return tuple(jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
                 for a in arrs)


def _torch(arrs, bf16=False):
    return tuple(torch.from_numpy(a).to(torch.bfloat16 if bf16
                                        else torch.float32) for a in arrs)


# (sq, sk, bq, bk, causal, window, kv_len, hq, hkv)
KERNEL_CASES = [
    (8, 24, 8, 8, True, None, None, 4, 2),     # Sq < Sk, top-left
    (16, 16, 4, 4, True, None, None, 4, 4),    # MHA, causal skip
    (32, 32, 4, 4, True, 4, None, 4, 2),       # two-sided window skip
    (16, 32, 8, 4, True, 1, None, 4, 1),       # MQA, window 1
    (16, 32, 8, 16, True, 3, 20, 4, 2),        # kv_len inside a tile
    (8, 16, 4, 4, True, 2, 3, 4, 2),           # rows that see no key
    (8, 16, 4, 4, False, None, 6, 4, 2),       # non-causal, kv_len
    (16, 48, 16, 16, False, None, None, 8, 2),
    (8, 8, 8, 8, True, 100, None, 4, 2),       # window wider than Sk
    (16, 24, 8, 8, True, None, 0, 4, 2),       # kv_len 0: nothing kept
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[f"case{i}" for i in range(len(KERNEL_CASES))])
def test_kernel_entries_match_the_pallas_kernel(case, bf16):
    sq, sk, bq, bk, causal, window, kv_len, hq, hkv = case
    arrs = _qkv(sq * 31 + sk, hq=hq, hkv=hkv, sq=sq, sk=sk)
    kw = dict(causal=causal, window=window, kv_len=kv_len, bq=bq, bk=bk)
    jo, jl = jkernel(*_jax(arrs, bf16), interpret=True, **kw)
    jn = jcounts(*_jax(arrs, bf16), interpret=True, **kw)
    reset_launch_counts()
    to, tl = flash_attention_kernel(*_torch(arrs, bf16), **kw)
    tn = flash_attention_block_counts(*_torch(arrs, bf16), **kw)
    assert not launch_counts                      # CPU: the plain version
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # the plain version, called directly, is the same function
    po, pl, pn = flash_attention_ref(*_torch(arrs, bf16), **kw)
    np.testing.assert_array_equal(po.numpy(), to.numpy())
    np.testing.assert_array_equal(pl.numpy(), tl.numpy())
    np.testing.assert_array_equal(pn.numpy(), tn.numpy())


def test_causal_mask_is_top_left_at_offset_zero():
    """Sq = 8 < Sk = 24, causal: the kernel keeps key c <= row r (the
    Pallas kernel's `rows >= cols`), which is not `attention_ref`'s
    bottom-right alignment; q_offset = Sk - Sq is."""
    arrs = _qkv(0, sq=8, sk=24)
    jo, _ = jkernel(*_jax(arrs), bq=8, bk=8, interpret=True)
    to, _ = flash_attention_kernel(*_torch(arrs), bq=8, bk=8)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    bottom_right, _ = jattention_ref(*_jax(arrs))
    assert np.abs(to.numpy() - np.asarray(bottom_right)).max() > 0.1
    shifted, _ = flash_attention_kernel(*_torch(arrs), bq=8, bk=8,
                                        q_offset=16)
    np.testing.assert_allclose(shifted.numpy(), np.asarray(bottom_right),
                               **TOL)


@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("sq,sk", [(8, 24), (5, 13), (16, 16), (1, 40)])
def test_offset_sk_minus_sq_matches_attention_ref(sq, sk, window):
    arrs = _qkv(sq + sk, sq=sq, sk=sk)
    jo, jl = jattention_ref(*_jax(arrs), causal=True, window=window)
    to, tl = flash_attention(*_torch(arrs), causal=True, window=window,
                             q_offset=sk - sq, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 3)])
@pytest.mark.parametrize("sq,sk", [(5, 13), (5, 97), (24, 24), (33, 130),
                                   (200, 200)])
def test_ops_matches_the_reference_ops(sq, sk, causal, window):
    """Ragged lengths: the reference pads Q/K/V and masks the padded
    keys; the port treats the ragged edge as padding without a copy."""
    arrs = _qkv(sq * 7 + sk, hq=4, hkv=2, sq=sq, sk=sk)
    jo, jl = jflash(*_jax(arrs), causal=causal, window=window,
                    return_lse=True, interpret=True)
    to, tl = flash_attention(*_torch(arrs), causal=causal, window=window,
                             return_lse=True)
    assert to.shape == jo.shape and tl.shape == jl.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_ops_bf16_inputs_match_the_reference_ops():
    arrs = _qkv(10, b=2, hq=8, hkv=2, sq=40, sk=72, d=16)
    jo = jflash(*_jax(arrs, bf16=True), causal=True, interpret=True)
    to = flash_attention(*_torch(arrs, bf16=True), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo, np.float32), **TOL)


def test_attention_ref_copy_matches_the_reference():
    for causal, window in ((True, None), (True, 4), (False, None)):
        arrs = _qkv(12, hq=6, hkv=3, sq=10, sk=19)
        jo, jl = jattention_ref(*_jax(arrs), causal=causal, window=window)
        to, tl = attention_ref(*_torch(arrs), causal=causal, window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_kv_cast_rounds_keys_and_values_first():
    """kv_cast=bf16 on f32 K/V is the reference's `ck.astype(bf16)`
    before the attention: the same as passing the rounded K/V."""
    q, k, v = _torch(_qkv(13, sq=6, sk=20))
    got = flash_attention(q, k, v, q_offset=9, kv_len=15,
                          kv_cast=torch.bfloat16)
    want = flash_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                           q_offset=9, kv_len=15)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, flash_attention(q, k, v, q_offset=9,
                                                kv_len=15))


def test_decode_row_matches_a_sliced_cache():
    """A decode step: one query at cache index 12 over a 20-slot cache
    with kv_len 13 equals attention over the first 13 keys."""
    q, k, v = _torch(_qkv(14, sq=1, sk=20))
    o, lse, nvis = flash_attention_all(q, k, v, q_offset=12, kv_len=13,
                                       bq=8, bk=8)
    want_o, want_lse = attention_ref(q, k[:, :, :13], v[:, :, :13],
                                     causal=False)
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL)
    assert (nvis == 2).all()                      # tiles 0-7 and 8-15


def test_window_requires_causal_raises_as_the_reference():
    arrs = _qkv(1)
    with pytest.raises(ValueError) as want:
        jflash(*_jax(arrs), causal=False, window=4, interpret=True)
    for fn in (flash_attention, flash_attention_kernel,
               flash_attention_block_counts, flash_attention_all):
        with pytest.raises(ValueError) as got:
            fn(*_torch(arrs), causal=False, window=4, bq=8, bk=8)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jattention_ref(*_jax(arrs), causal=False, window=4)
    with pytest.raises(ValueError) as got:
        attention_ref(*_torch(arrs), causal=False, window=4)
    assert str(got.value) == str(want.value)


def test_window_below_one_raises_as_the_reference():
    arrs = _qkv(2)
    with pytest.raises(ValueError) as want:
        jkernel(*_jax(arrs), window=0, bq=8, bk=8, interpret=True)
    with pytest.raises(ValueError) as got:
        flash_attention_kernel(*_torch(arrs), window=0, bq=8, bk=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,match", [
    (dict(bq=6), "multiples"),                    # Sq 16 % 6
    (dict(bk=5), "multiples"),
    (dict(kv_len=-1), "kv_len"),
])
def test_kernel_entry_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        flash_attention_kernel(*_torch(_qkv(3)), **{"bq": 8, "bk": 8, **kw})


def test_head_counts_must_divide():
    q, k, v = _torch(_qkv(4, hq=6, hkv=4))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention(q, k, v)


def test_non_cpu_tensors_never_take_the_plain_version():
    """Dispatch is by device: anything but all-CPU operands goes to the
    kernel path, which refuses operands split across devices."""
    q, k, v = _torch(_qkv(5))
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# The kernel's two instances: the choice, the validation, and the tile
# instance's algorithm and arithmetic (bf16 tensor cores) emulated here
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    VARIANTS,
    kernel_variant,
)

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("q_dt,kv_dt,kv_cast,sq,d,want", [
    (BF16, F32, BF16, 1024, 128, "tile"),   # the static prefill
    (BF16, F32, BF16, 1, 128, "rows"),      # its decode steps
    (BF16, F32, BF16, 15, 128, "rows"),     # short of a 16-row mma tile
    (BF16, F32, BF16, 16, 64, "tile"),
    (BF16, BF16, None, 33, 32, "tile"),     # bf16 K/V need no cast
    (BF16, BF16, F32, 33, 16, "tile"),      # widening keeps bf16 values
    (BF16, F32, None, 1024, 128, "rows"),   # f32 K/V: products not exact
    (BF16, F32, F32, 1024, 128, "rows"),
    (F32, F32, F32, 256, 128, "rows"),      # the f32 static path
    (F32, BF16, None, 256, 128, "rows"),    # f32 q
    (BF16, F32, BF16, 1024, 256, "rows"),   # gemma_2b's D: no tile
    (BF16, BF16, None, 64, 96, "rows"),
    (BF16, BF16, None, 64, 8, "rows"),
])
def test_kernel_variant(q_dt, kv_dt, kv_cast, sq, d, want):
    assert kernel_variant(q_dt, kv_dt, kv_cast, sq, d) == want


def test_variant_is_validated_before_dispatch():
    """The variant the wrapper hands the C entry is checked on every
    device, before the CPU tensors take the plain version: a forced
    "tile" on operands it does not compute exactly raises."""
    q, k, v = _torch(_qkv(6, sq=16, sk=24, d=16))
    qb, kb, vb = (t.to(BF16) for t in (q, k, v))
    with pytest.raises(ValueError, match="variant must be one of"):
        flash_attention_all(qb, kb, vb, variant="tiles")
    for args, kw in (((q, kb, vb), {}),                   # f32 q
                     ((qb, k, v), {}),                    # f32 K/V
                     ((qb, k, v), dict(kv_cast=F32)),
                     ((qb[..., :8], kb[..., :8], vb[..., :8]), {})):  # D 8
        with pytest.raises(ValueError, match="tile instance takes"):
            flash_attention_all(*args, variant="tile", **kw)
    want = flash_attention_ref(qb, k, v, kv_cast=BF16)
    for variant in VARIANTS:
        got = flash_attention_all(qb, k, v, kv_cast=BF16, variant=variant)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert VARIANTS.index("rows") == 0 and VARIANTS.index("tile") == 1


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG2 = np.float32(-1e30 * LOG2E)      # -1e30 in base 2, as the kernel
CHUNK, BLOCK_ROWS, WARP_ROWS = 64, 128, 16


def _split_p(p: torch.Tensor):
    """p = hi + lo as the tile instance splits P for its two bf16 P.V
    passes: hi = bf16(p), lo = bf16(p - hi), both to nearest even."""
    hi = p.to(BF16).float()
    return hi, (p - hi).to(BF16).float()


def test_p_split_keeps_sixteen_bits():
    """|p - hi - lo| <= 2^-16 p over [2^-118, 1] (p = exp2 of a score
    less its row max); below, where lo is a bf16 subnormal, the error is
    at most half its spacing, 2^-134, nothing beside a row sum of at
    least 1. One bf16 pass alone keeps 8 bits."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(0, 1, 100_000),
                        np.exp2(-rng.uniform(0, 149, 100_000)),
                        [0.0, 1.0, 2.0**-118, 2.0**-126, 1 - 2.0**-24]])
    p = torch.from_numpy(x.astype(np.float32))
    hi, lo = _split_p(p)
    err = (p.double() - hi.double() - lo.double()).abs()
    normal = p.double() >= 2.0**-118
    assert (err[normal] <= 2.0**-16 * p.double()[normal]).all()
    assert (err[~normal] <= 2.0**-134).all()
    assert ((p.double() - hi.double()).abs() > 2.0**-16 * p.double()).any()


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16-valued f32 operands as the tensor cores form it:
    every product exact, the sum in f32 (here in f64, then rounded)."""
    assert torch.equal(a, a.to(BF16).float())
    assert torch.equal(b, b.to(BF16).float())
    return (a.double() @ b.double()).float()


def _tile_emulation(q, k, v, *, causal=True, window=None, kv_len=None,
                    q_offset=0, scale=None, bq=128, bk=128, kv_cast=None):
    """The tile instance's algorithm in torch. Per (batch, query head):
    blocks of 128 query rows, each walking chunks of 64 keys from its
    first row's first tile to its last row's last; a chunk is loaded
    when a row of the block needs it and taken by each warp of 16 rows
    that has such a row. A row needs the chunks that hold a key it keeps
    among those it visits, or, keeping none, every visited one. Q.K is
    one bf16 pass, scores scaled into base 2, a visited key it does not
    keep -1e30 (in base 2) and an unvisited one -inf, the online softmax
    per warp, P.V two bf16 passes of P = hi + lo; l clamped at 1e-30.
    Asserts that every row's walk covers the keys it needs. Returns (o,
    lse, nvis) as the plain version does."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    scale2 = torch.tensor(scale, dtype=F32) * torch.tensor(LOG2E, dtype=F32)
    kv_len = sk if kv_len is None else min(kv_len, sk)
    nk = -(-sk // bk)
    if kv_cast is not None:
        k, v = k.to(kv_cast), v.to(kv_cast)
    qf, kf, vf = (t.float() for t in (q, k, v))
    pad = CHUNK + bk                        # keys past Sk load as zeros
    kf = torch.nn.functional.pad(kf, (0, 0, 0, nk * bk + pad - sk))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, nk * bk + pad - sk))

    def tile_range(qi):
        qs = qi * bq + q_offset
        hi = min(nk - 1, (kv_len - 1) // bk)
        lo = 0
        if causal:
            hi = min(hi, (qs + bq - 1) // bk)
            if window is not None:
                lo = max(0, (qs - window - bk + 1) // bk + 1)
        return lo, hi

    def row_keys(row):
        lo, hi = tile_range(row // bq)
        v_lo, v_hi = (lo * bk, (hi + 1) * bk) if lo <= hi else (0, 0)
        pos = row + q_offset
        k_lo, k_hi = -2**30, kv_len
        if causal:
            k_hi = min(k_hi, pos + 1)
            if window is not None:
                k_lo = pos - window + 1
        e_lo, e_hi = max(v_lo, k_lo), min(v_hi, k_hi)
        if e_lo >= e_hi:
            e_lo, e_hi = v_lo, v_hi
        return v_lo, v_hi, k_lo, k_hi, e_lo, e_hi

    def needs(r, c0):
        return r[4] < r[5] and r[4] < c0 + CHUNK and r[5] > c0

    o = torch.zeros((b, hq, sq, d))
    lse = torch.zeros((b, hq, sq))
    nvis = torch.zeros((b, hq, sq))
    for r0 in range(0, sq, BLOCK_ROWS):
        rows = list(range(r0, min(r0 + BLOCK_ROWS, sq)))
        keys = [row_keys(r) for r in rows]
        c_begin = tile_range(rows[0] // bq)[0] * bk
        c_end = min((tile_range(rows[-1] // bq)[1] + 1) * bk, nk * bk)
        chunks = [c0 for c0 in range(c_begin, c_end, CHUNK)
                  if any(needs(r, c0) for r in keys)]
        for w0 in range(0, len(rows), WARP_ROWS):
            wk = keys[w0:w0 + WARP_ROWS]
            wr = torch.tensor(rows[w0:w0 + WARP_ROWS])
            mine = [c0 for c0 in chunks if any(needs(r, c0) for r in wk)]
            for r in wk:                      # the walk covers every need
                assert all(any(c0 <= c < c0 + CHUNK for c0 in mine)
                           for c in range(r[4], r[5]))
            v_lo, v_hi, k_lo, k_hi = (torch.tensor([r[i] for r in wk])[:, None]
                                      for i in range(4))
            for bi in range(b):
                for h in range(hq):
                    qw = qf[bi, h, wr]
                    m = torch.full((len(wr),), NEG2, dtype=F32)
                    lsum = torch.zeros(len(wr))
                    acc = torch.zeros((len(wr), d))
                    for c0 in mine:
                        c = torch.arange(c0, c0 + CHUNK)[None]
                        kk = kf[bi, h // g, c0:c0 + CHUNK]
                        vv = vf[bi, h // g, c0:c0 + CHUNK]
                        x = _mm_bf16(qw, kk.T) * scale2
                        x = torch.where((c >= k_lo) & (c < k_hi), x,
                                        torch.tensor(NEG2))
                        x = torch.where((c >= v_lo) & (c < v_hi), x,
                                        torch.tensor(-torch.inf))
                        m_new = torch.maximum(m, x.amax(1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new[:, None])
                        lsum = lsum * alpha + p.sum(1)
                        hi, lo = _split_p(p)
                        acc = acc * alpha[:, None] + (_mm_bf16(hi, vv)
                                                      + _mm_bf16(lo, vv))
                        m = m_new
                    lsum = lsum.clamp(min=1e-30)
                    o[bi, h, wr] = acc / lsum[:, None]
                    lse[bi, h, wr] = m * LN2 + torch.log(lsum)
                    nvis[bi, h, wr] = ((v_hi - v_lo) // bk)[:, 0].float()
    return o, lse, nvis


def _jax_all(arrs, *, causal, window, kv_len, q_offset, bq, bk):
    """The Pallas kernel (interpret mode) on the same function: it has no
    query offset and takes block multiples, so q gets q_offset (a
    multiple of bq) leading zero rows and the ragged edges zeros, the
    padded keys masked by kv_len; the padding is sliced off again."""
    q, k, v = arrs
    sq, sk = q.shape[2], k.shape[2]
    assert q_offset % bq == 0
    rows = -(-(q_offset + sq) // bq) * bq
    qp = np.zeros(q.shape[:2] + (rows, q.shape[3]), np.float32)
    qp[:, :, q_offset:q_offset + sq] = q
    keys = -(-sk // bk) * bk
    kp, vp = (np.pad(t, ((0, 0), (0, 0), (0, keys - sk), (0, 0)))
              for t in (k, v))
    kw = dict(causal=causal, window=window, bq=bq, bk=bk, interpret=True,
              kv_len=sk if kv_len is None else min(kv_len, sk))
    jo, jl = jkernel(*_jax((qp, kp, vp)), **kw)
    jn = jcounts(*_jax((qp, kp, vp)), **kw)
    cut = slice(q_offset, q_offset + sq)
    return (np.asarray(jo)[:, :, cut], np.asarray(jl)[:, :, cut],
            np.asarray(jn)[:, :, cut])


EMU_TOL = dict(rtol=2e-4, atol=2e-4)
# (sq, sk, d, kv: "bf16" or "cast" (f32 rounded by kv_cast), causal,
#  window, q_offset: 0 or "end" (Sk - Sq), kv_len, (bq, bk))
TILE_CASES = [
    (64, 64, 128, "bf16", True, None, 0, None, (64, 64)),
    (130, 130, 64, "cast", True, None, 0, None, (128, 128)),   # ragged Sq
    (33, 65, 128, "cast", True, 16, "end", None, (16, 32)),
    (130, 194, 64, "bf16", True, 1, "end", 150, (64, 16)),     # rows past
    #                                         kv_len keep no key
    (33, 40, 64, "cast", True, 1, 0, 20, (8, 8)),
    (130, 130, 128, "bf16", True, 16, 0, 100, (32, 128)),
    (130, 160, 128, "cast", True, None, 0, 130, (128, 128)),   # the static
    #                                         prefill's layout, cut down
    (33, 70, 64, "bf16", False, None, 0, 50, (16, 32)),
    (100, 100, 128, "cast", True, None, "end", 0, (64, 64)),   # no key
]


@pytest.mark.parametrize("case", TILE_CASES,
                         ids=[f"case{i}" for i in range(len(TILE_CASES))])
def test_tile_emulation_matches_the_plain_version_and_pallas(case):
    """The tile instance's algorithm and arithmetic, emulated at the
    block level (G 4, bf16 q), within 2e-4 of the plain version and of
    the Pallas kernel in interpret mode, block counts equal."""
    sq, sk, d, kv, causal, window, q_offset, kv_len, (bq, bk) = case
    q_offset = sk - sq if q_offset == "end" else q_offset
    arrs = _qkv(sq * 3 + sk + d, hq=8, hkv=2, sq=sq, sk=sk, d=d)
    q = torch.from_numpy(arrs[0]).to(BF16)
    k, v = (torch.from_numpy(a) for a in arrs[1:])
    kv_cast = BF16 if kv == "cast" else None
    if kv == "bf16":
        k, v = k.to(BF16), v.to(BF16)
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset,
              bq=bq, bk=bk)
    got = _tile_emulation(q, k, v, kv_cast=kv_cast, **kw)
    want = flash_attention_ref(q, k, v, kv_cast=kv_cast, **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **EMU_TOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    jarrs = (q.float().numpy(), k.to(BF16).float().numpy(),
             v.to(BF16).float().numpy())
    jo, jl, jn = _jax_all(jarrs, **kw)
    np.testing.assert_allclose(got[0].numpy(), jo, **EMU_TOL)
    np.testing.assert_allclose(got[1].numpy(), jl, **EMU_TOL)
    np.testing.assert_array_equal(got[2].numpy(), jn)
