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
from torch_one_thread import one_torch_thread  # noqa: E402,F401

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
    TILE_HEAD_DIMS,
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
    (BF16, F32, BF16, 1024, 256, "tile"),   # gemma_2b's D
    (BF16, BF16, None, 64, 96, "rows"),
    (BF16, BF16, None, 64, 8, "rows"),
    (BF16, F32, BF16, 1024, 112, "tile"),   # zamba2_7b's D
    (BF16, F32, BF16, 1, 112, "rows"),      # its decode steps
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
BLOCK_ROWS, WARP_ROWS = 128, 16


def _chunk(d: int) -> int:
    """Keys a chunk of the tile instance: 64, or 32 at D 256, where Q
    sits in shared memory beside the chunks."""
    return 32 if d > 128 else 64


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
    blocks of 128 query rows, each walking chunks of 64 keys (32 at D
    256, `_chunk`) from its first row's first tile to its last row's
    last; a chunk is loaded
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
    chunk = _chunk(d)
    scale = d ** -0.5 if scale is None else scale
    scale2 = torch.tensor(scale, dtype=F32) * torch.tensor(LOG2E, dtype=F32)
    kv_len = sk if kv_len is None else min(kv_len, sk)
    nk = -(-sk // bk)
    if kv_cast is not None:
        k, v = k.to(kv_cast), v.to(kv_cast)
    qf, kf, vf = (t.float() for t in (q, k, v))
    pad = chunk + bk                        # keys past Sk load as zeros
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
        return r[4] < r[5] and r[4] < c0 + chunk and r[5] > c0

    o = torch.zeros((b, hq, sq, d))
    lse = torch.zeros((b, hq, sq))
    nvis = torch.zeros((b, hq, sq))
    for r0 in range(0, sq, BLOCK_ROWS):
        rows = list(range(r0, min(r0 + BLOCK_ROWS, sq)))
        keys = [row_keys(r) for r in rows]
        c_begin = tile_range(rows[0] // bq)[0] * bk
        c_end = min((tile_range(rows[-1] // bq)[1] + 1) * bk, nk * bk)
        chunks = [c0 for c0 in range(c_begin, c_end, chunk)
                  if any(needs(r, c0) for r in keys)]
        for w0 in range(0, len(rows), WARP_ROWS):
            wk = keys[w0:w0 + WARP_ROWS]
            wr = torch.tensor(rows[w0:w0 + WARP_ROWS])
            mine = [c0 for c0 in chunks if any(needs(r, c0) for r in wk)]
            for r in wk:                      # the walk covers every need
                assert all(any(c0 <= c < c0 + chunk for c0 in mine)
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
                        c = torch.arange(c0, c0 + chunk)[None]
                        kk = kf[bi, h // g, c0:c0 + chunk]
                        vv = vf[bi, h // g, c0:c0 + chunk]
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
    # zamba2_7b's D 112 and gemma_2b's D 256 (32-key chunks): the static
    # prefill's layout cut down, a window with rows past kv_len, ragged
    # Sq over a shifted causal mask, a row block that keeps no key
    (130, 160, 112, "cast", True, None, 0, 130, (128, 128)),
    (130, 194, 112, "bf16", True, 16, "end", 150, (64, 16)),
    (130, 160, 256, "cast", True, None, 0, 130, (128, 128)),
    (130, 194, 256, "bf16", True, 1, "end", 150, (64, 16)),
    (33, 65, 256, "cast", True, 16, "end", None, (16, 32)),
    (100, 100, 256, "cast", True, None, "end", 0, (64, 64)),
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


# (D, G) of the configurations the card runs from chip_smoke phase 36 on:
# gemma_2b's D 256 at G 8, qwen3_14b's G 5 and deepseek_coder_33b's G 7
# at D 128
NEW_GEOMETRIES = [(256, 8), (128, 5), (128, 7)]
# (sq, sk, window, q_offset, kv_len, (bq, bk)): a causal prefill; a
# prefill whose later rows keep no key (window 3, kv_len 16); a decode row
# at the end of a 40-slot cache
NEW_CASES = [(64, 64, None, 0, None, (32, 32)),
             (32, 64, 3, 0, 16, (16, 16)),
             (1, 40, None, 39, None, (1, 8))]


@pytest.mark.parametrize("case", NEW_CASES,
                         ids=["prefill", "no_key_rows", "decode"])
@pytest.mark.parametrize("d,group", NEW_GEOMETRIES)
def test_new_geometries_match_the_pallas_kernel(d, group, case):
    """At each new (D, G): the port's wrapper (the plain version, on CPU
    tensors) within 2e-5 of the Pallas kernel in interpret mode on o and
    lse, block counts equal, f32 operands; the tile instance's algorithm
    (at D 256 in 32-key chunks), emulated on bf16 q over K/V rounded by
    kv_cast (the static path), within 2e-4 of the plain version, and
    `kernel_variant` sends a prefill there and a decode to rows."""
    sq, sk, window, q_offset, kv_len, (bq, bk) = case
    arrs = _qkv(d + group * 7 + sq, hq=2 * group, hkv=2, sq=sq, sk=sk, d=d)
    kw = dict(causal=True, window=window, kv_len=kv_len, q_offset=q_offset,
              bq=bq, bk=bk)
    jo, jl, jn = _jax_all(arrs, **kw)
    reset_launch_counts()
    to, tl, tn = flash_attention_all(*_torch(arrs), **kw)
    assert not launch_counts                      # CPU: the plain version
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    np.testing.assert_array_equal(tn.numpy(), jn)
    if window:                            # rows 19-31 keep no key
        assert (tl.numpy() < -1e29).any()
    want = "tile" if d in TILE_HEAD_DIMS and sq >= 16 else "rows"
    assert kernel_variant(BF16, torch.float32, BF16, sq, d) == want
    if d not in TILE_HEAD_DIMS:
        return
    q = torch.from_numpy(arrs[0]).to(BF16)
    k, v = (torch.from_numpy(a) for a in arrs[1:])
    got = _tile_emulation(q, k, v, kv_cast=BF16, **kw)
    plain = flash_attention_ref(q, k, v, kv_cast=BF16, **kw)
    for g, w in zip(got[:2], plain[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **EMU_TOL)
    np.testing.assert_array_equal(got[2].numpy(), plain[2].numpy())


# ---------------------------------------------------------------------------
# The rows instance's split path (decode steps): its algorithm emulated,
# and its plan
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    CARD_SMS,
    split_plan,
    split_takes,
)

SPLIT_KEYS, SPLIT_WARPS, SPLIT_ROUND = 8, 4, 32


def _merge_states(states):
    """(m, l, o) partials added in order as the kernel adds them (its
    warps, then its parts): M = max m_i, L = sum l_i e^(m_i - M), o =
    sum o_i e^(m_i - M) over the partials with l_i > 0."""
    m = torch.stack([s[0] for s in states]).amax(0)
    lsum, o = torch.zeros_like(m), torch.zeros_like(states[0][2])
    for mi, li, oi in states:
        w = torch.exp(mi - m)
        lsum = lsum + li * w
        o = o + torch.where((li > 0)[:, None], oi * w[:, None],
                            torch.tensor(0.0))
    return m, lsum, o


def _split_emulation(q, k, v, *, causal=True, window=None, kv_len=None,
                     q_offset=0, scale=None, bq=128, bk=128, kv_cast=None,
                     n_splits=None):
    """The split path's algorithm in torch (f32). Per (batch, kv head) a
    block of all R = G * Sq rows (row = position * G + head-in-group)
    walks the union of its rows' needed keys (a row that keeps a visited
    key needs the keys it keeps, one that keeps none all it visits), cut
    into n_splits parts (`split_plan`'s when None) of equal length
    rounded up to 32 keys; in a part, warp w takes chunks w, w + 4, ...
    of 8 keys with its own online softmax (a visited key the mask drops
    -1e30, an unvisited one or one past the part -inf); the warps' states
    merge in order, then the parts' (`_merge_states`). Returns (o, lse,
    nvis) as the plain version does."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kv_len = sk if kv_len is None else min(kv_len, sk)
    nk = -(-sk // bk)
    if kv_cast is not None:
        k, v = k.to(kv_cast), v.to(kv_cast)
    qf = q.float()
    pad = nk * bk + SPLIT_KEYS * SPLIT_WARPS - sk   # keys past Sk: zeros
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))

    def row_keys(s):
        qs = s // bq * bq + q_offset
        hi = min(nk - 1, (kv_len - 1) // bk)
        lo = 0
        if causal:
            hi = min(hi, (qs + bq - 1) // bk)
            if window is not None:
                lo = max(0, (qs - window - bk + 1) // bk + 1)
        v_lo, v_hi = (lo * bk, (hi + 1) * bk) if lo <= hi else (0, 0)
        k_lo, k_hi = -2**30, kv_len
        if causal:
            k_hi = min(k_hi, s + q_offset + 1)
            if window is not None:
                k_lo = s + q_offset - window + 1
        e_lo, e_hi = max(v_lo, k_lo), min(v_hi, k_hi)
        if e_lo >= e_hi:
            e_lo, e_hi = v_lo, v_hi
        return v_lo, v_hi, k_lo, k_hi, e_lo, e_hi

    keys = [row_keys(r // g) for r in range(g * sq)]
    needed = [kr for kr in keys if kr[4] < kr[5]]
    w0 = min((kr[4] for kr in needed), default=0)
    w1 = max((kr[5] for kr in needed), default=0)
    if n_splits is None:
        n_splits = split_plan(b, hkv, g * sq, d, kv_len)
    assert n_splits >= 1
    n = -(-(w1 - w0) // n_splits) if w1 > w0 else 0
    n = -(-n // SPLIT_ROUND) * SPLIT_ROUND
    parts = [(w0 + i * n, min(w0 + (i + 1) * n, w1)) for i in range(n_splits)]
    v_lo, v_hi, k_lo, k_hi = (torch.tensor([kr[i] for kr in keys])[:, None]
                              for i in range(4))
    rows = torch.arange(g * sq)
    o = torch.zeros((b, hq, sq, d))
    lse = torch.zeros((b, hq, sq))
    nvis = torch.zeros((b, hq, sq))
    for bi in range(b):
        for kh in range(hkv):
            qr = qf[bi, kh * g + rows % g, rows // g]          # (R, D)
            states = []
            for p0, p1 in parts:
                warps = []
                for w in range(SPLIT_WARPS if p0 < p1 else 1):
                    m = torch.full((g * sq,), -1e30)
                    lsum, acc = torch.zeros(g * sq), torch.zeros((g * sq, d))
                    for c0 in range(p0 + w * SPLIT_KEYS, p1,
                                    SPLIT_WARPS * SPLIT_KEYS):
                        c = torch.arange(c0, c0 + SPLIT_KEYS)[None]
                        kk = kf[bi, kh, c0:c0 + SPLIT_KEYS]
                        vv = vf[bi, kh, c0:c0 + SPLIT_KEYS]
                        x = (qr @ kk.T) * scale
                        x = torch.where((c >= k_lo) & (c < k_hi), x,
                                        torch.tensor(-1e30))
                        x = torch.where((c < p1) & (c >= v_lo) & (c < v_hi),
                                        x, torch.tensor(-torch.inf))
                        m_new = torch.maximum(m, x.amax(1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(x - m_new[:, None])
                        lsum = lsum * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ vv
                        m = m_new
                    warps.append((m, lsum, acc))
                states.append(_merge_states(warps))
            m, lsum, acc = _merge_states(states)
            lsum = lsum.clamp(min=1e-30)
            o[bi, kh * g + rows % g, rows // g] = acc / lsum[:, None]
            lse[bi, kh * g + rows % g, rows // g] = m + torch.log(lsum)
            nvis[bi, kh * g + rows % g, rows // g] = (
                (v_hi - v_lo) // bk)[:, 0].float()
    return o, lse, nvis


# (sq, sk, d, G, window, q_offset, kv_len, (bq, bk)); q_offset a multiple
# of bq, so the Pallas kernel (no query offset) runs the same function
SPLIT_CASES = [
    (1, 200, 16, 4, None, 192, 193, (8, 16)),    # a decode step at the end
    (1, 200, 16, 1, 40, 192, None, (8, 16)),     # its window starts inside
    #                                              a part
    (1, 200, 16, 4, 3, 152, 140, (8, 64)),       # its visited tile keeps
    #                                              no key
    (1, 64, 16, 4, None, 40, 0, (8, 16)),        # it visits no tile
    (4, 200, 32, 4, 5, 196, None, (4, 16)),      # 16 rows: parts that hold
    #                                              no key of the first rows
    (8, 120, 64, 2, None, 96, 100, (8, 32)),     # rows past kv_len
    (1, 130, 16, 1, None, 128, None, (8, 64)),   # Sk not a tile multiple
]


@pytest.mark.parametrize("n_splits", [1, 2, 3, None])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"case{i}" for i in range(len(SPLIT_CASES))])
def test_split_emulation_matches_the_plain_version_and_pallas(case,
                                                               n_splits):
    """The split path's algorithm, emulated (f32 operands, B 2, 2 KV
    heads), within 2e-4 (the card's bound on the kernel) of the plain
    version and of the Pallas kernel in interpret mode on o and lse,
    block counts equal, at forced part counts and at the plan's."""
    sq, sk, d, group, window, q_offset, kv_len, (bq, bk) = case
    arrs = _qkv(sq * 5 + sk + d + group, b=2, hq=2 * group, hkv=2, sq=sq,
                sk=sk, d=d)
    kw = dict(causal=True, window=window, kv_len=kv_len, q_offset=q_offset,
              bq=bq, bk=bk)
    got = _split_emulation(*_torch(arrs), n_splits=n_splits, **kw)
    want = flash_attention_ref(*_torch(arrs), **kw)
    for g_, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), **EMU_TOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    jo, jl, jn = _jax_all(arrs, **kw)
    np.testing.assert_allclose(got[0].numpy(), jo, **EMU_TOL)
    np.testing.assert_allclose(got[1].numpy(), jl, **EMU_TOL)
    np.testing.assert_array_equal(got[2].numpy(), jn)


def test_split_emulation_rounds_a_cast_cache():
    """bf16 q over an f32 cache rounded by kv_cast (the static decode):
    the emulation within 2e-4 of the plain version over 2 parts."""
    arrs = _qkv(11, b=2, hq=8, hkv=2, sq=1, sk=300, d=32)
    q = torch.from_numpy(arrs[0]).to(BF16)
    k, v = (torch.from_numpy(a) for a in arrs[1:])
    kw = dict(kv_len=290, q_offset=289, bq=8, bk=128, kv_cast=BF16)
    got = _split_emulation(q, k, v, n_splits=2, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), **EMU_TOL)


# (B, KV, G, Sq, D, kv_len, the plan's count) at every shape chip_smoke
# phases 4 and 4b-4e time: the static decode of qwen3_8b (G 4),
# qwen2_moe_a2_7b (G 1, 16 KV heads), zamba2_7b and musicgen_large (32
# KV heads, D 112 and 64: the grid fills the card), internvl2_1b (G 7, D
# 64, its 256-token prefix), gemma_2b (MQA, D 256), qwen3_14b (G 5),
# deepseek_coder_33b (G 7); their prefills are not the split path's (0)
FLASH_PLAN_CASES = [
    (8, 8, 4, 1, 128, 1041, 3), (8, 16, 1, 1, 128, 1041, 2),
    (8, 32, 1, 1, 112, 1041, 1), (8, 32, 1, 1, 64, 1041, 1),
    (8, 2, 7, 1, 64, 1297, 9), (8, 1, 8, 1, 256, 1041, 17),
    (8, 8, 5, 1, 128, 1041, 3), (8, 8, 7, 1, 128, 1041, 3),
    (8, 8, 4, 1024, 128, 1024, 0), (8, 32, 1, 1024, 112, 1024, 0),
    (8, 2, 7, 1280, 64, 1280, 0), (8, 1, 8, 1024, 256, 1024, 0)]


@pytest.mark.parametrize("b,kvh,group,sq,d,kv_len,want", FLASH_PLAN_CASES)
def test_split_plan_at_the_timed_shapes(b, kvh, group, sq, d, kv_len, want):
    """The plan from shapes and host ints alone (the same count from the
    shape of meta tensors, the dry run's): the grid fills the card's SMs
    at least once where it can, each part at least 32 keys long; 1 where
    the grid already fills the card."""
    q = torch.empty((b, kvh * group, sq, d), device="meta")
    n = split_plan(q.shape[0], kvh, q.shape[1] // kvh * q.shape[2],
                   q.shape[3], kv_len)
    assert n == want and type(n) is int
    assert (want > 0) == split_takes(group * sq, d)
    if want:
        assert b * kvh * want >= CARD_SMS or want == kv_len // 32
        assert b * kvh * (want - 1) < CARD_SMS


def test_the_splits_argument_is_validated_before_dispatch():
    """`splits` is checked on every device: 0 (the walk of many rows)
    anywhere the rows instance runs, n >= 1 only where the split path
    takes the call, never beside the tile instance; on the CPU every path
    gives the plain version, and on meta tensors the outputs' shapes."""
    q, k, v = _torch(_qkv(9, sq=1, sk=40, d=16))
    want = flash_attention_ref(q, k, v, q_offset=39)
    for splits in (None, 0, 1, 3):
        got = flash_attention_all(q, k, v, q_offset=39, splits=splits)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), w_.numpy())
    for splits, kw in ((-1, {}), (1.5, {}), (1, dict(variant="tile"))):
        with pytest.raises(ValueError, match="splits"):
            flash_attention_all(q.to(BF16), k.to(BF16), v.to(BF16),
                                splits=splits, **kw)
    q17, k17, v17 = _torch(_qkv(9, sq=17, sk=40, d=16, hq=2, hkv=2))
    with pytest.raises(ValueError, match="splits"):
        flash_attention_all(q17, k17, v17, splits=1)
    assert flash_attention_all(q17, k17, v17, splits=0)[0].shape == q17.shape
    meta = [t.to("meta") for t in (q, k, v)]
    assert flash_attention_all(*meta, splits=2)[0].shape == q.shape
