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
