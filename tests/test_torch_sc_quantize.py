"""sc_quantize, the int8 quantization in front of the ARTEMIS MAC
(`repro_torch.kernels.sc_matmul.quantize`), against the JAX package.

The kernel runs only on the card, where `chip_smoke.py` holds it bit for
bit against its plain version. Here, with numpy-seeded inputs:

- the plain entry (`quantize_int8` on CPU tensors) against
  `repro.core.quantization`'s `quant_scale` and `quantize` on the f32 of
  the input, bit for bit: per tensor, per lane (3-D and 4-D), per row,
  per column, a given absmax (a part of a tensor scaled by the whole
  tensor's), bf16 and f32 inputs, an all-zero group and exact .5 ties;
- a torch restatement of the kernel's arithmetic (chunk maxima of the
  bits of |x| as integers, the scale from their max, then a true
  division an element) against the plain version, NaN and inf included,
  at the chunking the plan gives;
- `artemis_matmul` in every quantized mode, with and without the
  straight-through estimator, outputs and gradients against the
  reference (`jax.grad`);
- the dispatch: CPU runs the plain version and launches nothing, meta
  gives shapes only, a CUDA call the kernel does not take raises before
  a plan is made;
- the host path: the C entry's argument block (the ctypes mirror field
  for field against the struct parsed from the `.cu`, a library of
  another block size refused) and what a plan writes into it, with the C
  entry replaced by a recorder.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_kernel_launch import _c_struct, _Recorder  # noqa: E402

from repro import core as J  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sc_matmul import quantize as qmod  # noqa: E402
from repro_torch.kernels.sc_matmul import (  # noqa: E402
    quantize_int8,
    quantize_int8_ref,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ref(x, axis=None):
    """The reference's (q, scale) of the f32 array x."""
    s = J.quant_scale(jnp.asarray(x), 8, axis)
    return np.asarray(J.quantize(jnp.asarray(x), s)), np.asarray(s)


def _bf16(x):
    """x rounded to bf16: the torch tensor and its exact f32 values."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, t.float().numpy()


def _bits_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# the plain entry against the reference
# ---------------------------------------------------------------------------

GROUPINGS = [((6, 40), None), ((6, 40), -1), ((6, 40), 0), ((4, 3, 40), (1, 2)),
             ((4, 3, 5, 16), (1, 2, 3)), ((4, 3, 40), -1), ((7, 1, 33), (1, 2))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", GROUPINGS, ids=str)
def test_plain_entry_matches_reference(shape, axis, dtype):
    x = _x(len(shape) * 10 + shape[-1], shape)
    t = torch.from_numpy(x)
    if dtype == "bf16":
        t, x = _bf16(x)
    q, s = quantize_int8(t, axis)
    want_q, want_s = _ref(x, axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == want_s.shape == qmod.scale_shape(shape, axis)
    np.testing.assert_array_equal(q.numpy(), want_q)
    _bits_equal(s.numpy(), want_s)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_given_absmax_scales_a_part_as_the_whole(dtype):
    """A rank's part of a tensor, given the whole tensor's absmax, takes
    the whole tensor's scale and int8 values (the reference quantizes
    the whole tensor)."""
    x = _x(3, (8, 64))
    if dtype == "bf16":
        _, x = _bf16(x)
    want_q, want_s = _ref(x)
    whole = torch.tensor(np.abs(x).max())
    for part in (slice(0, 32), slice(32, 64)):
        t = torch.from_numpy(np.ascontiguousarray(x[:, part]))
        if dtype == "bf16":
            t = t.to(torch.bfloat16)
        # a given absmax makes the scale per tensor whatever axis says
        for axis in (None, -1):
            q, s = quantize_int8(t, axis, whole)
            assert tuple(s.shape) == (1, 1)
            np.testing.assert_array_equal(q.numpy(), want_q[:, part])
            _bits_equal(s.numpy(), want_s)


def test_zero_groups_and_exact_ties():
    """An all-zero row takes the 1e-8 floor and quantizes to zeros; values
    on exact .5 steps round half to even."""
    x = np.zeros((4, 512), np.float32)
    steps = np.arange(-127, 128, dtype=np.float32)
    x[1, :255] = steps
    x[1, 255:509] = steps[:-1] + 0.5
    x[2] = x[1] / 4                      # scale 127 / 4 / 127: ties again
    x[3, :3] = (0.5, -0.5, 1.5)
    for axis in (-1, None):
        q, s = quantize_int8(torch.from_numpy(x), axis)
        want_q, want_s = _ref(x, axis)
        np.testing.assert_array_equal(q.numpy(), want_q)
        _bits_equal(s.numpy(), want_s)
    q, s = quantize_int8(torch.from_numpy(x), -1)
    assert not q[0].any() and s[0, 0].item() == np.float32(1e-8) / 127
    halves = q[1, 255:509].numpy().astype(np.int64)
    assert (halves == np.round(steps[:-1] + 0.5)).all()   # to even
    assert (halves % 2 == 0).all()


# ---------------------------------------------------------------------------
# the kernel's arithmetic, restated in torch
# ---------------------------------------------------------------------------


def _rint_quotient(x, s):
    """The kernel's rint(RN(x / s)) (`quantize_one`): y = RN(x * RN(1 /
    s)) rounded where it is under 128 and more than 1e-4 from every
    half-integer, else the true quotient rounded."""
    r = torch.tensor(1.0) / s
    y = x * r
    ry = torch.round(y)
    fast = (y.abs() < 128) & (((y - ry).abs() - 0.5).abs() > 1e-4)
    return torch.where(fast, ry, torch.round(x / s))


def _kernel_emulation(x, axis=None, absmax=None):
    """What the card's kernel computes, step by step: x as (O, R, I), R
    cut into the plan's chunks; each chunk's max of the bits of |x| as
    integers (NaN above inf), the group's max of its chunks' maxima, the
    scale max(m, 1e-8) / 127 (NaN kept), and clamp(rint(x / scale)) with
    NaN to 0, the quotient's integer by `_rint_quotient`."""
    xf = x.float().contiguous()
    if absmax is not None:
        o, r, i = 1, xf.numel(), 1
    else:
        o, r, i = qmod.groups(tuple(x.shape), axis)
    chunks, chunk = qmod.chunk_plan(o, r, i)
    bits = (xf.reshape(o, r, i).view(torch.int32) & 0x7FFFFFFF)
    if absmax is not None:
        m = absmax.float().reshape(1, 1)
    else:
        parts = [bits[:, c * chunk:(c + 1) * chunk].amax(dim=1)
                 for c in range(chunks)]
        m = torch.stack(parts).amax(dim=0).view(torch.float32)
    m = torch.where(m < np.float32(1e-8), torch.tensor(np.float32(1e-8)), m)
    s = m / torch.tensor(127.0)
    t = _rint_quotient(xf.reshape(o, r, i), s[:, None, :])
    t = torch.where(t < -127, -127.0, torch.where(t > 127, 127.0, t))
    q = torch.where(t.isnan(), 0.0, t).to(torch.int8)
    return q.reshape(x.shape), s


@pytest.mark.parametrize("shape,axis", [
    ((64, 300), None), ((3000, 7), None), ((8, 5000), -1), ((40, 96), 0),
    ((2, 3, 4100), (1, 2)), ((12, 9), (0, 1))], ids=str)
def test_kernel_arithmetic_matches_the_plain_version(shape, axis,
                                                     monkeypatch):
    # small chunks, so that every group spans several of them
    monkeypatch.setattr(qmod, "MIN_ROW_CHUNK", 64)
    monkeypatch.setattr(qmod, "MIN_COL_CHUNK", 2)
    x = torch.from_numpy(_x(sum(shape), shape))
    flat = x.view(-1)
    flat[5] = float("nan")
    flat[-3] = float("inf")
    flat[7] = -0.0
    q, s = _kernel_emulation(x, axis)
    rq, rs = quantize_int8_ref(x, axis)
    assert torch.equal(q, rq)
    assert torch.equal(s.reshape(rs.shape).isnan(), rs.isnan())
    keep = ~rs.isnan()
    assert torch.equal(s.reshape(rs.shape)[keep].view(torch.int32),
                       rs[keep].view(torch.int32))
    given = torch.tensor(2.5)
    q, s = _kernel_emulation(x, absmax=given)
    rq, rs = quantize_int8_ref(x, absmax=given)
    assert torch.equal(q, rq) and torch.equal(s.reshape(rs.shape), rs)


@pytest.mark.parametrize("seed", range(3))
def test_reciprocal_path_rounds_as_the_division(seed):
    """rint(RN(x * RN(1 / s))) away from half-integers, the division near
    them: the true quotient's integer for every x of a group, over
    random scales, values on and within a few ulps of every tie, the
    group's max and values past it (a given absmax under x's own)."""
    rng = np.random.default_rng(seed)
    m = np.float32(10.0) ** rng.uniform(-9, 4, 64).astype(np.float32)
    s = torch.from_numpy(np.maximum(m, np.float32(1e-8))) / torch.tensor(
        127.0)
    k = rng.integers(-127, 127, (64, 4096)).astype(np.float32) + 0.5
    near = torch.from_numpy(k) * s[:, None]
    ulps = torch.from_numpy(rng.integers(-3, 4, (64, 4096)).astype(np.int32))
    near = (near.view(torch.int32) + ulps).view(torch.float32)
    spread = torch.from_numpy(rng.uniform(-1.3, 1.3, (64, 4096)).astype(
        np.float32)) * torch.from_numpy(m)[:, None]
    for x in (near, spread):
        want = torch.round(x / s[:, None])
        assert torch.equal(_rint_quotient(x, s[:, None]), want)


@pytest.mark.parametrize("o,r,i", [(1, 50_331_648, 1), (1, 32_768, 1),
                                   (256, 4096, 1), (8, 2560, 1),
                                   (1, 4096, 12288), (7, 333, 5), (1, 1, 1)])
def test_chunk_plan_covers_every_group(o, r, i):
    chunks, chunk = qmod.chunk_plan(o, r, i)
    assert chunks >= 1 and (chunks - 1) * chunk < r <= chunks * chunk
    tiles = -(-i // qmod.THREADS)
    blocks = o * chunks * tiles
    assert chunks == 1 or blocks <= qmod.TARGET_BLOCKS + o * tiles
    if i == 1 and chunks > 1:
        assert chunk % qmod.ROW_CHUNK_GRANULE == 0
        assert chunk >= qmod.MIN_ROW_CHUNK


def test_groups_view_the_reduced_dims():
    assert qmod.groups((4, 3, 40), None) == (1, 480, 1)
    assert qmod.groups((4, 3, 40), (1, 2)) == (4, 120, 1)
    assert qmod.groups((4, 3, 40), -1) == (12, 40, 1)
    assert qmod.groups((64, 96), 0) == (1, 64, 96)
    assert qmod.groups((4, 3, 40), (0, 1)) == (1, 12, 40)
    assert qmod.groups((4, 3, 40), ()) == (1, 480, 1)
    assert qmod.groups((4, 3, 40), (0, 2)) is None
    with pytest.raises(ValueError, match="out of range"):
        qmod.groups((4, 3), 2)
    with pytest.raises(ValueError, match="twice"):
        qmod.groups((4, 3), (1, -1))


# ---------------------------------------------------------------------------
# artemis_matmul through the entry, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ste", [True, False])
@pytest.mark.parametrize("mode", ["int8", "artemis_mxu", "artemis"])
def test_artemis_matmul_outputs_and_gradients(mode, ste):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((3, 5, 40)).astype(np.float32)
    b = (rng.standard_normal((40, 24)) * 0.3).astype(np.float32)
    jpol = J.ArithmeticPolicy(mode=mode, ste=ste)
    tpol = T.ArithmeticPolicy(mode=mode, ste=ste)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = T.artemis_matmul(ta, tb, tpol)
    want = np.asarray(J.artemis_matmul(jnp.asarray(a), jnp.asarray(b), jpol))
    if ste:
        np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    else:
        np.testing.assert_array_equal(out.detach().numpy(), want)
    out.sum().backward()
    ga, gb = jax.grad(lambda x, w: jnp.sum(J.artemis_matmul(x, w, jpol)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **TOL)


@pytest.mark.parametrize("mode", ["int8", "artemis_mxu", "artemis"])
def test_artemis_matmul_takes_bf16_operands_as_given(mode):
    """bf16 operands go to the quantization as they are (exact in f32):
    the output is the reference's on their f32 values, bit for bit."""
    rng = np.random.default_rng(5)
    ab, a = _bf16(rng.standard_normal((2, 6, 64)).astype(np.float32))
    bb, b = _bf16((rng.standard_normal((64, 20)) * 0.3).astype(np.float32))
    got = T.artemis_matmul(ab, bb, T.ArithmeticPolicy(mode, ste=False))
    want = J.artemis_matmul(jnp.asarray(a), jnp.asarray(b),
                            J.ArithmeticPolicy(mode, ste=False))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_plans():
    qmod._PLANS.clear()
    yield
    qmod._PLANS.clear()


def test_cpu_runs_the_plain_version_and_launches_nothing(fresh_plans):
    build.reset_launch_counts()
    x = torch.from_numpy(_x(1, (8, 48)))
    for axis in (None, -1, (1,)):
        q, s = quantize_int8(x, axis)
        rq, rs = quantize_int8_ref(x, axis)
        assert torch.equal(q, rq) and torch.equal(s, rs)
    assert not build.launch_counts.get(qmod.NAME)


def test_meta_gives_shapes_only(fresh_plans):
    x = torch.empty((4, 3, 40), device="meta", dtype=torch.bfloat16)
    for axis, shape in ((None, (1, 1, 1)), ((1, 2), (4, 1, 1)),
                        (-1, (4, 3, 1))):
        q, s = quantize_int8(x, axis)
        assert q.device.type == s.device.type == "meta"
        assert (q.shape, q.dtype) == (x.shape, torch.int8)
        assert (tuple(s.shape), s.dtype) == (shape, torch.float32)
    q, s = quantize_int8(x, -1, torch.empty((), device="meta"))
    assert tuple(s.shape) == (1, 1, 1)


def test_autograd_is_refused():
    x = torch.ones(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quantize_int8(x)
    with torch.no_grad():
        quantize_int8(x)


@pytest.mark.parametrize("x,axis,absmax,exc,match", [
    (torch.ones(4, 8, dtype=torch.float64), None, None, TypeError,
     "f32 or bf16"),
    (torch.ones(4, 8, dtype=torch.int32), None, None, TypeError,
     "f32 or bf16"),
    (torch.ones(2, 3, 4), (0, 2), None, ValueError, "one run"),
    (torch.ones(0, 8), None, None, ValueError, "non-empty"),
    (torch.ones(4, 8), None, torch.ones(2), ValueError, "one element"),
    (torch.ones(4, 8), 3, None, ValueError, "out of range"),
], ids=["f64", "int32", "axes apart", "empty", "absmax of 2", "axis 3"])
def test_a_cuda_call_the_kernel_refuses_raises_before_a_plan(
        fresh_plans, monkeypatch, x, axis, absmax, exc, match):
    entries = []
    monkeypatch.setattr(qmod, "_entry", lambda: entries.append(1))
    with pytest.raises(exc, match=match):
        qmod._Plan(x, axis, absmax, kind="cuda")
    assert not entries and not qmod._PLANS


def test_a_refused_call_stores_nothing(fresh_plans):
    x = torch.ones(4, 8)
    for axis, absmax in ((5, None), ((0, 0), None), (None, torch.ones(3))):
        for _ in range(2):
            with pytest.raises(ValueError):
                quantize_int8(x, axis, absmax)
    assert not qmod._PLANS


def test_one_plan_per_signature(fresh_plans):
    x = torch.from_numpy(_x(2, (8, 48)))
    quantize_int8(x)
    quantize_int8(x.clone())
    assert len(qmod._PLANS) == 1
    quantize_int8(x, -1)
    quantize_int8(x.to(torch.bfloat16))
    quantize_int8(x[:4])
    quantize_int8(x, None, torch.tensor(4.0))
    quantize_int8(x.t())                              # other strides
    assert len(qmod._PLANS) == 6
    quantize_int8(x, [-1])              # a list of dims is their tuple
    quantize_int8(x, (-1,))
    assert len(qmod._PLANS) == 7


# ---------------------------------------------------------------------------
# the host path: the C entry's argument block
# ---------------------------------------------------------------------------


def test_mirror_matches_the_c_struct():
    assert list(qmod._Args._fields_) == _c_struct(qmod, "ScQuantizeArgs")


@pytest.mark.parametrize("delta", [0, 8, -4])
def test_entry_refuses_a_block_of_another_size(monkeypatch, delta):
    size = ctypes.sizeof(qmod._Args) + delta

    class Fn:
        argtypes = None
        restype = None

        def __call__(self, *args):
            return size

    class Lib:
        sc_quantize_launch_args_bytes = Fn()
        sc_quantize_launch = Fn()

    monkeypatch.setattr(build, "load", lambda source: Lib)
    if delta == 0:
        fn = qmod._entry()
        assert fn.argtypes == [ctypes.POINTER(qmod._Args)]
        return
    for _ in range(2):
        with pytest.raises(RuntimeError, match="argument block"):
            qmod._entry()
    assert Lib.sc_quantize_launch.argtypes is None


@pytest.fixture
def recorder(monkeypatch, fresh_plans):
    """A CUDA plan made from CPU tensors, launched into a recorder of its
    block: the raw stream is 4660, and no capture is open unless a test
    says."""
    rec = _Recorder(qmod._Args)
    monkeypatch.setattr(qmod, "_entry", lambda: rec)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 4660, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    build.workspaces.clear()
    yield rec
    build.workspaces.clear()


def test_block_holds_the_call(recorder):
    x = torch.from_numpy(_x(4, (3, 40000))).to(torch.bfloat16)
    p = qmod._Plan(x, None, None, kind="cuda")
    chunks, chunk = qmod.chunk_plan(1, 120000, 1)
    assert chunks > 1 and p.part_numel == chunks
    q, s = qmod._launch(p, x, None)
    assert (q.shape, q.dtype, tuple(s.shape)) == (x.shape, torch.int8,
                                                  (1, 1))
    (block,) = recorder.blocks
    (part,) = build.workspaces.values()
    assert block == dict(x=x.data_ptr(), absmax=None, q=q.data_ptr(),
                         scale=s.data_ptr(), part=part.data_ptr(),
                         stream=4660, outer=1, reduce=120000, inner=1,
                         chunk=chunk, chunks=chunks, x_bf16=1)
    # a second call writes its pointers into the same block and reuses
    # the workspace
    x2 = x.clone()
    qmod._launch(p, x2, None)
    assert recorder.blocks[1]["x"] == x2.data_ptr()
    assert recorder.blocks[1]["part"] == block["part"]
    assert recorder.refs[0] is recorder.refs[1]


def test_block_per_row_per_column_and_given(recorder):
    x = torch.from_numpy(_x(5, (6, 7, 50)))
    p = qmod._Plan(x, -1, None, kind="cuda")
    qmod._launch(p, x, None)
    b = recorder.blocks[-1]
    assert (b["outer"], b["reduce"], b["inner"], b["chunks"], b["x_bf16"]) \
        == (42, 50, 1, 1, 0)
    p = qmod._Plan(x, (0, 1), None, kind="cuda")
    _, s = qmod._launch(p, x, None)
    b = recorder.blocks[-1]
    assert (b["outer"], b["reduce"], b["inner"]) == (1, 42, 50)
    assert tuple(s.shape) == (1, 1, 50)
    absmax = torch.tensor(3.0, dtype=torch.float64)
    p = qmod._Plan(x, -1, absmax, kind="cuda")
    assert p.part_numel == 0 and not p.absmax_ready
    _, s = qmod._launch(p, x, absmax)
    b = recorder.blocks[-1]
    assert (b["outer"], b["reduce"], b["inner"], b["part"]) == (
        1, 2100, 1, None)
    assert b["absmax"] not in (None, absmax.data_ptr())   # an f32 copy
    assert tuple(s.shape) == (1, 1, 1)


def test_a_strided_input_is_copied_per_call(recorder):
    x = torch.from_numpy(_x(6, (40, 30))).t()
    p = qmod._Plan(x, None, None, kind="cuda")
    assert not p.x_ready
    qmod._launch(p, x, None)
    assert recorder.blocks[0]["x"] != x.data_ptr()


def test_capture_takes_its_own_scratch(recorder, monkeypatch):
    x = torch.from_numpy(_x(7, (2, 60000)))
    p = qmod._Plan(x, None, None, kind="cuda")
    assert p.part_numel
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    qmod._launch(p, x, None)
    assert not build.workspaces and recorder.blocks[0]["part"]


def test_launch_counts_and_a_failed_launch(recorder):
    build.reset_launch_counts()
    x = torch.from_numpy(_x(8, (4, 64)))
    p = qmod._Plan(x, None, None, kind="cuda")
    for _ in range(3):
        qmod._launch(p, x, None)
    assert build.launch_counts[qmod.NAME] == 3
    recorder.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        qmod._launch(p, x, None)
    assert build.launch_counts[qmod.NAME] == 3
    build.reset_launch_counts()


def test_work_reads_x_once_and_writes_q_and_the_scale():
    x = torch.empty((4, 3, 40), dtype=torch.bfloat16, device="meta")
    assert qmod.work(x) == (0, 480 * 3 + 4)
    assert qmod.work(x, -1) == (0, 480 * 3 + 4 * 12)
    assert qmod.work(x, -1, torch.empty(())) == (0, 480 * 3 + 4 + 4)
