"""sc_matmul_quantized's host path: the launch plan cached per call
signature, the C entry's packed argument block, and the scratch from
the per-(device, stream) workspace.

The kernel runs only on the card, so a CUDA plan is made here from CPU
tensors with the C entries replaced by recorders: the launch records
the argument block it is handed, `sc_matmul_scratch_bytes` the calls
made to it. The ctypes mirror is held field for field against the
struct parsed from the `.cu`, and a library whose block size differs
from the mirror's is refused at load.
"""
import ctypes
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from test_torch_kernel_launch import _c_struct, _Recorder  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sc_matmul import (  # noqa: E402
    sc_matmul_quantized,
    sc_matmul_ref,
)

# the wrapper's module (the package exports the function by its name)
sc_mod = importlib.import_module("repro_torch.kernels.sc_matmul.sc_matmul")


def _int8(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.fixture
def fresh_plans():
    sc_mod._PLANS.clear()
    yield
    sc_mod._PLANS.clear()


# ---------------------------------------------------------------------------
# the argument block
# ---------------------------------------------------------------------------


def test_mirror_matches_the_c_struct():
    assert list(sc_mod._Args._fields_) == _c_struct(sc_mod, "ScMatmulArgs")


@pytest.mark.parametrize("delta", [0, 8, -4])
def test_entry_refuses_a_block_of_another_size(monkeypatch, delta):
    """The library's sizeof against the mirror's at load: equal, the
    entry takes one pointer to the block; else it raises, and raises
    again on the next load."""
    size = ctypes.sizeof(sc_mod._Args) + delta

    class Fn:
        argtypes = None
        restype = None

        def __call__(self, *args):
            return size

    class Lib:
        sc_matmul_launch_args_bytes = Fn()
        sc_matmul_launch = Fn()
        sc_matmul_scratch_bytes = Fn()

    monkeypatch.setattr(build, "load", lambda source: Lib)
    if delta == 0:
        fn, nbytes = sc_mod._entries()
        assert fn.argtypes == [ctypes.POINTER(sc_mod._Args)]
        assert nbytes.restype is ctypes.c_longlong
        return
    for _ in range(2):
        with pytest.raises(RuntimeError, match="argument block"):
            sc_mod._entries()
    assert Lib.sc_matmul_launch.argtypes is None


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------


def test_repeated_call_reuses_one_plan(fresh_plans):
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    sc_matmul_quantized(a, b, mode="int8")
    (plan,) = sc_mod._PLANS.values()
    sc_matmul_quantized(a, b, mode="int8")
    sc_matmul_quantized(a.clone(), b.clone(), mode="int8")
    assert list(sc_mod._PLANS.values()) == [plan]


@pytest.mark.parametrize("change", [
    dict(mode="artemis_mxu"), dict(readout_bits=4), dict(readout_bits=None),
    dict(rbar=60.25), dict(acc_depth=16), "K padding", "M"])
def test_a_changed_signature_makes_a_new_plan(fresh_plans, change):
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    kw = dict(mode="artemis")
    sc_matmul_quantized(a, b, **kw)
    if change == "K padding":              # K 70: padded to 80 (artemis)
        a, b = _int8(2, 8, 70), _int8(3, 70, 48)
    elif change == "M":
        a = _int8(2, 9, 64)
    else:
        kw.update(change)
    sc_matmul_quantized(a, b, **kw)
    assert len(sc_mod._PLANS) == 2


def test_a_refused_call_stores_nothing(fresh_plans):
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    for call, exc in (
            (lambda: sc_matmul_quantized(a, b, mode="fp8"), ValueError),
            (lambda: sc_matmul_quantized(a, b[:32]), ValueError),
            (lambda: sc_matmul_quantized(a.float(), b), TypeError),
            (lambda: sc_matmul_quantized(a, b, acc_depth=0), ValueError),
            (lambda: sc_matmul_quantized(a, b, readout_bits=30), ValueError)):
        messages = []
        for _ in range(2):
            with pytest.raises(exc) as err:
                call()
            messages.append(str(err.value))
        assert messages[0] == messages[1]
    # a float operand that requires grad is refused as autograd's
    with pytest.raises(RuntimeError, match="no backward"):
        sc_matmul_quantized(a.float().requires_grad_(True), b)
    assert not sc_mod._PLANS


def test_the_cache_is_bounded(fresh_plans, monkeypatch):
    monkeypatch.setattr(build, "MAX_PLANS", 3)
    b = _int8(1, 64, 48)
    for m in range(1, 8):
        sc_matmul_quantized(_int8(m, m, 64), b, mode="int8")
        assert 1 <= len(sc_mod._PLANS) <= 3


@pytest.mark.parametrize("mode,kw", [("int8", {}), ("artemis_mxu", {}),
                                     ("artemis", {}),
                                     ("artemis", dict(readout_bits=None))])
def test_warm_and_cold_cpu_outputs_are_bit_equal(fresh_plans, mode, kw):
    a, b = _int8(4, 9, 70), _int8(5, 70, 37)
    cold = sc_matmul_quantized(a, b, mode=mode, **kw)
    warm = sc_matmul_quantized(a, b, mode=mode, **kw)
    ref = sc_matmul_ref(a, b, mode=mode, **kw)
    for got in (cold, warm):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.equal(got.contiguous().view(torch.int32),
                           ref.contiguous().view(torch.int32))


# ---------------------------------------------------------------------------
# the CUDA path with the C entries replaced by recorders
# ---------------------------------------------------------------------------


class _ScratchBytes:
    """Stands in for `sc_matmul_scratch_bytes`: the C entry's sizes, and
    the calls made to it."""

    def __init__(self):
        self.calls = []

    def __call__(self, m, n, k, mode, depth):
        self.calls.append((m, n, k, mode, depth))
        if mode == 1:
            return 2 * m * n * 4
        if mode == 2 and m <= 16:
            return -(-k // depth) * m * n * 4
        return 0


@pytest.fixture
def recorder(monkeypatch, fresh_plans):
    """A CUDA plan made from CPU tensors, launched into a recorder of its
    block: the raw stream is 4660, and no capture is open unless a test
    says."""
    rec, nbytes = _Recorder(sc_mod._Args), _ScratchBytes()
    monkeypatch.setattr(sc_mod, "_entries", lambda: (rec, nbytes))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 4660, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    build.workspaces.clear()
    yield rec, nbytes
    build.workspaces.clear()


def _plan(a, b, mode="artemis", acc_depth=20, readout_bits=8, rbar=63.5):
    return sc_mod._Plan(a, b, mode, acc_depth, readout_bits, rbar,
                        kind="cuda")


def test_int8_block_holds_the_call(recorder):
    rec, nbytes = recorder
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    p = _plan(a, b, "int8")
    assert p.ready and p.scratch_numel == 0 and p.table is None
    out = sc_mod._launch(p, a, b)
    assert (out.shape, out.dtype) == ((8, 48), torch.int32)
    (block,) = rec.blocks
    assert block == dict(A=a.data_ptr(), B=b.data_ptr(), out=out.data_ptr(),
                         scratch=None, table=None, stream=4660, M=8, N=48,
                         K=64, mode=0, acc_depth=20, readout_bits=8,
                         delta=pytest.approx(20 * 127 / 255, rel=1e-7),
                         rbar=63.5)
    assert not build.workspaces
    # a second call writes its pointers into the same block
    a2 = a.clone()
    sc_mod._launch(p, a2, b)
    assert rec.blocks[1]["A"] == a2.data_ptr()
    assert rec.refs[0] is rec.refs[1]
    assert len(nbytes.calls) == 1            # asked once, for the plan


def test_artemis_block_holds_its_table_and_scratch(recorder):
    rec, nbytes = recorder
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    p = _plan(a, b, "artemis", readout_bits=None)
    assert p.table is sc_mod._table(20, None, torch.device("cpu"))
    sc_mod._launch(p, a, b)
    block = rec.blocks[0]
    (scratch,) = build.workspaces.values()
    assert block["table"] == p.table.data_ptr()
    assert block["scratch"] == scratch.data_ptr()
    assert (block["mode"], block["readout_bits"], block["delta"]) == (2, -1,
                                                                     0.0)
    assert scratch.numel() == -(-64 // 20) * 8 * 48   # groups x M x N
    assert nbytes.calls == [(8, 48, 64, 2, 20)]


def test_padding_copies_and_the_output_is_a_view(recorder):
    rec, _ = recorder
    a, b = _int8(0, 5, 70), _int8(1, 70, 37)
    p = _plan(a, b, "int8")
    assert not p.ready and p.out_shape == (5, 48)
    out = sc_mod._launch(p, a, b)
    block = rec.blocks[0]
    assert (block["M"], block["N"], block["K"]) == (5, 48, 96)
    assert block["A"] != a.data_ptr() and block["B"] != b.data_ptr()
    assert out.shape == (5, 37) and out.stride() == (48, 1)
    # an operand a byte off its 16-byte alignment is copied, per call
    flat = torch.zeros(8 * 64 + 1, dtype=torch.int8)
    off = flat[1:].view(8, 64)
    b2 = _int8(2, 64, 48)
    p = _plan(off, b2, "int8")
    assert p.ready
    sc_mod._launch(p, off, b2)
    assert rec.blocks[-1]["A"] % 16 == 0 and rec.blocks[-1]["A"] != \
        off.data_ptr()


def test_workspace_reused_grown_once_and_keyed_by_stream(recorder,
                                                          monkeypatch):
    rec, _ = recorder
    small = _plan(_int8(0, 8, 64), _int8(1, 64, 48), "artemis_mxu")
    big = _plan(_int8(2, 16, 64), _int8(3, 64, 96), "artemis_mxu")
    for p, (m, k, n) in ((small, (8, 64, 48)), (big, (16, 64, 96))):
        assert p.scratch_numel == 2 * m * n
    sc_mod._launch(small, _int8(0, 8, 64), _int8(1, 64, 48))
    first = build.workspaces[(torch.device("cpu"), 4660)]
    sc_mod._launch(small, _int8(0, 8, 64), _int8(1, 64, 48))
    assert build.workspaces[(torch.device("cpu"), 4660)] is first
    sc_mod._launch(big, _int8(2, 16, 64), _int8(3, 64, 96))
    grown = build.workspaces[(torch.device("cpu"), 4660)]
    assert grown is not first and grown.numel() == 2 * 16 * 96
    sc_mod._launch(small, _int8(0, 8, 64), _int8(1, 64, 48))
    assert build.workspaces[(torch.device("cpu"), 4660)] is grown
    assert rec.blocks[-1]["scratch"] == grown.data_ptr()
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 99, raising=False)
    sc_mod._launch(small, _int8(0, 8, 64), _int8(1, 64, 48))
    assert set(build.workspaces) == {(torch.device("cpu"), 4660),
                                     (torch.device("cpu"), 99)}


def test_capture_takes_its_own_scratch(recorder, monkeypatch):
    rec, _ = recorder
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    p = _plan(a, b, "artemis")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    sc_mod._launch(p, a, b)
    assert not build.workspaces and rec.blocks[0]["scratch"]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    sc_mod._launch(p, a, b)
    shared = build.workspaces[(torch.device("cpu"), 4660)]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    sc_mod._launch(_plan(_int8(2, 16, 64), _int8(3, 64, 480), "artemis"),
                   _int8(2, 16, 64), _int8(3, 64, 480))
    # a bigger captured call neither grows nor takes the shared buffer
    assert build.workspaces[(torch.device("cpu"), 4660)] is shared
    assert rec.blocks[-1]["scratch"] != shared.data_ptr()


def test_cuda_checks_refuse_before_a_plan(recorder):
    rec, nbytes = recorder
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    with pytest.raises(ValueError, match="acc_depth <= 128"):
        _plan(a, b, "artemis", acc_depth=129)
    assert not nbytes.calls and not rec.blocks


def test_launch_counts_and_a_failed_launch(recorder):
    rec, _ = recorder
    build.reset_launch_counts()
    a, b = _int8(0, 8, 64), _int8(1, 64, 48)
    p = _plan(a, b, "int8")
    for _ in range(3):
        sc_mod._launch(p, a, b)
    assert build.launch_counts["sc_matmul"] == 3
    rec.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        sc_mod._launch(p, a, b)
    assert build.launch_counts["sc_matmul"] == 3
    build.reset_launch_counts()
