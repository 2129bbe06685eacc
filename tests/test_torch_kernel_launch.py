"""The attention wrappers' host path: the launch plan cached per call
signature, the C entries' packed argument block, the per-(device,
stream) workspace, and flash attention's outputs as views of one
allocation.

The kernels run only on the card, so a CUDA plan is made here from CPU
tensors with the C entry replaced by a recorder that reads the argument
block it is handed: the sizes, strides, masks and pointers a launch
would give the kernel. The ctypes mirrors are held field for field (name,
C type, order) against the structs parsed from the `.cu` sources, and a
library whose block size differs from its mirror's is refused at load.
"""
import ctypes
import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_all,
    flash_attention_ref,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_ref,
)

# the wrappers' modules (their packages export the functions by the
# modules' names)
pa_mod = importlib.import_module(
    "repro_torch.kernels.paged_attention.paged_attention")
fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

# the C types of the argument blocks' fields, as ctypes declares them
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def _c_struct(mod, name: str) -> list[tuple[str, type]]:
    """(field, ctypes type) of `struct name` in the module's .cu source,
    in order; every pointer is a c_void_p."""
    text = mod.SOURCE.read_text()
    found = re.search(r"struct %s \{(.*?)\};" % name, text, re.S)
    assert found, f"struct {name} not in {mod.SOURCE.name}"
    fields = []
    for decl in re.sub(r"//[^\n]*", "", found.group(1)).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        first, *more = (part.strip() for part in decl.split(","))
        ctype, _, fname = first.rpartition(" ")
        if fname.startswith("*"):
            ctype, fname = ctype + "*", fname[1:]
        for field in (fname, *more):
            fields.append((field, ctypes.c_void_p if ctype.endswith("*")
                           else _C_TYPES[ctype]))
    return fields


@pytest.mark.parametrize("mod,struct", [(pa_mod, "PagedAttentionArgs"),
                                        (fa_mod, "FlashAttentionArgs")])
def test_mirror_matches_the_c_struct(mod, struct):
    assert list(mod._Args._fields_) == _c_struct(mod, struct)


@pytest.mark.parametrize("mod,size_fn", [
    (pa_mod, "paged_attention_launch_args_bytes"),
    (fa_mod, "flash_attention_launch_args_bytes")])
@pytest.mark.parametrize("delta", [0, 8, -4])
def test_entry_refuses_a_block_of_another_size(monkeypatch, mod, size_fn,
                                               delta):
    """The library's sizeof against the mirror's at load: equal, the
    entry takes one pointer to the block; else it raises, and raises
    again on the next load (nothing is set up that a call could use)."""
    size = ctypes.sizeof(mod._Args) + delta

    class Fn:
        argtypes = None
        restype = None

        def __call__(self, *args):
            return size

    class Lib:
        pass

    lib = Lib()
    setattr(lib, size_fn, Fn())
    setattr(lib, f"{mod.NAME}_launch", Fn())
    monkeypatch.setattr(build, "load", lambda source: lib)
    if delta == 0:
        fn = mod._entry()
        assert fn.argtypes == [ctypes.POINTER(mod._Args)]
        assert fn.restype is ctypes.c_int
        return
    for _ in range(2):
        with pytest.raises(RuntimeError, match="argument block"):
            mod._entry()
    assert getattr(lib, f"{mod.NAME}_launch").argtypes is None


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------


def _paged(b=2, s=1, h=4, kvh=2, hd=16, npages=8, page=4, pmax=3, seed=0,
           dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(dtype)
    kp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    bt = rng.integers(1, npages, (b, pmax)).astype(np.int32)
    pos = np.stack([np.arange(s) + 5 + i for i in range(b)]).astype(np.int32)
    return [torch.from_numpy(a) for a in (q, kp, vp, bt, pos)]


def _flash(b=2, hq=4, hkv=2, sq=1, sk=24, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    # the static path's strided (B, H, S, D) views
    return [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]


@pytest.fixture
def fresh_plans():
    pa_mod._PLANS.clear()
    fa_mod._PLANS.clear()
    yield
    pa_mod._PLANS.clear()
    fa_mod._PLANS.clear()


def test_repeated_call_reuses_one_plan(fresh_plans):
    args = _paged()
    paged_attention(*args, window=3)
    (plan,) = pa_mod._PLANS.values()
    paged_attention(*args, window=3)
    paged_attention(*[t.clone() for t in args], window=3)
    assert list(pa_mod._PLANS.values()) == [plan]
    q, k, v = _flash()
    flash_attention_all(q, k, v, kv_len=20, q_offset=19)
    (fplan,) = fa_mod._PLANS.values()
    flash_attention_all(q.clone(), k, v, kv_len=20, q_offset=19)
    assert list(fa_mod._PLANS.values()) == [fplan]


@pytest.mark.parametrize("change", [
    dict(window=5), dict(splits=0), dict(splits=2), dict(scale=0.5),
    "dtype", "shape"])
def test_a_changed_signature_makes_a_new_plan(fresh_plans, change):
    args = _paged()
    paged_attention(*args, window=3)
    kw = dict(window=3)
    if change == "dtype":
        args[0] = args[0].to(torch.bfloat16)
    elif change == "shape":
        args = _paged(b=3)
    else:
        kw.update(change)
    paged_attention(*args, **kw)
    assert len(pa_mod._PLANS) == 2


def test_tile_parts_and_flash_arguments_make_new_plans(fresh_plans):
    args = _paged(s=8)                       # G * S = 16: the tile instance
    for parts in (None, 1, 3):
        paged_attention(*args, tile_parts=parts)
    assert len(pa_mod._PLANS) == 3
    q, k, v = _flash(sq=2)
    base = dict(kv_len=20, q_offset=18)
    for kw in (base, dict(base, q_offset=17), dict(base, kv_len=21),
               dict(base, window=4), dict(base, splits=1),
               dict(base, kv_cast=torch.bfloat16)):
        flash_attention_all(q, k, v, **kw)
    flash_attention_all(q.contiguous(), k, v, **base)       # other strides
    assert len(fa_mod._PLANS) == 7


def test_a_refused_call_stores_nothing(fresh_plans):
    args = _paged()
    q, k, v = _flash()
    for call, exc in (
            (lambda: paged_attention(*args, window=0), ValueError),
            (lambda: paged_attention(*args, variant="tiles"), ValueError),
            (lambda: paged_attention(*args, tile_parts=2), ValueError),
            (lambda: paged_attention(args[0], args[1][..., :8], *args[2:]),
             ValueError),
            (lambda: flash_attention_all(q, k, v, causal=False, window=2),
             ValueError),
            (lambda: flash_attention_all(q, k, v, kv_len=-1), ValueError),
            (lambda: flash_attention_all(q, k, v, splits=-1), ValueError)):
        messages = []
        for _ in range(2):
            with pytest.raises(exc) as err:
                call()
            messages.append(str(err.value))
        assert messages[0] == messages[1]
    assert not pa_mod._PLANS and not fa_mod._PLANS


def test_the_cache_is_bounded(fresh_plans, monkeypatch):
    monkeypatch.setattr(build, "MAX_PLANS", 3)
    q, k, v = _flash()
    for offset in range(7):
        flash_attention_all(q, k, v, kv_len=offset + 1, q_offset=offset)
        assert 1 <= len(fa_mod._PLANS) <= 3


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_warm_and_cold_cpu_outputs_are_bit_equal(fresh_plans):
    args = _paged(s=3)
    cold = paged_attention(*args, window=4)
    warm = paged_attention(*args, window=4)
    assert torch.equal(_bits(cold), _bits(warm))
    assert torch.equal(_bits(cold), _bits(paged_attention_ref(
        *args, window=4, scale=16 ** -0.5)))
    q, k, v = _flash(sq=3)
    kw = dict(kv_len=20, q_offset=17, window=6)
    cold = flash_attention_all(q, k, v, **kw)
    warm = flash_attention_all(q, k, v, **kw)
    for a, b in zip(cold, warm):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(cold, flash_attention_ref(q, k, v, **kw)):
        assert torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the workspace
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_workspaces():
    build.workspaces.clear()
    yield
    build.workspaces.clear()


def test_workspace_reuses_grows_once_and_keys_by_device_and_stream(
        fresh_workspaces):
    cpu = torch.device("cpu")
    first = build.workspace(cpu, 7, 100, False)
    assert first.numel() == 100 and first.dtype == torch.float32
    for n in (100, 60, 1):
        assert build.workspace(cpu, 7, n, False).data_ptr() == \
            first.data_ptr()
    grown = build.workspace(cpu, 7, 250, False)
    assert grown.numel() == 250
    for n in (250, 200, 100):
        assert build.workspace(cpu, 7, n, False) is grown
    other_stream = build.workspace(cpu, 8, 50, False)
    other_device = build.workspace(torch.device("meta"), 7, 50, False)
    assert other_stream is not grown and other_device is not grown
    assert other_device.device.type == "meta"
    assert set(build.workspaces) == {(cpu, 7), (cpu, 8),
                                     (torch.device("meta"), 7)}


def test_workspace_under_capture_neither_makes_nor_grows(fresh_workspaces):
    cpu = torch.device("cpu")
    captured = build.workspace(cpu, 3, 64, True)
    assert captured.numel() == 64 and not build.workspaces
    shared = build.workspace(cpu, 3, 32, False)
    for n in (16, 128):
        assert build.workspace(cpu, 3, n, True) is not shared
    assert build.workspaces == {(cpu, 3): shared}
    assert shared.numel() == 32


# ---------------------------------------------------------------------------
# flash attention's outputs: one allocation, the old shapes and strides
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("b,hq,sq,d", [(2, 4, 1, 16), (1, 6, 5, 12),
                                       (3, 2, 33, 64)])
def test_flash_outputs_keep_their_layout(device, b, hq, sq, d):
    q = torch.empty((b, sq, hq, d), device=device).transpose(1, 2)
    k = torch.empty((b, 2, 40, d), device=device)
    o, lse, nvis = flash_attention_all(q, k, k, kv_len=40, q_offset=39)
    # what three allocations gave before
    want_o = torch.empty((b, sq, hq, d)).transpose(1, 2)
    want_l = torch.empty((b, hq, sq))
    assert (o.shape, o.stride(), o.dtype) == (want_o.shape, want_o.stride(),
                                              torch.float32)
    for t in (lse, nvis):
        assert (t.shape, t.stride(), t.dtype) == (want_l.shape,
                                                  want_l.stride(),
                                                  torch.float32)
    assert o.storage_offset() == 0
    assert lse.storage_offset() == b * sq * hq * d
    assert nvis.storage_offset() == b * sq * hq * d + b * hq * sq
    if device == "cpu":
        assert o.data_ptr() % 16 == 0
        assert o.untyped_storage().data_ptr() == \
            nvis.untyped_storage().data_ptr()
        flat = o.transpose(1, 2).reshape(b, sq, hq * d)
        assert flat.data_ptr() == o.data_ptr()       # the reshape is free


# ---------------------------------------------------------------------------
# the CUDA path with the C entry replaced by a recorder of its block
# ---------------------------------------------------------------------------


class _Recorder:
    """Stands in for a C entry: records each argument block it is handed
    and returns `err`."""

    def __init__(self, mirror, err=0):
        self.mirror, self.err, self.blocks, self.refs = mirror, err, [], []

    def __call__(self, ref):
        self.refs.append(ref)
        args = ref._obj
        self.blocks.append({name: getattr(args, name)
                            for name, _ in self.mirror._fields_})
        return self.err


@pytest.fixture
def recorder(monkeypatch, fresh_plans, fresh_workspaces):
    """A CUDA plan made from CPU tensors, launched into a recorder: the
    raw stream is 4660, and no capture is open unless a test says."""
    rec = {}
    for mod in (pa_mod, fa_mod):
        rec[mod] = _Recorder(mod._Args)
        monkeypatch.setattr(mod, "_entry", lambda mod=mod: rec[mod])
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 4660, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return rec


def _paged_plan(args, **kw):
    kw = dict(dict(window=None, scale=None, variant=None, splits=None,
                   tile_parts=None), **kw)
    return pa_mod._Plan("cuda", *args, **kw)


def test_paged_block_holds_the_call(recorder):
    args = _paged(b=2, s=1, h=8, kvh=2, hd=32, npages=8, page=4, pmax=40)
    plan = _paged_plan(args, window=7)
    assert (plan.variant, plan.n_splits) == ("rows", pa_mod.split_plan(
        2, 2, 4, 32, 160))
    assert plan.n_splits > 1
    out = pa_mod._launch(plan, *args)
    assert out.shape == (2, 1, 8, 32) and out.dtype == torch.float32
    (block,) = recorder[pa_mod].blocks
    q, kp, vp, bt, pos = args
    assert block == dict(
        q=q.data_ptr(), k_pages=kp.data_ptr(), v_pages=vp.data_ptr(),
        block_tables=bt.data_ptr(), positions=pos.data_ptr(),
        out=out.data_ptr(), part=block["part"], stream=4660, B=2, S=1, H=8,
        KV=2, Dh=32, n_pages=8, page=4, pmax=40, window=7,
        scale=pytest.approx(32 ** -0.5, rel=1e-7), q_bf16=0, kv_bf16=0,
        variant=0, n_splits=plan.n_splits)
    (part,) = build.workspaces.values()
    assert block["part"] == part.data_ptr()
    assert part.numel() == plan.n_splits * 2 * 8 * 34
    # a second call writes the pointers into the same block and reuses
    # the workspace
    args2 = [t.clone() for t in args]
    pa_mod._launch(plan, *args2)
    second = recorder[pa_mod].blocks[1]
    assert second["q"] == args2[0].data_ptr() and second["part"] == \
        block["part"]
    assert {k_: v_ for k_, v_ in second.items() if k_ not in
            ("q", "k_pages", "v_pages", "block_tables", "positions",
             "out")} == {k_: v_ for k_, v_ in block.items() if k_ not in
                         ("q", "k_pages", "v_pages", "block_tables",
                          "positions", "out")}
    assert recorder[pa_mod].refs[0] is recorder[pa_mod].refs[1]


def test_paged_capture_takes_its_own_workspace(recorder, monkeypatch):
    args = _paged(b=2, s=1, h=8, kvh=2, hd=32, pmax=40)
    plan = _paged_plan(args)
    assert plan.n_splits > 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    pa_mod._launch(plan, *args)
    assert not build.workspaces
    assert recorder[pa_mod].blocks[0]["part"]


def test_paged_tile_block_and_one_part(recorder):
    args = _paged(b=2, s=8, h=4, kvh=2, hd=16, pmax=9)
    plan = _paged_plan(args, tile_parts=1)
    assert (plan.variant, plan.n_splits, plan.part_numel) == ("tile", 1, 0)
    pa_mod._launch(plan, *args)
    (block,) = recorder[pa_mod].blocks
    assert (block["variant"], block["n_splits"], block["part"]) == (1, 1,
                                                                   None)
    assert not build.workspaces


def test_paged_converts_tables_and_checks_alignment_per_call(recorder):
    q, kp, vp, bt, pos = _paged(b=2, s=1, h=8, kvh=2, hd=32, pmax=40)
    wide = (bt.long(), pos.long())
    plan = _paged_plan([q, kp, vp, *wide])
    assert not (plan.tables_ready or plan.positions_ready)
    pa_mod._launch(plan, q, kp, vp, *wide)
    block = recorder[pa_mod].blocks[0]
    assert block["block_tables"] not in (bt.data_ptr(), wide[0].data_ptr())
    # a pool one element off its 4-element boundary: the split path's
    # rule, checked per call, raises for every such call
    flat = torch.zeros(kp.numel() + 1)
    off = flat[1:].view(kp.shape)
    plan = _paged_plan([q, off, off, bt, pos])
    for _ in range(2):
        with pytest.raises(ValueError, match="aligned to 4 elements"):
            pa_mod._launch(plan, q, off, off, bt, pos)
    assert len(recorder[pa_mod].blocks) == 1


def test_paged_cuda_checks_refuse_before_a_plan(recorder):
    q, kp, vp, bt, pos = _paged()
    with pytest.raises(TypeError, match="f32/bf16"):
        _paged_plan([q.double(), kp, vp, bt, pos])
    with pytest.raises(ValueError, match="contiguous pools"):
        _paged_plan([q, kp.transpose(0, 1), vp.transpose(0, 1), bt, pos])


def test_a_failed_launch_raises(recorder):
    recorder[pa_mod].err = 1
    recorder[fa_mod].err = 700
    args = _paged()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        pa_mod._launch(_paged_plan(args), *args)
    q, k, v = _flash()
    plan = fa_mod._Plan("cuda", q, k, v, **_fa_kw(kv_len=20, q_offset=19))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa_mod._launch(plan, q, k, v)


def _fa_kw(**kw):
    return dict(dict(causal=True, window=None, kv_len=None, q_offset=0,
                     scale=None, bq=128, bk=128, kv_cast=None, variant=None,
                     splits=None), **kw)


def test_flash_block_holds_the_call(recorder):
    q, k, v = _flash(b=2, hq=8, hkv=2, sq=1, sk=96, d=16)
    plan = fa_mod._Plan("cuda", q, k, v, **_fa_kw(
        kv_len=200, q_offset=90, window=40, bq=8, bk=96,
        kv_cast=torch.bfloat16))
    assert plan.kv_len == 96 and plan.variant == "rows"
    o, lse, nvis = fa_mod._launch(plan, q, k, v)
    (block,) = recorder[fa_mod].blocks
    strides = {f"{t}_s{dim}": s for t, x in zip("qkvo", (q, k, v, o))
               for dim, s in zip("bhs", x.stride()[:3])}
    assert block == dict(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        lse=lse.data_ptr(), nvis=nvis.data_ptr(), part=block["part"],
        stream=4660, B=2, Hq=8, Hkv=2, Sq=1, Sk=96, D=16, **strides,
        causal=1, window=40, kv_len=96, q_offset=90, bq=8, bk=96,
        scale=pytest.approx(0.25), q_bf16=0, kv_bf16=0, kv_round=1,
        variant=0, n_splits=plan.args.n_splits)
    assert plan.args.n_splits == fa_mod.split_plan(2, 2, 4, 16, 96) > 1
    assert block["part"] == build.workspaces[
        (torch.device("cpu"), 4660)].data_ptr()
    assert lse.data_ptr() == o.data_ptr() + 4 * o.numel()


def test_flash_q_is_copied_where_its_rows_do_not_align(recorder):
    q, k, v = _flash(b=1, hq=2, hkv=2, sq=2, sk=8, d=8)
    # strides the kernel cannot read: the plan names a contiguous copy's
    odd = torch.zeros(1, 2, 2, 10)[..., :8]
    odd = odd.as_strided((1, 2, 2, 8), (40, 20, 10, 1))
    plan = fa_mod._Plan("cuda", odd, k, v, **_fa_kw())
    assert not plan.q_ready
    assert (plan.args.q_sb, plan.args.q_sh, plan.args.q_ss) == (32, 16, 8)
    fa_mod._launch(plan, odd, k, v)
    assert recorder[fa_mod].blocks[0]["q"] != odd.data_ptr()
    # aligned strides but an address one element off: an aligned copy in
    # q's own layout, so the plan's strides still hold
    flat = torch.zeros(q.numel() + 1)
    shifted = flat[1:].view(1, 2, 2, 8).transpose(1, 2)
    plan = fa_mod._Plan("cuda", shifted, k, v, **_fa_kw())
    assert plan.q_ready
    fa_mod._launch(plan, shifted, k, v)
    block = recorder[fa_mod].blocks[1]
    assert block["q"] % 16 == 0
    assert (block["q_sb"], block["q_sh"], block["q_ss"]) == \
        shifted.stride()[:3]
    # K/V one element off: refused per call
    kflat = torch.zeros(k.numel() + 1)
    kshift = kflat[1:].view(k.transpose(1, 2).shape).transpose(1, 2)
    plan = fa_mod._Plan("cuda", q, kshift, kshift, **_fa_kw())
    with pytest.raises(ValueError, match="4-element aligned rows"):
        fa_mod._launch(plan, q, kshift, kshift)


def test_flash_cuda_checks_refuse_before_a_plan(recorder):
    q, k, v = _flash()
    with pytest.raises(TypeError, match="rounds K/V"):
        fa_mod._Plan("cuda", q, k, v, **_fa_kw(kv_cast=torch.float16))
    with pytest.raises(ValueError, match="4-element aligned rows"):
        kt = torch.zeros(2, 2, 24, 18)[..., :16]
        fa_mod._Plan("cuda", q, kt, kt, **_fa_kw())


def test_launch_counts_by_instance(recorder):
    build.reset_launch_counts()
    args = _paged()
    plan = _paged_plan(args)
    for _ in range(3):
        pa_mod._launch(plan, *args)
    q, k, v = _flash()
    fplan = fa_mod._Plan("cuda", q, k, v, **_fa_kw())
    fa_mod._launch(fplan, q, k, v)
    assert build.launch_counts["paged_attention"] == 3
    assert build.launch_counts["paged_attention.rows"] == 3
    assert build.launch_counts["flash_attention"] == 1
    assert build.launch_counts["flash_attention.rows"] == 1
    build.reset_launch_counts()
