"""The port's roofline (`repro_torch.roofline`) against the reference's
(`repro.roofline`): `model_flops`, `analyze` and every
`RooflineReport` property equal on the same inputs under `HW_V5E`;
`HW_H100`'s terms by hand; the collective stats of records equal to
tests/test_roofline.py's HLO sample equal `parse_collectives`;
`parallel.comm`'s records over a fake group of 4; each kernel's
declared work at PERF.md §6's shapes; a tiny qwen3 forward counted
the same on the CPU (plain versions) as on meta, exact and int8; a
tiny MoE forward on meta.
"""
import importlib
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.models import model as modellib  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.roofline import (HW_H100, HW_V5E, analyze,  # noqa: E402
                                  collective_stats, model_flops, recording)
from repro_torch.roofline.count import Count  # noqa: E402

# the wrapper modules (each package exports a function of its name)
fa_mod, pa_mod, sc_mod = (importlib.import_module(
    f"repro_torch.kernels.{name}.{name}")
    for name in ("flash_attention", "paged_attention", "sc_matmul"))
KINDS = ("train", "prefill", "decode")


def _hlo_sample() -> str:
    path = pathlib.Path(__file__).with_name("test_roofline.py")
    spec = importlib.util.spec_from_file_location("_ref_roofline_tests",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HLO_SAMPLE


# the HLO sample's collectives as (kind, operand bytes, group size)
SAMPLE_RECORDS = [
    ("all-reduce", 64 * 1024 * 4, 2),
    ("all-gather", 128 * 256 * 4 // 4, 4),
    ("reduce-scatter", 32 * 64 * 2 * 8, 8),
    ("collective-permute", 16 * 16 * 4, 2),
    ("all-to-all", 2 * 4 * 4 * 4, 4),
]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for kind in KINDS:
        for n_tokens, kv_len in ((1, 0), (4096, 4096), (128, 32768)):
            assert model_flops(cfg, n_tokens, kind, kv_len=kv_len) == \
                jroofline.model_flops(jcfg, n_tokens, kind, kv_len=kv_len)


def test_collective_stats_equal_hlo_parser():
    ref = jroofline.parse_collectives(_hlo_sample())
    port = collective_stats(SAMPLE_RECORDS)
    assert port.ops == ref.ops
    assert port.bytes_by_kind == ref.bytes_by_kind
    assert port.raw_bytes == ref.raw_bytes
    assert port.wire_bytes == ref.wire_bytes
    assert port.summary() == ref.summary()
    assert collective_stats([("all-reduce", 64, 1)]).raw_bytes == 0


def test_analyze_equals_reference_and_h100_by_hand():
    ref_coll = jroofline.parse_collectives(_hlo_sample())
    coll = collective_stats(SAMPLE_RECORDS)
    for cost, mflops, peak in (({"flops": 1e15, "bytes accessed": 1e12},
                                2.56e17, 8e9),
                               ({"flops": 3e9, "bytes accessed": 7e11},
                                1e11, 1e9),
                               ({"flops": 0.0, "bytes accessed": 0.0},
                                0.0, 0.0)):
        rep = analyze("a", "s", "m", 256, cost, coll, mflops, peak,
                      hw=HW_V5E)
        want = jroofline.analyze("a", "s", "m", 256, cost, ref_coll,
                                 mflops, peak, hw=jroofline.HW_V5E)
        assert rep.row() == want.row()
        for prop in ("dominant", "step_time", "useful_flop_fraction",
                     "roofline_fraction"):
            assert getattr(rep, prop) == getattr(want, prop), prop
    rep = analyze("a", "s", "m", 4, {"flops": 2e12, "bytes accessed": 5e9},
                  coll, 8e12, 1.0, hw=HW_H100)
    assert rep.t_compute == 2e12 / 989.4e12
    assert rep.t_memory == 5e9 / 3.35e12
    assert rep.t_collective == coll.wire_bytes / (25e9 * 18)
    assert rep.model_flops == 2e12
    assert HW_H100.hbm_gib == 80.0
    # int8 operations among the FLOPs take the int8 tensor cores' rate;
    # a spec without one (the reference's) prices them at its peak
    cost = {"flops": 2e12, "bytes accessed": 5e9, "int8 ops": 1.5e12}
    rep = analyze("a", "s", "m", 4, cost, coll, 8e12, 1.0, hw=HW_H100)
    assert rep.t_compute == 0.5e12 / 989.4e12 + 1.5e12 / 1979e12
    assert rep.hlo_flops == 2e12
    rep = analyze("a", "s", "m", 4, cost, coll, 8e12, 1.0, hw=HW_V5E)
    assert rep.t_compute == 0.5e12 / 197e12 + 1.5e12 / 197e12


@pytest.fixture
def fake4():
    """A fake process group of 4 ranks, destroyed after the test."""
    with fake_group(4, rank=1):
        yield dist.new_group(list(range(4)))


def test_comm_records_every_collective(fake4):
    x = torch.empty(8, 16, device="meta")
    with recording() as records:
        comm.all_reduce(x, fake4)
        comm.all_gather(x, fake4, 0)
        comm.reduce_scatter(x, fake4, 0)
        out = comm.ring_shift([x, x[:2]], fake4)
        w = torch.empty(8, 16, device="meta", requires_grad=True)
        y = comm.gather_scatter_grad(w, fake4, 0)
        y.sum().backward()
    assert [o.shape for o in out] == [x.shape, (2, 16)]
    n = 8 * 16 * 4
    assert records == [("all-reduce", n, 4), ("all-gather", n, 4),
                       ("reduce-scatter", n, 4),
                       ("collective-permute", n, 4),
                       ("collective-permute", n // 4, 4),
                       ("all-gather", n, 4), ("reduce-scatter", 4 * n, 4)]
    stats = collective_stats(records)
    assert stats.ops == {"all-reduce": 1, "all-gather": 2,
                         "reduce-scatter": 2, "collective-permute": 2}
    # nothing is recorded outside a recording, or over a group of one
    comm.all_reduce(x, fake4)
    with recording() as again:
        comm.reduce_sum(x, dist.new_group([1]))
    assert again == []


def _bound_us(flops, n_bytes, int8=False):
    rate = HW_H100.peak_int8_ops if int8 else HW_H100.peak_flops
    return max(flops / rate, n_bytes / HW_H100.hbm_bw) * 1e6


def test_declared_work_at_perf_table_shapes():
    """PERF.md §6: flash at the static path's shapes (B 8, Hq 32, Hkv 8,
    D 128, bf16 q, an f32 cache of 1056 slots), paged at 8 lanes of 288
    tokens (page 8, f32 pool), sc_matmul at K x N 4096 x 12288 (int8
    operations: bytes bind at M 256 too, which the bf16 rate would
    not)."""
    meta = dict(device="meta")
    cache = torch.empty(8, 1056, 8, 128, **meta).transpose(1, 2)
    q = torch.empty(8, 1, 32, 128, dtype=torch.bfloat16, **meta)
    flops, n_bytes = fa_mod.work(q.transpose(1, 2), cache, kv_len=1041,
                                 q_offset=1040)
    assert round(n_bytes / 1e6, 1) == 68.4
    assert round(_bound_us(flops, n_bytes), 2) == 20.42
    q = torch.empty(8, 1024, 32, 128, dtype=torch.bfloat16, **meta)
    flops, n_bytes = fa_mod.work(q.transpose(1, 2), cache, kv_len=1024)
    assert flops == 2 * 34_393_292_800
    assert round(n_bytes / 1e6, 1) == 270.5
    pool = torch.empty(512, 8, 8, 128, **meta)
    q = torch.empty(8, 1, 32, 128, dtype=torch.bfloat16, **meta)
    bt = torch.zeros(8, 37, dtype=torch.int32)
    pos = torch.full((8, 1), 287, dtype=torch.int32)
    assert round(_bound_us(*pa_mod.work(q, pool, bt, pos)), 2) == 5.69
    b = torch.empty(4096, 12288, dtype=torch.int8, **meta)
    for m, want in ((8, 15.15), (256, 19.09)):
        a = torch.empty(m, 4096, dtype=torch.int8, **meta)
        flops, n_bytes = sc_mod.work(a, b)
        assert flops == 2 * m * 4096 * 12288
        assert round(n_bytes / HW_H100.hbm_bw * 1e6, 2) == want
        assert round(_bound_us(flops, n_bytes, int8=True), 2) == want
        with Count() as c:
            sc_mod.sc_matmul_quantized(a, b, mode="int8")
        assert (c.flops, c.int8_ops, c.bytes) == (flops, flops, n_bytes)


def test_a_kernel_call_counts_its_declared_work_once():
    q = torch.randn(1, 4, 24, 16)
    k = torch.randn(1, 2, 40, 16)
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (q, k, k)]
        with Count(args) as c:
            out = flash_attention(*args, window=8, kv_len=30, q_offset=6)
        assert out.shape == (1, 4, 24, 16) and out.device.type == dev
        assert dict(c.kernel_calls) == {"flash_attention": 1}
        assert (c.flops, c.bytes) == fa_mod.work(
            q, k, window=8, kv_len=30, q_offset=6)
        assert c.int8_ops == 0
        assert not build.COUNTERS


def _count_serve(cfg, policy, device):
    model = (modellib.init(cfg, seed=0, device="cpu") if device == "cpu"
             else modellib.empty(cfg, device="meta"))
    prefill = steps.make_prefill_step(cfg, policy)
    decode = steps.make_decode_step(cfg, policy)
    cache = modellib.init_cache(cfg, 2, 24, dtype=torch.float32,
                                device=device)
    tok = torch.zeros((2, 16), dtype=torch.int32, device=device)
    with Count([dict(model.named_parameters()), tok, cache]) as c:
        logits, cache = prefill(model, {"tokens": tok}, cache)
        logits, cache = decode(model, tok[:, :1], cache)
    assert logits.device.type == device
    return c.flops, c.bytes, dict(c.kernel_calls), c.peak


@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_cpu_and_meta_count_the_same(mode):
    cfg = configs.get_config("qwen3_8b", smoke=True)
    policy = ArithmeticPolicy(mode=mode)
    cpu = _count_serve(cfg, policy, "cpu")
    assert cpu == _count_serve(cfg, policy, "meta")
    # a quantized product is one sc_matmul call and one sc_quantize call
    # an operand
    products = cfg.n_layers * 2 * 7
    want = ({"flash_attention": cfg.n_layers * 2} if mode == "exact" else
            {"sc_matmul": products, "sc_quantize": 2 * products})
    assert cpu[2] == want
    assert cpu[0] > 0 and cpu[1] > 0 and cpu[3] > 0


def test_moe_forward_on_meta():
    cfg = configs.get_config("qwen2_moe_a2_7b", smoke=True)
    model = modellib.empty(cfg, device="meta")
    tok = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with Count([dict(model.named_parameters()), tok]) as c:
        logits, aux, _ = modellib.apply(model, cfg, {"tokens": tok},
                                        attn_impl="gather")
    assert logits.shape == (2, 8, cfg.padded_vocab)
    assert aux.device.type == "meta" and c.flops > 0


def test_the_count_keeps_no_tensor_alive():
    """Once its block ends a count holds nothing of the step: its inputs
    and outputs are freed when the caller lets go of them."""
    import gc
    import weakref
    x = torch.randn(64, 64)
    with Count([x]) as c:
        y = x @ x
    assert c.flops == 2 * 64**3 and c.peak == 2 * 64 * 64 * 4
    refs = [weakref.ref(t) for t in (x, y)]
    del x, y
    gc.collect()
    assert all(r() is None for r in refs)
