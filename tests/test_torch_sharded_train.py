"""The port's sharded train step (`repro_torch.launch.steps.
make_train_step(mesh=, rules=)`, `repro_torch.parallel.data_parallel`)
against the reference's step, on the CPU.

Every case runs in one spawned gloo group of 2 ranks and one of 4
(`launch.mesh.spawn`, module fixture), started while the parent
compiles the reference. Each case builds the smoke config at f32 from
the same numpy weights as the reference (through the bridge), cuts
each rank's part over a `make_smoke_mesh(data, model)` of its ranks,
takes the gradients of the first batch and then two steps on the
reference's `make_batch` batches.

The reference of a dense or rwkv6 step is its single-device jitted
step: the reference's sharded step computes the same function
(GSPMD). A MoE step groups its tokens by data rank, so its reference
at data 2 is the reference's own `make_train_step(mesh=, rules=)`,
jitted over a (data 2, model 1) mesh built here with Auto axes: the
mesh `repro.launch.mesh.make_smoke_mesh` builds has Explicit axes on
jax 0.9.0, where `with_sharding_constraint` refuses the reference's
specs (ROADMAP, reference observations). The inputs stay replicated.

Held, at f32 (`TIGHT`, loss relative, each leaf against its max abs):
the loss, aux (the MoE load-balance loss over the whole batch) and
every gathered gradient, the router's included, at the start; after
each step the metrics, and every gathered parameter after the last
within 0.05 x lr (where a gradient is near zero Adam's first steps are
about its sign, as in tests/test_torch_train.py). qwen3_8b and qwen2_moe_a2_7b at (2, 1), (1, 2) and (2, 2);
rwkv6_3b at (2, 1). int8 at (2, 1) on qwen3_8b within
`FLIP["int8"]` of the single-device step (tests/test_torch_train.py:
a last-bit difference flips a value at a rounding tie): the activation
scales are taken over the data ranks, as the reference's per-tensor
absmax of the whole batch. Every rank's metrics and gathered
parameters are the same; cutting a model and its AdamW state and
gathering them back gives them bit for bit; rwkv6_3b at (1, 2) is
refused with a sequence-parallel placement, naming the family, and
taken without one (tests/test_torch_tp_families.py holds its
tensor-parallel step); `mesh=None` is the single-device step bit
for bit; the ranks import neither jax nor `repro`.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.parallel.context import use_sharding as juse_sharding  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import mesh_cases  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.parallel import data_parallel as dp  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs 8 (simulated) host devices")

OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)
N_STEPS = 2
# (loss relative, a leaf's max abs): f32 sums in another order
TIGHT = (1e-5, 1e-4)
FLIP_INT8 = (1e-3, 5e-2)
# parameters after the steps, in units of lr: where a gradient is near
# zero, Adam's first steps are about its sign (tests/test_torch_train.py)
PARAM_TOL = 0.05
# the int8 step's elements whose starting gradient may part at a tie
INT8_MAX_FLIPS = 16
# (arch, policy, (data, model))
CASES = [("qwen3_8b", "exact", (2, 1)), ("qwen3_8b", "exact", (1, 2)),
         ("qwen3_8b", "exact", (2, 2)), ("qwen2_moe_a2_7b", "exact", (2, 1)),
         ("qwen2_moe_a2_7b", "exact", (1, 2)),
         ("qwen2_moe_a2_7b", "exact", (2, 2)), ("rwkv6_3b", "exact", (2, 1))]
INT8 = ("qwen3_8b", "int8", (2, 1))


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(configs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """The initial weights (the port's seeded init, in the reference's
    layout: the reference's eager init takes seconds a config) and the
    reference's batches, numpy."""
    jc, tc = _cfgs(arch)
    weights = bridge.params_to_numpy(tmodel.init(tc, seed=0, device="cpu",
                                                 train=True))
    batches = [_np(make_batch(jc, DataConfig(seq_len=16, global_batch=4), s))
               for s in range(N_STEPS)]
    return weights, batches


def _case(arch, policy, mesh, round_trip=True):
    weights, batches = _inputs(arch)
    return ("train", dict(cfg=_cfgs(arch)[1], mesh=mesh, weights=weights,
                          batches=batches, policy=policy, opt=OPT,
                          round_trip=round_trip))


def _group_cases(n):
    cases = [c for c in CASES + [INT8] if c[2][0] * c[2][1] == n]
    jobs = [_case(*c) for c in cases]
    if n == 2:
        rw = _cfgs("rwkv6_3b")[1]
        jobs += [("train_refusal", dict(cfg=rw, mesh=(1, 2),
                                        rules=dict(seq_parallel=True))),
                 ("train_refusal", dict(cfg=rw, mesh=(1, 2)))]
    jobs += [("lanes", {}), ("modules", {})]
    return cases, jobs


def _spawn(n):
    cases, jobs = _group_cases(n)
    per_rank = meshlib.spawn(mesh_cases.run, n, jobs, device="cpu",
                             timeout_s=120)
    out = {c: [r[i] for r in per_rank] for i, c in enumerate(cases)}
    if n == 2:
        out["refusal"] = [r[len(cases):len(cases) + 2] for r in per_rank]
    out["lanes"] = [r[-2] for r in per_rank]
    out["modules"] = [r[-1] for r in per_rank]
    return out


def _reference(arch, policy, data):
    """The reference's loss, aux and gradients at the start and its
    N_STEPS steps (params and metrics after each): jitted once, on one
    device, or for a MoE config at data > 1 over a (data, 1) Auto mesh
    (its token groups)."""
    jc, _ = _cfgs(arch)
    pol = jsteps.ArithmeticPolicy(mode=policy)
    mesh = rules = None
    if jc.family == "moe" and data > 1:
        mesh = jax.make_mesh((data, 1), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto),
                             devices=jax.devices()[:data])
        rules = jsh.ShardingRules()
    step = jsteps.make_train_step(jc, JOpt(**OPT), pol, mesh=mesh,
                                  rules=rules)

    def loss_fn(p, batch):
        def run():
            logits, aux, _ = jmodel.apply(p, jc, {"tokens": batch["tokens"]},
                                          policy=pol)
            loss = jmodel.lm_loss(logits, batch["labels"])
            return loss + aux, (loss, aux)
        if mesh is None:
            return run()
        with juse_sharding(mesh, rules):
            return run()

    def both(p, o, batch):
        (_, (loss, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, batch)
        return (loss, aux, grads) + step(p, o, batch)

    fn = jax.jit(both)
    weights, batches = _inputs(arch)
    params, opt = weights, jadamw_init(weights)
    out = {"steps": []}
    for i, batch in enumerate(batches):
        loss, aux, grads, params, opt, metrics = fn(params, opt, batch)
        if i == 0:
            out.update(loss=float(loss), aux=float(aux), grads=_np(grads))
        out["steps"].append(dict(
            params=_np(params), metrics={k: float(v) for k, v in
                                         metrics.items()}))
    return out


@pytest.fixture(scope="module")
def runs():
    """Every case's ranks' results (both groups run while the reference
    compiles) and the references they are held against."""
    for arch in ("qwen3_8b", "qwen2_moe_a2_7b", "rwkv6_3b"):
        _inputs(arch)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        groups = {n: pool.submit(_spawn, n) for n in (2, 4)}
        refs = {}
        for arch, policy, (data, _) in CASES + [INT8]:
            key = (arch, policy, data if arch == "qwen2_moe_a2_7b" else 1)
            if key not in refs:
                refs[key] = _reference(*key)
        port = {n: f.result() for n, f in groups.items()}
    return port, refs


def _ranks(runs, case):
    port, _ = runs
    return port[case[2][0] * case[2][1]][case]


def _ref(runs, case):
    arch, policy, (data, _) = case
    return runs[1][(arch, policy, data if arch == "qwen2_moe_a2_7b" else 1)]


def _leaf_errors(want, got) -> dict:
    """Per leaf (jax keystr): max |want - got| over max |want|."""
    out = {}
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        w = np.asarray(w, np.float64)
        out[jax.tree_util.keystr(path)] = (
            np.abs(w - np.asarray(g, np.float64)).max()
            / max(np.abs(w).max(), 1e-30))
    return out


def _worst(want, got):
    errs = _leaf_errors(want, got)
    assert set(errs) and jax.tree.structure(want) == jax.tree.structure(got)
    key = max(errs, key=errs.get)
    return errs[key], key


def _ids(cases):
    return [f"{a}-{p}-data{m[0]}xmodel{m[1]}" for a, p, m in cases]


@needs8
@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_sharded_step_matches_reference(runs, case):
    got, ref = _ranks(runs, case)[0], _ref(runs, case)
    assert abs(got["loss"] - ref["loss"]) <= TIGHT[0] * abs(ref["loss"])
    assert got["aux"] == pytest.approx(ref["aux"], rel=TIGHT[0], abs=1e-8)
    if case[0] == "qwen2_moe_a2_7b":
        assert ref["aux"] > 0
        assert "router" in got["grads"]["layers"]["moe"]
    err, leaf = _worst(ref["grads"], got["grads"])
    assert err <= TIGHT[1], (leaf, err)
    for i, step in enumerate(ref["steps"]):
        for key, want in step["metrics"].items():
            assert got["metrics"][i][key] == pytest.approx(
                want, rel=TIGHT[0]), (i, key)
    drift = jax.tree.map(lambda a, b: np.abs(a - b).max(),
                         ref["steps"][-1]["params"], got["params"])
    assert max(jax.tree.leaves(drift)) <= PARAM_TOL * OPT["lr"]


@needs8
def test_sharded_int8_step_within_flip(runs):
    """int8 at (data 2): the activations' per-tensor scales are the whole
    batch's, so the step is the single-device step but where a
    last-bit difference flips a value at a tie. The parameters are held
    per element within PARAM_TOL x lr, as the exact steps', except
    where the starting gradient parts from the reference's by more than
    `TIGHT` (a flip's signature), at most INT8_MAX_FLIPS elements
    (measured at this seed: 0 of 106880; the farthest parameter 0.0099
    x lr). An update of the wrong sign or size moves a parameter by
    about lr a step, and fails."""
    got, ref = _ranks(runs, INT8)[0], _ref(runs, INT8)
    assert abs(got["loss"] - ref["loss"]) <= FLIP_INT8[0] * abs(ref["loss"])
    err, leaf = _worst(ref["grads"], got["grads"])
    assert err <= FLIP_INT8[1], (leaf, err)
    for i, step in enumerate(ref["steps"]):
        assert got["metrics"][i]["loss"] == pytest.approx(
            step["metrics"]["loss"], rel=FLIP_INT8[0]), i
    flat = [jax.tree.leaves(t) for t in (ref["grads"], got["grads"],
                                         ref["steps"][-1]["params"],
                                         got["params"])]
    n_flips = 0
    for i, (gw, gg, pw, pg) in enumerate(zip(*flat)):
        gw, gg = np.asarray(gw, np.float64), np.asarray(gg, np.float64)
        flipped = np.abs(gw - gg) > TIGHT[1] * max(np.abs(gw).max(), 1e-30)
        n_flips += int(flipped.sum())
        drift = np.abs(np.asarray(pw, np.float64) - np.asarray(pg, np.float64))
        assert drift[~flipped].max(initial=0.0) <= PARAM_TOL * OPT["lr"], i
    assert n_flips <= INT8_MAX_FLIPS, n_flips


@needs8
@pytest.mark.parametrize("case", CASES + [INT8], ids=_ids(CASES + [INT8]))
def test_ranks_agree(runs, case):
    """Every rank's metrics, gradients and parameters are the same, and
    a quantized step launches sc_matmul only on the card (none here)."""
    ranks = _ranks(runs, case)
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        assert other["loss"] == ranks[0]["loss"]
        for key in ("grads", "params"):
            jax.tree.map(np.testing.assert_array_equal, other[key],
                         ranks[0][key])
    assert all("sc_matmul" not in r["counts"] for r in ranks)


@needs8
@pytest.mark.parametrize("case", CASES + [INT8], ids=_ids(CASES + [INT8]))
def test_shard_and_gather_round_trip(runs, case):
    assert all(r["round_trip"] for r in _ranks(runs, case))


@needs8
def test_tensor_parallel_refuses_rwkv6(runs):
    """rwkv6 at (model 2) is refused with a sequence-parallel placement,
    which the sharded step lacks, and taken without one."""
    for seq_parallel, plain in runs[0][2]["refusal"]:
        assert "rwkv6" in seq_parallel and \
            "sequence-parallel" in seq_parallel
        assert plain == ""


@needs8
@pytest.mark.parametrize("n", [2, 4])
def test_collectives_split_over_lanes_equal_one_lane(runs, n):
    """A large collective split over a group's lanes (`comm.add_lanes`,
    which `launch.mesh.rank_mesh` gives every axis) equals it on one."""
    for per_rank in runs[0][n]["lanes"]:
        assert len(per_rank) == 6 and all(per_rank.values()), per_rank


@needs8
@pytest.mark.parametrize("n", [2, 4])
def test_rank_children_import_no_jax(runs, n):
    for roots in runs[0][n]["modules"]:
        assert "repro_torch" in roots
        assert not {"jax", "jaxlib", "repro"} & set(roots)


@pytest.mark.parametrize("policy", ["exact", "int8"])
def test_train_placement(policy):
    """The model entries are tensor-parallel serving's placement, the
    data entries the reference's fsdp dims, moved to the other dim of
    wo and w_down where a quantized policy cuts them by columns."""
    _, tc = _cfgs("qwen3_8b")
    shapes = sh.param_shapes(tmodel.empty(tc, device="meta", train=True))
    mesh = meshlib.make_smoke_mesh(2, 2)
    specs = dp.train_placement(tc, shapes, mesh, ArithmeticPolicy(policy))
    ref = sh.param_specs(tc, shapes, mesh)
    assert specs["layers.0.attn.wq"] == ("data", "model")
    assert specs["layers.0.ln1.scale"] == (None,)
    moved = ("data", "model") if policy == "int8" else ("model", "data")
    for leaf in ("attn.wo", "ffn.w_down"):
        assert specs[f"layers.0.{leaf}"] == moved
        assert ref[f"layers.0.{leaf}"] == ("model", "data")
    for name, spec in specs.items():
        if not name.endswith(("wo", "w_down")):
            assert spec == tuple(dp._pad(ref[name], len(shapes[name]))), name


@pytest.mark.parametrize("arch,policy", [("qwen3_8b", "int8"),
                                         ("qwen2_moe_a2_7b", "exact")])
def test_mesh_none_is_the_single_device_step(arch, policy):
    """Without a mesh (or without rules) `make_train_step` is the
    single-device step: `loss_and_grads` and `adamw_update`, bit for
    bit."""
    _, tc = _cfgs(arch)
    weights, batches = _inputs(arch)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batches[0].items()}
    pol = ArithmeticPolicy(policy)
    out = []
    for kw in (None, {}, {"mesh": None, "rules": sh.ShardingRules()}):
        model = bridge.params_from_numpy(weights, tc, device="cpu",
                                         train=True)
        state = adamw_init(model)
        if kw is None:
            loss, _, grads = tsteps.loss_and_grads(model, tc, batch, pol)
            metrics = adamw_update(model, grads, state, OptimizerConfig(**OPT))
            metrics["loss"] = loss
        else:
            step = tsteps.make_train_step(tc, OptimizerConfig(**OPT), pol,
                                          **kw)
            model, state, metrics = step(model, state, batch)
        out.append((metrics, dict(model.named_parameters()), state))
    for metrics, params, state in out[1:]:
        for key in ("loss", "grad_norm", "param_norm", "lr"):
            assert torch.equal(metrics[key], out[0][0][key]), key
        for name, p in params.items():
            assert torch.equal(p, out[0][1][name]), name
            assert torch.equal(state["m"][name], out[0][2]["m"][name])
            assert torch.equal(state["v"][name], out[0][2]["v"][name])


def test_port_covers_the_sharded_train_slice():
    """The slice's modules, and the phase that runs it on the card."""
    import importlib
    import pathlib
    for name in ("context", "compress", "data_parallel"):
        importlib.import_module(f"repro_torch.parallel.{name}")
    smoke = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    assert "def shard_rank(" in smoke.read_text()
