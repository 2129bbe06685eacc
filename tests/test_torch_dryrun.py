"""The port's dry run (`repro_torch.launch.dryrun`, `launch.specs`)
against the reference's: `input_specs` at a one-rank mesh (the rank
models `count_cell` runs: `shape_rank_model`, the serving model) leaf
by leaf against `repro.launch.specs` (shapes through `jax.eval_shape`,
nothing allocated) for the four archs of tests/test_launch.py's
`test_input_specs_cover_all_kinds` at full width; `run_cell` over a
fake (data 2, model 2) mesh on smoke configs: ok rows with the
reference's keys written to a cache file (rwkv6's tensor-parallel
train step among them), and an error row for per-channel scales, which
the sharded step refuses; the table and compare scripts.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402
from repro_torch.parallel.sharding import reference_path  # noqa: E402
from repro_torch.parallel.tensor_parallel import named_shards  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
# the reference's row keys that mean nothing for an eager count (XLA's
# memory analysis, its compile times and its layer probes)
XLA_ONLY = {"arg_bytes", "temp_bytes", "out_bytes", "alias_bytes",
            "t_lower_s", "t_compile_s", "probe"}
# the leaves a serving model of the port keeps in f32, as its forward
# reads them, where the reference's serving specs cast every leaf to the
# compute dtype (`launch.specs`' docstring); audio's embedding too
SERVE_F32 = {"scale", "q_norm", "k_norm", "router", "A_log", "D", "conv_b",
             "conv_w", "dt_bias"}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_leaf(port: torch.Tensor, ref, stacked: int | None,
               f32: bool = False):
    want = tuple(ref.shape)
    if stacked is not None:
        assert want[0] == stacked
        want = want[1:]
    assert port.device.type == "meta"
    assert tuple(port.shape) == want
    assert str(port.dtype) == ("torch.float32" if f32
                               else f"torch.{ref.dtype}")


def _check_named(port: dict, ref_tree, f32=frozenset()):
    """Port leaves by parameter name against the reference's stacked
    tree: each stacked leaf holds as many layers as the port names; a
    leaf whose last name is in `f32` is f32 in the port."""
    ref = _flat(ref_tree)
    by_path: dict = {}
    for name in port:
        by_path.setdefault(reference_path(name), []).append(name)
    assert set(by_path) == set(ref)
    for path, names in by_path.items():
        stacked = len(names) if any(p.isdigit() for p in
                                    names[0].split(".")) else None
        for name in names:
            _same_leaf(port[name], ref[path], stacked,
                       name.split(".")[-1] in f32)


def _check_plain(port: dict, ref_tree):
    """A batch or a cache: the same keys and leaves, the port's cache
    index a host int."""
    ref = _flat(ref_tree)
    flat = {}
    for key, leaf in port.items():
        if isinstance(leaf, dict):
            flat.update({f"['{key}']['{k}']": v for k, v in leaf.items()})
        else:
            flat[f"['{key}']"] = leaf
    assert set(flat) == set(ref)
    for key, leaf in flat.items():
        if key == "['index']":
            assert isinstance(leaf, int) and ref[key].shape == ()
        else:
            _same_leaf(leaf, ref[key], None)


@pytest.mark.parametrize("arch", ["qwen3_8b", "musicgen_large",
                                  "internvl2_1b", "zamba2_7b"])
def test_input_specs_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    serve_f32 = SERVE_F32 | ({"embed"} if cfg.modality == "audio" else set())
    with dryrun.fake_group(1):
        rmesh = meshlib.rank_mesh(meshlib.make_smoke_mesh(1, 1))
        for shape in configs.runnable_shapes(arch):
            cell = configs.SHAPES[shape]
            ins = specs.input_specs(cfg, cell, rmesh)
            ref = jspecs.input_specs(jcfg, jconfigs.SHAPES[shape])
            _check_cell(cell, ins, ref, serve_f32)


def _check_cell(cell, ins, ref, serve_f32):
    assert set(ins) - {"model"} == set(ref) - {"params"}
    params = dict(named_shards(ins["model"]))
    _check_named(params, ref["params"],
                 frozenset() if cell.kind == "train" else serve_f32)
    if cell.kind == "train":
        for key in ("m", "v"):
            _check_named(ins["opt_state"][key], ref["opt_state"][key])
        _same_leaf(ins["opt_state"]["step"], ref["opt_state"]["step"], None)
        _check_plain(ins["batch"], ref["batch"])
    else:
        _check_plain(ins["cache"], ref["cache"])
        if cell.kind == "prefill":
            _check_plain(ins["batch"], ref["batch"])
        else:
            _same_leaf(ins["tokens"], ref["tokens"], None)


@pytest.fixture
def smoke_cells(monkeypatch):
    """Smoke configs and tiny shape cells for `run_cell`."""
    real = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config",
                        lambda arch, smoke=False: real(arch, smoke=True))
    for name, kind in (("tiny_train", "train"), ("tiny_decode", "decode")):
        monkeypatch.setitem(configs.SHAPES, name,
                            configs.ShapeCell(name, 32, 4, kind))


def _reference_ok_keys() -> set:
    with open(REPO / "experiments" / "dryrun_cache.json") as f:
        rows = json.load(f).values()
    row = next(r for r in rows if r.get("status") == "ok")
    return set(row) - XLA_ONLY


def test_run_cell_rows(smoke_cells, tmp_path):
    mesh = meshlib.make_smoke_mesh(2, 2)
    path = str(tmp_path / "cache.json")
    cache = {}
    rows = {(arch, shape): dryrun.run_cell(
        arch, shape, mesh, "smoke_2x2", cache=cache, cache_path=path,
        verbose=False)
        for arch, shape in (("qwen3_8b", "tiny_train"),
                            ("qwen3_8b", "tiny_decode"),
                            ("rwkv6_3b", "tiny_train"))}
    assert not dist.is_initialized()
    with open(path) as f:
        assert json.load(f) == cache
    bad = dryrun.run_cell("rwkv6_3b", "tiny_train", mesh, "smoke_2x2",
                          policy=ArithmeticPolicy(mode="int8",
                                                  act_quant_axis=-1),
                          cache=cache, cache_path=path, verbose=False)
    assert len(cache) == 4
    for shape in ("tiny_train", "tiny_decode"):
        row = rows[("qwen3_8b", shape)]
        assert row["status"] == "ok", row.get("error")
        assert _reference_ok_keys() <= set(row)
        assert row["hw"] == "h100-sxm" and row["chips"] == 4
        assert row["hlo_gflops"] > 0 and row["t_memory_s"] > 0
        assert row["coll_ops"] and row["fits_hbm"]
    assert rows[("qwen3_8b", "tiny_decode")]["kernel_calls"] == {
        "flash_attention": 2}
    ok = rows[("rwkv6_3b", "tiny_train")]
    assert ok["status"] == "ok", ok.get("error")
    assert _reference_ok_keys() <= set(ok) and ok["hlo_gflops"] > 0
    assert bad["status"] == "error"
    assert bad["error"].startswith("ValueError") and \
        "act_quant_axis" in bad["error"]
    # a cached ok row is returned as it is; an existing group is refused
    again = dryrun.run_cell("qwen3_8b", "tiny_decode", mesh, "smoke_2x2",
                            cache=cache, cache_path=path, verbose=False)
    assert again is cache[next(k for k in cache if "tiny_decode" in k)]
    with dryrun.fake_group(1):
        with pytest.raises(RuntimeError, match="already has one"):
            dryrun.run_cell("qwen3_8b", "tiny_train", mesh, "smoke_2x2",
                            force=True, verbose=False)
    # the port has no sequence-parallel placement to price
    with pytest.raises(ValueError, match="no sequence-parallel placement"):
        dryrun.run_cell("qwen3_8b", "tiny_train", mesh, "smoke_2x2",
                        rules=ShardingRules(seq_parallel=True), force=True,
                        verbose=False)


def _script(name: str, *args, cwd=REPO):
    return subprocess.run(
        [sys.executable, str(REPO / "benchmarks" / name), *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})


def test_table_and_compare_scripts(tmp_path):
    """The table reads the port's cache; the compare takes a saved copy
    of it as its baseline (every cell equal), and refuses no baseline,
    a missing one and the reference's cache (XLA's counts)."""
    table = _script("torch_roofline_table.py", "--markdown")
    assert table.returncode == 0, table.stderr
    assert "| qwen3_8b | decode_32k |" in table.stdout
    saved = tmp_path / "baseline.json"
    saved.write_text((REPO / "experiments" /
                      "torch_dryrun_cache.json").read_text())
    same = _script("torch_perf_compare.py", "--baseline", str(saved))
    assert same.returncode == 0, same.stderr
    assert "qwen3_8b x train_4k" in same.stdout
    lines = same.stdout.splitlines()[1:]
    assert lines and all(line.endswith("(=baseline)") for line in lines)
    assert _script("torch_perf_compare.py").returncode == 2
    missing = _script("torch_perf_compare.py", "--baseline",
                      str(tmp_path / "none.json"))
    assert missing.returncode == 1 and "no baseline cache" in missing.stderr
    xla = _script("torch_perf_compare.py", "--baseline",
                  str(REPO / "experiments" / "dryrun_cache.json"))
    assert xla.returncode == 1 and "is not the port's" in xla.stderr


def test_collective_bytes_script():
    """Ring against all-gather over 8 fake ranks: the same K/V bytes on
    the wire (the ring's positions aside), bf16 half of f32."""
    spec = importlib.util.spec_from_file_location(
        "_torch_collective_bytes",
        REPO / "benchmarks" / "torch_collective_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = {r["dataflow"]: r for r in mod.run()}
    assert not dist.is_initialized()
    ring = rows["token (ring, bf16 K/V)"]
    layer = rows["layer (all-gather, bf16)"]
    assert ring["ops"] == {"collective-permute": 3 * (mod.N_SHARDS - 1)}
    assert layer["ops"] == {"all-gather": 2}
    kv = 2 * (mod.N_SHARDS - 1) * mod.B * (mod.S // mod.N_SHARDS) * \
        mod.H * mod.D * 2
    assert layer["ici_wire_bytes"] == kv
    positions = (mod.N_SHARDS - 1) * mod.B * (mod.S // mod.N_SHARDS) * 4
    assert ring["ici_wire_bytes"] == kv + positions
    assert rows["token (ring, f32 K/V)"]["ici_wire_bytes"] == \
        2 * kv + positions
