"""Boundaries of the PyTorch port: it imports neither jax nor anything
of the JAX package, and the repository's static contract checker finds
nothing in it. The port is `src/repro_torch/` (every subpackage, found
by walking it), `chip_smoke.py` and the port's own scripts,
`benchmarks/torch_*.py` and `examples/torch_*.py`."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro.analysis import Project, analyze_project  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _port_scripts() -> list[pathlib.Path]:
    return [REPO / "chip_smoke.py",
            *sorted((REPO / "benchmarks").glob("torch_*.py")),
            *sorted((REPO / "examples").glob("torch_*.py"))]


def test_port_covers_the_training_slice():
    mods = _port_modules()
    for name in ("repro_torch.data.pipeline", "repro_torch.optim.adamw",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.launch.train"):
        assert name in mods
    names = {p.name for p in _port_scripts()}
    assert {"torch_table4_accuracy.py", "torch_train_tiny_lm.py",
            "torch_accuracy_ablation.py"} <= names


def test_port_covers_the_arithmetic_slice():
    """The rest of the ARTEMIS arithmetic and the paper's scripts."""
    mods = _port_modules()
    for name in ("repro_torch.core.lut", "repro_torch.core.softmax",
                 "repro_torch.xla_math", "repro_torch.hwsim.baselines"):
        assert name in mods
    names = {p.name for p in _port_scripts()}
    for script in ("fig2_breakdown", "fig7_momcap", "fig8_dataflow",
                   "fig9_11_comparison", "fig12_scalability",
                   "table5_calibration", "kernel_micro", "run",
                   "quickstart", "serve_batched", "serve_engine"):
        assert f"torch_{script}.py" in names


def test_port_covers_the_mesh_slice():
    """Tensor-parallel serving. The rank workers that spawned processes
    run (`repro_torch.launch.mesh_cases.run`, `chip_smoke.mesh_rank`)
    live in the port's own files, so the import-boundary checks below
    cover every module a rank loads (and tests/test_torch_parallel.py
    reads what a spawned rank has imported)."""
    mods = _port_modules()
    for name in ("repro_torch.launch.mesh", "repro_torch.launch.mesh_cases",
                 "repro_torch.parallel", "repro_torch.parallel.comm",
                 "repro_torch.parallel.sharding",
                 "repro_torch.parallel.ring_attention",
                 "repro_torch.parallel.split_kv",
                 "repro_torch.parallel.tensor_parallel",
                 "repro_torch.serve.mesh",
                 "repro_torch.serve.sharded_backend"):
        assert name in mods
    assert "def mesh_rank(" in (REPO / "chip_smoke.py").read_text()


def test_port_covers_the_roofline_slice():
    """The dry run and the roofline."""
    mods = _port_modules()
    for name in ("repro_torch.roofline", "repro_torch.roofline.model",
                 "repro_torch.roofline.collectives",
                 "repro_torch.roofline.count", "repro_torch.launch.specs",
                 "repro_torch.launch.dryrun"):
        assert name in mods
    names = {p.name for p in _port_scripts()}
    assert {"torch_roofline_table.py", "torch_perf_compare.py",
            "torch_collective_bytes.py"} <= names


def test_port_imports_without_jax_or_repro():
    """Every module of the port, chip_smoke.py and the port's scripts
    import with `jax`, `jaxlib` and `repro` made unimportable."""
    code = ("import importlib, sys\n"
            "for mod in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[mod] = None\n"
            f"for name in {_port_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "import chip_smoke\n"
            "import importlib.util\n"
            f"for i, path in enumerate({[str(p) for p in _port_scripts()]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'_s{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
            "                and sys.modules[m] is not None)\n"
            "assert not leaked, leaked\n"
            "print('ok')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_name_no_jax_import():
    for path in sorted(PORT.rglob("*.py")) + _port_scripts():
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path}: {line.strip()}"


def test_static_analysis_finds_nothing_in_the_port():
    result = analyze_project(Project.from_paths([str(PORT)]))
    assert result.n_files == len(list(PORT.rglob("*.py")))
    assert result.findings == [], [str(f) for f in result.findings]
