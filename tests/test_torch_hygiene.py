"""Boundaries of the PyTorch port: it imports neither jax nor anything
of the JAX package, and the repository's static contract checker finds
nothing in it."""
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


def test_port_imports_without_jax_or_repro():
    """Every module of the port, and chip_smoke.py, imports with `jax`,
    `jaxlib` and `repro` made unimportable."""
    code = ("import importlib, sys\n"
            "for mod in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[mod] = None\n"
            f"for name in {_port_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "import chip_smoke\n"
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
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
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
