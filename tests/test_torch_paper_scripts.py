"""The port's paper scripts (`benchmarks/torch_*.py`, `examples/torch_*`)
against the reference's on the CPU.

- Figs 2, 8, 9-11 and 12 use hwsim only: their rows equal the
  reference script's, the headline check included;
- Fig 7's rows equal but for the f32 staircase, within 1e-6;
- Table V's rows: MAE and max within 1e-6 of the reference's (the port
  sums the mean in f64, the reference in f32, and the softmax's
  normalizer adds in another order), calibration bits within 1e-4;
- kernel_micro on the CPU runs the plain versions: its inputs are the
  reference's bit for bit, its outputs (at the first sc_matmul shape
  and flash's first) within 1e-4 of `repro.core.artemis_matmul` and
  `attention_ref` on those inputs, and each row's `rel_err_fp32` within
  1e-4 of the reference ladder's (the reference's own kernel_micro
  interprets Pallas, too slow to run here);
- `torch_run` runs the CPU suites, names the two it skips and exits 1
  when a suite fails;
- the three examples run as subprocesses at `--device cpu` and exit 0.
"""
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import artemis_matmul as jmatmul  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.kernels import attention_ref as jattention_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _scripts(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"benchmarks.torch_{name}"))


def _close(got, want, tol):
    """Row dicts equal, floats within `tol` (0 = equal)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, float) and tol:
                assert g[k] == pytest.approx(v, abs=tol), (k, g, w)
            else:
                assert g[k] == v, (k, g, w)


@pytest.mark.parametrize("name", ["fig2_breakdown", "fig8_dataflow",
                                  "fig9_11_comparison", "fig12_scalability"])
def test_hwsim_figures_equal_reference(name):
    ref, port = _scripts(name)
    want, got = ref.run(), port.run()
    _close(got, want, 0)
    if name == "fig9_11_comparison":
        assert got[-1]["headline_holds"] is True


def test_fig7_matches_reference():
    ref, port = _scripts("fig7_momcap")
    _close(port.run(), ref.run(), 1e-6)


def test_table5_matches_reference():
    ref, port = _scripts("table5_calibration")
    want, got = ref.run(), port.run(device="cpu")
    assert [r["block"] for r in got] == [r["block"] for r in want]
    for g, w in zip(got, want):
        assert g["mae"] == pytest.approx(w["mae"], abs=1e-6), g
        assert g["max"] == pytest.approx(w["max"], abs=1e-6), g
        assert g["calib_bits"] == pytest.approx(w["calib_bits"], abs=1e-4)
        assert (g["paper_mae"], g["paper_max"], g["paper_calib"]) == \
            (w["paper_mae"], w["paper_max"], w["paper_calib"])
    # the noise-calibrated ACC row reproduces the paper's 0.0085
    assert got[-1]["mae"] == pytest.approx(0.00859, abs=1e-4)


def test_table5_inputs_are_the_reference_draws():
    _, port = _scripts("table5_calibration")
    np.testing.assert_array_equal(
        port.linspace_f32(0.0, 2540.0, 100001, "cpu").numpy(),
        np.asarray(jnp.linspace(0.0, 2540, 100001)))
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 64))) * 4
    np.testing.assert_allclose(port.softmax(torch.from_numpy(y)).numpy(),
                               np.asarray(jax.nn.softmax(jnp.asarray(y))),
                               rtol=2e-6, atol=1e-9)


def test_kernel_micro_matches_reference_ladder():
    km = importlib.import_module("benchmarks.torch_kernel_micro")
    rows = km.run(device="cpu")
    sc = [r for r in rows if r["kernel"] == "sc_matmul"]
    assert len(sc) == len(km.SC_SHAPES) * len(km.SC_MODES)
    key = jax.random.PRNGKey(0)
    for (m, k, n), group in zip(km.SC_SHAPES, np.split(np.array(sc), 2)):
        a = jax.random.normal(key, (m, k))
        b = jax.random.normal(jax.random.fold_in(key, 1), (k, n))
        ta, tb = km.sc_inputs(m, k, n, "cpu")
        np.testing.assert_array_equal(ta.numpy(), np.asarray(a))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(b))
        for row in group:
            pol = dict(mode=row["mode"], ste=False)
            want = jmatmul(a, b, JPolicy(**pol))
            if m == km.SC_SHAPES[0][0]:     # the outputs, at one shape
                got = km.sc_matmul(ta, tb, km.ArithmeticPolicy(**pol))
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-4, atol=1e-4)
            rel = float(jnp.linalg.norm(want - a @ b)
                        / jnp.linalg.norm(a @ b))
            assert row["rel_err_fp32"] == pytest.approx(rel, abs=1e-4)
            assert row["max_abs_err"] == 0.0   # the plain version itself
    fa = [r for r in rows if r["kernel"] == "flash_attention"]
    assert [r["shape"] for r in fa] == list(km.FA_SHAPES)
    b_, h, s, d = km.FA_SHAPES[0]
    q, kk, v = km.fa_inputs(b_, h, s, d, "cpu")
    o, lse = km.flash_attention(q, kk, v, causal=True, return_lse=True)
    jq = jax.random.normal(key, (b_, h, s, d))
    jk = jax.random.normal(jax.random.fold_in(key, 2), (b_, h, s, d))
    jv = jax.random.normal(jax.random.fold_in(key, 3), (b_, h, s, d))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    o_ref, lse_ref = jattention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-4,
                               atol=1e-4)
    assert all(r["device"].startswith("cpu") for r in rows)


def test_torch_run_orchestrates_and_fails_loudly(capsys):
    run = importlib.import_module("benchmarks.torch_run")
    names = [s[0] for s in run.SUITES]
    assert names == ["table4", "table5", "fig2", "fig7", "fig8", "fig9_11",
                     "fig12", "kernels"]
    assert run.main(["--only", "fig2,fig7,collectives,serve",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "skipped collectives" in out and "skipped serve" in out
    # a suite that fails (no CUDA device here) makes the run exit 1
    if not torch.cuda.is_available():
        assert run.main(["--only", "table5", "--device", "cuda"]) == 1
        assert "FAIL" in capsys.readouterr().out


EXAMPLES = [["torch_quickstart.py"], ["torch_serve_batched.py"],
            ["torch_serve_engine.py"],
            ["torch_serve_engine.py", "--arch", "rwkv6_3b"]]


@pytest.mark.parametrize("argv", EXAMPLES, ids=" ".join)
def test_example_runs_on_the_cpu(argv):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / argv[0]), *argv[1:],
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
