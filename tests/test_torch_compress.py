"""The port's compressed gradient all-reduce (`repro_torch.parallel.
compress.compressed_psum` over a 2-rank gloo group, spawned once for
the module) against the reference's `compressed_psum` under
`jax.vmap(..., axis_name="dp")` on the same per-rank gradients, bit for
bit in every mode: "none" (the mean), "bf16" (a cast before the sum)
and "int8" (one scale over the group, the reference's pmax; the int8
lanes summed in int32, which is exact). Three steps carry the
error-feedback buffers, each step's mean and buffers held.
"""
import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.parallel import compress as jcompress  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import mesh_cases  # noqa: E402
from repro_torch.parallel.compress import (CompressionState,  # noqa: E402
                                           init_compression)

MODES = ["none", "bf16", "int8"]
N_RANKS = 2
N_STEPS = 3
SHAPES = {"w": (16, 24), "b": (24,), "stack": (3, 5, 7)}


def _grads():
    """Per rank, gradients by name: f32 normals of unlike scales."""
    rng = np.random.default_rng(0)
    return [{name: (rng.standard_normal(shape) * 10.0 ** (i - 2))
             .astype(np.float32) for i, (name, shape) in
             enumerate(SHAPES.items())} for _ in range(N_RANKS)]


def _reference(mode, grads):
    """Each step's (mean, error buffers) of every rank, the reference's
    compressed_psum vmapped over the ranks."""
    stacked = {k: jnp.stack([g[k] for g in grads]) for k in SHAPES}

    def one(g, err):
        return jcompress.compressed_psum(
            g, jcompress.CompressionState(mode, err), "dp")

    step = jax.vmap(lambda g, err: (lambda o, s: (o, s.error))(*one(g, err)),
                    axis_name="dp")
    err = None if mode == "none" else jax.tree.map(jnp.zeros_like, stacked)
    out = []
    for _ in range(N_STEPS):
        mean, err = step(stacked, err)
        out.append((jax.tree.map(np.asarray, mean),
                    None if err is None else jax.tree.map(np.asarray, err)))
    return out


@pytest.fixture(scope="module")
def runs():
    grads = _grads()
    jobs = [("compress", dict(grads=grads, mode=m, steps=N_STEPS))
            for m in MODES] + [("modules", {})]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(meshlib.spawn, mesh_cases.run, N_RANKS, jobs,
                           device="cpu", timeout_s=60)
        ref = {m: _reference(m, grads) for m in MODES}
        per_rank = port.result()
    return per_rank, ref


@pytest.mark.parametrize("mode", MODES)
def test_compressed_psum_matches_reference_bit_for_bit(runs, mode):
    per_rank, ref = runs
    i = MODES.index(mode)
    for rank, results in enumerate(per_rank):
        for step, ((mean, err), (rmean, rerr)) in enumerate(
                zip(results[i], ref[mode])):
            for name in SHAPES:
                np.testing.assert_array_equal(mean[name], rmean[name][rank],
                                              err_msg=f"{step} {name}")
                if mode == "none":
                    assert err is None and rerr is None
                else:
                    np.testing.assert_array_equal(
                        err[name], rerr[name][rank], err_msg=f"{step} {name}")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_error_feedback_moves_the_mean_toward_exact(runs, mode):
    """Over the steps, the compressed means' running average nears the
    exact mean, and each buffer is what its rank's cast lost."""
    per_rank, _ = runs
    grads = _grads()
    results = per_rank[0][MODES.index(mode)]
    for name in SHAPES:
        exact = (grads[0][name] + grads[1][name]) / 2
        first = np.abs(results[0][0][name] - exact).max()
        avg = np.mean([r[0][name] for r in results], axis=0)
        assert np.abs(avg - exact).max() <= first
        assert np.abs(results[0][1][name]).max() > 0


def test_init_compression():
    g = {"w": torch.ones(2, 3)}
    assert init_compression(g) == CompressionState("none", None)
    state = init_compression(g, "int8")
    assert state.mode == "int8" and torch.equal(state.error["w"],
                                                torch.zeros(2, 3))


def test_rank_children_import_no_jax(runs):
    for roots in (r[-1] for r in runs[0]):
        assert "repro_torch" in roots
        assert not {"jax", "jaxlib", "repro"} & set(roots)
