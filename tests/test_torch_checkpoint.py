"""The port's checkpoints (`repro_torch.checkpoint`) and its trainer's
restart (`repro_torch.launch.train`), on the CPU:

- the on-disk layout is the reference's: the same leaf order, `paths`
  and `treedef` as jax gives the same tree, a `.npy` per leaf;
- a checkpoint the reference's manager writes after a step restores in
  the port (weights and AdamW state through the bridge), and the port's
  next step gives the reference's next step: the loss within 1e-5
  relative, the parameters within 0.05 x lr (as in
  `tests/test_torch_train.py`);
- a checkpoint the port writes restores through the reference's
  `load_pytree(like=)`, every leaf equal;
- `train()` resumed from step 3 of 6 (the later checkpoint removed, as
  if the job had died after saving step 3) gives the uninterrupted
  run's last three losses bit for bit, and the same weights;
- the counterparts of `tests/test_substrate.py`'s checkpoint cases:
  round trip, corruption detected with fallback, keep-k, async save,
  no `.tmp` left, shape mismatch rejected.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointConfig as JCkptConfig  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import load_pytree as jload  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)


def _cfgs():
    jc = dataclasses.replace(jconfigs.get_config("qwen3_8b", smoke=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                             compute_dtype="float32")
    return jc, tc


def _batch(jc, step):
    return jax.tree.map(np.asarray, make_batch(
        jc, DataConfig(seq_len=16, global_batch=4), step))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _reference_state(jc, n_steps):
    params = jmodel.init(jax.random.PRNGKey(0), jc)
    opt = jadamw_init(params)
    step_fn = jax.jit(jsteps.make_train_step(jc, JOpt(**OPT), JPolicy()))
    metrics = None
    for step in range(n_steps):
        params, opt, metrics = step_fn(params, opt, _batch(jc, step))
    return params, opt, step_fn, metrics


def test_layout_is_the_references(tmp_path):
    jc, tc = _cfgs()
    params, opt, _, _ = _reference_state(jc, 0)
    jtree = {"params": params, "opt": opt}
    jsave(jtree, str(tmp_path / "ref"))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tc,
                                     device="cpu", train=True)
    save_pytree(ttrain.train_state(model, adamw_init(model)),
                str(tmp_path / "port"))
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("ref", "port")]
    for key in ("treedef", "paths"):
        assert manifests[0][key] == manifests[1][key], key
    for a, b in zip(manifests[0]["leaves"], manifests[1]["leaves"]):
        assert (a["file"], a["shape"], a["dtype"]) == \
            (b["file"], b["shape"], b["dtype"])
    assert "['params']['layers']['attn']['wq']" in manifests[1]["paths"]


def test_reference_checkpoint_restores_and_steps_in_the_port(tmp_path):
    jc, tc = _cfgs()
    params, opt, step_fn, _ = _reference_state(jc, 1)
    mgr = JManager(JCkptConfig(str(tmp_path), async_save=False))
    mgr.save(1, {"params": params, "opt": opt})

    port_mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    like_model = tsteps.modellib.init(tc, seed=1, device="cpu", train=True)
    step, tree = port_mgr.restore_latest(
        ttrain.train_state(like_model, adamw_init(like_model)))
    assert step == 1
    model = bridge.params_from_numpy(tree["params"], tc, device="cpu",
                                     train=True)
    state = bridge.opt_state_from_numpy(tree["opt"], model)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32

    want_p, _, want_m = step_fn(params, opt, _batch(jc, 1))
    port_step = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy())
    model, state, got_m = port_step(model, state,
                                    _torch_batch(_batch(jc, 1)))
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=1e-5)
    assert int(state["step"]) == 2
    got_p = bridge.params_to_numpy(model)
    for w, g in zip(jax.tree.leaves(want_p), jax.tree.leaves(got_p)):
        assert np.abs(np.asarray(w) - g).max() <= 0.05 * OPT["lr"]


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    jc, tc = _cfgs()
    params, opt, _, _ = _reference_state(jc, 0)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tc,
                                     device="cpu", train=True)
    state = adamw_init(model)
    step_fn = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy())
    model, state, _ = step_fn(model, state, _torch_batch(_batch(jc, 0)))
    saved = ttrain.train_state(model, state)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(1, saved)
    mgr.wait()
    out = jload(os.path.join(str(tmp_path), "step_000000001"),
                like={"params": params, "opt": opt})
    assert int(out["opt"]["step"]) == 1
    assert out["opt"]["step"].dtype == jnp.int32
    for w, g in zip(jax.tree.leaves(saved), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(g), w)
    # and the reference's manager finds it
    step, _ = JManager(JCkptConfig(str(tmp_path))).restore_latest(
        {"params": params, "opt": opt})
    assert step == 1


def test_train_resumes_to_the_uninterrupted_run(tmp_path, capsys):
    kw = dict(steps=6, seq_len=16, global_batch=4, save_every=3,
              log_every=100, device="cpu")
    whole = ttrain.train(ckpt_dir=str(tmp_path / "a"), **kw)
    assert sorted(os.listdir(tmp_path / "a")) == ["step_000000003",
                                                   "step_000000006"]
    # a job that died after saving step 3
    shutil.copytree(tmp_path / "a" / "step_000000003",
                    tmp_path / "b" / "step_000000003")
    resumed = ttrain.train(ckpt_dir=str(tmp_path / "b"), **kw)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert resumed["losses"] == whole["losses"][3:]
    for (name, p), q in zip(whole["model"].named_parameters(),
                            resumed["model"].parameters()):
        assert torch.equal(p, q), name
    assert int(resumed["opt_state"]["step"]) == 6


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    ttrain.main(["--device", "cpu", "--steps", "2", "--seq-len", "8",
                 "--global-batch", "2", "--policy", "int8",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss" in out
    assert os.listdir(tmp_path) == ["step_000000002"]


# ---------------------------------------------------------------------------
# counterparts of tests/test_substrate.py's checkpoint cases
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": np.arange(3.0, dtype=np.float32),
            "step": np.int32(7)}


def test_roundtrip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "step_1")
    save_pytree(tree, path)
    out = load_pytree(path, like=jax.tree.map(np.zeros_like, tree))
    for key in tree:
        np.testing.assert_array_equal(out[key], tree[key])
        assert out[key].dtype == tree[key].dtype


def test_corruption_detected_and_fallback(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path),
                                             async_save=False))
    t1, t2 = _tree(1), _tree(2)
    mgr.save(1, t1)
    mgr.save(2, t2)
    victim = os.path.join(str(tmp_path), "step_000000002", "00000.npy")
    with open(victim, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    step, out = mgr.restore_latest(jax.tree.map(np.zeros_like, t1))
    assert step == 1   # fell back past the corrupt one
    np.testing.assert_array_equal(out["w"], t1["w"])


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2,
                                             async_save=False))
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path),
                                             async_save=True))
    t = _tree()
    mgr.save(5, t)
    mgr.wait()
    step, _ = mgr.restore_latest(jax.tree.map(np.zeros_like, t))
    assert step == 5


def test_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path),
                                             async_save=False))
    mgr.save(1, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "step_9")
    save_pytree({"w": np.zeros((4,), np.float32)}, path)
    with pytest.raises(ValueError):
        load_pytree(path, like={"w": np.zeros((5,), np.float32)})
