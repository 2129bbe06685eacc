"""Training of the port's recurrent families against the JAX package's,
on the CPU: rwkv6_3b and zamba2_7b at their smoke sizes with f32
compute, weights from the reference's `model.init` through the numpy
bridge.

- the train step (`loss_and_grads`, `make_train_step`): at each of
  three steps' parameters of the reference's exact run, the loss within
  1e-5 relative and every gradient within 1e-4 of its leaf's max abs
  (`jax.grad` through the reference's chunked wkv and SSD scans) under
  the exact policy (measured 8.4e-8 and 1.8e-6 for rwkv6, 8.2e-8 and
  1.6e-5 for zamba2). Under int8 a step is held within 1e-3 and 0.25,
  the bounds for an int8 value flipped at a rounding tie
  (`tests/test_torch_multimodal.py`), and at least one step must be
  tight: rwkv6's three are (1.6e-7, 1.3e-6); zamba2's steps 0 and 1 are
  within 6.3e-6 / 3.8e-3, its step 2 parts by 2.0e-4 / 0.12, where the
  reference parts from itself (jitted against `jax.disable_jit`) by
  7.9e-5 / 1.7e-2. The port's own three exact steps end within 0.05 x
  lr of the reference's parameters for rwkv6 and 1 x lr for zamba2
  (`PARAM_TOL`);
- the clip tie: in `_wkv_chunked`'s kept sub-diagonal the exponent
  `lx_t - lc_{t-1}` is often exactly 0, the clip's upper bound, where
  `jnp.clip` passes half the gradient and `torch.clamp` all of it; the
  port's `rwkv6.clip` passes half, as jax. That exponent is identically
  0 as a function of log_w, so the share cancels on its way back: the
  inputs' gradients equal jax's within 1e-5 with either clip;
- remat on and off agree exactly, and an int8 step runs the sc_matmul
  wrapper once a projection (rwkv6 9 a layer; zamba2 2 a Mamba2 layer
  and 7 a shared-block invocation) and again in the recompute of each
  rematerialized layer (the shared block is not);
- the shared block's gradients sum over its invocations;
- the trees: `bridge.leaf_ndim` equals the rank of each leaf in the
  reference's tree (stacked per-layer vectors such as rwkv6's `maa_x`
  are decayed, zamba2's unstacked `shared` vectors and rwkv6's `ln0`
  are not), AdamW's state crosses the bridge both ways, and a training
  model keeps f32 master weights with gradients on;
- a checkpoint crosses between the packages, and `train()` of each
  family resumes bit for bit.
"""
import dataclasses
import functools
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
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager)
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCHS = ["rwkv6_3b", "zamba2_7b"]
N_STEPS = 3
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)
# (loss relative, gradient of a leaf's max abs): where no int8 tie flips,
# and the bound of a step where one does (module docstring)
TIGHT = (1e-5, 1e-4)
FLIP = {"exact": TIGHT, "int8": (1e-3, 0.25)}
DCFG = dict(seq_len=16, global_batch=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference cfg, port cfg, reference params) at f32 compute."""
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(configs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    return jc, tc, jmodel.init(jax.random.PRNGKey(0), jc)


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


@functools.lru_cache(maxsize=None)
def _batches(arch):
    jc, _, _ = _setup(arch)
    return [_np_tree(jpipe.make_batch(jc, jpipe.DataConfig(**DCFG), step))
            for step in range(N_STEPS)]


def _torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's three exact steps of `make_train_step`: per step
    the parameters before it and the step's loss, and the final
    parameters."""
    jc, _, params = _setup(arch)
    policy = JPolicy()
    step_fn = jax.jit(jsteps.make_train_step(jc, JOpt(**OPT), policy))
    opt = jadamw_init(params)
    steps = []
    for batch in _batches(arch):
        steps.append(dict(params=_np_tree(params)))
        params, opt, metrics = step_fn(params, opt, batch)
        steps[-1]["loss"] = float(metrics["loss"])
    return steps, _np_tree(params)


@functools.lru_cache(maxsize=None)
def _reference_grads(arch, mode):
    """The reference's loss and gradients (`jax.grad` of its train
    step's objective) under `mode` at each step's parameters of the
    exact run."""
    jc = _setup(arch)[0]
    policy = JPolicy(mode=mode)

    def loss_fn(p, batch):
        inputs = {"tokens": batch["tokens"]}
        if "prefix_embeds" in batch:
            inputs["prefix_embeds"] = batch["prefix_embeds"]
        logits, aux, _ = jmodel.apply(p, jc, inputs, policy=policy)
        if "prefix_embeds" in batch:
            logits = logits[:, -batch["tokens"].shape[1]:]
        return jmodel.lm_loss(logits, batch["labels"]) + aux

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    out = []
    for step, batch in zip(_reference_run(arch)[0], _batches(arch)):
        loss, grads = grad_fn(step["params"], batch)
        out.append(dict(loss=float(loss), grads=_np_tree(grads)))
    return out


def _train_model(arch, step=0):
    _, tc, _ = _setup(arch)
    ref, _ = _reference_run(arch)
    return bridge.params_from_numpy(ref[step]["params"], tc, device="cpu",
                                    train=True)


# ---------------------------------------------------------------------------
# the train step against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_at_each_step(arch, mode):
    _, tc, _ = _setup(arch)
    ref, _ = _reference_run(arch)
    n_tight = 0
    for i, (step, want, batch) in enumerate(zip(
            ref, _reference_grads(arch, mode), _batches(arch))):
        model = bridge.params_from_numpy(step["params"], tc, device="cpu",
                                         train=True)
        loss, aux, grads = tsteps.loss_and_grads(
            model, tc, _torch_batch(batch), TPolicy(mode=mode))
        loss_err = abs(float(loss) - want["loss"]) / abs(want["loss"])
        errs = _leaf_errors(want["grads"],
                            bridge.named_to_numpy(grads.items()))
        worst = max(errs, key=errs.get)
        assert loss_err <= FLIP[mode][0] and errs[worst] <= FLIP[mode][1], \
            (i, loss_err, worst, errs[worst])
        n_tight += loss_err <= TIGHT[0] and errs[worst] <= TIGHT[1]
        assert float(aux) == 0.0
    assert n_tight >= (N_STEPS if mode == "exact" else 1)


# the port's own run against the reference's parameters after three
# steps: zamba2's gradients part from the reference's by up to 1.6e-5 of
# a leaf's max abs (rwkv6's 1.2e-6), and Adam's normalized steps carry
# that to elements whose gradient is small against their leaf's
# (measured 0.43 x lr on zamba2's out_proj, 6.2e-3 x lr on rwkv6); a
# wrong gradient moves an element by up to 2 x lr a step
PARAM_TOL = {"rwkv6_3b": 0.05, "zamba2_7b": 1.0}


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    _, tc, _ = _setup(arch)
    ref, final = _reference_run(arch)
    model = _train_model(arch)
    opt = adamw_init(model)
    step_fn = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy())
    for step, batch in zip(ref, _batches(arch)):
        model, opt, metrics = step_fn(model, opt, _torch_batch(batch))
        assert float(metrics["loss"]) == pytest.approx(step["loss"],
                                                       rel=1e-5)
    got = bridge.params_to_numpy(model)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(final)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        assert np.abs(w - g).max() <= PARAM_TOL[arch] * OPT["lr"], \
            jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the clip tie
# ---------------------------------------------------------------------------

def _wkv_inputs():
    rng = np.random.default_rng(11)
    b, s, h, n = 2, 16, 2, 8
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.standard_normal((b, s, h, n)) * 0.5
                    - 1.0).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    cot = rng.standard_normal((b, s, h, n)).astype(np.float32)
    return (r, k, v, log_w, u, s0), cot


def _port_wkv_grads(args, cot, clip):
    """The gradients of `_wkv_chunked`'s inputs with `clip` as its
    clip, and (exponent, its gradient, the clip output's gradient) of
    the wkv exponent."""
    seen = []

    def spy(x, lo, hi):
        y = clip(x, lo, hi)
        if lo == -60.0:
            x.retain_grad()
            y.retain_grad()
            seen.append((x, y))
        return y

    ts = [_t(a).requires_grad_(True) for a in args]
    real = rwkv6.clip
    rwkv6.clip = spy
    try:
        o, s_final = rwkv6._wkv_chunked(*ts, chunk=8)
    finally:
        rwkv6.clip = real
    (torch.sum(o * _t(cot)) + torch.sum(s_final)).backward()
    x = torch.cat([a.detach().flatten() for a, _ in seen])
    gx = torch.cat([a.grad.flatten() for a, _ in seen])
    gy = torch.cat([b.grad.flatten() for _, b in seen])
    return [t.grad.numpy() for t in ts], (x, gx, gy)


def test_wkv_clip_tie_takes_jax_gradient():
    """Where the wkv exponent ties the clip's upper bound (0.0: in the
    kept sub-diagonal, lx_t - lc_{t-1}), `rwkv6.clip` passes half the
    gradient to it, as `jnp.clip`, and `torch.clamp` all of it. That
    exponent is identically 0 as a function of log_w (lx_t = lc_{t-1}),
    so the share it passes cancels on the way back to log_w: the
    gradients of `_wkv_chunked`'s inputs equal jax's within 1e-5 of
    their max abs with either clip, and the fix keeps the pass
    jax's op for op."""
    args, cot = _wkv_inputs()

    def loss(*a):
        o, s_final = jrwkv6._wkv_chunked(*a, chunk=8)
        return jnp.sum(o * cot) + jnp.sum(s_final)

    want = [np.asarray(g) for g in jax.grad(loss, argnums=range(6))(
        *map(jnp.asarray, args))]
    for clip, share in ((rwkv6.clip, 0.5), (torch.clamp, 1.0)):
        got, (x, gx, gy) = _port_wkv_grads(args, cot, clip)
        tie = (x == 0.0) & (gy != 0)
        assert int(tie.sum()) > 100, int(tie.sum())
        torch.testing.assert_close(gx[tie], share * gy[tie], rtol=0, atol=0)
        inside = (x > -60.0) & (x < 0.0)
        torch.testing.assert_close(gx[inside], gy[inside], rtol=0, atol=0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    jtie = jax.grad(lambda e: jnp.sum(jnp.clip(e, -60.0, 0.0)))(
        jnp.zeros(3))
    np.testing.assert_array_equal(np.asarray(jtie), 0.5)


def test_clip_is_jnp_clip():
    x = torch.tensor([-70.0, -60.0, -1.0, 0.0, 3.0], requires_grad=True)
    y = rwkv6.clip(x, -60.0, 0.0)
    torch.testing.assert_close(y, torch.clamp(x, -60.0, 0.0), rtol=0,
                               atol=0)
    y.sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, -60.0, 0.0)))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# remat, the kernel launches of a step, the shared block
# ---------------------------------------------------------------------------

def _launches_per_forward(tc, remat: bool) -> int:
    """sc_matmul wrapper calls of one int8 train step."""
    if tc.family == "rwkv6":
        return 9 * tc.n_layers * (2 if remat else 1)
    shared = 4 + (3 if tc.glu else 2)
    return (2 * tc.n_layers * (2 if remat else 1)
            + shared * zamba2.n_invocations(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_agree_and_launch_per_projection(arch, monkeypatch):
    import importlib
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real, calls = am.sc_matmul_quantized, []

    def counting(aq, bq, **kw):
        calls.append(aq.shape[0])
        return real(aq, bq, **kw)

    monkeypatch.setattr(am, "sc_matmul_quantized", counting)
    _, tc, _ = _setup(arch)
    batch = _torch_batch(_batches(arch)[0])
    rows = DCFG["global_batch"] * DCFG["seq_len"]
    for mode in ("exact", "int8"):
        out = []
        for remat in (True, False):
            calls.clear()
            loss, _, grads = tsteps.loss_and_grads(
                _train_model(arch), tc, batch, TPolicy(mode=mode), remat)
            out.append((float(loss), {k: g.clone() for k, g in
                                      grads.items()}))
            want = 0 if mode == "exact" else _launches_per_forward(tc, remat)
            assert len(calls) == want and set(calls) <= {rows}
        assert out[0][0] == out[1][0]
        for name, g in out[0][1].items():
            torch.testing.assert_close(g, out[1][1][name], rtol=0, atol=0)


def test_shared_block_gradients_sum_over_invocations():
    """zamba2's shared block runs `n_invocations` times: its gradient is
    the sum of what each invocation contributes (each through a copy of
    the block, the rest held)."""
    _, tc, _ = _setup("zamba2_7b")
    assert zamba2.n_invocations(tc) >= 2
    batch = _torch_batch(_batches("zamba2_7b")[0])
    model = _train_model("zamba2_7b")
    _, _, grads = tsteps.loss_and_grads(model, tc, batch)
    whole = {k: g.clone() for k, g in grads.items() if k.startswith("shared")}
    parts = []
    real = zamba2._shared_block
    for inv in range(zamba2.n_invocations(tc)):
        seen = []

        def one(sp, *args, inv=inv, seen=seen):
            if len(seen) != inv:                 # the others: frozen copies
                sp = _frozen_copy(sp)
            seen.append(1)
            return real(sp, *args)

        zamba2._shared_block = one
        try:
            _, _, g = tsteps.loss_and_grads(model, tc, batch)
        finally:
            zamba2._shared_block = real
        parts.append({k: g[k].clone() for k in whole})
    for k, g in whole.items():
        torch.testing.assert_close(sum(p[k] for p in parts), g, rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))


def _frozen_copy(module):
    import copy
    twin = copy.deepcopy(module)
    twin.requires_grad_(False)
    return twin


# ---------------------------------------------------------------------------
# the trees: ranks and weight decay, AdamW's state, master weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_ranks_and_optimizer_state_match_the_reference_tree(arch):
    _, tc, params = _setup(arch)
    ranks = {".".join(str(getattr(k, "key", k)) for k in path): a.ndim
             for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    model = _train_model(arch)
    seen = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        ref_name = ".".join(parts[:1] + parts[2:]) if parts[0] == "layers" \
            else name
        assert bridge.leaf_ndim(name, p) == ranks[ref_name], name
        seen.add(ref_name)
    assert seen == set(ranks)
    if arch == "rwkv6_3b":
        assert ranks["layers.maa_x"] == 2 and ranks["ln0.scale"] == 1
    else:
        assert ranks["shared.ln1.scale"] == 1
        assert ranks["layers.A_log"] == 2
    opt = adamw_init(model)
    step_fn = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy())
    model, opt, _ = step_fn(model, opt, _torch_batch(_batches(arch)[0]))
    tree = bridge.opt_state_to_numpy(opt, model)
    assert jax.tree.structure(tree) == jax.tree.structure(
        _np_tree(jadamw_init(params)))
    back = bridge.opt_state_from_numpy(tree, model)
    assert int(back["step"]) == 1
    for part in ("m", "v"):
        for name, t in opt[part].items():
            assert torch.equal(back[part][name], t), (part, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_model_keeps_f32_master_weights(arch):
    tc = configs.get_config(arch, smoke=True)           # bf16 compute
    model = tmodel.init(tc, seed=0, device="cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    with torch.no_grad():
        logits, _, _ = tmodel.apply(model, tc, {"tokens": torch.zeros(
            (1, 3), dtype=torch.int32)})
    assert logits.dtype == torch.bfloat16
    serve = tmodel.init(tc, seed=0, device="cpu")
    assert serve.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())


# ---------------------------------------------------------------------------
# checkpoints and restart
# ---------------------------------------------------------------------------

def test_checkpoint_crosses_between_the_packages(tmp_path):
    """rwkv6's training state: the reference's checkpoint after a step
    restores in the port, whose next step gives the reference's; the
    port's checkpoint restores in the reference's manager, leaves
    equal."""
    jc, tc, params = _setup("rwkv6_3b")
    batches = _batches("rwkv6_3b")
    step_fn = jax.jit(jsteps.make_train_step(jc, JOpt(**OPT), JPolicy()))
    params, opt, _ = step_fn(params, jadamw_init(params), batches[0])
    JManager(JCkptConfig(str(tmp_path / "ref"), async_save=False)).save(
        1, {"params": params, "opt": opt})
    like = tmodel.init(tc, seed=1, device="cpu", train=True)
    step, tree = CheckpointManager(CheckpointConfig(
        str(tmp_path / "ref"))).restore_latest(
        ttrain.train_state(like, adamw_init(like)))
    assert step == 1
    model = bridge.params_from_numpy(tree["params"], tc, device="cpu",
                                     train=True)
    state = bridge.opt_state_from_numpy(tree["opt"], model)
    want_p, _, want_m = step_fn(params, opt, batches[1])
    model, state, got_m = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy())(
        model, state, _torch_batch(batches[1]))
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=1e-5)
    for w, g in zip(jax.tree.leaves(want_p),
                    jax.tree.leaves(bridge.params_to_numpy(model))):
        assert np.abs(np.asarray(w) - g).max() <= 0.05 * OPT["lr"]
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "port")))
    saved = ttrain.train_state(model, state)
    mgr.save(2, saved)
    mgr.wait()
    step, out = JManager(JCkptConfig(str(tmp_path / "port"))).restore_latest(
        {"params": want_p, "opt": opt})
    assert step == 2
    for w, g in zip(jax.tree.leaves(saved), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_resumes_to_the_uninterrupted_run(arch, tmp_path, capsys):
    kw = dict(arch=arch, steps=4, seq_len=8, global_batch=2, save_every=2,
              log_every=100, device="cpu")
    whole = ttrain.train(ckpt_dir=str(tmp_path / "a"), **kw)
    shutil.copytree(tmp_path / "a" / "step_000000002",
                    tmp_path / "b" / "step_000000002")
    resumed = ttrain.train(ckpt_dir=str(tmp_path / "b"), **kw)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert resumed["losses"] == whole["losses"][2:]
    for (name, p), q in zip(whole["model"].named_parameters(),
                            resumed["model"].parameters()):
        assert torch.equal(p, q), name
