"""The port's training path (`repro_torch.launch.steps.make_train_step`
and what it runs) against the JAX package's, on the CPU, from the
reference's `model.init` weights carried over by the numpy bridge:

- `lm_loss` with and without a mask, and its audio (ndim-3) branch,
  within 1e-6;
- `layers.mm`'s gradients with respect to the activations and the
  weight under every policy, with `ste` True (the exact product's
  gradient) and False (only through the dequantize scales, since
  round and the int8 cast have none), against `jax.grad`, within 1e-5
  of each gradient's max abs;
- train steps of smoke qwen3_8b (f32 compute) under every policy and
  of smoke qwen2_moe_a2_7b (exact, with the aux loss): at each of
  three steps the loss, aux and per-leaf gradients at the reference's
  own parameters of that step, and the port's own three-step run from
  the same start (its losses and parameters);
- remat on and off give equal losses and gradients, and a quantized
  step runs the sc_matmul wrapper 7 times a layer forward and 7 more
  in the recompute;
- the kernel wrappers refuse autograd: flash_attention,
  paged_attention and sc_matmul_quantized raise where a floating
  input requires grad under grad mode.

Tolerances. Exact (both families): loss within 1e-5 relative,
gradients within 1e-4 of each leaf's max abs (f32 sums in another
order; measured below 2e-6), parameters after one and three AdamW
steps within 0.05 x lr (measured 1.6e-2 x lr: where a gradient is near
zero Adam's first steps are about its sign).

Quantized policies part on last bits (ROADMAP Queue 3): the attention
context leaves its int8 contraction on the integer lattice of its
scales, so the output projection's quantization meets exact ties
(x / scale = k + 1/2), which a last-bit difference (XLA's fusions
against torch's ops) flips; under artemis a flipped value moves whole
readout levels. At a step where no tie flips, the port equals the
reference as tightly as under exact (measured: int8 steps 0 and 1,
artemis_mxu all three, artemis step 1), and every quantized policy
must show at least one such step. At a step where one flips (int8
step 2: loss 1.4e-4 relative, gradients 2.3e-2 of a leaf's max abs;
artemis steps 0 and 2: 2.1e-3 and 0.25), int8 and artemis_mxu are
held within 1e-3 and 5e-2, artemis within 1e-2 and 0.5, which still
fails a missing straight-through estimator (an error of about 1). The
reference parts from itself the same way: jitted against
`jax.disable_jit`, its artemis gradients differ by 4.8e-2 and 7.2e-2
of a leaf's max abs on seeds 0 and 1. A quantized run of its own
drifts after its first update, so its parameters after three steps
are held within 2 x lr x steps, what Adam's steps allow.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import (flash_attention, paged_attention,  # noqa: E402
                                 sc_matmul_quantized)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

MODES = ["exact", "int8", "artemis_mxu", "artemis"]
N_STEPS = 3
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)
# (loss relative, gradient of a leaf's max abs): where no tie flips,
# and the bound of a step where one does
TIGHT = (1e-5, 1e-4)
FLIP = {"exact": TIGHT, "int8": (1e-3, 5e-2), "artemis_mxu": (1e-3, 5e-2),
        "artemis": (1e-2, 0.5)}


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(configs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    return jc, tc


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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
    """The reference's batches of the three steps (numpy)."""
    jc, _ = _cfgs(arch)
    return [_np_tree(make_batch(jc, DataConfig(seq_len=16, global_batch=4),
                                step)) for step in range(N_STEPS)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch, mode):
    """The reference's three steps: per step (params, loss, aux, grads,
    metrics), and the final params."""
    jc, _ = _cfgs(arch)
    policy = JPolicy(mode=mode)

    def loss_fn(p, batch):
        logits, aux, _ = jmodel.apply(p, jc, {"tokens": batch["tokens"]},
                                      policy=policy)
        loss = jmodel.lm_loss(logits, batch["labels"])
        return loss + aux, (loss, aux)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    step_fn = jax.jit(jsteps.make_train_step(jc, JOpt(**OPT), policy))
    params = jmodel.init(jax.random.PRNGKey(0), jc)
    opt = jadamw_init(params)
    steps = []
    for batch in _batches(arch):
        (_, (loss, aux)), grads = grad_fn(params, batch)
        before = _np_tree(params)
        params, opt, metrics = step_fn(params, opt, batch)
        steps.append(dict(params=before, loss=float(loss), aux=float(aux),
                          grads=_np_tree(grads),
                          metrics={k: float(v) for k, v in metrics.items()}))
    return steps, _np_tree(params)


CASES = [("qwen3_8b", m) for m in MODES] + [("qwen2_moe_a2_7b", "exact")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_loss_and_grads_match_reference_at_each_step(arch, mode):
    """At each step's parameters of the reference's run, the port's
    forward and backward give the reference's loss, aux and gradients:
    tightly where no tie flips, and at one step at least."""
    _, tc = _cfgs(arch)
    ref, _ = _reference_run(arch, mode)
    n_tight = 0
    for i, (step, batch) in enumerate(zip(ref, _batches(arch))):
        model = bridge.params_from_numpy(step["params"], tc, device="cpu",
                                         train=True)
        loss, aux, grads = tsteps.loss_and_grads(
            model, tc, _torch_batch(batch), TPolicy(mode=mode))
        loss_err = abs(float(loss) - step["loss"]) / abs(step["loss"])
        grad_err = max(_leaf_errors(
            step["grads"], bridge.named_to_numpy(grads.items())).values())
        assert loss_err <= FLIP[mode][0] and grad_err <= FLIP[mode][1], \
            (i, loss_err, grad_err)
        n_tight += loss_err <= TIGHT[0] and grad_err <= TIGHT[1]
        assert float(aux) == pytest.approx(step["aux"], rel=1e-5,
                                           abs=1e-7), i
        if arch == "qwen2_moe_a2_7b":
            assert step["aux"] > 0
    assert n_tight >= (N_STEPS if mode == "exact" else 1)


@pytest.mark.parametrize("arch,mode", CASES)
def test_three_train_steps_match_reference(arch, mode):
    """The port's own run of `make_train_step` from the same start: its
    metrics at each step (the first as tightly as the step above), its
    parameters after the first step and after three."""
    _, tc = _cfgs(arch)
    ref, final = _reference_run(arch, mode)
    model = bridge.params_from_numpy(ref[0]["params"], tc, device="cpu",
                                     train=True)
    opt = adamw_init(model)
    step_fn = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy(mode=mode))
    first_tight = None
    for i, (step, batch) in enumerate(zip(ref, _batches(arch))):
        model, opt, metrics = step_fn(model, opt, _torch_batch(batch))
        got = {k: float(v) for k, v in metrics.items()}
        assert set(got) == set(step["metrics"])
        errs = {key: abs(got[key] - step["metrics"][key])
                / abs(step["metrics"][key])
                for key in ("loss", "total_loss", "grad_norm", "param_norm")}
        assert max(errs.values()) <= FLIP[mode][0], (i, errs)
        assert got["lr"] == pytest.approx(step["metrics"]["lr"], rel=1e-6)
        assert got["aux_loss"] == pytest.approx(step["metrics"]["aux_loss"],
                                                rel=1e-5, abs=1e-7)
        if i == 0:
            first_tight = max(errs.values()) <= TIGHT[0]
            if first_tight:
                _assert_params_close(ref[1]["params"], model,
                                     0.05 * OPT["lr"])
    assert first_tight or mode == "artemis"
    bound = (0.05 * OPT["lr"] if mode == "exact"
             else 2 * OPT["lr"] * N_STEPS)
    _assert_params_close(final, model, bound)
    assert int(opt["step"]) == N_STEPS


def _assert_params_close(want, model, bound):
    got = bridge.params_to_numpy(model)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        diff = np.abs(np.asarray(w) - g).max()
        assert diff <= bound, (jax.tree_util.keystr(path), diff, bound)


# ---------------------------------------------------------------------------
# lm_loss and the gradients of mm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["text", "text_masked", "audio"])
def test_lm_loss_matches_reference(case):
    rng = np.random.default_rng(3)
    shape = (3, 7, 4) if case == "audio" else (3, 7)
    logits = (rng.standard_normal(shape + (50,)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, shape).astype(np.int32)
    mask = None
    if case == "text_masked":
        mask = (rng.random((3, 7)) > 0.4).astype(np.float32)
    want = jmodel.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    got = tmodel.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("ste", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_mm_gradients_match_jax_grad(mode, ste):
    """d/dx and d/dw of sum(mm(x, w) * cot): with the STE the exact
    product's, without it only the dequantize scales' (round and the
    int8 cast carry none), as jax.grad gives them."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((3, 5, 24)).astype(np.float32)
    jpol, tpol = JPolicy(mode=mode, ste=ste), TPolicy(mode=mode, ste=ste)
    want = jax.grad(lambda a, b: jnp.sum(JL.mm(a, b, jpol) * cot),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (TL.mm(tx, tw, tpol) * torch.from_numpy(cot)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad), want):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    if mode != "exact" and not ste:
        # only the per-tensor activation scale carries a gradient: it
        # reaches x through its absmax alone
        assert np.count_nonzero(tx.grad.numpy()) <= 2


# ---------------------------------------------------------------------------
# remat and the kernel launches of a step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_remat_on_and_off_agree(mode):
    _, tc = _cfgs("qwen3_8b")
    ref, _ = _reference_run("qwen3_8b", "exact")
    batch = _torch_batch(_batches("qwen3_8b")[0])
    out = []
    for remat in (True, False):
        model = bridge.params_from_numpy(ref[0]["params"], tc, device="cpu",
                                         train=True)
        loss, _, grads = tsteps.loss_and_grads(model, tc, batch,
                                               TPolicy(mode=mode), remat)
        out.append((float(loss), {k: g.clone() for k, g in grads.items()}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        torch.testing.assert_close(g, out[1][1][name], rtol=0, atol=0)


@pytest.mark.parametrize("remat", [True, False])
def test_quantized_step_runs_the_kernel_wrapper_per_projection(remat,
                                                               monkeypatch):
    """7 dense projections a layer forward, 7 more in the recompute."""
    import importlib
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real, calls = am.sc_matmul_quantized, []

    def counting(aq, bq, **kw):
        calls.append(tuple(aq.shape) + (bq.shape[1],))
        return real(aq, bq, **kw)

    monkeypatch.setattr(am, "sc_matmul_quantized", counting)
    _, tc = _cfgs("qwen3_8b")
    model = tmodel.init(tc, seed=0, device="cpu", train=True)
    step = tsteps.make_train_step(tc, TOpt(**OPT), TPolicy(mode="int8"),
                                  remat=remat)
    step(model, adamw_init(model), _torch_batch(_batches("qwen3_8b")[0]))
    assert len(calls) == 7 * tc.n_layers * (2 if remat else 1)
    assert all(c[0] == 4 * 16 for c in calls)      # M = batch x seq


def test_training_model_keeps_f32_master_weights():
    _, tc = _cfgs("qwen3_8b")
    tc = dataclasses.replace(tc, compute_dtype="bfloat16")
    model = tmodel.init(tc, seed=0, device="cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    x = model.embed_tokens(torch.zeros((1, 3), dtype=torch.int32))
    assert x.dtype == torch.bfloat16
    serve = tmodel.init(tc, seed=0, device="cpu")
    assert serve.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    with pytest.raises(NotImplementedError, match="item 10"):
        tmodel.empty(configs.get_config("rwkv6_3b", smoke=True),
                     device="cpu", train=True)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse autograd
# ---------------------------------------------------------------------------

def _flash_call(requires_grad):
    q = torch.randn(1, 2, 4, 16, requires_grad=requires_grad)
    kv = torch.randn(1, 2, 4, 16)
    return lambda: flash_attention(q, kv, kv)


def _paged_call(requires_grad):
    q = torch.randn(1, 1, 2, 16, requires_grad=requires_grad)
    pages = torch.randn(3, 4, 2, 16)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    pos = torch.tensor([[5]], dtype=torch.int32)
    return lambda: paged_attention(q, pages, pages, table, pos)


def _sc_call(requires_grad):
    a = torch.randn(4, 32, requires_grad=requires_grad)
    b = torch.randint(-127, 128, (32, 16), dtype=torch.int8)
    if requires_grad:
        return lambda: sc_matmul_quantized(a, b, mode="int8")
    return lambda: sc_matmul_quantized(a.to(torch.int8), b, mode="int8")


@pytest.mark.parametrize("make,route", [
    (_flash_call, "gather core"), (_paged_call, "gather core"),
    (_sc_call, "straight-through estimator")])
def test_kernel_wrappers_refuse_autograd(make, route):
    with pytest.raises(RuntimeError, match=route):
        make(True)()
    with torch.no_grad():            # serving: grad mode off
        if make is not _sc_call:
            make(True)()
    make(False)()                    # nothing requires grad
