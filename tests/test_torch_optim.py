"""The port's AdamW (`repro_torch.optim`) against the JAX package's, on
the CPU:

- `cosine_schedule` at every step of a run within 1e-6 relative (XLA's
  cos and torch's may part in the last bit);
- `global_norm` and the clip within 1e-6 relative: the port sums its
  per-layer tensors in another order than the reference its stacked
  leaves;
- `adamw_update` from identical inputs (a smoke qwen3_8b tree of
  weights, gradients and moments): the new parameters within
  two ulps of the parameter plus 1e-5 x lr (XLA fuses `p - lr * u`
  and the moments' `b * m + (1 - b) * g` into FMAs, torch rounds each
  product; where a moment nearly cancels, u moves by a few 1e-6), the
  moments within
  1e-6 of each leaf's max abs, the step and the metrics;
- weight decay by the reference's leaf rank: the per-layer norm scales
  and qk-norm scales, stacked (L, d) leaves there and (d,) tensors
  here, are decayed, the final norm's (d,) scale is not;
- the counterparts of `tests/test_substrate.py`'s optimizer cases.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.optim import (OptimizerConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule, global_norm)


class _Params(torch.nn.Module):
    """A flat module of named parameters."""

    def __init__(self, named: dict):
        super().__init__()
        for name, value in named.items():
            self.register_parameter(name, torch.nn.Parameter(value))

    @property
    def device(self):
        return next(self.parameters()).device


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=60, min_lr_frac=0.1)
    steps = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.cosine_schedule(
        JOpt(**cfg), s))(jnp.asarray(steps)))
    got = cosine_schedule(OptimizerConfig(**cfg), torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _smoke_tree(seed=0):
    cfg = dataclasses.replace(jconfigs.get_config("qwen3_8b", smoke=True),
                              compute_dtype="float32")
    tcfg = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                               compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def like(scale):
        return jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                       * scale).astype(np.float32), params)
    return tcfg, jax.tree.map(np.asarray, params), like


@pytest.mark.parametrize("step0,clip", [(0, 1.0), (4, 1.0), (4, 1e3)])
def test_adamw_update_matches_reference(step0, clip):
    tcfg, params, like = _smoke_tree()
    grads, m0 = like(0.05), like(0.01)
    v0 = jax.tree.map(np.abs, like(1e-3))
    cfg = dict(lr=2e-3, warmup_steps=3, total_steps=20, clip_norm=clip)
    jstate = {"m": m0, "v": v0, "step": jnp.int32(step0)}
    want_p, want_s, want_m = jax.jit(
        lambda p, g, s: jadamw.adamw_update(p, g, s, JOpt(**cfg)))(
        params, grads, jstate)

    model = bridge.params_from_numpy(params, tcfg, device="cpu", train=True)
    state = bridge.opt_state_from_numpy(
        {"m": m0, "v": v0, "step": np.int32(step0)}, model)
    tgrads = bridge.opt_state_from_numpy(
        {"m": grads, "v": grads, "step": np.int32(0)}, model)["m"]
    got_m = adamw_update(model, tgrads, state, OptimizerConfig(**cfg))

    assert int(state["step"]) == step0 + 1
    for key in ("lr", "grad_norm", "param_norm"):
        assert float(got_m[key]) == pytest.approx(float(want_m[key]),
                                                  rel=1e-6), key
    if clip < 1e2:
        assert float(got_m["grad_norm"]) > clip   # the clip is active
    got_p = bridge.params_to_numpy(model)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(want_p)[0],
            jax.tree_util.tree_flatten_with_path(got_p)[0]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2.4e-7,
                                   atol=1e-5 * cfg["lr"],
                                   err_msg=jax.tree_util.keystr(path))
    got_s = bridge.opt_state_to_numpy(state, model)
    for part in ("m", "v"):
        for w, g in zip(jax.tree.leaves(want_s[part]),
                        jax.tree.leaves(got_s[part])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=1e-6 * np.abs(w).max())


def test_weight_decay_follows_the_reference_leaf_rank():
    """With zero gradients and moments only the decay moves a weight."""
    tcfg, params, _ = _smoke_tree()
    model = bridge.params_from_numpy(params, tcfg, device="cpu", train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    adamw_update(model, zeros, adamw_init(model),
                 OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.5))
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    assert "layers.0.ln1.scale" in moved
    assert "layers.1.attn.q_norm" in moved
    assert "layers.0.attn.wq" in moved and "embed" in moved
    assert "final_norm.scale" not in moved
    assert bridge.leaf_ndim("layers.0.ln1.scale", before["layers.0.ln1.scale"]) == 2
    assert bridge.leaf_ndim("final_norm.scale", before["final_norm.scale"]) == 1
    # the reference's update moves exactly the same leaves
    want_p, _, _ = jadamw.adamw_update(
        params, jax.tree.map(np.zeros_like, params),
        jadamw.adamw_init(params),
        JOpt(lr=0.1, warmup_steps=0, weight_decay=0.5))
    for path, w in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        orig = params
        for k in path:
            orig = orig[k.key]
        ref_moved = not np.array_equal(np.asarray(w), orig)
        name = ".".join(k.key for k in path)
        if name.startswith("layers."):
            name = "layers.0." + name[len("layers."):]
        assert ref_moved == (name in moved), name


def test_global_norm_matches_reference():
    """Over the port's per-layer tensors, summed in another order."""
    tcfg, params, _ = _smoke_tree(1)
    model = bridge.params_from_numpy(params, tcfg, device="cpu", train=True)
    want = float(jadamw.global_norm(params))
    assert float(global_norm(model.parameters())) == pytest.approx(
        want, rel=1e-6)


# ---------------------------------------------------------------------------
# counterparts of tests/test_substrate.py's optimizer cases
# ---------------------------------------------------------------------------

def _module(**tensors):
    return _Params({k: torch.tensor(v, dtype=torch.float32)
                    for k, v in tensors.items()})


def test_quadratic_convergence():
    model = _module(w=[5.0, -3.0, 2.0])
    cfg = OptimizerConfig(lr=0.3, warmup_steps=5, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
    state = adamw_init(model)
    for _ in range(200):
        grads = {"w": 2.0 * model.w.detach()}
        adamw_update(model, grads, state, cfg)
    assert float(model.w.detach().abs().max()) < 1e-2


def test_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    step = lambda s: float(cosine_schedule(cfg, torch.tensor(s)))  # noqa: E731
    assert step(0) < 0.2
    assert abs(step(10) - 1.0) < 1e-6
    assert abs(step(100) - 0.1) < 1e-2


def test_clipping():
    model = _module(w=[0.0] * 4)
    cfg = OptimizerConfig(lr=1.0, clip_norm=1.0, warmup_steps=0,
                          weight_decay=0.0)
    m = adamw_update(model, {"w": torch.full((4,), 100.0)},
                     adamw_init(model), cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_global_norm():
    assert float(global_norm([torch.ones(4), torch.ones(2, 6)])) == \
        pytest.approx(4.0)
