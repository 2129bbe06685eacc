"""The port's layers and model weights against the JAX package's.

Same numpy inputs through `repro.models.layers` and
`repro_torch.models.layers` at float32 (rtol=atol=1e-5: XLA's CPU ops
and torch's round the same f32 math in other orders), and the numpy
bridge round-tripping every leaf of the reference's `model.init`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 64), _rand(rng, 64)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = TL.rmsnorm(_t(scale), _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_headwise_rmsnorm():
    rng = np.random.default_rng(1)
    x, scale = _rand(rng, 2, 3, 4, 16), _rand(rng, 16)
    want = JL.headwise_rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    got = TL.headwise_rmsnorm(_t(scale), _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 6, 4, 16)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        TL.rope_frequencies(16, theta).numpy(),
        np.asarray(JL.rope_frequencies(16, theta)), **TOL)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("relu", False), ("relu2", False)])
def test_ffn(act, glu):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 5, 32)
    p = {"w_up": _rand(rng, 32, 48) / 6, "w_down": _rand(rng, 48, 32) / 7}
    if glu:
        p["w_gate"] = _rand(rng, 32, 48) / 6
    want = JL.ffn({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), act, glu, ArithmeticPolicy())
    tp = type("P", (), {k: _t(v) for k, v in p.items()})
    got = TL.ffn(tp, _t(x), act, glu, TPolicy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mm_exact():
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 3, 4, 32), _rand(rng, 32, 24)
    want = JL.mm(jnp.asarray(x), jnp.asarray(w), ArithmeticPolicy())
    got = TL.mm(_t(x), _t(w), TPolicy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mm_refuses_quantized_modes():
    """The quantized modes run (tests/test_torch_quantized_serve.py);
    the one that `mm` refuses is artemis with analog readout noise: it
    passes no PRNG key, and the noise needs one. The reference's `mm`
    raises the same ValueError."""
    x, w = torch.zeros(2, 4), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="key"):
        TL.mm(x, w, TPolicy(mode="artemis", sigma_analog=0.01))
    with pytest.raises(ValueError, match="key"):
        JL.mm(jnp.zeros((2, 4)), jnp.zeros((4, 3)),
              ArithmeticPolicy(mode="artemis", sigma_analog=0.01))


def _numpy_params(arch, **overrides):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **overrides)
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma_2b", "rwkv6_3b",
                                  "zamba2_7b"])
def test_bridge_round_trips_every_leaf(arch):
    cfg, _, tree = _numpy_params(arch, compute_dtype="float32")
    model = params_from_numpy(tree, cfg, device="cpu")
    back = params_to_numpy(model)
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_bridge_holds_matrices_in_the_compute_dtype():
    """At bf16 compute the matrices are stored cast once (as the
    reference casts them on every use); norm scales stay f32."""
    cfg, _, tree = _numpy_params("qwen3_8b")
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.scale.dtype == torch.float32
    assert model.layers[0].attn.q_norm.dtype == torch.float32
    np.testing.assert_array_equal(
        model.layers[1].ffn.w_up.float().numpy(),
        np.asarray(jnp.asarray(tree["layers"]["ffn"]["w_up"][1])
                   .astype(jnp.bfloat16).astype(jnp.float32)))


def test_bridge_rejects_a_wrong_tree():
    cfg, _, tree = _numpy_params("qwen3_8b", compute_dtype="float32")
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["ffn"] = {k: v for k, v in tree["layers"]["ffn"].items()
                            if k != "w_gate"}
    with pytest.raises(ValueError, match="w_gate"):
        params_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma_2b"])
def test_embed_and_logits(arch):
    cfg, params, tree = _numpy_params(arch, compute_dtype="float32")
    model = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    x = jtransformer._embed_tokens(params, cfg, jnp.asarray(tokens),
                                   jnp.float32)
    np.testing.assert_allclose(model.embed_tokens(_t(tokens)).numpy(),
                               np.asarray(x), **TOL)
    h = _rand(rng, 2, 5, cfg.d_model)
    np.testing.assert_allclose(
        model.logits(_t(h)).numpy(),
        np.asarray(jtransformer._logits(params, cfg, jnp.asarray(h))),
        **TOL)


def test_seeded_init_matches_the_reference_distributions():
    cfg = tconfigs.get_config("qwen3_8b", smoke=True)
    a = ttransformer.init(cfg, seed=3, device="cpu")
    b = ttransformer.init(cfg, seed=3, device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    w = a.layers[0].ffn.w_up.float()
    # dense_init: N(0, 1/d_in); embed_init: N(0, 1); norms: ones
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.02
    assert abs(a.embed.float().std().item() - 1.0) < 0.05
    assert torch.equal(a.layers[0].ln1.scale, torch.ones(cfg.d_model))


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("qwen3_8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttransformer.Transformer(cfg)
