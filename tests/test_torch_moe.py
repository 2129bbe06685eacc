"""The port's Mixture-of-Experts layer and MoE model against the JAX
package's, on the smoke `qwen2_moe_a2_7b` and `dbrx_132b` configs with
the reference's `model.init` weights carried over by the numpy bridge:

- `moe_ffn` in float32 at each config's own capacity factor and at
  1.25 and 0.5 (tokens dropped): the routing choices, which choices
  are kept and where they land equal exactly; the output within 1e-5
  and the aux loss within 1e-6;
- the combine, in bfloat16, equal to the reference's scatter-add bit
  for bit, and the whole layer in bfloat16 within 2**-6 of its
  output's scale (the expert products round their intermediates in
  bf16, XLA's and torch's apart) and no farther from the float32
  layer than the reference's bfloat16 layer is;
- equal router probabilities break top-k ties by the lower expert id,
  as `jax.lax.top_k` does;
- under each quantized policy, on both configs, `layers.mm` runs once
  per expert and projection, the pad experts included (4 + 3 * (E +
  shared) calls a layer), and the layer matches the reference's;
- teacher-forced under each quantized policy with the trained router:
  the hidden states that the reference's own jitted forward (and a
  decode step after a prefill) feeds each layer's attention and MoE,
  recorded from inside its layer scan, give the same routing choices
  and destinations in the port exactly and the same outputs within
  1e-5; and the port's and the reference's norms, two ulps apart at most,
  move the reference's own artemis attention by a whole readout step,
  which is why whole quantized forwards are held layer by layer;
- `transformer.apply` logits within 1e-4 and its aux loss, the summed
  layer losses, within 1e-6;
- the static path's prefill-then-decode greedy loop token-identical;
- the bridge round-trips an MoE tree.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy as JPolicy  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["qwen2_moe_a2_7b", "dbrx_132b"]
QUANTIZED = ["int8", "artemis_mxu", "artemis"]
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _weights(arch, capacity_factor=None, dtype="float32"):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              compute_dtype=dtype)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _x(cfg, shape=(3, 5), seed=1):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"])["moe"]


class _Spy:
    """Stands in for `jax` inside `repro.models.moe` and records what
    the reference computes: top_k's (gate, ids) and the arguments of
    each vmapped call (the dispatch scatter's are (buf, dest, src, x))."""

    def __init__(self):
        self.top_k, self.vmapped = [], []
        spy = self

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, operand, k):
                out = jax.lax.top_k(operand, k)
                spy.top_k.append(out)
                return out
        self.lax = Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)

        def call(*args):
            self.vmapped.append(args)
            return mapped(*args)
        return call


def _reference_routing(monkeypatch, lp, x, cfg, policy=JPolicy()):
    spy = _Spy()
    monkeypatch.setattr(JM, "jax", spy)
    out, aux = JM.moe_ffn(lp, jnp.asarray(x), cfg, policy)
    monkeypatch.undo()
    (_, ids), = spy.top_k
    dest = next(args[1] for args in spy.vmapped if len(args) == 4)
    return np.asarray(out), float(aux), np.asarray(ids)[0], \
        np.asarray(dest)[0]


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [None, 1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, capacity_factor, monkeypatch):
    cfg, params, model = _weights(arch, capacity_factor)
    x = _x(cfg)
    want, want_aux, want_ids, want_dest = _reference_routing(
        monkeypatch, _layer0(params), x, cfg)
    p = model.layers[0].moe
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, ids, _, cap, _, keep, dest = TM.route(p, xt, cfg, TPolicy())
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    e = cfg.padded_experts
    np.testing.assert_array_equal(keep.numpy(), want_dest != e * cap)
    if capacity_factor == 0.5:
        assert not keep.all()                 # the case drops choices
    got, aux = TM.moe_ffn(p, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(float(aux), want_aux, **AUX_TOL)


def test_combine_equals_the_reference_scatter_add_in_bf16():
    """The gated outputs of T * k choices in sorted-slot order, summed
    per token: the port's fixed-order loop and the reference's
    scatter-add round alike after every add."""
    rng = np.random.default_rng(2)
    t, k, d, e = 40, 4, 16, 8
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    contrib = rng.standard_normal((t * k, d)).astype(np.float32)
    cb = jnp.asarray(contrib).astype(jnp.bfloat16)
    want = jnp.zeros((t, d), jnp.bfloat16).at[order // k].add(cb)
    got = TM.combine(torch.from_numpy(contrib).bfloat16(),
                     torch.from_numpy(order), k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_in_bf16_within_bf16_rounding(arch):
    cfg, params, model = _weights(arch, dtype="bfloat16")
    x = _x(cfg)
    xb = torch.from_numpy(x).bfloat16()
    want, want_aux = JM.moe_ffn(_layer0(params),
                                jnp.asarray(x).astype(jnp.bfloat16), cfg)
    got, aux = TM.moe_ffn(model.layers[0].moe, xb, cfg)
    assert got.dtype == torch.bfloat16
    # XLA's bf16 products and torch's round their intermediates apart;
    # measured largest |port - reference|: 0.0234 at an output scale of
    # 4.22 (qwen2_moe) and 0.0156 at 1.95 (dbrx), under 2**-6 of it
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -6,
                               atol=2 ** -6 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)
    # no coarser than the reference: against the float32 layer on the
    # same input, the port's largest and RMS errors within 1.25x of the
    # reference's (measured 0.82x-0.93x)
    _, _, model32 = _weights(arch)
    truth = TM.moe_ffn(model32.layers[0].moe, xb.float(),
                       dataclasses.replace(cfg, compute_dtype="float32"))[0]
    err_got = np.abs(got - truth.numpy())
    err_want = np.abs(want - truth.numpy())
    assert err_got.max() <= 1.25 * err_want.max()
    assert np.sqrt(np.mean(err_got ** 2)) <= \
        1.25 * np.sqrt(np.mean(err_want ** 2))


def test_top_k_ties_break_by_the_lower_expert_id(monkeypatch):
    """Router columns 1, 2 and 3 equal: their probabilities tie
    exactly, and both packages pick the lower ids first."""
    cfg, params, model = _weights("qwen2_moe_a2_7b")
    lp = _layer0(params)
    router = np.array(lp["router"])
    router[:, 2] = router[:, 3] = router[:, 1]
    lp = dict(lp, router=jnp.asarray(router))
    x = _x(cfg, seed=4)
    _, _, want_ids, want_dest = _reference_routing(monkeypatch, lp, x, cfg)
    p = model.layers[0].moe
    with torch.no_grad():
        saved = p.router.clone()
        p.router.copy_(torch.from_numpy(router))
        try:
            _, ids, *_, dest = TM.route(
                p, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg,
                TPolicy())
        finally:
            p.router.copy_(saved)
    ties = np.isin(want_ids, [1, 2, 3]).sum(axis=1) >= 2
    assert ties.any()
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(dest.numpy(), want_dest)


@pytest.mark.parametrize("mode", QUANTIZED)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_experts_run_one_product_each(arch, mode, monkeypatch):
    cfg, params, model = _weights(arch)
    calls = []
    mm = TL.mm

    def counted(x, w, policy):
        calls.append(tuple(w.shape))
        return mm(x, w, policy)

    x = _x(cfg, shape=(2, 3))
    want, want_aux = JM.moe_ffn(_layer0(params), jnp.asarray(x), cfg,
                                JPolicy(mode=mode))
    monkeypatch.setattr(TL, "mm", counted)
    got, aux = TM.moe_ffn(model.layers[0].moe, torch.from_numpy(x), cfg,
                          TPolicy(mode=mode))
    n_ffn = cfg.padded_experts + cfg.n_shared_experts
    assert len(calls) == 1 + 3 * n_ffn     # the exact router's f32 product
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX_TOL)


class _Recorder:
    """Records, from inside the reference's jitted layer scan, each
    layer's attention (in-sequence calls: normed input, positions,
    output) and MoE (normed input, output, aux), in layer order, through
    `jax.debug.callback`."""

    def __init__(self, mp):
        self.attn, self.moe = [], []
        attention, moe_ffn = JL.attention, JM.moe_ffn

        def record(into, *vals):
            jax.debug.callback(
                lambda *v: into.append([np.asarray(a) for a in v]), *vals,
                ordered=True)

        def attention_spy(p, x, dims, **kw):
            out, new_kv = attention(p, x, dims, **kw)
            if kw.get("cache") is None:
                record(self.attn, x, kw["positions"], out)
            return out, new_kv

        def moe_spy(p, x, cfg, policy=JPolicy()):
            out, aux = moe_ffn(p, x, cfg, policy)
            record(self.moe, x, out, aux)
            return out, aux

        mp.setattr(JL, "attention", attention_spy)
        mp.setattr(JM, "moe_ffn", moe_spy)


def _reference_forwards(monkeypatch, cfg, params, mode, toks):
    """The reference's jitted in-sequence apply, and a jitted decode step
    after a jitted prefill, under `mode`: what each layer was fed."""
    policy = JPolicy(mode=mode)
    b, s = toks.shape
    with monkeypatch.context() as mp:
        rec = _Recorder(mp)
        jax.jit(lambda p, t: jmodel.apply(p, cfg, {"tokens": t},
                                          policy=policy)[0])(
            params, jnp.asarray(toks[:, :-1])).block_until_ready()
        n_apply = len(rec.moe)
        cache = jmodel.init_cache(cfg, b, s, dtype=jnp.float32)
        _, cache = jax.jit(jsteps.make_prefill_step(cfg, policy))(
            params, {"tokens": jnp.asarray(toks[:, :-1])}, cache)
        del rec.moe[n_apply:]
        jax.jit(jsteps.make_decode_step(cfg, policy))(
            params, jnp.asarray(toks[:, -1:]), cache)[0].block_until_ready()
        jax.effects_barrier()
    return rec


@pytest.mark.parametrize("mode", QUANTIZED)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_layers_teacher_forced_match_reference(arch, mode,
                                                          monkeypatch):
    """Each layer of the trained model, under a quantized policy, on the
    hidden states the reference's own forward gives it: in-sequence
    (2 x 7 tokens: attention and MoE) and at a decode step (2 rows:
    MoE, where each expert's capacity is small). Routing choices and
    destinations equal exactly, outputs within 1e-5, aux within 1e-6."""
    cfg, params, model = _weights(arch)
    toks = np.random.default_rng(5).integers(2, cfg.vocab_size, (2, 8))
    rec = _reference_forwards(monkeypatch, cfg, params, mode, toks)
    n = cfg.n_layers
    assert len(rec.attn) == n and len(rec.moe) == 2 * n
    tpol = TPolicy(mode=mode)
    for li, (x, pos, want) in enumerate(rec.attn):
        got, _ = TL.attention(
            model.layers[li].attn, torch.tensor(x), TT._dims(cfg),
            positions=torch.tensor(pos), policy=tpol,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            window=cfg.attn_window, norm_eps=cfg.norm_eps,
            attn_impl="gather")
        np.testing.assert_allclose(got.numpy(), want, **OUT_TOL,
                                   err_msg=f"attention, layer {li}")
    for i, (x, want, want_aux) in enumerate(rec.moe):
        li = i % n
        lp = jax.tree.map(lambda a: a[li], params["layers"])["moe"]
        _, _, want_ids, want_dest = _reference_routing(
            monkeypatch, lp, x, cfg, JPolicy(mode=mode))
        p = model.layers[li].moe
        xt = torch.tensor(x)
        _, ids, *_, dest = TM.route(p, xt.reshape(-1, cfg.d_model), cfg,
                                    tpol)
        where = f"{'decode' if i >= n else 'in-sequence'} MoE, layer {li}"
        np.testing.assert_array_equal(ids.numpy(), want_ids, err_msg=where)
        np.testing.assert_array_equal(dest.numpy(), want_dest, err_msg=where)
        got, aux = TM.moe_ffn(p, xt, cfg, tpol)
        np.testing.assert_allclose(got.numpy(), want, **OUT_TOL,
                                   err_msg=where)
        np.testing.assert_allclose(float(aux), float(want_aux), **AUX_TOL,
                                   err_msg=where)


def test_a_last_bit_of_the_norm_moves_artemis_by_a_readout_step():
    """Why whole quantized forwards are not held token for token: the
    two packages' RMS norms of the same embeddings are at most two ulps
    apart (XLA's and torch's f32 mean and rsqrt), and that is enough to
    move the REFERENCE's own artemis attention by a whole readout step
    at some positions. On the same input the port's attention equals
    the reference's."""
    cfg, params, model = _weights("qwen2_moe_a2_7b")
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 7))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    x = JT._embed_tokens(params, cfg, jnp.asarray(toks), jnp.float32)
    want = np.asarray(JL.rmsnorm(lp["ln1"], x, cfg.norm_eps))
    got = TL.rmsnorm(model.layers[0].ln1.scale,
                     torch.tensor(np.asarray(x)), cfg.norm_eps).numpy()
    ulp = np.spacing(np.abs(want))
    assert (np.abs(got - want) <= 2 * ulp).all() and (got != want).any()
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    kw = dict(positions=jnp.asarray(pos), policy=JPolicy(mode="artemis"),
              qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
              window=cfg.attn_window, norm_eps=cfg.norm_eps)
    on_want = np.asarray(JL.attention(lp["attn"], jnp.asarray(want),
                                      JT._dims(cfg), **kw)[0])
    on_got = np.asarray(JL.attention(lp["attn"], jnp.asarray(got),
                                     JT._dims(cfg), **kw)[0])
    assert np.abs(on_got - on_want).max() > 0.05     # a readout step
    port, _ = TL.attention(
        model.layers[0].attn, torch.tensor(want), TT._dims(cfg),
        positions=torch.from_numpy(pos.copy()),
        policy=TPolicy(mode="artemis"), qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, window=cfg.attn_window,
        norm_eps=cfg.norm_eps, attn_impl="gather")
    np.testing.assert_allclose(port.numpy(), on_want, **OUT_TOL)


def test_a_quantized_model_layer_runs_208_products_at_full_width():
    """The launch formula of the full qwen2_moe_a2_7b layer under a
    quantized policy: 4 attention projections + 3 per expert FFN."""
    from repro_torch import configs as tconfigs
    cfg = tconfigs.get_config("qwen2_moe_a2_7b")
    assert 4 + 3 * (cfg.padded_experts + cfg.n_shared_experts) == 208


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_and_aux_match_reference(arch):
    cfg, params, model = _weights(arch)
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 7))
    want, want_aux, _ = jmodel.apply(params, cfg,
                                     {"tokens": jnp.asarray(toks)})
    got, aux, _ = tmodel.apply(model, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX_TOL)
    assert float(aux) > 0


def _greedy(prefill, decode, sample, params, toks, cache, gen, wrap):
    logits, cache = prefill(params, {"tokens": wrap(toks)}, cache)
    nxt = sample(logits)
    out = []
    for _ in range(gen):
        logits, cache = decode(params, nxt[:, None], cache)
        nxt = sample(logits)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_greedy_loop_token_identical_to_reference(arch):
    cfg, params, model = _weights(arch)
    b, s, gen = 3, 9, 6
    toks = np.random.default_rng(9).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)
    want = _greedy(jax.jit(jsteps.make_prefill_step(cfg, JPolicy())),
                   jax.jit(jsteps.make_decode_step(cfg, JPolicy())),
                   jsteps.greedy_sample, params, toks,
                   jmodel.init_cache(cfg, b, s + gen, dtype=jnp.float32),
                   gen, jnp.asarray)
    got = _greedy(tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg),
                  tsteps.greedy_sample, model, toks,
                  tmodel.init_cache(cfg, b, s + gen, torch.float32,
                                    device="cpu"), gen,
                  lambda a: torch.from_numpy(a))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_an_moe_tree(arch):
    cfg, params, model = _weights(arch)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    moe = back["layers"]["moe"]
    e, ns = cfg.padded_experts, cfg.n_shared_experts
    assert moe["router"].shape == (cfg.n_layers, cfg.d_model, e)
    assert moe["experts"]["w_up"].shape == (cfg.n_layers, e, cfg.d_model,
                                            cfg.d_ff_expert)
    if ns:
        assert moe["shared"]["w_down"].shape == (
            cfg.n_layers, ns, cfg.d_ff_expert, cfg.d_model)


def test_bridge_refuses_an_incomplete_moe_tree():
    cfg, params, _ = _weights("qwen2_moe_a2_7b")
    tree = jax.tree.map(np.asarray, params)
    del tree["layers"]["moe"]["shared"]
    with pytest.raises(ValueError, match="shared"):
        params_from_numpy(tree, cfg, device="cpu")
