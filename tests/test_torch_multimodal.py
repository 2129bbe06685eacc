"""The port's multimodal configs against the JAX package's, on the CPU:
musicgen_large (audio: (B, S, C) tokens over 4 codebooks, summed
embeddings, a head per codebook) and internvl2_1b (vlm: a 256-token
stub image prefix before the tokens, tied embeddings), at their smoke
sizes with f32 compute, weights from the reference's `model.init`
through the numpy bridge.

- `models/frontend.py`: the prefix equals `jax.random.normal`'s bit for
  bit; `n_prefix_tokens` and `token_shape` equal the reference's;
- the audio embedding sums its codebook rows in f32 before the cast,
  as the reference: at the bf16 smoke config the port's serving model
  equals the reference's `_embed_tokens` bit for bit, and summing the
  rows cast to bf16 (the text path's storage) differs, so the f32 table
  is needed;
- `apply` in-sequence, and a prefill then a decode step over the dense
  cache: logits within 1e-4, the written K/V (each layer's) within
  1e-5;
- static generation at f32, through the flash core's plain version and
  the gather core: from the reference's own prompt and prefix, tokens
  identical to the reference's greedy loop; `serve()`'s own prompt,
  prefix (the reference's, bit for bit) and cache index; the CLI's
  `--mode static` line and `--mode engine`'s refusal, as the
  reference's;
- `make_batch`: tokens, labels and the vlm prefix equal the reference's
  (a token may differ only where `_zipf_tokens`' r lies within two ulps
  of an integer, as in `tests/test_torch_data.py`; none does here);
- the train step (`loss_and_grads`, `make_train_step`): at each of
  three steps' parameters of the reference's exact run, the loss within
  1e-5 relative and every gradient within 1e-4 of its leaf's max abs
  under the exact policy (measured 2.3e-7 and 1.1e-6); the port's own
  three exact steps end within 0.05 x lr of the reference's parameters.
  Under int8 a last-bit difference can flip an int8 value at a rounding
  tie (ROADMAP Queue 3; `tests/test_torch_train.py`), which the causal
  attention carries to every later position of its row: a step is held
  within 1e-3 and 0.25 (a missing straight-through estimator gives about
  1), and musicgen must show a tight step (measured: steps 0 and 2
  tight, step 1 1.7e-5 and 2.1e-3). internvl's int8 forward flips a
  value at each of the three points (2.4e-6 / 2.9e-3, 1.3e-4 / 6.4e-3,
  6.9e-4 / 2.5e-2), so its int8 logits are held to the flip's signature
  instead: every row equal within 1e-4 but one, and that one from a
  single position on. The reference parts from itself there too: jitted
  against `jax.disable_jit`, 2.8e-4 / 2.6e-2 at step 2;
- remat on and off agree exactly, and a quantized step runs the
  sc_matmul wrapper once a projection, forward and recompute;
- a checkpoint crosses between the packages (musicgen's (C, V, d) and
  (C, d, V) leaves), and `train()` of each config resumes bit for bit.
"""
import dataclasses
import functools
import re
import shutil
import sys

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
from repro.launch import serve as jcli  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import frontend as jfrontend  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.serve import paged_model as jpm  # noqa: E402
from repro_torch import bridge, configs, prng  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager)
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import frontend  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCHS = ["musicgen_large", "internvl2_1b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
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
def _setup(arch, compute_dtype="float32"):
    """(reference cfg, port cfg, reference params, port serving model)."""
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             compute_dtype=compute_dtype)
    tc = dataclasses.replace(configs.get_config(arch, smoke=True),
                             compute_dtype=compute_dtype)
    params = jmodel.init(jax.random.PRNGKey(0), jc)
    model = bridge.params_from_numpy(_np_tree(params), tc, device="cpu")
    return jc, tc, params, model


def _inputs(jc, seed, b, s):
    """Numpy tokens of the config's shape, and the vlm prefix (the
    reference's, from PRNGKey(seed))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, jc.vocab_size,
                        jfrontend.token_shape(jc, b, s)).astype(np.int32)
    out = {"tokens": toks}
    if jc.modality == "vlm":
        out["prefix_embeds"] = np.asarray(jfrontend.synth_prefix_embeds(
            jax.random.PRNGKey(seed), jc, b))
    return out


# ---------------------------------------------------------------------------
# the frontend and the audio embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["qwen3_8b"])
def test_frontend_equals_reference(arch):
    jc, tc = (jconfigs.get_config(arch, smoke=True),
              configs.get_config(arch, smoke=True))
    assert frontend.n_prefix_tokens(tc) == jfrontend.n_prefix_tokens(jc)
    assert frontend.token_shape(tc, 3, 5) == jfrontend.token_shape(jc, 3, 5)
    if jc.modality != "vlm":
        return
    for seed, dtype in ((0, "bfloat16"), (7, "float32")):
        jcd = dataclasses.replace(jc, compute_dtype=dtype)
        tcd = dataclasses.replace(tc, compute_dtype=dtype)
        want = jfrontend.synth_prefix_embeds(jax.random.PRNGKey(seed), jcd, 3)
        got = frontend.synth_prefix_embeds(prng.PRNGKey(seed), tcd, 3)
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == (3, frontend.VLM_PREFIX_TOKENS, tc.d_model)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_audio_embedding_sums_in_f32():
    """At the bf16 smoke config the serving model keeps its table in
    f32 and equals the reference's gather-sum-cast bit for bit; the
    sum of bf16-stored rows is another function."""
    jc, tc, params, model = _setup("musicgen_large", "bfloat16")
    assert model.embed.dtype == torch.float32
    assert model.head.dtype == torch.bfloat16
    toks = _inputs(jc, 4, 8, 64)["tokens"]
    want = np.asarray(jtransformer._embed_tokens(
        params, jc, jnp.asarray(toks), jnp.bfloat16), np.float32)
    got = model.embed_tokens(_t(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    stored_bf16 = model.embed.to(torch.bfloat16)
    rows = sum(torch.nn.functional.embedding(_t(toks[..., c]),
                                             stored_bf16[c])
               for c in range(tc.n_codebooks))
    n_apart = int((rows.float().numpy() != want).sum())
    assert n_apart > 0.1 * want.size, n_apart


# ---------------------------------------------------------------------------
# apply: in-sequence, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_in_sequence_matches_reference(arch):
    jc, tc, params, model = _setup(arch)
    inp = _inputs(jc, 1, 2, 7)
    want, _, _ = jmodel.apply(params, jc, jax.tree.map(jnp.asarray, inp),
                              remat=False)
    for impl in ("flash", "gather"):
        got, aux, _ = tmodel.apply(model, tc, {k: _t(v) for k, v in
                                               inp.items()}, attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
        assert float(aux) == 0.0
    p = frontend.n_prefix_tokens(tc)
    want_shape = ((2, 7, tc.n_codebooks, tc.padded_vocab)
                  if arch == "musicgen_large" else (2, p + 7, tc.padded_vocab))
    assert tuple(got.shape) == want_shape


@pytest.mark.parametrize("impl", ["flash", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_reference(arch, impl):
    jc, tc, params, model = _setup(arch)
    b, s, smax = 2, 6, 6 + 3 + frontend.n_prefix_tokens(tc)
    inp = _inputs(jc, 2, b, s)
    jcache = jmodel.init_cache(jc, b, smax, dtype=jnp.float32)
    want, _, jcache = jmodel.apply(params, jc, jax.tree.map(jnp.asarray, inp),
                                   cache=jcache, remat=False)
    cache = tmodel.init_cache(tc, b, smax, torch.float32, device="cpu")
    got, _, cache = tmodel.apply(model, tc, {k: _t(v) for k, v in
                                             inp.items()},
                                 cache=cache, attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **LAYER_TOL)
    assert cache["index"] == int(jcache["index"]) == smax - 3
    for i in range(2):                      # two decode steps
        tok = _inputs(jc, 10 + i, b, 1)["tokens"]
        want, _, jcache = jmodel.apply(params, jc, {"tokens": tok},
                                       cache=jcache, remat=False)
        got, _, cache = tmodel.apply(model, tc, {"tokens": _t(tok)},
                                     cache=cache, attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), **LAYER_TOL)


# ---------------------------------------------------------------------------
# static generation
# ---------------------------------------------------------------------------

def _greedy(prefill, decode, sample, params, batch, cache, gen):
    logits, cache = prefill(params, batch, cache)
    nxt, out = sample(logits), []
    for _ in range(gen):
        logits, cache = decode(params, nxt[:, None], cache)
        nxt = sample(logits)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("impl", ["flash", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_generation_matches_reference(arch, impl):
    """From the reference's own prompt (`jax.random.randint` of
    PRNGKey(seed + 1)) and prefix (PRNGKey(seed + 2)), as its `serve()`
    draws them: the port's greedy tokens equal the reference's."""
    jc, tc, params, model = _setup(arch)
    b, s, gen, seed = 2, 5, 4, 3
    toks = jax.random.randint(jax.random.PRNGKey(seed + 1),
                              jfrontend.token_shape(jc, b, s), 2,
                              jc.vocab_size, dtype=jnp.int32)
    batch = {"tokens": toks}
    if jc.modality == "vlm":
        batch["prefix_embeds"] = jfrontend.synth_prefix_embeds(
            jax.random.PRNGKey(seed + 2), jc, b)
    smax = s + gen + frontend.n_prefix_tokens(tc)
    want, _ = _greedy(jax.jit(jsteps.make_prefill_step(jc)),
                      jax.jit(jsteps.make_decode_step(jc)),
                      jsteps.greedy_sample, params, batch,
                      jmodel.init_cache(jc, b, smax, dtype=jnp.float32), gen)
    reset_launch_counts()
    got, cache = _greedy(
        tsteps.make_prefill_step(tc, attn_impl=impl),
        tsteps.make_decode_step(tc, attn_impl=impl), tsteps.greedy_sample,
        model, {k: _t(v) for k, v in batch.items()},
        tmodel.init_cache(tc, b, smax, torch.float32, device="cpu"), gen)
    assert not launch_counts                      # CPU: the plain versions
    want_shape = (b, gen) + ((tc.n_codebooks,) if arch == "musicgen_large"
                             else ())
    assert got.shape == want_shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert cache["index"] == smax


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_static_draws_the_references_prefix(arch):
    """`serve()` on the CPU: the output's shapes and cache index (the
    prefix counted), the vlm prefix of PRNGKey(seed + 2) bit for bit,
    and tokens equal the reference's greedy loop on its prompt."""
    jc, tc, params, model = _setup(arch)
    b, s, gen, seed = 2, 5, 3, 4
    out = tcli.serve(params=model, batch=b, prompt_len=s, gen_len=gen,
                     seed=seed, device="cpu")
    p = frontend.n_prefix_tokens(tc)
    codebooks = (tc.n_codebooks,) if arch == "musicgen_large" else ()
    assert tuple(out["prompt"].shape) == (b, s) + codebooks
    assert tuple(out["generated"].shape) == (b, gen) + codebooks
    assert out["cache_index"] == p + s + gen
    batch = {"tokens": out["prompt"].numpy()}
    if arch == "internvl2_1b":
        want = jfrontend.synth_prefix_embeds(jax.random.PRNGKey(seed + 2),
                                             jc, b)
        np.testing.assert_array_equal(out["prefix_embeds"].numpy(),
                                      np.asarray(want))
        batch["prefix_embeds"] = want
    else:
        assert out["prefix_embeds"] is None
    want, _ = _greedy(jax.jit(jsteps.make_prefill_step(jc)),
                      jax.jit(jsteps.make_decode_step(jc)),
                      jsteps.greedy_sample, params, batch,
                      jmodel.init_cache(jc, b, p + s + gen,
                                        dtype=jnp.float32), gen)
    np.testing.assert_array_equal(out["generated"].numpy(), want)


def _strip(text: str) -> str:
    return re.sub(r"prefill \d+ms \| decode [\d.]+ tok/s", "", text)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_static_line_and_engine_refusal_match_reference(
        arch, monkeypatch, capsys):
    flags = ["--arch", arch, "--batch", "2", "--prompt-len", "4",
             "--gen-len", "3"]
    monkeypatch.setattr(sys, "argv", ["serve", "--mode", "static", *flags])
    jcli.main()
    want = capsys.readouterr().out.strip().splitlines()
    tcli.main(["--mode", "static", *flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 1
    assert _strip(got[0]) == _strip(want[0])
    assert "generated shape (2, 3" in got[0]
    with pytest.raises(ValueError) as want:
        jpm._check_family(jconfigs.get_config(arch, smoke=True))
    with pytest.raises(ValueError) as got:
        tcli.main(["--mode", "engine", "--arch", arch, "--device", "cpu",
                   "--n-requests", "2"])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# make_batch
# ---------------------------------------------------------------------------

def _near_integer(r: np.ndarray) -> np.ndarray:
    return np.abs(r - np.round(r)) <= 2 * np.spacing(np.abs(r))


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equals_reference(arch, smoke):
    jc = jconfigs.get_config(arch, smoke=smoke)
    tc = configs.get_config(arch, smoke=smoke)
    rows = 2
    for seed, step in ((0, 0), (7, 17)):
        kw = dict(seed=seed, seq_len=32, global_batch=rows)
        want = _np_tree(jpipe.make_batch(jc, jpipe.DataConfig(**kw), step))
        got = make_batch(tc, DataConfig(**kw), step, device="cpu")
        assert set(got) == set(want)
        wt, gt = want["tokens"], got["tokens"].numpy()
        assert gt.shape == wt.shape == jfrontend.token_shape(jc, rows, 32)
        diff = wt != gt
        if diff.any():
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed), step), 0)
            u = jax.random.uniform(jax.random.split(key)[0], wt.shape,
                                   jnp.float32, 1e-6, 1.0)
            r = np.asarray(jnp.exp(u * jnp.log(float(jc.vocab_size))) - 1.0)
            assert _near_integer(r[diff]).all()
        assert diff.sum() <= 1e-3 * diff.size
        np.testing.assert_array_equal(got["labels"].numpy()[:, :-1],
                                      gt[:, 1:])
        assert (got["labels"].numpy()[:, -1] == 0).all()
        if arch == "internvl2_1b":
            assert got["prefix_embeds"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got["prefix_embeds"].float().numpy(),
                want["prefix_embeds"].astype(np.float32))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

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
    jc, _, _, _ = _setup(arch)
    return [_np_tree(jpipe.make_batch(jc, jpipe.DataConfig(**DCFG), step))
            for step in range(N_STEPS)]


def _torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's three exact steps of `make_train_step`: per step
    the parameters before it and the step's loss, and the final
    parameters."""
    jc, _, params, _ = _setup(arch)
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


@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_at_each_step(arch, mode):
    _, tc, _, _ = _setup(arch)
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
    # internvl's int8 forward flips a tie at every step's parameters
    # (test_int8_forward_parts_only_after_one_flipped_value)
    assert n_tight >= (N_STEPS if mode == "exact"
                       else int(arch != "internvl2_1b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_forward_parts_only_after_one_flipped_value(arch):
    """At the first step's parameters the int8 logits equal the
    reference's within 1e-4 except in at most one row, and there from
    one position on: a single int8 value flipped at a rounding tie and
    carried forward by the causal attention, not a systematic
    difference (which would show in every row)."""
    jc, tc, _, _ = _setup(arch)
    params = _reference_run(arch)[0][0]["params"]
    batch = {k: v for k, v in _batches(arch)[0].items() if k != "labels"}
    for mode in ("exact", "int8"):
        want, _, _ = jmodel.apply(params, jc, batch,
                                  policy=JPolicy(mode=mode), remat=False)
        model = bridge.params_from_numpy(params, tc, device="cpu")
        with torch.no_grad():
            got, _, _ = tmodel.apply(model, tc, _torch_batch(batch),
                                     policy=TPolicy(mode=mode),
                                     attn_impl="gather")
        diff = np.abs(np.asarray(want) - got.numpy())
        apart = diff.reshape(diff.shape[0], diff.shape[1], -1).max(-1) > 1e-4
        if mode == "exact":
            assert not apart.any()
            continue
        rows = np.flatnonzero(apart.any(-1))
        assert len(rows) <= 1, rows
        for r in rows:
            onset = np.flatnonzero(apart[r])[0]
            assert not apart[r, :onset].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    _, tc, _, _ = _setup(arch)
    ref, final = _reference_run(arch)
    model = bridge.params_from_numpy(ref[0]["params"], tc, device="cpu",
                                     train=True)
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
        assert np.abs(w - g).max() <= 0.05 * OPT["lr"], \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_agree_and_launch_per_projection(arch, monkeypatch):
    """Equal losses and gradients with and without remat; under int8
    the sc_matmul wrapper runs once a projection of a layer forward (4
    attention, 2 or 3 FFN), and as often again in the recompute."""
    import importlib
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real, calls = am.sc_matmul_quantized, []

    def counting(aq, bq, **kw):
        calls.append(aq.shape[0])
        return real(aq, bq, **kw)

    monkeypatch.setattr(am, "sc_matmul_quantized", counting)
    _, tc, _, _ = _setup(arch)
    ref, _ = _reference_run(arch)
    batch = _torch_batch(_batches(arch)[0])
    per_layer = 4 + (3 if tc.glu else 2)
    rows = DCFG["global_batch"] * (DCFG["seq_len"]
                                   + frontend.n_prefix_tokens(tc))
    for mode in ("exact", "int8"):
        out = []
        for remat in (True, False):
            calls.clear()
            model = bridge.params_from_numpy(ref[0]["params"], tc,
                                             device="cpu", train=True)
            loss, _, grads = tsteps.loss_and_grads(
                model, tc, batch, TPolicy(mode=mode), remat)
            out.append((float(loss), {k: g.clone() for k, g in
                                      grads.items()}))
            want = 0 if mode == "exact" else \
                per_layer * tc.n_layers * (2 if remat else 1)
            assert len(calls) == want and set(calls) <= {rows}
        assert out[0][0] == out[1][0]
        for name, g in out[0][1].items():
            torch.testing.assert_close(g, out[1][1][name], rtol=0, atol=0)


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """musicgen's training state, (C, V, d) embed and (C, d, V) head
    leaves included: the reference's checkpoint after a step restores
    in the port, whose next step gives the reference's next step; the
    port's checkpoint restores in the reference's manager, leaves
    equal."""
    jc, tc, params, _ = _setup("musicgen_large")
    batches = _batches("musicgen_large")
    step_fn = jax.jit(jsteps.make_train_step(jc, JOpt(**OPT), JPolicy()))
    params, opt, _ = step_fn(params, jadamw_init(params), batches[0])
    JManager(JCkptConfig(str(tmp_path / "ref"), async_save=False)).save(
        1, {"params": params, "opt": opt})
    like = tmodel.init(tc, seed=1, device="cpu", train=True)
    step, tree = CheckpointManager(CheckpointConfig(
        str(tmp_path / "ref"))).restore_latest(
        ttrain.train_state(like, adamw_init(like)))
    assert step == 1
    assert tree["params"]["embed"].shape == (tc.n_codebooks,
                                             tc.padded_vocab, tc.d_model)
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
