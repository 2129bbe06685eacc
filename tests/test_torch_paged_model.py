"""The port's chunked-prefill and decode steps against the JAX
package's.

Weights come from the reference's `model.init` through the numpy
bridge; tokens, tables and cursors are numpy. Step logits of every
valid row and every written pool page (the trash page excluded: its
duplicate writes land in no fixed order) agree at float32 within
rtol=atol=1e-4 — XLA's CPU dot and torch's CPU GEMM sum in different
orders. Two comparisons: port vs reference with the gather core on
both sides, and the port's fused core vs its gather core.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core.policy import ArithmeticPolicy  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import paged_model as jpm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy as TPolicy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.serve import paged_model as tpm  # noqa: E402
from repro_torch.serve.paged_cache import cow_copy_page  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE, N_PAGES, PMAX, B, CHUNK = 4, 16, 4, 2, 6


@functools.lru_cache(maxsize=None)
def _setup(arch: str, attn_window: int):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              compute_dtype="float32",
                              attn_window=attn_window)
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _schedule(cfg):
    """Two prefill chunks and one decode round. Row 0: a 9-token prompt
    split 6+3 (pages 1-3); row 1: 5 prompt tokens of which the first 4
    are already resident (write_from=4, as after a prefix-sharing hit),
    then idle in chunk 2."""
    rng = np.random.default_rng(0)
    toks = [rng.integers(2, cfg.vocab_size, (B, CHUNK)).astype(np.int32)
            for _ in range(2)]
    dtok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    steps = [
        ("prefill", (toks[0], bt, i32([0, 0]), i32([6, 5]),
                     np.asarray([True, True]), i32([0, 4]))),
        ("prefill", (toks[1], bt, i32([6, 0]), i32([3, 0]),
                     np.asarray([True, False]), i32([0, 0]))),
        ("decode", (dtok, bt, i32([9, 5]), np.asarray([True, True]))),
    ]
    valid = [[(0, 6), (1, 5)], [(0, 3)], None]
    return steps, valid


def _pool(cfg, rng):
    shape = (cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    # resident K/V in the pages row 1 shares (4: positions 0-3)
    k = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    k[:, 4] = rng.standard_normal(k[:, 4].shape)
    v[:, 4] = rng.standard_normal(v[:, 4].shape)
    return k, v


def _run_jax(cfg, params, steps):
    prefill = jpm.make_paged_chunked_prefill(cfg, ArithmeticPolicy())
    decode = jpm.make_paged_decode(cfg, ArithmeticPolicy())
    k, v = _pool(cfg, np.random.default_rng(1))
    kv = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    out = []
    for kind, args in steps:
        fn = prefill if kind == "prefill" else decode
        logits, kv = fn(params, jnp.asarray(args[0]), kv,
                        *(jnp.asarray(a) for a in args[1:]))
        out.append(np.asarray(logits))
    return out, {n: np.asarray(a) for n, a in kv.items()}


def _run_port(cfg, model, steps, fused: bool):
    core = tpm.make_fused_paged_core(cfg, TPolicy()) if fused else None
    prefill = tpm.make_paged_chunked_prefill(cfg, TPolicy(),
                                             paged_core=core)
    decode = tpm.make_paged_decode(cfg, TPolicy(), paged_core=core)
    k, v = _pool(cfg, np.random.default_rng(1))
    kv = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    out = []
    for kind, args in steps:
        fn = prefill if kind == "prefill" else decode
        logits, kv = fn(model, *(torch.from_numpy(a) for a in args[:1]),
                        kv, *(torch.from_numpy(a) for a in args[1:]))
        out.append(logits.numpy())
    return out, {n: a.numpy() for n, a in kv.items()}


def _compare(got, want, valid):
    (got_logits, got_kv), (want_logits, want_kv) = got, want
    for g, w, rows in zip(got_logits, want_logits, valid):
        if rows is None:                      # decode: every lane valid
            np.testing.assert_allclose(g, w, **TOL)
        else:
            for r, n in rows:
                np.testing.assert_allclose(g[r, :n], w[r, :n], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_kv[name][:, 1:], want_kv[name][:, 1:],
                                   **TOL)


@pytest.mark.parametrize("arch,attn_window", [("qwen3_8b", 0),
                                              ("qwen3_8b", 6),
                                              ("gemma_2b", 0)])
def test_gather_steps_match_reference(arch, attn_window):
    cfg, params, model = _setup(arch, attn_window)
    steps, valid = _schedule(cfg)
    _compare(_run_port(cfg, model, steps, fused=False),
             _run_jax(cfg, params, steps), valid)


@pytest.mark.parametrize("attn_window", [0, 6])
def test_fused_steps_match_gather(attn_window):
    cfg, _, model = _setup("qwen3_8b", attn_window)
    steps, valid = _schedule(cfg)
    reset_launch_counts()
    fused = _run_port(cfg, model, steps, fused=True)
    # CPU tensors: the fused core ran the kernel's plain version
    assert launch_counts["paged_attention"] == 0
    _compare(fused, _run_port(cfg, model, steps, fused=False), valid)


def test_write_from_keeps_resident_pages():
    """Positions below write_from are not scattered: the shared page's
    resident K/V stays bit-for-bit, and only page 5 takes row 1's
    fifth token."""
    cfg, _, model = _setup("qwen3_8b", 0)
    steps, _ = _schedule(cfg)
    _, kv = _run_port(cfg, model, steps[:1], fused=False)
    k0, v0 = _pool(cfg, np.random.default_rng(1))
    np.testing.assert_array_equal(kv["k"][:, 4], k0[:, 4])
    np.testing.assert_array_equal(kv["v"][:, 4], v0[:, 4])
    assert np.abs(kv["k"][:, 5, 0]).sum() > 0
    assert np.abs(kv["k"][:, 5, 1:]).sum() == 0


def test_cow_copy_page_is_in_place():
    rng = np.random.default_rng(2)
    kv = {n: torch.from_numpy(rng.standard_normal((2, 5, 4, 2, 8))
                              .astype(np.float32)) for n in ("k", "v")}
    before = {n: t.clone() for n, t in kv.items()}
    out = cow_copy_page(kv, 3, 1)
    assert out["k"] is kv["k"]
    for n in ("k", "v"):
        assert torch.equal(kv[n][:, 1], before[n][:, 3])
        assert torch.equal(kv[n][:, [0, 2, 3, 4]], before[n][:, [0, 2, 3, 4]])


def test_fused_core_rejects_quantized_policy():
    cfg, _, _ = _setup("qwen3_8b", 0)
    with pytest.raises(ValueError, match="quantized"):
        tpm.make_fused_paged_core(cfg, TPolicy(mode="int8"))
