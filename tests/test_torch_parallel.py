"""The port's distribution layer against the JAX package's: the
partition-spec rules, and the token-dataflow attention cores (ring
attention, the layer-based dataflow and split-KV decode) on
`torch.distributed`.

Specs: for every leaf of six smoke configs, the port's `param_specs`
over its named parameters equal the reference's over its tree, dim for
dim (a leaf the reference stacks on the leading L axis is the port's
leaf less that axis), on model-parallel meshes of 2, 4 and 8 and on a
data 2 x model 2 mesh, with FSDP on and off; likewise `cache_specs`,
`batch_specs` and `paged_pool_spec`.

The serve CLI joins a `torchrun` group (2 CPU ranks over gloo).

Attention: the cases of the reference's tests/test_parallel.py and
tests/test_parallel_serve.py run in one spawned gloo group of 2 ranks
and one of 4 (each group runs every case once, in a module fixture),
each held within 1e-5 against the reference's function under
`shard_map` on as many of the 8 forced host devices and against full
attention, in f32. The rank workers (`repro_torch.launch.mesh_cases`)
import neither jax nor `repro`.
"""
import functools
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
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.parallel import ring_attention as jring  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.parallel import split_kv_attention as jsplit  # noqa: E402
from repro.parallel.ring_attention import layer_dataflow_attention as jlayer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import mesh_cases  # noqa: E402
from repro_torch.models import model as modellib  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.ring_attention import _repeat_kv  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs 8 (simulated) host devices")

ARCHS = ["qwen3_8b", "gemma_2b", "qwen2_moe_a2_7b", "dbrx_132b",
         "rwkv6_3b", "zamba2_7b"]
# (name, axes) of the meshes the specs are held on
MESHES = {"model2": (("model", 2),), "model4": (("model", 4),),
          "model8": (("model", 8),), "data2xmodel2": (("data", 2),
                                                       ("model", 2))}
TOL = dict(rtol=1e-5, atol=1e-5)
EMPTY = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def _jmesh(axes):
    n = int(np.prod([s for _, s in axes]))
    devs = np.array(jax.devices()[:n]).reshape([s for _, s in axes])
    return Mesh(devs, tuple(a for a, _ in axes))


def _tup(spec, ndim=None):
    t = tuple(spec)
    return t if ndim is None else t + (None,) * (ndim - len(t))


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return (jconfigs.get_config(arch, smoke=True),
            configs.get_config(arch, smoke=True))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    jcfg, _ = _cfgs(arch)
    return jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))


@needs8
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name):
    jcfg, cfg = _cfgs(arch)
    axes = MESHES[mesh_name]
    shapes = sh.param_shapes(modellib.empty(cfg, device="meta"))
    flat, _ = jax.tree_util.tree_flatten_with_path(_ref_shapes(arch))
    ref_leaves = {jax.tree_util.keystr(kp): leaf for kp, leaf in flat}
    for fsdp in (True, False):
        ref = jsh.param_specs(jcfg, _ref_shapes(arch), _jmesh(axes),
                              jsh.ShardingRules(fsdp=fsdp))
        ref_flat = {jax.tree_util.keystr(kp): s for kp, s in
                    jax.tree_util.tree_flatten_with_path(
                        ref, is_leaf=lambda x: isinstance(x, P))[0]}
        port = sh.param_specs(cfg, shapes, meshlib.MeshShape(axes),
                              sh.ShardingRules(fsdp=fsdp))
        assert {sh.reference_path(n) for n in port} == set(ref_flat)
        for name, spec in port.items():
            path = sh.reference_path(name)
            want = _tup(ref_flat[path], len(ref_leaves[path].shape))
            if name.startswith("layers."):
                assert want[0] is None
                want = want[1:]
            assert _tup(spec, len(shapes[name])) == want, (name, fsdp)


@needs8
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_pool_specs_match_reference(arch, mesh_name):
    jcfg, cfg = _cfgs(arch)
    axes = MESHES[mesh_name]
    jm, pm = _jmesh(axes), meshlib.MeshShape(axes)
    is_p = dict(is_leaf=lambda x: isinstance(x, P))
    for batch in (1, 4):
        for rules in (sh.ShardingRules(), sh.ShardingRules(
                decode_kv_seq_shard=False)):
            ref = jax.tree.map(tuple, jsh.cache_specs(
                jcfg, jm, batch, jsh.ShardingRules(
                    decode_kv_seq_shard=rules.decode_kv_seq_shard)), **is_p)
            assert sh.cache_specs(cfg, pm, batch, rules) == ref
        ref = jax.tree.map(tuple, jsh.batch_specs(jcfg, jm, batch), **is_p)
        assert sh.batch_specs(cfg, pm, batch) == ref
    if cfg.family in ("dense", "moe"):
        assert sh.paged_pool_spec(cfg, pm) == tuple(
            jsh.paged_pool_spec(jcfg, jm))
    assert sh.logits_spec(("data",)) == tuple(jsh.logits_spec(("data",)))
    assert sh.replicated_spec() == tuple(jsh.replicated_spec())
    assert sh.moe_dispatch_specs("data", "model") == jax.tree.map(
        tuple, jsh.moe_dispatch_specs("data", "model"), **is_p)


def test_shard_leaf_cuts_contiguous_blocks():
    x = torch.arange(48.0).reshape(4, 12)
    parts = [sh.shard_leaf(x, (None, "model"), r, 3) for r in range(3)]
    assert torch.equal(torch.cat(parts, dim=1), x)
    assert sh.local_shape((4, 12), (None, "model"), 3) == (4, 4)
    assert torch.equal(sh.shard_leaf(x, ("model",), 1, 2), x[2:])
    assert torch.equal(sh.shard_leaf(x, (), 1, 2), x)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_leaf(x, ("model", None), 0, 3)


def test_cli_joins_a_torchrun_group():
    """Under torchrun (RANK / WORLD_SIZE in the environment) the serve
    CLI joins that group instead of spawning its own (gloo on the CPU,
    a free localhost port); rank 0 alone prints the summary lines."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.serve",
         "--mode", "engine", "--mesh-shards", "2", "--device", "cpu",
         "--n-requests", "4", "--gen-len", "6"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum(ln.startswith("engine: 4 requests") for ln in lines) == 1
    assert sum(ln.startswith("energy: ") for ln in lines) == 1


def test_mesh_shapes():
    mesh = meshlib.make_smoke_mesh(2, 2)
    assert meshlib.mesh_chips(mesh) == 4
    assert meshlib.mesh_name(mesh) == "data2xmodel2"
    prod = meshlib.make_production_mesh(multi_pod=True)
    assert prod.axis_names == ("pod", "data", "model")
    assert meshlib.mesh_chips(prod) == 512
    assert meshlib.transport(2, "cpu") == "gloo"


# ---------------------------------------------------------------------------
# ring attention, the layer dataflow and split-KV decode
# ---------------------------------------------------------------------------


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _full(q, k, v, causal=True, q_pos=None, k_pos=None):
    """Dense attention in f64 (numpy), KV heads repeated to the query
    heads; the causal mask compares positions (default: aranges)."""
    g = q.shape[2] // k.shape[2]
    k = np.repeat(k, g, axis=2).astype(np.float64)
    v = np.repeat(v, g, axis=2).astype(np.float64)
    s_ = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k)
    s_ = s_ / np.sqrt(q.shape[-1])
    if causal:
        qp = np.arange(q.shape[1]) if q_pos is None else q_pos
        kp = np.arange(k.shape[1]) if k_pos is None else k_pos
        s_ = np.where((qp[:, None] >= kp[None, :])[None, None], s_, -1e30)
    p = np.exp(s_ - s_.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v).astype(np.float32)


def _positions(values, b):
    return np.broadcast_to(np.asarray(values, np.int32)[None],
                           (b, len(values))).copy()


@functools.lru_cache(maxsize=None)
def _case(name):
    """(fn, inputs, full-attention expectation) of a named case."""
    if name == "ring_full":
        b, s, h, d = 2, 64, 4, 16
        q, k, v = _rand(0, (b, s, h, d)), _rand(1, (b, s, h, d)), _rand(
            2, (b, s, h, d))
        return "ring", dict(q=q, k=k, v=v), _full(q, k, v)
    if name == "layer_full":
        b, s, h, d = 1, 64, 2, 8
        q, k, v = _rand(3, (b, s, h, d)), _rand(4, (b, s, h, d)), _rand(
            5, (b, s, h, d))
        return "layer", dict(q=q, k=k, v=v), _full(q, k, v)
    if name == "ring_non_causal":
        b, s, h, d = 1, 32, 2, 8
        q, k, v = (_rand(6 + i, (b, s, h, d)) for i in range(3))
        return ("ring", dict(q=q, k=k, v=v, causal=False),
                _full(q, k, v, causal=False))
    if name == "split_decode":
        b, sc, h, d = 2, 64, 4, 16
        q, k, v = _rand(9, (b, 1, h, d)), _rand(10, (b, sc, h, d)), _rand(
            11, (b, sc, h, d))
        return ("split_kv", dict(q=q, k=k, v=v,
                                 q_positions=np.full((b, 1), sc - 1, np.int32),
                                 kv_positions=_positions(range(sc), b)),
                _full(q, k, v, causal=False))
    if name == "split_empty_slots":
        b, sc, h, d, valid = 1, 32, 2, 8, 17
        q, k, v = _rand(12, (b, 1, h, d)), _rand(13, (b, sc, h, d)), _rand(
            14, (b, sc, h, d))
        kp = np.where(np.arange(sc) < valid, np.arange(sc), EMPTY)
        return ("split_kv", dict(q=q, k=k, v=v,
                                 q_positions=np.full((b, 1), valid - 1,
                                                     np.int32),
                                 kv_positions=_positions(kp, b)),
                _full(q, k[:, :valid], v[:, :valid], causal=False))
    if name == "ring_gqa":
        b, s, h, kvh, d = 2, 64, 8, 2, 16
        q, k, v = _rand(15, (b, s, h, d)), _rand(16, (b, s, kvh, d)), _rand(
            17, (b, s, kvh, d))
        return "ring", dict(q=q, k=k, v=v), _full(q, k, v)
    if name == "split_gqa":
        b, sc, h, kvh, d = 2, 64, 4, 2, 8
        q, k, v = _rand(18, (b, 1, h, d)), _rand(19, (b, sc, kvh, d)), _rand(
            20, (b, sc, kvh, d))
        return ("split_kv", dict(q=q, k=k, v=v,
                                 q_positions=np.full((b, 1), sc - 1, np.int32),
                                 kv_positions=_positions(range(sc), b)),
                _full(q, k, v, causal=False))
    if name == "layer_gqa":
        b, s, h, kvh, d = 1, 64, 4, 2, 8
        q, k, v = _rand(21, (b, s, h, d)), _rand(22, (b, s, kvh, d)), _rand(
            23, (b, s, kvh, d))
        return "layer", dict(q=q, k=k, v=v), _full(q, k, v)
    if name == "ring_non_causal_empty":
        b, s, h, d, valid = 1, 64, 2, 8, 40
        q, k, v = (_rand(24 + i, (b, s, h, d)) for i in range(3))
        kp = np.where(np.arange(s) < valid, np.arange(s), EMPTY)
        return ("ring", dict(q=q, k=k, v=v, causal=False,
                             kv_positions=_positions(kp, b)),
                _full(q, k[:, :valid], v[:, :valid], causal=False))
    if name == "split_non_causal_empty":
        b, sc, h, d, valid = 1, 32, 2, 8, 17
        q, k, v = _rand(27, (b, 1, h, d)), _rand(28, (b, sc, h, d)), _rand(
            29, (b, sc, h, d))
        kp = np.where(np.arange(sc) < valid, np.arange(sc), EMPTY)
        # the query "position" sits below some valid slots: non-causal
        # still attends all of them
        return ("split_kv", dict(q=q, k=k, v=v, causal=False,
                                 q_positions=np.zeros((b, 1), np.int32),
                                 kv_positions=_positions(kp, b)),
                _full(q, k[:, :valid], v[:, :valid], causal=False))
    if name == "ring_permuted":
        b, s, h, d = 1, 64, 2, 8
        q, k, v = _rand(30, (b, s, h, d)), _rand(31, (b, s, h, d)), _rand(
            32, (b, s, h, d))
        perm = np.random.default_rng(0).permutation(s).astype(np.int32)
        return ("ring", dict(q=q, k=k[:, perm], v=v[:, perm],
                             q_positions=_positions(range(s), b),
                             kv_positions=_positions(perm, b)),
                _full(q, k, v))
    if name == "ring_short_query":
        b, sq, sk, h, d = 1, 16, 64, 2, 8
        q, k, v = _rand(33, (b, sq, h, d)), _rand(34, (b, sk, h, d)), _rand(
            35, (b, sk, h, d))
        qp = sk - sq + np.arange(sq)
        return ("ring", dict(q=q, k=k, v=v, q_positions=_positions(qp, b),
                             kv_positions=_positions(range(sk), b)),
                _full(q, k, v, q_pos=qp))
    raise KeyError(name)


CASES = ["ring_full", "layer_full", "ring_non_causal", "split_decode",
         "split_empty_slots", "ring_gqa", "split_gqa", "layer_gqa",
         "ring_non_causal_empty", "split_non_causal_empty", "ring_permuted",
         "ring_short_query"]


def _reference(fn, n, kw):
    """The reference's function under shard_map on n host devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    seq, rep = P(None, "sp"), P()
    causal = kw.get("causal", True)
    if fn == "split_kv":
        qp = jnp.asarray(kw["q_positions"])
        f = shard_map(
            lambda q, k, v, kp: jsplit(q, k, v, axis_name="sp",
                                       q_positions=qp, kv_positions_local=kp,
                                       causal=causal),
            mesh=mesh, in_specs=(rep, seq, seq, seq), out_specs=rep)
        return np.asarray(jax.jit(f)(kw["q"], kw["k"], kw["v"],
                                     kw["kv_positions"]))
    if fn == "layer":
        f = shard_map(lambda q, k, v: jlayer(q, k, v, axis_name="sp",
                                             causal=causal),
                      mesh=mesh, in_specs=(seq,) * 3, out_specs=seq)
        return np.asarray(jax.jit(f)(kw["q"], kw["k"], kw["v"]))
    args = [kw["q"], kw["k"], kw["v"]]
    names = [a for a in ("q_positions", "kv_positions") if a in kw]
    args += [kw[a] for a in names]

    def ring(q, k, v, *pos):
        return jring(q, k, v, axis_name="sp", causal=causal,
                     **dict(zip(names, pos)))

    f = shard_map(ring, mesh=mesh, in_specs=(seq,) * len(args),
                  out_specs=seq)
    return np.asarray(jax.jit(f)(*args))


@functools.lru_cache(maxsize=None)
def _port_results(n):
    """Every case in one spawned group of n ranks (the 2-rank group also
    reports the packages its ranks imported)."""
    cases = [("attention", dict(fn=_case(c)[0], **_case(c)[1]))
             for c in CASES] + [("modules", {})]
    per_rank = meshlib.spawn(mesh_cases.run, n, cases, device="cpu",
                             timeout_s=60)
    out = {"modules": [r[-1] for r in per_rank]}
    for i, c in enumerate(CASES):
        fn = _case(c)[0]
        parts = [r[i] for r in per_rank]
        if fn == "split_kv":
            for p in parts[1:]:
                assert np.array_equal(p, parts[0]), "ranks disagree"
            out[c] = parts[0]
        else:
            out[c] = np.concatenate(parts, axis=1)
    return out


@pytest.fixture(scope="module")
def port_attention():
    return {n: _port_results(n) for n in (2, 4)}


@needs8
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_collective_attention_matches_reference(port_attention, case, n):
    fn, kw, full = _case(case)
    port = port_attention[n][case]
    np.testing.assert_allclose(port, _reference(fn, n, kw), **TOL)
    np.testing.assert_allclose(port, full, **TOL)


def test_repeat_kv_rejects_indivisible_heads():
    k = v = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError, match="multiple of KV heads"):
        _repeat_kv(4, k, v)
    kk, vv = _repeat_kv(4, torch.zeros(1, 2, 2, 8), torch.ones(1, 2, 2, 8))
    assert kk.shape == (1, 2, 4, 8) and torch.equal(vv, torch.ones(
        1, 2, 4, 8))


@pytest.mark.parametrize("n", [2, 4])
def test_rank_children_import_no_jax(port_attention, n):
    """A spawned rank imports the port only: the parent has jax and
    `repro` loaded, its children do not."""
    for roots in port_attention[n]["modules"]:
        assert "repro_torch" in roots
        assert not {"jax", "jaxlib", "repro"} & set(roots)
