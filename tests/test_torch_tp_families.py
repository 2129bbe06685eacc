"""Tensor parallelism for rwkv6, zamba2 and the multimodal families
(`repro_torch.parallel.tensor_parallel`'s placement and seams through
`launch.steps.make_prefill_step(mesh=)`, `make_decode_step(mesh=)` and
`make_train_step(mesh=, rules=)` at model > 1) against the reference,
on the CPU.

Every case runs in one spawned gloo group of 2 ranks and one of 4
(`launch.mesh.spawn`, module fixture), started while the parent jits
the reference. Smoke rwkv6_3b, zamba2_7b, musicgen_large and
internvl2_1b at f32, from the same numpy weights (the port's seeded
init in the reference's layout, through the bridge):

  (a) the static steps at (model 2) and (model 4): a prefill (after
      the vlm's 256-token prefix) and 2 decode steps of given tokens,
      every rank's logits and its cache's parts put back together
      against the reference's single-device jitted `make_prefill_step`
      / `make_decode_step`, each within 1e-4 of its max abs; zamba2's
      cache of 6 slots is shorter than its 8-token prompt, so its
      prefill keeps the ring's last 6 tokens and its decodes wrap it;
  (b) int8 static steps at (model 2): every rank's logits and cache
      equal the port's single-device int8 steps bit for bit, and each
      rank calls sc_matmul (its plain version here) once a policy
      product of every forward;
  (c) train steps at (model 2) and (data 2, model 2): the loss and
      every gathered gradient at the start within `TIGHT` of the
      reference's single-device jitted step, each step's metrics, and
      the parameters after 2 steps within 0.05 x lr; one int8 step
      (musicgen_large at (model 2)) within `FLIP_INT8` of the reference's
      single-device int8 step.

Coverage: smoke rwkv6 has 2 wkv heads, so the 2-rank group splits them
by heads and the 4-rank group, where n does not divide the heads, by
each head's key channels (the wkv readout then sums over the ranks);
smoke internvl2_1b has 2 KV heads, split at 2 ranks and kept whole at
4; smoke zamba2's 4 SSD heads and its shared block's 4 heads split at
both. The placement tests hold each family's cut at n = 2 and n = 16 of
the full configs on meta shapes.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.policy import ArithmeticPolicy  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import mesh_cases  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.parallel import data_parallel as dp  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel import tensor_parallel as tpl  # noqa: E402

ARCHS = ["rwkv6_3b", "zamba2_7b", "musicgen_large", "internvl2_1b"]
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)
N_STEPS = 2
# the static steps: each logits row and cache leaf within this share of
# its max abs (f32 sums in another order)
STEP_TOL = 1e-4
# (loss relative, a leaf's max abs), as tests/test_torch_sharded_train.py
TIGHT = (1e-5, 1e-4)
FLIP_INT8 = (1e-3, 5e-2)
PARAM_TOL = 0.05
B, S, N_DECODE = 2, 8, 2
# zamba2's cache: fewer slots than the prompt (module docstring)
MAX_LEN = {"zamba2_7b": 6}
TRAIN_MESHES = [(1, 2), (2, 2)]
INT8_TRAIN = ("musicgen_large", (1, 2))


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(configs.get_config(arch, smoke=True),
                             compute_dtype="float32")
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The port's seeded init in the reference's layout (numpy)."""
    return bridge.params_to_numpy(tmodel.init(_cfgs(arch)[1], seed=0,
                                              device="cpu", train=True))


@functools.lru_cache(maxsize=None)
def _serve_inputs(arch):
    """(prompt tokens, the decode steps' tokens, the vlm prefix or
    None), numpy."""
    jc, _ = _cfgs(arch)
    rng = np.random.default_rng(7)
    codebooks = (jc.n_codebooks,) if jc.modality == "audio" else ()
    tokens = rng.integers(2, jc.vocab_size, (B, S) + codebooks)
    decode = rng.integers(2, jc.vocab_size, (N_DECODE, B, 1) + codebooks)
    prefix = (rng.standard_normal((B, 256, jc.d_model)).astype(np.float32)
              if jc.modality == "vlm" else None)
    return tokens.astype(np.int32), decode.astype(np.int32), prefix


@functools.lru_cache(maxsize=None)
def _batches(arch):
    jc, _ = _cfgs(arch)
    return [jax.tree.map(np.asarray,
                         make_batch(jc, DataConfig(seq_len=16,
                                                   global_batch=4), s))
            for s in range(N_STEPS)]


def _serve_case(arch, policy):
    tokens, decode, prefix = _serve_inputs(arch)
    return ("serve_steps", dict(cfg=_cfgs(arch)[1], tokens=tokens,
                                weights=_weights(arch), prefix=prefix,
                                decode=decode, policy=policy,
                                max_len=MAX_LEN.get(arch)))


def _train_case(arch, mesh, policy="exact"):
    return ("train", dict(cfg=_cfgs(arch)[1], mesh=mesh,
                          weights=_weights(arch), batches=_batches(arch),
                          policy=policy, opt=OPT))


def _jobs(n):
    """{name: case} of the n-rank group."""
    jobs = {}
    for arch in ARCHS:
        jobs[("serve", arch, "exact")] = _serve_case(arch, "exact")
        if n == 2:
            jobs[("serve", arch, "int8")] = _serve_case(arch, "int8")
        for mesh in TRAIN_MESHES:
            if mesh[0] * mesh[1] == n:
                jobs[("train", arch, mesh, "exact")] = _train_case(arch,
                                                                   mesh)
    arch, mesh = INT8_TRAIN
    if mesh[0] * mesh[1] == n:
        jobs[("train", arch, mesh, "int8")] = _train_case(arch, mesh, "int8")
    return jobs


def _spawn(n):
    jobs = _jobs(n)
    per_rank = meshlib.spawn(mesh_cases.run, n, list(jobs.values()),
                             device="cpu", timeout_s=300)
    return {name: [r[i] for r in per_rank] for i, name in enumerate(jobs)}


def _reference_serve(arch):
    """The reference's single-device jitted prefill and decode steps on
    the same weights and tokens: (every step's logits, the cache after
    the last, flattened by dotted path), numpy."""
    jc, _ = _cfgs(arch)
    tokens, decode, prefix = _serve_inputs(arch)
    batch = {"tokens": tokens}
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    p = 0 if prefix is None else prefix.shape[1]
    cache = jmodel.init_cache(jc, B, MAX_LEN.get(arch, p + S + N_DECODE),
                              dtype=jnp.float32)
    params = _weights(arch)
    out, cache = jax.jit(jsteps.make_prefill_step(jc))(params, batch, cache)
    logits = [np.asarray(out)]
    step = jax.jit(jsteps.make_decode_step(jc))
    for tok in decode:
        out, cache = step(params, tok, cache)
        logits.append(np.asarray(out))
    flat = mesh_cases.flatten(jax.tree.map(np.asarray, cache))
    return logits, {k: v for k, v in flat.items() if k != "index"}


def _reference_train(arch, policy):
    """The reference's loss, aux and gradients at the start and its
    N_STEPS single-device jitted steps (params and metrics after
    each)."""
    jc, _ = _cfgs(arch)
    pol = jsteps.ArithmeticPolicy(mode=policy)
    step = jsteps.make_train_step(jc, JOpt(**OPT), pol)

    def loss_fn(p, batch):
        inputs = {k: batch[k] for k in ("tokens", "prefix_embeds")
                  if k in batch}
        logits, aux, _ = jmodel.apply(p, jc, inputs, policy=pol)
        logits = logits[:, -batch["tokens"].shape[1]:]
        loss = jmodel.lm_loss(logits, batch["labels"])
        return loss + aux, (loss, aux)

    def both(p, o, batch):
        (_, (loss, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, batch)
        return (loss, aux, grads) + step(p, o, batch)

    fn = jax.jit(both)
    params = _weights(arch)
    opt = jadamw_init(params)
    out = {"steps": []}
    for i, batch in enumerate(_batches(arch)):
        loss, aux, grads, params, opt, metrics = fn(params, opt, batch)
        if i == 0:
            out.update(loss=float(loss), grads=jax.tree.map(np.asarray,
                                                            grads))
        out["steps"].append(dict(
            params=jax.tree.map(np.asarray, params),
            metrics={k: float(v) for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def runs():
    """(every case's ranks' results by group, the references): both
    groups run while the parent jits the reference."""
    for arch in ARCHS:
        _weights(arch), _serve_inputs(arch), _batches(arch)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        groups = {n: pool.submit(_spawn, n) for n in (2, 4)}
        refs = {("serve", arch): _reference_serve(arch) for arch in ARCHS}
        for arch in ARCHS:
            refs[("train", arch, "exact")] = _reference_train(arch, "exact")
        refs[("train", INT8_TRAIN[0], "int8")] = _reference_train(
            INT8_TRAIN[0], "int8")
        port = {n: f.result() for n, f in groups.items()}
    return port, refs


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(want - np.asarray(got, np.float64)).max()
                 / max(np.abs(want).max(), 1e-30))


def _joined_cache(ranks, cfg, n) -> dict:
    """The ranks' cache parts put back together, by dotted path."""
    specs = mesh_cases.flatten(tpl.cache_placement(cfg, n))
    return {k: sh.join_parts([r["cache"][k] for r in ranks], specs[k])
            for k in ranks[0]["cache"]}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_steps_match_reference(runs, arch, n):
    ranks = runs[0][n][("serve", arch, "exact")]
    want_logits, want_cache = runs[1][("serve", arch)]
    _, tc = _cfgs(arch)
    for r in ranks:
        assert len(r["logits"]) == N_DECODE + 1
        for want, got in zip(want_logits, r["logits"]):
            assert got.shape == want.shape
            assert _rel(want, got.numpy()) <= STEP_TOL
        for other, mine in zip(r["logits"], ranks[0]["logits"]):
            assert torch.equal(other, mine)
    joined = _joined_cache(ranks, tc, n)
    assert set(joined) == set(want_cache)
    for key, want in want_cache.items():
        got = joined[key].numpy()
        assert got.shape == want.shape, key
        if key == "attn_pos":
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(want, got) <= STEP_TOL, key


def _port_single(arch, policy):
    """The port's single-device static steps on the same weights and
    tokens: (logits, cache by dotted path)."""
    _, tc = _cfgs(arch)
    tokens, decode, prefix = _serve_inputs(arch)
    pol = ArithmeticPolicy(mode=policy)
    model = bridge.params_from_numpy(_weights(arch), tc, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    if prefix is not None:
        batch["prefix_embeds"] = torch.from_numpy(prefix)
    p = 0 if prefix is None else prefix.shape[1]
    cache = tmodel.init_cache(tc, B, MAX_LEN.get(arch, p + S + N_DECODE),
                              dtype=torch.float32, device="cpu")
    from repro_torch.launch import steps
    out, cache = steps.make_prefill_step(tc, pol)(model, batch, cache)
    logits = [out]
    for tok in decode:
        out, cache = steps.make_decode_step(tc, pol)(
            model, torch.from_numpy(tok), cache)
        logits.append(out)
    flat = mesh_cases.flatten(cache)
    return logits, {k: v for k, v in flat.items() if k != "index"}


def _policy_products(cfg) -> int:
    """The policy products of one forward of the smoke config."""
    if cfg.family == "rwkv6":
        return 9 * cfg.n_layers
    attn = 4 + (3 if cfg.glu else 2)
    if cfg.family == "zamba2":
        return 2 * cfg.n_layers + attn * (cfg.n_layers
                                          // cfg.shared_attn_period)
    return attn * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_static_steps_bit_equal_single_device(runs, arch):
    ranks = runs[0][2][("serve", arch, "int8")]
    _, tc = _cfgs(arch)
    want_logits, want_cache = _port_single(arch, "int8")
    for r in ranks:
        for want, got in zip(want_logits, r["logits"]):
            assert torch.equal(got, want)
        products = (N_DECODE + 1) * _policy_products(tc)
        assert r["kernel_calls"] == {"sc_matmul": products,
                                     "sc_quantize": 2 * products}
    joined = _joined_cache(ranks, tc, 2)
    for key, want in want_cache.items():
        assert torch.equal(joined[key], want), key


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_static_steps_call_flash_on_each_rank(runs, arch):
    """Every attention layer of every forward calls flash_attention (its
    plain version here) on each rank, but zamba2's decodes over a
    wrapped ring (the gather core); rwkv6 has no attention."""
    _, tc = _cfgs(arch)
    if arch == "rwkv6_3b":
        want = {}
    elif arch == "zamba2_7b":
        want = {"flash_attention": tc.n_layers // tc.shared_attn_period}
    else:
        want = {"flash_attention": (N_DECODE + 1) * tc.n_layers}
    for n in (2, 4):
        for r in runs[0][n][("serve", arch, "exact")]:
            assert r["kernel_calls"] == want


def _worst(want, got):
    errs = {}
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        errs[jax.tree_util.keystr(path)] = _rel(w, g)
    assert errs and jax.tree.structure(want) == jax.tree.structure(got)
    key = max(errs, key=errs.get)
    return errs[key], key


@pytest.mark.parametrize("mesh", TRAIN_MESHES,
                         ids=[f"data{d}xmodel{m}" for d, m in TRAIN_MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(runs, arch, mesh):
    ranks = runs[0][mesh[0] * mesh[1]][("train", arch, mesh, "exact")]
    ref = runs[1][("train", arch, "exact")]
    got = ranks[0]
    assert abs(got["loss"] - ref["loss"]) <= TIGHT[0] * abs(ref["loss"])
    err, leaf = _worst(ref["grads"], got["grads"])
    assert err <= TIGHT[1], (leaf, err)
    for i, step in enumerate(ref["steps"]):
        for key, want in step["metrics"].items():
            assert got["metrics"][i][key] == pytest.approx(
                want, rel=TIGHT[0]), (i, key)
    drift = jax.tree.map(lambda a, b: np.abs(a - b).max(),
                         ref["steps"][-1]["params"], got["params"])
    assert max(jax.tree.leaves(drift)) <= PARAM_TOL * OPT["lr"]
    for other in ranks[1:]:
        assert other["metrics"] == got["metrics"]
        jax.tree.map(np.testing.assert_array_equal, other["params"],
                     got["params"])


def test_int8_train_step_within_flip(runs):
    """One int8 step: its loss, gradients and gradient norm (a
    last-bit difference flips an int8 value at a rounding tie, as in
    tests/test_torch_sharded_train.py); the steps after it start from
    parameters that part where a flipped gradient moved them."""
    arch, mesh = INT8_TRAIN
    got = runs[0][mesh[0] * mesh[1]][("train", arch, mesh, "int8")][0]
    ref = runs[1][("train", arch, "int8")]
    assert abs(got["loss"] - ref["loss"]) <= FLIP_INT8[0] * abs(ref["loss"])
    err, leaf = _worst(ref["grads"], got["grads"])
    assert err <= FLIP_INT8[1], (leaf, err)
    for key in ("loss", "grad_norm"):
        assert got["metrics"][0][key] == pytest.approx(
            ref["steps"][0]["metrics"][key], rel=FLIP_INT8[0]), key


# ---------------------------------------------------------------------------
# the placement, on meta shapes of the full configs
# ---------------------------------------------------------------------------


def _rank_parts_join(shape, spec, n) -> bool:
    """Cutting an index vector of each cut dim for every rank and putting
    the parts back together gives it whole: every element of the leaf
    lies in exactly one place of one rank's part, or whole on all."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = torch.arange(shape[dim])
        parts = [sh.cut_dim(idx, 0, entry, r, n) for r in range(n)]
        if any(p.shape[0] != sh.local_size(shape[dim], entry, n)
               for p in parts):
            return False
        if not torch.equal(sh.join_dim(parts, 0, entry), idx):
            return False
    return True


def _local(cfg, n, policy):
    meta = tmodel.empty(cfg, device="meta")
    shapes = sh.param_shapes(meta)
    specs = tpl.placement(cfg, shapes, n, ArithmeticPolicy(mode=policy))
    local = {k: sh.local_shape(shapes[k], specs[k], n) for k in shapes}
    return shapes, specs, local


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("policy", ["exact", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_cuts_each_family(arch, policy, n):
    cfg = configs.get_config(arch)
    shapes, specs, local = _local(cfg, n, policy)
    d = cfg.d_model
    for name, shape in shapes.items():
        assert _rank_parts_join(shape, specs[name], n), name
        assert len(local[name]) == len(shape)
    rows = policy == "exact"
    if arch == "rwkv6_3b":
        h, hn = d // cfg.ssm_head_dim, cfg.ssm_head_dim
        by_heads = h % n == 0
        assert by_heads == (n == 2)                 # 40 heads, 16 ranks
        keys = (d, d // n)
        assert local["layers.0.wr"] == local["layers.0.wk"] == keys
        assert local["layers.0.td_w2"] == (64, d // n)
        assert local["layers.0.u"] == ((h // n, hn) if by_heads
                                       else (h, hn // n))
        assert local["layers.0.wv"] == ((d, d // n) if by_heads else (d, d))
        assert local["layers.0.wg"] == local["layers.0.cm_wr"] == (d, d // n)
        assert local["layers.0.cm_wk"] == (d, cfg.d_ff // n)
        assert local["layers.0.wo"] == ((d // n, d) if rows else (d, d // n))
        assert local["layers.0.cm_wv"] == ((cfg.d_ff // n, d) if rows
                                           else (cfg.d_ff, d // n))
        for leaf in ("maa_w1", "maa_w2", "td_w1", "ln_x.scale", "maa_wkvrg"):
            assert specs[f"layers.0.{leaf}"] == (), leaf
        if not by_heads:
            seg = specs["layers.0.wr"][1]
            assert isinstance(seg, sh.Segments) and seg.sizes == (hn,) * h
            cache = tpl.cache_placement(cfg, n)["layers"]["wkv"]
            assert cache == (None, None, None, "model", None)
    elif arch == "zamba2_7b":
        di, ns, hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        assert local["layers.0.in_proj"] == (
            d, 2 * di // n + 2 * ns + hs // n)
        assert local["layers.0.conv_w"] == (cfg.conv_width, di // n + 2 * ns)
        assert local["layers.0.conv_b"] == (di // n + 2 * ns,)
        for leaf in ("A_log", "dt_bias", "D"):
            assert local[f"layers.0.{leaf}"] == (hs // n,)
        assert specs["layers.0.norm.scale"] == ()
        assert local["layers.0.out_proj"] == ((di // n, d) if rows
                                              else (di, d // n))
        # the shared block split as a dense layer's, not kept whole
        hd = cfg.resolved_head_dim
        assert local["shared.attn.wq"] == (d, cfg.n_heads * hd // n)
        assert local["shared.attn.wk"] == (d, cfg.n_kv_heads * hd // n)
        assert local["shared.attn.wo"] == ((cfg.n_heads * hd // n, d)
                                           if rows else
                                           (cfg.n_heads * hd, d // n))
        assert local["shared.ffn.w_up"] == local["shared.ffn.w_gate"] == (
            d, cfg.d_ff // n)
        assert local["shared.ffn.w_down"] == ((cfg.d_ff // n, d) if rows
                                              else (cfg.d_ff, d // n))
    elif arch == "musicgen_large":
        v, c = cfg.padded_vocab, cfg.n_codebooks
        assert local["head"] == (c, d, v // n)
        assert local["embed"] == (c, v // n, d)
        assert local["layers.0.attn.wq"] == (d, d // n)
    else:
        v = cfg.padded_vocab
        assert v % 16 == 0 and local["embed"] == (v // n, d)
        attn_cut = cfg.n_kv_heads % n == 0
        assert attn_cut == (n == 2)                 # 2 KV heads
        hd = cfg.resolved_head_dim
        assert local["layers.0.attn.wk"] == (
            (d, hd) if attn_cut else (d, 2 * hd))


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_parts_gather_back_to_the_whole_model(arch):
    """Smoke: every rank's part of every leaf put back together equals
    the whole leaf, under the serving placement (`tensor_parallel.
    shard_of` at 2 and 4 ranks, exact and int8) and the training one
    over (data 2, model 2) (`data_parallel.cut`); the rank cache's
    leaves have the cache's cut shapes and its fill."""
    _, tc = _cfgs(arch)
    whole = tmodel.init(tc, seed=0, device="cpu")
    for n in (2, 4):
        for policy in (ArithmeticPolicy(), ArithmeticPolicy(mode="int8")):
            parts = [tpl.shard_of(whole, tc, r, n, policy) for r in range(n)]
            for name, p in whole.named_parameters():
                got = sh.join_parts([q.get_parameter(name) for q in parts],
                                    parts[0].placement[name])
                assert torch.equal(got, p), (n, name)
        cache = tpl.rank_cache(tc, n, 2, 12, dtype=torch.float32,
                               device="cpu")
        full = tmodel.init_cache(tc, 2, 12, dtype=torch.float32,
                                 device="cpu")
        specs = mesh_cases.flatten(tpl.cache_placement(tc, n))
        flat, flat_full = mesh_cases.flatten(cache), mesh_cases.flatten(full)
        for key, t in flat.items():
            if key != "index":
                assert t.shape == sh.local_shape(flat_full[key].shape,
                                                 specs[key], n), key
                assert torch.equal(t.reshape(-1)[:1],
                                   flat_full[key].reshape(-1)[:1]), key
    train = tmodel.init(tc, seed=0, device="cpu", train=True)
    specs = dp.train_placement(tc, sh.param_shapes(train),
                               meshlib.make_smoke_mesh(2, 2))
    for name, p in train.named_parameters():
        spec = dp._pad(specs[name], p.dim())
        blocks = [[dp.cut(p, spec, _Coords(data=i, model=j))
                   for j in range(2)] for i in range(2)]
        for axis, sizes in (("model", None), ("data", None)):
            if axis not in sh.spec_axes(spec):
                blocks = [row[0] for row in blocks] if axis == "model" \
                    else blocks[0]
                continue
            dim = sh.spec_axes(spec).index(axis)
            if axis == "model":
                blocks = [sh.join_dim(row, dim, spec[dim]) for row in blocks]
            else:
                blocks = sh.join_dim(blocks, dim, spec[dim])
        assert torch.equal(blocks, p), name


class _Coords:
    """A rank's coordinates on a (data 2, model 2) mesh, as
    `launch.mesh.RankMesh` gives them to `data_parallel.cut`."""

    def __init__(self, **index):
        self._index = index

    def size(self, axis):
        return 2

    def index(self, axis):
        return self._index[axis]
