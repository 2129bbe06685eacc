"""The dry run: one rank's step of every (arch x shape x mesh) cell,
counted on meta tensors and priced on the roofline (the port's
counterpart of `repro.launch.dryrun`).

The reference lowers and compiles each cell's jitted step over a mesh
of 256 or 512 simulated host devices and reads the partitioned
program's `cost_analysis()`, `memory_analysis()` and HLO collectives.
The port runs one process a rank, so a cell runs rank 0 of its mesh:
a fake process group of `mesh_chips(mesh)` ranks (torch's
`torch.testing._internal.distributed.fake_pg`, whose collectives move
nothing) is made and destroyed inside `run_cell`, the rank's view of
the mesh built over it (`launch.mesh.rank_mesh`), and the rank's step
run eagerly on meta tensors, which hold shapes and dtypes and no
storage, so nothing is allocated. Inside `roofline.count.Count` and
`roofline.collectives.recording()` the step gives its FLOPs, bytes,
peak storage, kernel calls and collectives. Its inputs are
`launch.specs.input_specs`':

  train    `make_train_step(..., mesh=, rules=)` on the rank's
           shape-only model (`data_parallel.shape_rank_model`: its
           blocks, the placement, the FSDP reads) with AdamW's state
           keyed by `named_shards`, on the global batch (the step takes
           its rows).
  prefill, decode  `make_prefill_step` / `make_decode_step` with the
           mesh, on the rank's rows of the batch and of a bf16 cache:
           every family tensor-parallel over `model`
           (`tensor_parallel.placement`, the rank's part of the cache:
           `tensor_parallel.rank_cache`). Decode writes the last slot of a
           cache of seq_len (+ a vlm prefix), so it attends the whole
           context. Where the reference keeps FSDP for serving (a
           tensor-parallel bf16 copy over 4 GiB a chip: dbrx_132b), the
           row's `note` says that the port does not.

A cell the port cannot place is recorded as `status: "error"` with the
port's own ValueError, as the reference records a cell that fails to
lower (per-channel scales under `--policy`, which the sharded steps
refuse: `data_parallel.check_mesh`); every cell of the single-pod sweep
places. `main` exits 1 when any cell errs.

No probes and no `inner_scan_correction`: both correct XLA counting a
loop body once, while the eager count sees every layer and every
chunk of the recurrent scans; `--no-probes` is taken and says that it
changes nothing. The port has no sequence-parallel placement: the
reference's `--seq-parallel` is not taken, and `run_cell` refuses
`ShardingRules(seq_parallel=True)`.

Rows keep the reference's keys that mean something here
(`RooflineReport.row()`, `collectives`, `coll_ops`, `fits_hbm` against
`hw.hbm_gib`), with the seconds the count took (`t_count_s`), `hw`,
`kernel_calls`, the input bytes and the int8 operations among the
counted FLOPs (`int8_gops`, priced at `hw.peak_int8_ops`); the
XLA-only arg/temp/out/alias bytes are left out. The cache is `experiments/torch_dryrun_cache.json`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--multi-pod | --both-meshes] [--force]
      [--policy exact|int8|artemis_mxu] [--no-fsdp] [--no-probes]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as specslib
from repro_torch.launch import steps as stepslib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import (HW_H100, HardwareSpec, analyze,
                                  collective_stats, model_flops, recording)
from repro_torch.roofline.count import Count

CACHE_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "torch_dryrun_cache.json")
# the reference's serving placement keeps FSDP above this many GiB of
# tensor-parallel bf16 weights a chip (`repro.launch.dryrun.lower_cell`)
SERVE_FSDP_GIB = 4.0


def _cache_key(arch, shape, mesh_tag, rules: sh.ShardingRules,
               policy_mode: str) -> str:
    return f"{arch}|{shape}|{mesh_tag}|{dataclasses.asdict(rules)}|" \
           f"{policy_mode}"


def load_cache(path: str = CACHE_PATH) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def _save_cache(cache: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake process group of `world_size` ranks, this process rank
    `rank`, for the block; it refuses to replace a group the caller
    has."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("the dry run makes its own (fake) process group; "
                           "this process already has one")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run runs its ranks over torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have") from e
    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def serve_fsdp_note(cfg: ModelConfig, mesh,
                    rules: sh.ShardingRules) -> str | None:
    """The note of a serving cell where the reference keeps FSDP."""
    tp = mesh.shape.get("model", 1)
    resident_gib = cfg.param_count() * 2 / tp / 2**30
    if rules.fsdp and resident_gib > SERVE_FSDP_GIB:
        return (f"the reference keeps FSDP here ({resident_gib:.1f} GiB of "
                f"bf16 weights a chip over model {tp} > {SERVE_FSDP_GIB}); "
                f"the port serves tensor-parallel only")
    return None


def count_cell(cfg: ModelConfig, cell: configs.ShapeCell, rmesh,
               rules: sh.ShardingRules = sh.ShardingRules(),
               policy: ArithmeticPolicy = ArithmeticPolicy(), *,
               opt_cfg: OptimizerConfig = OptimizerConfig(),
               **cache_kw) -> dict:
    """One rank's step of `cell` on its meta inputs (`specs.input_specs`,
    which takes the cache's `cache_len`, `cache_dtype` and
    `cache_index`), counted: {"count": the `Count`, "records": the
    collectives' records}. `rmesh` is the rank's `launch.mesh.RankMesh`."""
    # the step first: its refusal of a placement the port lacks comes
    # before the inputs are cut for it
    if cell.kind == "train":
        step = stepslib.make_train_step(cfg, opt_cfg, policy, mesh=rmesh,
                                        rules=rules)
    else:
        make = (stepslib.make_prefill_step if cell.kind == "prefill"
                else stepslib.make_decode_step)
        step = make(cfg, policy, mesh=rmesh)
    ins = specslib.input_specs(cfg, cell, rmesh, rules, policy, **cache_kw)
    model = ins["model"]
    args = (model, *(ins[k] for k in {
        "train": ("opt_state", "batch"), "prefill": ("batch", "cache"),
        "decode": ("tokens", "cache")}[cell.kind]))
    inputs = [dict(model.named_parameters()), *args[1:]]
    with recording() as records, Count(inputs) as count:
        step(*args)
    return {"count": count, "records": records}


def run_cell(arch: str, shape: str, mesh, mesh_tag: str,
             rules: sh.ShardingRules = sh.ShardingRules(),
             policy: ArithmeticPolicy = ArithmeticPolicy(),
             cache: dict | None = None, verbose: bool = True,
             force: bool = False, hw: HardwareSpec = HW_H100,
             cache_path: str = CACHE_PATH) -> dict:
    """Count and price one cell on rank 0 of `mesh` (a
    `launch.mesh.MeshShape`); its row goes into `cache` (saved to
    `cache_path`) when one is given. A cached ok row is returned as it
    is unless `force`; errors are retried."""
    if rules.seq_parallel:
        raise ValueError("the port has no sequence-parallel placement "
                         "(ShardingRules.seq_parallel)")
    key = _cache_key(arch, shape, mesh_tag, rules, policy.mode)
    if cache is not None and key in cache and not force \
            and cache[key].get("status") == "ok":
        if verbose:
            print(f"[cached] {arch} × {shape} × {mesh_tag}")
        return cache[key]
    cfg = configs.get_config(arch)
    cell = configs.SHAPES[shape]
    chips = meshlib.mesh_chips(mesh)
    row: dict = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                 "status": "ok", "hw": hw.name}
    t0 = time.time()
    with fake_group(chips):
        try:
            rmesh = meshlib.rank_mesh(mesh)
            out = count_cell(cfg, cell, rmesh, rules, policy)
            count, coll = out["count"], collective_stats(out["records"])
            n_tokens = (cell.global_batch if cell.kind == "decode"
                        else cell.global_batch * cell.seq_len)
            mflops = model_flops(cfg, n_tokens, cell.kind,
                                 kv_len=cell.seq_len)
            rep = analyze(arch, shape, mesh_tag, chips,
                          {"flops": count.flops,
                           "bytes accessed": count.bytes,
                           "int8 ops": count.int8_ops},
                          coll, mflops, count.peak, hw=hw)
            row.update(rep.row())
            row.update({
                "collectives": coll.summary(),
                "coll_ops": coll.ops,
                "kernel_calls": dict(count.kernel_calls),
                "int8_gops": count.int8_ops / 1e9,
                "input_gib": count.input_bytes / 2**30,
                "t_count_s": round(time.time() - t0, 1),
                "fits_hbm": bool(count.peak < hw.hbm_gib * 2**30),
            })
            note = (serve_fsdp_note(cfg, mesh, rules)
                    if cell.kind != "train" else None)
            if note:
                row["note"] = note
            if verbose:
                print(f"[ok] {arch} × {shape} × {mesh_tag}: "
                      f"dom={row['dominant']} "
                      f"t=({row['t_compute_s']:.2e},{row['t_memory_s']:.2e},"
                      f"{row['t_collective_s']:.2e})s "
                      f"mem/dev={row['bytes_per_device_gib']:.2f}GiB "
                      f"count={row['t_count_s']:.0f}s")
        except Exception as e:   # recorded in the row, as the reference's
            row["status"] = "error"
            row["error"] = f"{type(e).__name__}: {e}"
            row["traceback"] = traceback.format_exc()[-2000:]
            if verbose:
                print(f"[ERR] {arch} × {shape} × {mesh_tag}: {row['error']}")
    if cache is not None:
        cache[key] = row
        _save_cache(cache, cache_path)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--force", action="store_true", help="ignore cache")
    ap.add_argument("--policy", default="exact",
                    choices=["exact", "int8", "artemis_mxu"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="taken for the reference's CLI; changes nothing "
                         "(the eager count has no probes)")
    args = ap.parse_args()
    if args.no_probes:
        print("--no-probes: the port's dry run counts every layer eagerly "
              "and runs no probes; the flag changes nothing")

    rules = sh.ShardingRules(fsdp=not args.no_fsdp)
    policy = ArithmeticPolicy(mode=args.policy)
    cache = load_cache()

    meshes = []
    if args.both_meshes or not args.multi_pod:
        meshes.append((meshlib.make_production_mesh(multi_pod=False),
                       "pod1_16x16"))
    if args.both_meshes or args.multi_pod:
        meshes.append((meshlib.make_production_mesh(multi_pod=True),
                       "pod2_2x16x16"))

    archs = [configs.canon(args.arch)] if args.arch else list(configs.ARCHS)
    n_ok = n_err = n_skip = 0
    for arch in archs:
        shapes = [args.shape] if args.shape else list(configs.SHAPES)
        runnable = set(configs.runnable_shapes(arch))
        for shape in shapes:
            if shape not in runnable:
                print(f"[skip] {arch} × {shape}: documented skip "
                      f"(long_500k runs the sub-quadratic archs only)")
                n_skip += 1
                continue
            for mesh, tag in meshes:
                row = run_cell(arch, shape, mesh, tag, rules, policy,
                               cache=cache, force=args.force)
                if row["status"] == "ok":
                    n_ok += 1
                else:
                    n_err += 1
    print(f"\ndry-run complete: {n_ok} ok, {n_err} errors, "
          f"{n_skip} documented skips")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
