#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (`src/repro_torch`) on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

  1. the card: name and power limit (nvidia-smi), capability (9, 0);
  2. build every kernel of the serve path from the checkout's sources
     (nvcc, sm_90a), timed as set-up;
  3. hold each kernel against its plain PyTorch version on the card
     over a grid of cases, with the tolerance stated per kernel;
  4. at the full-width qwen3_8b shapes of the serve path, hold each
     kernel against its plain version once more, then time it beside
     its plain version, its bound and one library call;
  5. drain the paged-KV engine at the full qwen3_8b width (36 layers,
     bf16, attn_impl="fused") with seeded random weights, with every
     launch count zeroed just before and read just after: each kernel
     of the path must have run, paged_attention once per layer of
     every forward;
  6. the same trace at float32 through 2 layers of the full width,
     once with the gather core and once with the fused kernel: the
     greedy tokens must be identical;
  7. print the kernels line, the card line, then the result line.

The script imports nothing of `repro` (the JAX package) or of jax.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores

PA_TOL = dict(rtol=2e-4, atol=2e-4)   # f32 sums in another order, over
#                                        up to a few hundred keys


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> str:
    """One line from nvcc's `-Xptxas -v` report: kernel instances,
    register range, and the largest spill."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
    if not regs:
        return "no resource report"
    return (f"{len(regs)} kernel instances, {min(regs)}-{max(regs)} "
            f"registers, {sum(1 for s in spills if s)} spilling (max "
            f"{max(spills, default=0)} bytes)")


def cuda_time_ms(fn, n_iter: int, warmup: int = 3) -> float:
    """Mean ms of fn(i) over n_iter calls, by CUDA events."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter


# ---------------------------------------------------------------------------
# phase 3: paged_attention against its plain version
# ---------------------------------------------------------------------------


def _pa_case(gen, *, page, hd, group, window, s, q_dtype, kv_dtype):
    """Operands of one case: lanes 0 and 1 mid-table (their chunks
    straddle page boundaries), lane 2 idle (all-trash table, positions
    0), as the engine lays them out."""
    import torch
    kvh, b = 2, 3
    h = kvh * group
    starts = [2 * page + 1, page - 1]
    pmax = -(-(max(starts) + s) // page) + 1
    n_pages = 2 * pmax + 2
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    kp = torch.randn((n_pages, page, kvh, hd), generator=gen, device="cuda")
    vp = torch.randn((n_pages, page, kvh, hd), generator=gen, device="cuda")
    bt = torch.zeros((b, pmax), dtype=torch.int32, device="cuda")
    pos = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    for lane, st in enumerate(starts):
        used = -(-(st + s) // page)
        bt[lane, :used] = torch.randint(1, n_pages, (used,), generator=gen,
                                        device="cuda", dtype=torch.int32)
        pos[lane] = st + torch.arange(s, device="cuda", dtype=torch.int32)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), bt, pos)


def check_paged_attention() -> float:
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    n = 0
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    for page in (4, 8, 16):
        for hd in (16, 128):
            for group in (1, 4):
                for window in (None, 3):
                    for s in (1, 7, 32):
                        errs = []
                        for q_dt, kv_dt in dtypes:
                            q, kp, vp, bt, pos = _pa_case(
                                gen, page=page, hd=hd, group=group,
                                window=window, s=s, q_dtype=q_dt,
                                kv_dtype=kv_dt)
                            out = paged_attention(q, kp, vp, bt, pos,
                                                  window=window)
                            torch.cuda.synchronize()
                            ref = paged_attention_ref(q, kp, vp, bt, pos,
                                                      window=window)
                            err = (out - ref).abs()
                            bound = PA_TOL["atol"] + PA_TOL["rtol"] * ref.abs()
                            if not bool(torch.isfinite(out).all()) or \
                                    bool((err > bound).any()):
                                raise AssertionError(
                                    f"paged_attention disagrees with its "
                                    f"plain version: page {page} Dh {hd} "
                                    f"G {group} window {window} S {s} q "
                                    f"{q_dt} kv {kv_dt}: max err "
                                    f"{err.max().item():.3e}")
                            # trash poisoning: valid lanes see none of it,
                            # the idle lane stays finite
                            kp2, vp2 = kp.clone(), vp.clone()
                            kp2[0] = 1e3
                            vp2[0] = 1e3
                            out2 = paged_attention(q, kp2, vp2, bt, pos,
                                                   window=window)
                            torch.cuda.synchronize()
                            if not torch.equal(out2[:2], out[:2]) or \
                                    not bool(torch.isfinite(out2).all()):
                                raise AssertionError(
                                    f"trash page leaked into valid lanes: "
                                    f"page {page} Dh {hd} G {group} window "
                                    f"{window} S {s}")
                            errs.append(err.max().item())
                            n += 1
                        worst = max(worst, *errs)
                        log(f"  page {page:2d} Dh {hd:3d} G {group} window "
                            f"{str(window):4s} S {s:2d} | max err " + " ".join(
                                f"{names[qd]}/{names[kd]} {e:.2e}"
                                for (qd, kd), e in zip(dtypes, errs)))
    log(f"paged_attention: {n} cases within rtol=atol=2e-4 "
        f"(max abs err {worst:.3e}); trash-poisoned pools change no valid "
        f"lane")
    return worst


# ---------------------------------------------------------------------------
# phase 4: paged_attention timing at the full-width shapes
# ---------------------------------------------------------------------------


def time_paged_attention(cfg) -> list[dict]:
    """Decode (S=1) and prefill-chunk (S=32) shapes of the qwen3_8b serve
    path: 8 lanes, 288 tokens a lane, page 8, f32 pool, bf16 queries.
    Each call reads another layer's pool (8 layers, 268 MB in all), so
    the 50 MB L2 holds none of it, as in a forward over 36 layers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, page, n_pages, n_layers, tokens = 8, 8, 512, 8, 288
    pmax = tokens // page + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    pool = (n_layers, n_pages, page, kvh, hd)
    kp = torch.randn(pool, generator=gen, device="cuda")
    vp = torch.randn(pool, generator=gen, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((b, pmax), dtype=torch.int32, device="cuda")
    bt[:, :tokens // page] = perm[:b * tokens // page].reshape(
        b, -1).to(torch.int32)
    scale = hd ** -0.5
    rows = []
    for label, s in (("decode", 1), ("prefill_chunk", 32)):
        q = torch.randn((b, s, h, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        pos = (tokens - s + torch.arange(s, device="cuda",
                                         dtype=torch.int32))[None].repeat(b, 1)
        # the kernel against its plain version at this shape first
        out = paged_attention(q, kp[0], vp[0], bt, pos, scale=scale)
        torch.cuda.synchronize()
        ref = paged_attention_ref(q, kp[0], vp[0], bt, pos, scale=scale)
        err = (out - ref).abs()
        if bool((err > PA_TOL["atol"] + PA_TOL["rtol"] * ref.abs()).any()):
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version at the {label} shape: max err "
                                 f"{err.max().item():.3e}")
        ms = cuda_time_ms(lambda i: paged_attention(
            q, kp[i % n_layers], vp[i % n_layers], bt, pos, scale=scale), 50)
        plain_ms = cuda_time_ms(lambda i: paged_attention_ref(
            q, kp[i % n_layers], vp[i % n_layers], bt, pos, scale=scale), 10)
        # library yardstick: SDPA over the pre-gathered view (the gather
        # is not timed; the port never calls this)
        smax = pmax * page
        kall = [kp[li][bt.long()].reshape(b, smax, kvh, hd).transpose(1, 2)
                .contiguous() for li in range(n_layers)]
        vall = [vp[li][bt.long()].reshape(b, smax, kvh, hd).transpose(1, 2)
                .contiguous() for li in range(n_layers)]
        qf = q.float().transpose(1, 2).contiguous()
        t = torch.arange(smax, device="cuda")
        mask = (t[None, None, :] <= pos[:, :, None])[:, None]
        library_ms = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
            qf, kall[i % n_layers], vall[i % n_layers], attn_mask=mask,
            scale=scale, enable_gqa=True), 50)
        # least work these inputs need: each visited K/V row read once
        # (keys 0..max position of the lane), q/tables/positions read
        # once, the f32 context written once; 4*Dh flops per kept key
        # per query head (q.k and p.v)
        keys = int(pos[:, -1].sum().item()) + b
        n_bytes = (2 * keys * kvh * hd * kp.element_size()
                   + q.numel() * q.element_size() + bt.numel() * 4
                   + pos.numel() * 4 + b * s * h * hd * 4)
        flops = 4 * hd * h * int((pos.long() + 1).sum().item())
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        rows.append(dict(
            shape=label, B=b, S=s, tokens_per_lane=tokens,
            max_abs_err=err.max().item(), ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=n_bytes, flops=flops))
        log(f"  {label:13s} B {b} S {s:2d}: max err {err.max().item():.2e} | "
            f"kernel {ms*1e3:8.2f} us | plain "
            f"{plain_ms*1e3:8.2f} us | sdpa {library_ms*1e3:8.2f} us | "
            f"bound {bound_ms*1e3:6.2f} us ({rows[-1]['bound_by']}: "
            f"{n_bytes/1e6:.1f} MB, {flops/1e9:.3f} GFLOP) | "
            f"{bound_ms/ms:.1%} of bound")
    del kp, vp
    return rows


# ---------------------------------------------------------------------------
# phases 5-6: the engine at full width
# ---------------------------------------------------------------------------


def smoke_trace(cfg):
    from repro_torch.serve import TrafficConfig, synth_trace
    return synth_trace(TrafficConfig(
        n_requests=8, arrival_rate=1e9, prompt_len_min=128,
        prompt_len_max=256, gen_len_min=32, gen_len_max=32,
        vocab_size=cfg.vocab_size, seed=0))


def engine_config(attn_impl: str):
    from repro_torch.serve import EngineConfig
    return EngineConfig(page_size=8, n_pages=512, max_batch=8,
                        max_pages_per_seq=37, prefill_chunk=32,
                        attn_impl=attn_impl)


def drain(cfg, model, trace, attn_impl: str) -> dict:
    """Drain `trace` through a fresh engine; launch counts are zeroed
    just before the drain and read just after."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params=model, ecfg=engine_config(attn_impl))
    eng.submit_trace(trace)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    m = eng.metrics()
    results = eng.results()
    n_forwards = eng.backend.n_forwards
    for rid, item in enumerate(trace):
        toks = results[rid]
        if len(toks) != item.max_new_tokens or toks.min() < 0 or \
                toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    if m["n_done"] != len(trace):
        raise AssertionError(f"{m['n_done']} of {len(trace)} requests done")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(results=results, metrics=m, wall_s=wall, counts=counts,
                n_forwards=n_forwards)


def full_width_drain(cfg) -> dict:
    import torch
    from repro_torch.models import transformer
    trace = smoke_trace(cfg)
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in model.parameters())/1e9:.3f} B "
        f"parameters in {model.compute_dtype}, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    # warm-up engine: cuBLAS handles and workspaces, first-launch costs
    drain(cfg, model, trace[:1], "fused")
    torch.cuda.reset_peak_memory_stats()
    run = drain(cfg, model, trace, "fused")
    launches = run["counts"].get("paged_attention", 0)
    want = cfg.n_layers * run["n_forwards"]
    m = run["metrics"]
    tok_s = m["n_generated_tokens"] / run["wall_s"]
    log(f"  drained {m['n_done']} requests, {m['n_generated_tokens']} tokens "
        f"in {run['wall_s']:.3f} s wall ({tok_s:.1f} tok/s; "
        f"{run['n_forwards']} forwards, "
        f"{run['wall_s'] / run['n_forwards'] * 1e3:.2f} ms each); "
        f"{m['n_preemptions']} preemptions; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  paged_attention launches {launches} = {cfg.n_layers} layers x "
        f"{run['n_forwards']} forwards? {launches == want}")
    if launches != want:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"want {want}: the path missed the kernel")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run, tok_s=tok_s, launches=launches)


def identity_drains(cfg) -> None:
    import torch
    from repro_torch.models import transformer
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    trace = smoke_trace(cfg2)
    model = transformer.init(cfg2, seed=0, device="cuda")
    gather = drain(cfg2, model, trace, "gather")
    fused = drain(cfg2, model, trace, "fused")
    if gather["counts"]:
        raise AssertionError(f"gather drain launched {gather['counts']}")
    if fused["counts"].get("paged_attention", 0) != 2 * fused["n_forwards"]:
        raise AssertionError(f"fused drain launches {fused['counts']}")
    same = all((gather["results"][r] == fused["results"][r]).all()
               for r in gather["results"])
    n_tok = sum(len(v) for v in fused["results"].values())
    log(f"  f32, 2 layers of the full width: gather and fused drains "
        f"token-identical over {n_tok} tokens? {same}")
    if not same:
        raise AssertionError("fused drain diverged from the gather drain")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import configs
        from repro_torch.kernels import build
        from repro_torch.kernels.paged_attention import paged_attention
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. card")
    card = card_line()
    log(f"  {card} | capability {torch.cuda.get_device_capability(0)}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise AssertionError("the kernels are built for sm_90a (Hopper)")

    log("== 2. build")
    pa_mod = sys.modules[paged_attention.__module__]
    t0 = time.perf_counter()
    lib = build.build(pa_mod.SOURCE)
    log(f"  {pa_mod.SOURCE.relative_to(ROOT)} -> {lib.relative_to(ROOT)} "
        f"in {time.perf_counter() - t0:.1f} s")
    log(f"  ptxas: {ptxas_summary(lib.with_suffix('.log').read_text())}")

    log("== 3. kernels against their plain versions")
    max_err = check_paged_attention()

    cfg = configs.get_config("qwen3_8b")
    log("== 4. kernel timing at the full-width qwen3_8b shapes")
    timing = time_paged_attention(cfg)

    log("== 5. full-width qwen3_8b drain: bf16, attn_impl=fused")
    full = full_width_drain(cfg)

    log("== 6. f32 token identity: gather vs fused")
    identity_drains(cfg)

    decode = timing[0]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/paged_attention.py:58",
        "launches": full["launches"],
        "max_abs_err": max(max_err, *(r["max_abs_err"] for r in timing)),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shapes": timing,
    }]
    log(json.dumps({"kernels": kernels,
                    "drain": {"tok_s": full["tok_s"],
                              "wall_s": full["wall_s"],
                              "n_forwards": full["n_forwards"]}}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
