#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (`src/repro_torch`) on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

  1. the card: name and power limit (nvidia-smi), capability (9, 0);
  2. build every kernel of the serve path from the checkout's sources
     (nvcc, sm_90a), timed as set-up; the registers and spill stores of
     the tensor-core instances (none may spill);
  3. hold each kernel against its plain PyTorch version on the card
     over a grid of cases, with the tolerance stated per kernel
     (paged_attention through both its instances, rows and tile, on
     every case and every row: ragged row counts, chunks past their
     table and rows that keep no key, a table of 2000 keys;
     flash_attention through its rows instance on every case and its
     tile instance on every case it takes (bf16 q, bf16-valued K/V),
     the static prefill's own shape at batch 2 included; sc_matmul's
     integer dots also at the edges of their tiles, splits and int32
     range, its artemis path at the edges of its K split and windows and
     on operands of -128);
  4. at the full-width qwen3_8b shapes of the serve paths, hold each
     kernel against its plain version once more, then time it beside
     its plain version, its bound and one library call (paged_attention
     at a prefill chunk and flash_attention at the static prefill: also
     the other instance and the f32 bound;
     sc_matmul int8: the ratio to torch._int_mm; artemis_mxu: the ratio
     to int8; artemis: the device time of each of its kernels);
  5. drain the paged-KV engine at the full qwen3_8b width (36 layers,
     bf16, attn_impl="fused") with seeded random weights, with every
     launch count zeroed just before and read just after: each kernel
     of the path must have run, paged_attention once per layer of
     every forward, its tile instance once per layer of every
     prefill-chunk forward and its rows instance for the rest;
  6. the same trace at float32 through 2 layers of the full width,
     once with the gather core and once with the fused kernel: the
     greedy tokens must be identical;
  7. drain the same trace at the full width (bf16, attn_impl="gather")
     under each quantized policy (int8, artemis_mxu, artemis), counts
     zeroed just before each drain and read just after: sc_matmul once
     per dense projection (7 per layer) of every forward, and
     paged_attention never; then profile one prefill-chunk forward and
     one decode forward per policy (device time by group);
  8. drive the static path (`launch.serve --mode static`'s serve()) at
     the full qwen3_8b width: bf16, f32 cache, batch 8, prompt 1024,
     gen 32, exact policy, counts zeroed just before and read just
     after: flash_attention once per layer of every forward (36 x 33),
     its tile instance at the prefill (36) and its rows instance at the
     decodes (36 x 32), paged_attention and sc_matmul never; then
     profile one static prefill forward and one decode forward (device
     time by group);
  9. the static path at float32 through 2 layers of the full width
     with the flash and the gather core: the greedy tokens must be
     identical; then one short int8 static run at the full width,
     sc_matmul once per dense projection and flash_attention never;
 10. the sampler on the card against the same sampler on CPU copies of
     the same (8, 151936) logits over a grid of temperature, top-k,
     top-p, seeds and positions: the lanes' random bits and uniforms
     equal exactly, the tokens equal but for near ties (perturbed
     scores within 1e-5 relative), each printed and counted;
 11. phase 5's drain with half of its requests sampled (temperature
     0.8, top-k 50, top-p 0.9), twice: sampled tokens drawn, the two
     drains token-identical, paged_attention counted as in phase 5;
 12. qwen2_moe_a2_7b at its full width (24 layers, d_model 2048, 16
     heads and KV heads, 60 routed experts padded to 64, top-4, 4
     shared, d_ff 1408): the mixed trace through the engine (bf16, f32
     pool, exact, fused core), paged_attention once per layer of every
     forward, sc_matmul and flash_attention never; then the f32 check
     of phase 6 through 2 layers of its width;
 13. its static path at batch 8, prompt 1024, gen 32: flash_attention
     24 x 33 times (tile 24, rows 24 x 32);
 14. a short int8 drain (4 requests, 8 new tokens): sc_matmul 208 times
     a layer of every forward (4 attention projections and 3 for each
     of the 64 padded and 4 shared experts, each quantized on its own),
     paged_attention never;
 15. the device time by group of one MoE decode forward (routing and
     dispatch, expert products, attention, the rest) beside the bytes
     it must read at the card's memory rate;
 17. rwkv6_3b at its full width (32 layers, d_model 2560, 40 wkv heads
     of 64, d_ff 8960, vocab 65536; bf16, f32 state) through the
     state-slot engine: phase 11's mixed trace on 8 lanes, chunk 32, 9
     slots, every launch count zeroed just before and read just after:
     no kernel runs; then at f32 through 2 layers of the full width,
     each greedy request's engine tokens equal its sequential static
     path;
 18. its static path at batch 8, prompt 1024, gen 32 (no kernel); the
     device time by group of one decode step beside its byte bound;
 19. its int8 drain (4 requests, 4 new tokens): sc_matmul 9 times a
     layer of every single-token apply; the lane check: an int8 decode
     step of 8 live lanes equals, bit for bit, each lane stepped alone
     in the 8-lane step;
 20. zamba2_7b at its full width (81 Mamba2 layers, d_model 3584, 112
     SSD heads, a shared attention block every 6 layers with 32 heads
     of 112, window 4096; bf16, f32 state and ring): the same drain,
     no kernel; then the f32 pin through 7 layers (one shared
     invocation and a 1-layer tail) with `attn_window` 64 and prompts
     of 32-48, so that the ring wraps during decode;
 21. its static path at batch 8, prompt 1024, gen 32: flash_attention
     13 x 33 times, all in its rows instance (D 112); at f32 through 7
     layers, the flash and gather cores token-identical;
 22. the device time by group of one zamba2 decode step beside its byte
     bound, and its int8 lane check;
 23. training at the full qwen3_8b width through 8 of its 36 layers
     (reduced: depth; f32 master weights, gradients and AdamW moments,
     16 B a parameter, do not fit one card at 36): bf16 compute, batch
     8 x seq 128 from `make_batch`, remat, through `make_train_step`: 4
     steps exact, then 2 each under int8, artemis_mxu and artemis on the
     same model; the launch counts zeroed once before the first step and
     each step's launches read around it: sc_matmul 112 a quantized
     step (7 projections a layer forward and 7 in the recompute, x 8)
     and none an exact one, the attention kernels never, the phase's
     totals the sums of its steps'; each policy's first step and the
     median of the rest, tokens/s, the peak device memory and the AdamW
     update's device time beside its byte bound;
 24. a train step's loss and gradients on the card against the CPU's
     (the plain versions), from the same weights, full width through 2
     layers, f32, batch 2 x seq 64: exact within 1e-5 (loss, relative)
     and 1e-4 (each gradient, of its max abs); int8 within 1e-3 and
     0.25 (a last bit flips int8 values, see `TRAIN_PIN_TOL`), and on
     the card the kernel's step bit-equal to the plain version's; then
     `launch.train.train` at the smoke config, 6 steps saving every 3,
     resumed from its step-3 checkpoint: the losses and weights of the
     uninterrupted run, bit for bit;
 16. (last) sc_matmul against its plain version at every shape phases
     7, 9, 14, 19, 22, 23 and 24 gave it; print the kernels line, the
     card line, then the result line.
Each phase's seconds are logged as it ends. Phase 4 also times each
kernel at the qwen2_moe_a2_7b shapes (4b) and flash_attention at
zamba2_7b's static shapes (4c), and phase 3 holds sc_matmul to its
plain version at the expert products' shapes and flash_attention at
D 112, G 1.

Kernels: paged_attention (exact engine path; its rows instance at
decode, its tensor-core tile instance at a prefill chunk), sc_matmul
(the ARTEMIS MAC of the quantized policies) and flash_attention (exact
static path; its bf16 tensor-core tile instance at the prefill, its
rows instance at decode), all CUDA C++ for sm_90a, built in parallel.
sc_matmul is held bit for bit against its plain version, the attention
kernels within 2e-4.

The script imports nothing of `repro` (the JAX package) or of jax.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 tensor cores, dense, f32 sums
TF32_FLOPS_PER_S = 495e12        # tf32 tensor cores, dense, f32 sums
INT8_OPS_PER_S = 1979e12         # int8 tensor cores, dense
# instruction issue of the CUDA cores: 132 SMs x 4 schedulers x 32 lanes
# x 1.98 GHz (the integer ALU pipe and the FMA pipe, where IMAD runs, are
# 64 lanes each)
INSTR_ISSUE_PER_S = 132 * 128 * 1.98e9
# the least integer instructions of sc_matmul's artemis inner loop: per
# pair of products (one k, two columns in 16-bit lanes) one IMAD, one PRMT
# that floors both, one LOP3 that routes the negative ones and one IADD3
# (two k added at once); the kernel issues 2.25, an IMAD for some adds
ARTEMIS_INSTR_PER_PRODUCT = 2

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


def ptxas_instances(text: str) -> list[tuple[str, int, int]]:
    """(mangled name, registers, spill-store bytes) of each kernel
    instance in nvcc's `-Xptxas -v` report."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


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


PA_VARIANTS = ("rows", "tile")       # the kernel's two instances


def _pa_case(gen, *, page, hd, group, window, s, q_dtype, kv_dtype,
             starts=None):
    """Operands of one case: lanes 0 and 1 mid-table (their chunks
    straddle page boundaries; `starts` moves them), lane 2 idle
    (all-trash table, positions 0), lane 3 a chunk that runs past its
    table (padding positions, as a lane's last chunk can), as the engine
    lays them out."""
    import torch
    kvh, b = 2, 4
    h = kvh * group
    starts = starts or [2 * page + 1, page - 1]
    pmax = -(-(max(starts) + s) // page) + 1
    n_pages = 2 * pmax + 2
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    kp = torch.randn((n_pages, page, kvh, hd), generator=gen, device="cuda")
    vp = torch.randn((n_pages, page, kvh, hd), generator=gen, device="cuda")
    bt = torch.zeros((b, pmax), dtype=torch.int32, device="cuda")
    pos = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    lanes = [(0, starts[0]), (1, starts[1]), (3, pmax * page - s // 2)]
    for lane, st in lanes:
        used = min(pmax, -(-(st + s) // page))
        bt[lane, :used] = torch.randint(1, n_pages, (used,), generator=gen,
                                        device="cuda", dtype=torch.int32)
        pos[lane] = st + torch.arange(s, device="cuda", dtype=torch.int32)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), bt, pos)


def _pa_keeps_a_key(pos, table_len, window):
    """(B, S, 1, 1) bool: the query keeps at least one kv position of
    its table. One that keeps none (past its table, with a window) has
    no agreed value in the reference: the Pallas kernel averages V over
    the pages its lane visits, the oracle (and the port's plain version,
    and both instances of the kernel) over the whole table."""
    lo = (pos - (window or pos.max().item() + 1) + 1).clamp(min=0)
    return (lo <= pos.clamp(max=table_len - 1))[:, :, None, None]


def check_paged_attention() -> dict:
    """Each case through both instances (`variant`), against the plain
    version within PA_TOL on every row, those that keep no key
    (`_pa_keeps_a_key`) included. Then the same with the trash page
    poisoned: no valid lane changes, the idle lane stays finite. Returns
    the max abs error per instance."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = dict.fromkeys(PA_VARIANTS, 0.0)
    n = dict.fromkeys(PA_VARIANTS, 0)
    n_blind = 0
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    grid = [dict(page=page, hd=hd, group=group, window=window, s=s)
            for page in (4, 8, 16) for hd in (16, 128) for group in (1, 4)
            for window in (None, 3)
            for s in ((1, 7, 32) if group == 1 else (1, 7, 16, 32, 64))]
    # 2000 keys behind a 32-token chunk: the error stays flat with depth
    grid += [dict(page=16, hd=128, group=4, window=window, s=32,
                  starts=[1968, 1000]) for window in (None, 3)]
    for case in grid:
        errs = {}
        for q_dt, kv_dt in dtypes:
            q, kp, vp, bt, pos = _pa_case(gen, q_dtype=q_dt, kv_dtype=kv_dt,
                                          **case)
            window = case["window"]
            ref = paged_attention_ref(q, kp, vp, bt, pos, window=window)
            keeps = _pa_keeps_a_key(pos, bt.shape[1] * kp.shape[1], window)
            kp2, vp2 = kp.clone(), vp.clone()
            kp2[0] = 1e3
            vp2[0] = 1e3
            for variant in PA_VARIANTS:
                out = paged_attention(q, kp, vp, bt, pos, window=window,
                                      variant=variant)
                torch.cuda.synchronize()
                err = (out - ref).abs()
                bad = err > PA_TOL["atol"] + PA_TOL["rtol"] * ref.abs()
                if not bool(torch.isfinite(out).all()) or bool(bad.any()):
                    raise AssertionError(
                        f"paged_attention ({variant}) disagrees with its "
                        f"plain version: {case} q {q_dt} kv {kv_dt}: max "
                        f"err {err.max().item():.3e}")
                # trash poisoning: valid lanes (0, 1 and 3) see none of
                # it, the idle lane stays finite
                out2 = paged_attention(q, kp2, vp2, bt, pos, window=window,
                                       variant=variant)
                torch.cuda.synchronize()
                valid = [0, 1, 3]
                if not torch.equal(out2[valid], out[valid]) or \
                        not bool(torch.isfinite(out2).all()):
                    raise AssertionError(
                        f"trash page leaked into valid lanes ({variant}): "
                        f"{case}")
                errs[variant, q_dt, kv_dt] = err.max().item()
                worst[variant] = max(worst[variant], errs[variant, q_dt,
                                                          kv_dt])
                n[variant] += 1
            n_blind += int((~keeps).sum().item()) * q.shape[2]
        log(f"  page {case['page']:2d} Dh {case['hd']:3d} G {case['group']} "
            f"window {str(case['window']):4s} S {case['s']:2d}"
            f"{' 2000 keys' if 'starts' in case else ''} | max err " +
            " | ".join(f"{v} " + " ".join(
                f"{names[qd]}/{names[kd]} {errs[v, qd, kd]:.2e}"
                for qd, kd in dtypes) for v in PA_VARIANTS))
    for v in PA_VARIANTS:
        log(f"paged_attention ({v}): {n[v]} cases within rtol=atol=2e-4 "
            f"(max abs err {worst[v]:.3e}); trash-poisoned pools change no "
            f"valid lane")
    log(f"  rows that keep no key (past the table, window 3): {n_blind} "
        f"query-head rows over the cases, held for both instances (the "
        f"plain version's mean of V over the table)")
    return worst


# ---------------------------------------------------------------------------
# phase 4: paged_attention timing at the full-width shapes
# ---------------------------------------------------------------------------


def time_paged_attention(cfg) -> list[dict]:
    """Decode (S=1) and prefill-chunk (S=32) shapes of the qwen3_8b serve
    path: 8 lanes, 288 tokens a lane, page 8, f32 pool, bf16 queries.
    Each call reads another layer's pool (8 layers, 268 MB in all), so
    the 50 MB L2 holds none of it, as in a forward over 36 layers. Each
    shape runs the instance the serve path picks (`kernel_variant`), and
    the other instance is timed beside it: the rows instance is the
    prefill chunk's kernel before the tile instance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.paged_attention import (
        kernel_variant)
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
        variant = kernel_variant(h // kvh, s, hd)
        q = torch.randn((b, s, h, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        pos = (tokens - s + torch.arange(s, device="cuda",
                                         dtype=torch.int32))[None].repeat(b, 1)
        # the kernel against its plain version at this shape first
        reset_launch_counts()
        out = paged_attention(q, kp[0], vp[0], bt, pos, scale=scale)
        torch.cuda.synchronize()
        if launch_counts[f"paged_attention.{variant}"] != 1:
            raise AssertionError(f"the {label} shape did not run the "
                                 f"{variant} instance: {dict(launch_counts)}")
        ref = paged_attention_ref(q, kp[0], vp[0], bt, pos, scale=scale)
        err = (out - ref).abs()
        if bool((err > PA_TOL["atol"] + PA_TOL["rtol"] * ref.abs()).any()):
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version at the {label} shape: max err "
                                 f"{err.max().item():.3e}")
        ms = cuda_time_ms(lambda i: paged_attention(
            q, kp[i % n_layers], vp[i % n_layers], bt, pos, scale=scale), 50)
        other = next(v for v in PA_VARIANTS if v != variant)
        other_ms = cuda_time_ms(lambda i: paged_attention(
            q, kp[i % n_layers], vp[i % n_layers], bt, pos, scale=scale,
            variant=other), 50)
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
        del kall, vall
        # least work these inputs need: each visited K/V row read once
        # (keys 0..max position of the lane), q/tables/positions read
        # once, the f32 context written once; 4*Dh flops per kept key
        # per query head (q.k and p.v), priced at the f32 rate of the
        # CUDA cores and, for the tile instance, at the tf32 tensor
        # cores' rate times its passes: q.k 1 + (q f32) + (pool f32),
        # p.v 2 + (pool f32), each pass a full tf32 product
        keys = int(pos[:, -1].sum().item()) + b
        n_bytes = (2 * keys * kvh * hd * kp.element_size()
                   + q.numel() * q.element_size() + bt.numel() * 4
                   + pos.numel() * 4 + b * s * h * hd * 4)
        flops = 4 * hd * h * int((pos.long() + 1).sum().item())
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_f32 = flops / F32_FLOPS_PER_S * 1e3
        qk_passes = 1 + int(q.dtype == torch.float32) + int(
            kp.dtype == torch.float32)
        pv_passes = 2 + int(kp.dtype == torch.float32)
        t_tf32 = (flops / 2 * (qk_passes + pv_passes) / TF32_FLOPS_PER_S
                  * 1e3)
        t_ops = t_tf32 if variant == "tile" else t_f32
        bound_ms = max(t_bytes, t_ops)
        bound_f32_ms = max(t_bytes, t_f32)
        row = dict(
            shape=label, B=b, S=s, tokens_per_lane=tokens, variant=variant,
            max_abs_err=err.max().item(), ms=ms,
            ms_by_variant={variant: ms, other: other_ms},
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_f32_ms=bound_f32_ms, bytes=n_bytes, flops=flops)
        if variant == "tile":
            row.update(qk_passes=qk_passes, pv_passes=pv_passes)
        rows.append(row)
        log(f"  {label:13s} B {b} S {s:2d} ({variant}): max err "
            f"{err.max().item():.2e} | kernel {ms*1e3:8.2f} us"
            + f" ({other} instance {other_ms*1e3:8.2f} us)"
            + f" | plain {plain_ms*1e3:8.2f} us | sdpa "
            f"{library_ms*1e3:8.2f} us | bound {bound_ms*1e3:6.2f} us "
            f"({row['bound_by']}: {n_bytes/1e6:.1f} MB, {flops/1e9:.3f} "
            f"GFLOP) {bound_ms/ms:.1%} of it | f32 bound "
            f"{bound_f32_ms*1e3:6.2f} us {bound_f32_ms/ms:.1%} of it")
    del kp, vp
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: sc_matmul against its plain version, and its timing
# ---------------------------------------------------------------------------

SC_MODES = ("int8", "artemis_mxu", "artemis")
# qwen3_8b's dense projections as (K, N): wq and wo, wk and wv, w_gate
# and w_up, w_down; M = 8 rows at decode (max_batch 8), 256 at a
# prefill chunk (8 lanes x 32 tokens)
SC_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
SC_ROWS = (("decode", 8), ("prefill_chunk", 256))
# qwen2_moe_a2_7b's products as (K, N): the expert FFN's w_gate and w_up,
# its w_down, and the attention's wq, wk, wv and wo (16 x 128 = 2048 on
# both sides). Each routed expert gets its capacity in rows: 1 at a
# decode of 8 lanes (max(int(1.25 * 8 * 4 / 64), 1)), 20 at a prefill
# chunk of 8 x 32 tokens; the shared experts and the attention take all
# 8 rows of a decode and all 256 of a chunk
MOE_SC_SHAPES = ((2048, 1408), (1408, 2048), (2048, 2048))
MOE_SC_ROWS = (("decode_expert", 1), ("decode_shared", 8),
               ("prefill_expert", 20), ("prefill_shared", 256))
# the policy's defaults, which a call may leave out
SC_DEFAULTS = dict(acc_depth=20, readout_bits=8, rbar=63.5)
# (M, K, N, kwargs) of every call held bit for bit against the plain version
SC_CHECKED: set = set()


def _sc_key(m, k, n, kw) -> tuple:
    return (m, k, n, tuple(sorted(dict(SC_DEFAULTS, **kw).items())))


def _int8(gen, *shape):
    """Uniform int8 in [-127, 127], as quantize gives, on the card."""
    import torch
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)


def _sc_compare(a, b, label, **kw):
    """The kernel against its plain version on the same operands: bit
    equality, else raise with the max abs error."""
    import torch
    from repro_torch.kernels.sc_matmul import (sc_matmul_quantized,
                                               sc_matmul_ref)
    out = sc_matmul_quantized(a, b, **kw)
    torch.cuda.synchronize()
    ref = sc_matmul_ref(a, b, **kw)
    SC_CHECKED.add(_sc_key(*a.shape, b.shape[1], kw))
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"sc_matmul {label} {kw}: {out.shape} "
                             f"{out.dtype} vs plain {ref.shape} {ref.dtype}")
    if not torch.equal(out, ref):
        err = (out.double() - ref.double()).abs().max().item()
        raise AssertionError(
            f"sc_matmul {label} {kw}: not bit-equal to its plain version, "
            f"max abs err {err:.3e} (both are exact integer dots, or the "
            f"same f32 group scan with fused readout products)")
    return out


# the integer dots' edges: M around the 16- and 128-row tiles; K below, at
# and above the mma depth (32) and a 128-deep stage (the split unit), and
# 12288; N off the 128-wide block
SC_DOT_MS = (1, 8, 15, 16, 17, 255, 256, 257)
SC_DOT_KNS = ((31, 45), (32, 16), (33, 130), (127, 200), (128, 128),
              (129, 257), (12288, 136))
# artemis's edges at depth 20: M on both sides of the split at 16 (scratch
# and a scan kernel at or below, the scan in the block above) and of its
# 8- and 32-row tiles; K one group, a window of groups (4 at decode, 8
# above) less and more one group, and 12288 with a ragged last group; N
# below, across and past the 256- and 64-column tiles
SC_ART_MS = (1, 8, 9, 37, 256)
SC_ART_KS = (20, 60, 100, 140, 180, 12288 + 13)
SC_ART_NS = (4, 36, 1028)


def _sc_extreme(gen, m, k, n):
    """Operands whose dots sit near the int32 range: every entry +-127,
    column 0 of B equal to row 0 of A (a dot of k * 127**2) and column 1
    its negation, row 1 of A and column 2 of B all -128 (k * 128**2)."""
    import torch
    def pm127(*shape):
        return torch.where(_int8(gen, *shape) >= 0, 127, -127).to(torch.int8)

    a, b = pm127(m, k), pm127(k, n)
    b[:, 0] = a[0]
    b[:, 1] = -a[0]
    a[1] = -128
    b[:, 2] = -128
    return a, b


def check_sc_matmul() -> int:
    """Ragged shapes in every mode and readout: M in {1, 8, 37, 256}, K
    not a multiple of 20 (nor of 4), N not a multiple of 128 (nor of
    4); then the integer dots' edges (SC_DOT_MS x SC_DOT_KNS) and an
    all-extreme case at K 12288."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dots = [dict(mode="int8"), dict(mode="artemis_mxu"),
            dict(mode="artemis_mxu", rbar=60.25)]
    variants = dots + [dict(mode="artemis", acc_depth=d, readout_bits=r)
                       for d in (20, 16) for r in (8, 4, None)]
    n = 0
    for m in (1, 8, 37, 256):
        for k, nn in ((333, 45), (1000, 130), (61, 258)):
            a, b = _int8(gen, m, k), _int8(gen, k, nn)
            for kw in variants:
                _sc_compare(a, b, f"M {m} K {k} N {nn}", **kw)
                n += 1
        log(f"  M {m:3d}: {3 * len(variants)} cases bit-equal (K x N in "
            f"333x45, 1000x130, 61x258)")
    log(f"sc_matmul: {n} ragged cases bit-equal to the plain version "
        f"(int8, artemis_mxu at rbar 63.5 and 60.25, artemis at depth "
        f"20/16 x readout 8/4/None)")
    n_dot = 0
    for m in SC_DOT_MS:
        for k, nn in SC_DOT_KNS:
            a, b = _int8(gen, m, k), _int8(gen, k, nn)
            for kw in dots:
                _sc_compare(a, b, f"M {m} K {k} N {nn}", **kw)
                n_dot += 1
    a, b = _sc_extreme(gen, 17, 12288, 136)
    for kw in dots:
        out = _sc_compare(a, b, "extreme M 17 K 12288 N 136", **kw)
        n_dot += 1
        if kw["mode"] == "int8" and not (
                out[0, 0].item() == 12288 * 127**2
                and out[0, 1].item() == -12288 * 127**2
                and out[1, 2].item() == 12288 * 128**2):
            raise AssertionError("sc_matmul extreme case: the largest "
                                 "dots are not exact")
    log(f"sc_matmul: {n_dot} integer-dot edge cases bit-equal (M in "
        f"{SC_DOT_MS}, K x N in {SC_DOT_KNS}, int8 and artemis_mxu at "
        f"rbar 63.5 and 60.25; all-extreme operands at K 12288 with dots "
        f"of +-12288 * 127**2 and 12288 * 128**2)")
    return n + n_dot + check_sc_artemis_edges(gen) + check_sc_moe_shapes(gen)


def check_sc_moe_shapes(gen) -> int:
    """qwen2_moe_a2_7b's expert and attention products (MOE_SC_SHAPES:
    K 1408 gives artemis a ragged last group of 8) at the rows they take
    (MOE_SC_ROWS), in every mode; bit-equal to the plain version."""
    n = 0
    for k, nn in MOE_SC_SHAPES:
        for _, m in MOE_SC_ROWS:
            a, b = _int8(gen, m, k), _int8(gen, k, nn)
            for mode in SC_MODES:
                _sc_compare(a, b, f"M {m} K {k} N {nn}", mode=mode)
                n += 1
    log(f"sc_matmul: {n} cases at the qwen2_moe_a2_7b shapes "
        f"bit-equal (K x N in {MOE_SC_SHAPES}, M in "
        f"{tuple(m for _, m in MOE_SC_ROWS)}, every mode)")
    return n


@contextlib.contextmanager
def sc_path_shapes(into: set):
    """Records the (M, K, N, kwargs) of every sc_matmul call made inside
    the block, through the name `core.artemis_matmul` calls; the wrapper
    itself, and its launch count, run as they are."""
    import importlib
    # the module, not the function of that name the package exports
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real = am.sc_matmul_quantized

    def recording(aq, bq, **kw):
        into.add(_sc_key(aq.shape[0], aq.shape[1], bq.shape[1], kw))
        return real(aq, bq, **kw)

    am.sc_matmul_quantized = recording
    try:
        yield into
    finally:
        am.sc_matmul_quantized = real


def check_sc_path_shapes(shapes: set) -> dict:
    """Every sc_matmul shape and setting the main path ran, held against
    the plain version: those phases 3-4 compared are counted, the rest
    compared now on random operands."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    new = sorted(shapes - SC_CHECKED, key=str)
    for m, k, n, kw in new:
        _sc_compare(_int8(gen, m, k), _int8(gen, k, n),
                    f"path shape M {m} K {k} N {n}", **dict(kw))
    log(f"sc_matmul: the main path ran {len(shapes)} shapes and settings; "
        f"{len(shapes) - len(new)} were compared in phases 3-4, {len(new)} "
        f"now, all bit-equal: "
        + ", ".join(f"{dict(kw)['mode']} {m}x{k}x{n}" for m, k, n, kw in new))
    return dict(n_shapes=len(shapes), n_compared_here=len(new))


def check_sc_artemis_edges(gen) -> int:
    """artemis at the edges of its K split (SC_ART_MS x SC_ART_KS x
    SC_ART_NS at depth 20, readout 8 and ideal), at depths 1 and 128,
    and on the all-extreme operands with their row of -128 and column of
    -128 (floor(128 * 128 / 128) = 128 in a product's 8 bits), on both
    sides of the split at M 16; bit-equal to the plain version."""
    variants = [dict(mode="artemis", acc_depth=20, readout_bits=r)
                for r in (8, None)]
    n = 0
    for m in SC_ART_MS:
        for k in SC_ART_KS:
            for nn in SC_ART_NS:
                a, b = _int8(gen, m, k), _int8(gen, k, nn)
                for kw in variants:
                    _sc_compare(a, b, f"M {m} K {k} N {nn}", **kw)
                    n += 1
    for m in (8, 37):
        a, b = _int8(gen, m, 1000), _int8(gen, 1000, 36)
        for kw in (dict(acc_depth=1, readout_bits=8),
                   dict(acc_depth=128, readout_bits=12)):
            _sc_compare(a, b, f"M {m} K 1000 N 36", mode="artemis", **kw)
            n += 1
    n_grid = n
    for m in (8, 17):
        a, b = _sc_extreme(gen, m, 12288, 136)
        for kw in (dict(acc_depth=20, readout_bits=8),
                   dict(acc_depth=20, readout_bits=None),
                   dict(acc_depth=128, readout_bits=None)):
            out = _sc_compare(a, b, f"extreme M {m} K 12288 N 136",
                              mode="artemis", **kw)
            n += 1
            if kw["readout_bits"] is None and \
                    out[1, 2].item() != 12288 * 128:
                raise AssertionError("sc_matmul artemis: a row of -128 "
                                     "against a column of -128 does not "
                                     "give 12288 products of 128")
    log(f"sc_matmul: {n_grid} artemis split-edge cases bit-equal (M in "
        f"{SC_ART_MS}, K in {SC_ART_KS}, N in {SC_ART_NS}, depth 20 at "
        f"readout 8 and ideal; depths 1 and 128), and {n - n_grid} on "
        f"all-extreme operands with -128 rows and columns (M 8 and 17, K "
        f"12288)")
    return n


def _sc_bound(mode, m, k, n):
    """(bound ms, bound_by, bytes, ops): each input read once, the
    output written once; int8 dots at the tensor cores' int8 rate, the
    artemis products at ARTEMIS_INSTR_PER_PRODUCT integer instructions
    each at the CUDA cores' instruction issue rate."""
    n_bytes = m * k + k * n + 4 * m * n
    if mode == "artemis":
        ops = m * k * n * ARTEMIS_INSTR_PER_PRODUCT
        t_ops = ops / INSTR_ISSUE_PER_S * 1e3
    else:
        ops = 2 * m * k * n * (2 if mode == "artemis_mxu" else 1)
        t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, ops)


def _adaptive_ms(fn, budget_s=0.25, most=50):
    """Mean ms of fn(i) by CUDA events after one warm-up call: one timed
    call when it alone takes half of `budget_s`, else as many as fit
    `budget_s` (at most `most`)."""
    once = cuda_time_ms(fn, 1, warmup=1)
    if once * 1e-3 >= budget_s / 2:
        return once
    n_iter = max(2, min(most, int(budget_s / max(once * 1e-3, 1e-6))))
    return cuda_time_ms(fn, n_iter, warmup=0)


def _graph_ms(fn, n_calls=20, replays=5):
    """Mean device ms of fn(i) from a CUDA graph of n_calls calls, which
    replays without the host's launch cost (the wrapper's Python, the
    allocations and the launches themselves)."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # global mode: every launch sets its kernels up at its first call on
    # the device (fn(0) above), so nothing in a captured call may sync
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * n_calls)
    del graph
    return ms


def _kernel_us(fn, n_calls=10) -> dict:
    """Mean device µs per call of each kernel fn(i) launches, by name,
    from a profile of n_calls calls after one warm-up call."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n_calls):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.self_device_time_total > 0:
            found = re.search(r"\w*kernel\w*", evt.key)
            name = found.group(0) if found else evt.key[:40]
            out[name] = out.get(name, 0.0) + evt.self_device_time_total / n_calls
    return out


def time_sc_matmul(shapes=SC_SHAPES, m_rows=SC_ROWS,
                   model="qwen3_8b") -> list[dict]:
    """Each full-width projection shape at decode and prefill-chunk M,
    in every mode: the kernel against its plain version once more (bit
    equality), then kernel (per call, and on the device alone), plain
    and (int8) torch._int_mm times. Each
    call reads another of 4 weight copies (up to 200 MB of int8), so the
    50 MB L2 does not hold the weight, as in a forward over 36 layers."""
    import torch
    from repro_torch.kernels.sc_matmul import (sc_matmul_quantized,
                                               sc_matmul_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    copies = 4
    rows = []
    for k, n in shapes:
        bs = [_int8(gen, k, n) for _ in range(copies)]
        for label, m in m_rows:
            a = _int8(gen, m, k)
            # torch._int_mm takes M > 16: decode rows are zero-padded
            # to 32, and only the first M rows of its result are used
            a_lib = torch.zeros((max(m, 32), k), dtype=torch.int8,
                                device="cuda")
            a_lib[:m] = a
            for mode in SC_MODES:
                out = _sc_compare(a, bs[0], f"{label} K {k} N {n}",
                                  mode=mode)
                ms = _adaptive_ms(lambda i: sc_matmul_quantized(
                    a, bs[i % copies], mode=mode))
                device_ms = _graph_ms(lambda i: sc_matmul_quantized(
                    a, bs[i % copies], mode=mode))
                plain_ms = _adaptive_ms(lambda i: sc_matmul_ref(
                    a, bs[i % copies], mode=mode), budget_s=1.0, most=10)
                library_ms = None
                if mode == "int8":
                    lib = torch._int_mm(a_lib, bs[0])[:m]
                    if not torch.equal(lib, out):
                        raise AssertionError("torch._int_mm disagrees "
                                             "with the int8 kernel")
                    library_ms = _adaptive_ms(lambda i: torch._int_mm(
                        a_lib, bs[i % copies]))
                bound_ms, bound_by, n_bytes, ops = _sc_bound(mode, m, k, n)
                row = dict(model=model, mode=mode, shape=label, M=m, K=k,
                           N=n, max_abs_err=0.0, ms=ms, device_ms=device_ms,
                           plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=n_bytes, ops=ops)
                if mode == "artemis":   # products and (decode) the scan
                    row["kernel_us"] = _kernel_us(lambda i: sc_matmul_quantized(
                        a, bs[i % copies], mode=mode))
                lib_txt = ""
                if library_ms is not None:
                    row["library_ratio"] = ms / library_ms
                    lib_txt = (f" | _int_mm {library_ms*1e3:9.2f} us "
                               f"(ratio {ms / library_ms:.2f})")
                if mode == "artemis_mxu":
                    int8 = rows[-1]   # same shape, int8 first
                    row["over_int8"] = ms / int8["ms"]
                    row["device_over_int8"] = device_ms / int8["device_ms"]
                    lib_txt = (f" | {ms / int8['ms']:.2f}x int8 (device "
                               f"{device_ms / int8['device_ms']:.2f}x)")
                if "kernel_us" in row:
                    lib_txt = " | " + ", ".join(
                        f"{name} {us:.2f} us"
                        for name, us in row["kernel_us"].items())
                rows.append(row)
                log(f"  {mode:11s} {label:13s} M {m:3d} K {k:5d} N {n:5d}:"
                    f" kernel {ms*1e3:9.2f} us (device {device_ms*1e3:8.2f})"
                    f" | plain {plain_ms*1e3:10.2f}"
                    f" us{lib_txt} | bound {bound_ms*1e3:8.2f} us "
                    f"({bound_by}) | {bound_ms/ms:6.1%} of bound")
        del bs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: flash_attention against its plain version, and its timing
# ---------------------------------------------------------------------------

FA_TOL = dict(rtol=2e-4, atol=2e-4)   # f32 sums in another order, over up
#                                        to 1056 keys
# (bq, bk) tiles cycled over the cases; None: the ops wrapper's choice
FA_TILES = (None, (8, 8), (16, 32), (64, 16), (32, 128))
FA_WINDOWS = ((False, None), (True, None), (True, 1), (True, 16),
              (True, 100))


def _fa_errors(out, ref):
    """(max abs err of o and of the finite lse entries, bool tensor: any
    entry outside FA_TOL or nvis unequal), on the device."""
    import torch
    (o, lse, nvis), (ro, rl, rn) = out, ref
    bad = ((o - ro).abs() > FA_TOL["atol"] + FA_TOL["rtol"] * ro.abs()).any()
    bad |= ((lse - rl).abs() > FA_TOL["atol"]
            + FA_TOL["rtol"] * rl.abs()).any()
    bad |= ~torch.isfinite(o).all() | (nvis != rn).any()
    finite = rl.abs() < 1e29              # rows that kept a key
    err = torch.maximum((o - ro).abs().max(),
                        torch.where(finite, (lse - rl).abs(), 0).max())
    return err, bad


FA_VARIANTS = ("rows", "tile")       # the kernel's two instances


def check_flash_attention() -> tuple[dict, dict]:
    """Every combination of Sq in {1, 8, 33, 128, 200}, Sk in {Sq,
    Sq + 40, 1056}, (causal, window) in FA_WINDOWS, kv_len unset or
    set, q_offset in {0, Sk - Sq, mid}, group in {1, 4}, D in {64, 128},
    q in {bf16, f32} and K/V in {f32, bf16}; tiles cycle over FA_TILES,
    every other case reads strided (B, S, H, D) views, and every third
    case with f32 K/V rounds them to bf16 (`kv_cast`). Then the static
    prefill's own shape at batch 2: Sq 1024 over an f32 cache of 1056
    slots read as strided views, kv_len 1024, `kv_cast` bf16, the ops
    wrapper's tiles. Each case through the rows instance, and through
    the tile instance where it takes the case (`tile_takes`); o and lse
    within FA_TOL of the plain version, nvis equal. Returns (max abs
    error, cases) per instance."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_all,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        tile_takes)
    from repro_torch.kernels.flash_attention.ops import effective_tiles
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16
    combos = [(g, d, qd, kd) for g in (1, 4) for d in (64, 128)
              for qd in (bf16, f32) for kd in (f32, bf16)]
    b, hkv = 2, 2
    n = 0
    worst = dict.fromkeys(FA_VARIANTS, 0.0)
    counts = dict.fromkeys(FA_VARIANTS, 0)

    def operand(heads, s, d, dtype, strided):
        if strided:
            x = torch.randn((b, s, heads, d), generator=gen, device="cuda")
            return x.to(dtype).transpose(1, 2)
        return torch.randn((b, heads, s, d), generator=gen,
                           device="cuda").to(dtype)

    def run(q, k, v, kw, label, cases):
        ref = flash_attention_ref(q, k, v, **kw)
        variants = [v_ for v_ in FA_VARIANTS if v_ == "rows" or tile_takes(
            q.dtype, k.dtype, kw["kv_cast"], q.shape[-1])]
        for variant in variants:
            err, bad = _fa_errors(
                flash_attention_all(q, k, v, variant=variant, **kw), ref)
            cases.append((kw | label, variant, err, bad))

    def settle(cases, what):
        torch.cuda.synchronize()
        errs = torch.stack([e for _, _, e, _ in cases]).cpu()
        bads = torch.stack([x for _, _, _, x in cases]).cpu()
        if bool(bads.any()):
            i = int(bads.nonzero()[0, 0])
            raise AssertionError(
                f"flash_attention ({cases[i][1]}) disagrees with its plain "
                f"version: {cases[i][0]}: max err {errs[i].item():.3e} (or "
                f"nvis)")
        line = []
        for variant in FA_VARIANTS:
            mine = [float(e) for (_, v_, _, _), e in zip(cases, errs)
                    if v_ == variant]
            counts[variant] += len(mine)
            worst[variant] = max(worst[variant], *mine, 0.0)
            line.append(f"{variant} {len(mine)} cases (max abs err "
                        f"{max(mine, default=0.0):.2e})")
        log(f"  {what}: " + " | ".join(line) + ", nvis equal")

    for sq in (1, 8, 33, 128, 200):
        cases = []
        for sk in sorted({sq, sq + 40, 1056}):
            for causal, window in FA_WINDOWS:
                for kv_set in (False, True):
                    for q_offset in sorted({0, sk - sq, (sk - sq) // 2}):
                        kv_len = (max(1, min(sk, q_offset + (sq + 1) // 2))
                                  if kv_set else None)
                        for group, d, q_dt, kv_dt in combos:
                            tiles = FA_TILES[n % len(FA_TILES)]
                            bq, bk = tiles or effective_tiles(sq, sk)
                            strided = n % 2 == 1
                            kv_cast = (bf16 if kv_dt == f32 and n % 3 == 0
                                       else None)
                            q = operand(hkv * group, sq, d, q_dt, strided)
                            k = operand(hkv, sk, d, kv_dt, strided)
                            v = operand(hkv, sk, d, kv_dt, strided)
                            kw = dict(causal=causal, window=window,
                                      kv_len=kv_len, q_offset=q_offset,
                                      bq=bq, bk=bk, kv_cast=kv_cast)
                            run(q, k, v, kw, dict(sq=sq, sk=sk, G=group, D=d,
                                                  q=q_dt, kv=kv_dt,
                                                  strided=strided), cases)
                            n += 1
        settle(cases, f"Sq {sq:3d}")
    # zamba2's shared attention: D 112 (not a tile head dim: the rows
    # instance only), G 1, its windows; bf16 q over an f32 ring rounded
    # by kv_cast (the static path) and f32 throughout
    cases = []
    for sq in (1, 8, 33, 128):
        for sk in sorted({sq, sq + 40, 300}):
            for window in (None, 16, 64):
                for q_offset in sorted({0, sk - sq}):
                    for q_dt, kv_dt, kv_cast in ((bf16, f32, bf16),
                                                 (f32, f32, None),
                                                 (bf16, bf16, None)):
                        tiles = FA_TILES[n % len(FA_TILES)]
                        bq, bk = tiles or effective_tiles(sq, sk)
                        strided = n % 2 == 1
                        q = operand(hkv, sq, 112, q_dt, strided)
                        k = operand(hkv, sk, 112, kv_dt, strided)
                        v = operand(hkv, sk, 112, kv_dt, strided)
                        kw = dict(causal=True, window=window, kv_len=None,
                                  q_offset=q_offset, bq=bq, bk=bk,
                                  kv_cast=kv_cast)
                        run(q, k, v, kw, dict(sq=sq, sk=sk, G=1, D=112,
                                              q=q_dt, kv=kv_dt,
                                              strided=strided), cases)
                        n += 1
    settle(cases, "D 112, G 1 (zamba2), windows 16 / 64")
    # the static prefill's shape (qwen3_8b's heads) at batch 2
    hq, hkv_s, d, sq, smax = 32, 8, 128, 1024, 1056
    q = torch.randn((2, sq, hq, d), generator=gen, device="cuda").to(
        bf16).transpose(1, 2)
    k, v = (torch.randn((2, smax, hkv_s, d), generator=gen,
                        device="cuda").transpose(1, 2) for _ in range(2))
    bq, bk = effective_tiles(sq, smax)
    kw = dict(causal=True, window=None, kv_len=sq, q_offset=0, bq=bq, bk=bk,
              kv_cast=bf16, scale=d ** -0.5)
    cases = []
    run(q, k, v, kw, dict(sq=sq, sk=smax, B=2), cases)
    settle(cases, "static prefill, B 2, Sq 1024, Smax 1056, f32 cache")
    del q, k, v
    for variant in FA_VARIANTS:
        log(f"flash_attention ({variant}): {counts[variant]} cases within "
            f"rtol=atol=2e-4 of the plain version, block counts equal (max "
            f"abs err {worst[variant]:.3e})")
    return worst, counts


def _fa_bound(b, hq, hkv, sq, d, kv_rows, pairs, q_bytes, kv_bytes,
              qk_bf16, variant="rows"):
    """(bound ms, bound_by, bytes, flops): q and the kv_rows K/V rows read
    once, o, lse and nvis written once; 2 * D flops of q.k and 2 * D of
    p.v per kept (query head, key) pair.

    "rows" (the f32 bound): q.k of bf16 operands (`qk_bf16`: bf16 q, K
    bf16 or rounded to it) is exact on the bf16 tensor cores with f32
    sums, so it is priced at their rate; p.v multiplies f32
    probabilities and q.k of f32 operands is f32, both priced at the
    CUDA cores' f32 rate. The two units run side by side, so the
    operations take the longer of the two times.

    "tile" (bf16 operands only): q.k in one bf16 tensor-core pass and
    p.v in two (P = hi + lo, V bf16-valued: the same work to f32
    accuracy), all at the bf16 rate."""
    n_bytes = (b * hq * sq * d * q_bytes + 2 * b * kv_rows * hkv * d
               * kv_bytes + b * hq * sq * (d + 2) * 4)
    half = 2 * d * hq * b * pairs
    flops = 2 * half
    if variant == "tile":
        t_ops = 3 * half / BF16_FLOPS_PER_S * 1e3
    elif qk_bf16:
        t_ops = max(half / BF16_FLOPS_PER_S, half / F32_FLOPS_PER_S) * 1e3
    else:
        t_ops = flops / F32_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, flops)


def time_flash_attention(cfg) -> list[dict]:
    """The static path's two shapes at the full qwen3_8b width: B 8, Hq
    32, Hkv 8, D 128, bf16 queries read as (B, S, H, D) views, an f32
    dense cache of Smax 1056 slots read in place as (B, KV, Smax, D)
    views and rounded to bf16 in the kernel (`kv_cast`), as the path
    calls it. Each call reads another of 4 layers' caches (69 MB each),
    so the 50 MB L2 holds none of it. The cache holds bf16 values, as
    the path's does, so the library call (SDPA on f32, GQA, keys sliced
    to kv_len) computes the same function. Each shape runs the instance
    the path picks (`kernel_variant`: rows at decode, tile at the
    prefill), held against the plain version, and the other instance is
    held and timed beside it; the prefill's f32 bound is the rows
    instance's, kept beside the tile instance's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (flash_attention_all,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_variant, tile_takes)
    b, hq, hkv, d = 8, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    smax, n_layers = 1056, 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    shape = (n_layers, b, smax, hkv, d)
    ck = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).float()
    cv = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).float()
    scale = d ** -0.5
    rows = []
    for label, sq, q_offset, kv_len in (("decode", 1, 1040, 1041),
                                        ("prefill", 1024, 0, 1024)):
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

        def kv(i):
            return ck[i % n_layers].transpose(1, 2), \
                cv[i % n_layers].transpose(1, 2)

        kw = dict(causal=True, kv_len=kv_len, q_offset=q_offset,
                  scale=scale, kv_cast=torch.bfloat16)
        variant = kernel_variant(q.dtype, ck.dtype, torch.bfloat16, sq, d)
        # the other instance where it takes the shape (the tile one takes
        # only TILE_HEAD_DIMS)
        other = next((v_ for v_ in FA_VARIANTS if v_ != variant and (
            v_ == "rows" or tile_takes(q.dtype, ck.dtype, torch.bfloat16,
                                       d))), None)
        reset_launch_counts()
        out = flash_attention_all(q, *kv(0), **kw)
        torch.cuda.synchronize()
        if launch_counts[f"flash_attention.{variant}"] != 1:
            raise AssertionError(f"the {label} shape did not run the "
                                 f"{variant} instance: {dict(launch_counts)}")
        ref = flash_attention_ref(q, *kv(0), **kw)
        errs = {}
        runs = [(variant, out)]
        if other:
            runs.append((other, flash_attention_all(q, *kv(0), variant=other,
                                                    **kw)))
        for v_, o_ in runs:
            err, bad = _fa_errors(o_, ref)
            if bool(bad):
                raise AssertionError(f"flash_attention ({v_}) disagrees with "
                                     f"its plain version at the {label} "
                                     f"shape: max err {err.item():.3e}")
            errs[v_] = err.item()
        ms = _adaptive_ms(lambda i: flash_attention_all(q, *kv(i), **kw))
        ms_by_variant = {variant: ms}
        if other:
            ms_by_variant[other] = _adaptive_ms(lambda i: flash_attention_all(
                q, *kv(i), variant=other, **kw))
        plain_ms = _adaptive_ms(lambda i: flash_attention_ref(q, *kv(i),
                                                              **kw),
                                budget_s=1.0, most=10)
        qf = q.float()

        def sdpa(i):
            k, v = kv(i)
            return F.scaled_dot_product_attention(
                qf, k[:, :, :kv_len], v[:, :, :kv_len],
                is_causal=sq > 1, scale=scale, enable_gqa=True)

        lib_err = (sdpa(0) - out[0]).abs().max().item()
        library_ms = _adaptive_ms(sdpa)
        pairs = sum(min(kv_len, r + q_offset + 1) for r in range(sq))
        args = (b, hq, hkv, sq, d, kv_len, pairs, 2, 4)
        bound_ms, bound_by, n_bytes, flops = _fa_bound(
            *args, qk_bf16=True, variant=variant)
        bound_f32_ms = _fa_bound(*args, qk_bf16=True)[0]
        rows.append(dict(shape=label, B=b, Sq=sq, Smax=smax,
                         q_offset=q_offset, kv_len=kv_len, variant=variant,
                         max_abs_err=errs[variant],
                         max_abs_err_by_variant=errs, ms=ms,
                         ms_by_variant=ms_by_variant,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_max_abs_diff=lib_err, bound_ms=bound_ms,
                         bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                         bytes=n_bytes, flops=flops))
        other_note = (f"{other} instance {ms_by_variant[other]*1e3:9.2f} "
                      f"us, max err {errs[other]:.2e}" if other
                      else f"no other instance takes D {d}")
        log(f"  {label:7s} Sq {sq:4d} q_offset {q_offset:4d} kv_len "
            f"{kv_len} ({variant}): max err {errs[variant]:.2e} | kernel "
            f"{ms*1e3:9.2f} us ({other_note}) | plain "
            f"{plain_ms*1e3:10.2f} us | "
            f"sdpa {library_ms*1e3:9.2f} us (max diff {lib_err:.1e}) | "
            f"bound {bound_ms*1e3:8.2f} us ({bound_by}: {n_bytes/1e6:.1f} "
            f"MB, {flops/1e9:.2f} GFLOP) {bound_ms/ms:.1%} of it | f32 "
            f"bound {bound_f32_ms*1e3:8.2f} us {bound_f32_ms/ms:.1%} of it")
    del ck, cv
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 5-6: the engine at full width
# ---------------------------------------------------------------------------


# the sampled lanes of the mixed drains: half of the requests
MIXED = dict(sampled_fraction=0.5, temperature=0.8, top_k=50, top_p=0.9)


def smoke_trace(cfg, **sampling):
    from repro_torch.serve import TrafficConfig, synth_trace
    return synth_trace(TrafficConfig(
        n_requests=8, arrival_rate=1e9, prompt_len_min=128,
        prompt_len_max=256, gen_len_min=32, gen_len_max=32,
        vocab_size=cfg.vocab_size, seed=0, **sampling))


def engine_config(attn_impl: str):
    from repro_torch.serve import EngineConfig
    return EngineConfig(page_size=8, n_pages=512, max_batch=8,
                        max_pages_per_seq=37, prefill_chunk=32,
                        attn_impl=attn_impl)


def drain(cfg, model, trace, attn_impl: str, policy=None,
          ecfg=None) -> dict:
    """Drain `trace` through a fresh engine (exact policy unless
    `policy`; `engine_config(attn_impl)` unless `ecfg`); launch counts
    are zeroed just before the drain and read just after."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params=model,
                      ecfg=ecfg or engine_config(attn_impl),
                      policy=policy or ArithmeticPolicy())
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
    n_prefill_forwards = eng.backend.n_prefill_forwards
    n_applies = getattr(eng.backend, "n_applies", n_forwards)
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
                n_forwards=n_forwards, n_prefill_forwards=n_prefill_forwards,
                n_applies=n_applies)


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
    by_variant = {v: run["counts"].get(f"paged_attention.{v}", 0)
                  for v in PA_VARIANTS}
    want_tile = cfg.n_layers * run["n_prefill_forwards"]
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
    log(f"  of them the tile instance {by_variant['tile']} = "
        f"{cfg.n_layers} layers x {run['n_prefill_forwards']} prefill-chunk "
        f"forwards? {by_variant['tile'] == want_tile}; the rows instance "
        f"{by_variant['rows']}")
    if launches != want:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"want {want}: the path missed the kernel")
    if by_variant["tile"] != want_tile or not want_tile or \
            by_variant["tile"] + by_variant["rows"] != launches:
        raise AssertionError(f"paged_attention instances {by_variant}: want "
                             f"the tile instance {want_tile} times (once per "
                             f"layer of each prefill-chunk forward)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run, tok_s=tok_s, launches=launches,
                launches_by_variant=by_variant)


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
    if fused["counts"].get("paged_attention", 0) != 2 * fused["n_forwards"] \
            or fused["counts"].get("paged_attention.tile", 0) != \
            2 * fused["n_prefill_forwards"]:
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


# ---------------------------------------------------------------------------
# phase 7: the quantized policies at full width
# ---------------------------------------------------------------------------

# the dense projections of a layer, as (K, N) of SC_SHAPES: wq, wk, wv,
# wo, w_gate, w_up, w_down
LAYER_PROJECTIONS = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                     (4096, 12288), (4096, 12288), (12288, 4096))
ARTEMIS_DRAIN_LIMIT_S = 60.0


def short_trace(cfg):
    from repro_torch.serve import TrafficConfig, synth_trace
    return synth_trace(TrafficConfig(
        n_requests=4, arrival_rate=1e9, prompt_len_min=32,
        prompt_len_max=64, gen_len_min=8, gen_len_max=8,
        vocab_size=cfg.vocab_size, seed=0))


def artemis_drain_estimate(cfg, trace, sc_rows, n_forwards) -> float:
    """Seconds of sc_matmul time an artemis drain of `trace` would take,
    from this run's kernel times: every forward of the exact drain
    priced as a decode forward, plus one prefill-chunk forward per 256
    prompt tokens priced as such."""
    ms = {(r["M"], r["K"], r["N"]): r["ms"] for r in sc_rows
          if r["mode"] == "artemis"}
    layer = {m: sum(ms[(m, k, n)] for k, n in LAYER_PROJECTIONS)
             for _, m in SC_ROWS}
    n_prefill = -(-sum(len(it.prompt) for it in trace) // 256)
    return cfg.n_layers * (n_forwards * layer[8]
                           + n_prefill * layer[256]) * 1e-3


def quantized_drains(cfg, sc_rows, n_forwards_exact) -> dict:
    """One full-width bf16 drain per quantized policy, gather core;
    then the profile of one prefill-chunk and one decode forward per
    policy on the same weights."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.models import transformer
    trace = smoke_trace(cfg)
    model = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    drain(cfg, model, trace[:1], "gather",
          ArithmeticPolicy(mode="int8"))              # warm-up
    runs = {}
    for mode in SC_MODES:
        tr, trace_name = trace, "8 requests, prompts 128-256, 32 new tokens"
        if mode == "artemis":
            est = artemis_drain_estimate(cfg, trace, sc_rows,
                                         n_forwards_exact)
            log(f"  artemis: the 8-request drain would spend about "
                f"{est:.1f} s in sc_matmul (from phase 4's kernel times)")
            if est > ARTEMIS_DRAIN_LIMIT_S:
                tr = short_trace(cfg)
                trace_name = "4 requests, prompts 32-64, 8 new tokens"
                log(f"  artemis: over {ARTEMIS_DRAIN_LIMIT_S:.0f} s, so it "
                    f"drains the shorter trace ({trace_name})")
        torch.cuda.reset_peak_memory_stats()
        run = drain(cfg, model, tr, "gather", ArithmeticPolicy(mode=mode))
        launches = run["counts"].get("sc_matmul", 0)
        want = 7 * cfg.n_layers * run["n_forwards"]
        m = run["metrics"]
        tok_s = m["n_generated_tokens"] / run["wall_s"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {mode:11s}: {m['n_done']} requests, "
            f"{m['n_generated_tokens']} tokens in {run['wall_s']:.3f} s "
            f"wall ({tok_s:.2f} tok/s; {run['n_forwards']} forwards, "
            f"{run['wall_s'] / run['n_forwards'] * 1e3:.2f} ms each); "
            f"peak device memory {peak:.2f} GiB; trace: {trace_name}")
        log(f"  {mode:11s}: sc_matmul launches {launches} = 7 x "
            f"{cfg.n_layers} layers x {run['n_forwards']} forwards? "
            f"{launches == want}; paged_attention launches "
            f"{run['counts'].get('paged_attention', 0)}")
        if launches != want:
            raise AssertionError(f"{mode}: sc_matmul launched {launches} "
                                 f"times, want {want}")
        if run["counts"].get("paged_attention", 0):
            raise AssertionError(f"{mode}: the gather drain launched "
                                 f"paged_attention")
        runs[mode] = dict(tok_s=tok_s, wall_s=run["wall_s"],
                          n_forwards=run["n_forwards"], launches=launches,
                          n_tokens=m["n_generated_tokens"],
                          peak_gib=peak, trace=trace_name)
    for mode in SC_MODES:
        runs[mode]["profile"] = profile_forwards(cfg, model, mode)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phases 8-9: the static path (`--mode static`) at full width
# ---------------------------------------------------------------------------


def static_run(cfg, model, *, batch, prompt_len, gen_len, policy_mode="exact",
               attn_impl=None) -> dict:
    """One `serve()` of the static path on `model`, launch counts zeroed
    just before and read just after; the generated tokens checked for
    shape and range."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve
    torch.cuda.synchronize()
    reset_launch_counts()
    out = serve(batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                policy_mode=policy_mode, params=model, device="cuda",
                attn_impl=attn_impl)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    gen = out["generated"]
    if tuple(gen.shape) != (batch, gen_len) or int(gen.min()) < 0 or \
            int(gen.max()) >= cfg.padded_vocab:
        raise AssertionError(f"static run: bad tokens {gen}")
    if out["cache_index"] != prompt_len + gen_len:
        raise AssertionError(f"static run: cache index {out['cache_index']}")
    return dict(out, counts=counts)


def static_drain(cfg) -> dict:
    """Full-width qwen3_8b through `--mode static`'s serve(): bf16, f32
    cache, batch 8, prompt 1024, gen 32, exact policy (flash core)."""
    import torch
    from repro_torch.models import transformer
    model = transformer.init(cfg, seed=0, device="cuda")
    # warm-up: cuBLAS handles and workspaces, first-launch costs
    static_run(cfg, model, batch=8, prompt_len=64, gen_len=2)
    torch.cuda.reset_peak_memory_stats()
    run = static_run(cfg, model, batch=8, prompt_len=1024, gen_len=32)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = run["counts"]
    want = cfg.n_layers * (1 + 32)
    step_ms = run["decode_s"] / 32 * 1e3
    log(f"  prefill {run['prefill_s']*1e3:.2f} ms (8 x 1024 tokens) | decode "
        f"{run['decode_tok_per_s']:.2f} tok/s, {step_ms:.2f} ms per step | "
        f"peak device memory {peak:.2f} GiB")
    by_variant = {v: counts.get(f"flash_attention.{v}", 0)
                  for v in FA_VARIANTS}
    want_by_variant = {"tile": cfg.n_layers, "rows": cfg.n_layers * 32}
    log(f"  launches: flash_attention {counts.get('flash_attention', 0)} = "
        f"{cfg.n_layers} layers x (1 prefill + 32 decode) forwards? "
        f"{counts.get('flash_attention', 0) == want}; tile "
        f"{by_variant['tile']} = {cfg.n_layers} x 1 prefill? "
        f"{by_variant['tile'] == want_by_variant['tile']}; rows "
        f"{by_variant['rows']} = {cfg.n_layers} x 32 decodes? "
        f"{by_variant['rows'] == want_by_variant['rows']}; paged_attention "
        f"{counts.get('paged_attention', 0)}, sc_matmul "
        f"{counts.get('sc_matmul', 0)}")
    if counts.get("flash_attention", 0) != want:
        raise AssertionError(f"flash_attention launched "
                             f"{counts.get('flash_attention', 0)} times, "
                             f"want {want}: the path missed the kernel")
    if by_variant != want_by_variant:
        raise AssertionError(f"flash_attention's instances launched "
                             f"{by_variant}, want {want_by_variant}")
    if counts.get("paged_attention", 0) or counts.get("sc_matmul", 0):
        raise AssertionError(f"the exact static path launched {counts}")
    return dict(model=model, prefill_ms=run["prefill_s"] * 1e3,
                decode_tok_s=run["decode_tok_per_s"], step_ms=step_ms,
                peak_gib=peak, launches=counts["flash_attention"],
                launches_by_variant=by_variant,
                profile=profile_static(cfg, model))


def profile_static(cfg, model) -> dict:
    """Device time by group of one static prefill forward (8 x 1024
    tokens) and one decode forward (8 lanes at index 1024) of the exact
    path: flash_attention (its two instances' kernels, by name), the
    matrix products (the kernels of aten GEMM operators) and the rest."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    b, s = 8, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    tokens = torch.randint(2, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    cache = modellib.init_cache(cfg, b, s + 32, torch.float32, device="cuda")
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    calls = {
        "prefill": lambda: prefill(model, {"tokens": tokens}, cache),
        "decode": lambda: decode(model, tokens[:, :1], dict(cache, index=s)),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for label, fn in calls.items():
        fn()                                              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        total = flash = 0.0
        n_kernels = 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA or \
                    evt.self_device_time_total <= 0:
                continue
            total += evt.self_device_time_total
            n_kernels += evt.count
            if any(k in evt.key for k in FA_KERNEL_NAMES):
                flash += evt.self_device_time_total
        matmul = sum(k.duration for evt in prof.events()
                     if evt.device_type == DeviceType.CPU
                     and evt.name in GEMM_OPS for k in evt.kernels)
        groups = {"flash_attention": flash * 1e-3, "matmul": matmul * 1e-3,
                  "other": (total - flash - matmul) * 1e-3}
        total *= 1e-3
        out[label] = dict(wall_ms=wall_ms, device_ms=total,
                          n_kernels=n_kernels, groups=groups)
        log(f"  profile, static {label:7s} forward: wall {wall_ms:9.2f} ms, "
            f"device {total:9.2f} ms ({total / wall_ms:.1%} busy), "
            f"{n_kernels} kernels | " + " | ".join(
                f"{g} {ms:.2f}" for g, ms in groups.items()))
        if total <= 0 or flash <= 0:
            raise AssertionError("the profiler recorded no flash_attention "
                                 "device time")
    del cache
    return out


def static_checks(cfg, model) -> dict:
    """f32 token identity of the flash and gather cores through 2 layers
    of the full width; one short int8 static run on the full model."""
    import torch
    from repro_torch.models import transformer
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    model2 = transformer.init(cfg2, seed=0, device="cuda")
    runs = {impl: static_run(cfg2, model2, batch=8, prompt_len=256,
                             gen_len=16, attn_impl=impl)
            for impl in ("flash", "gather")}
    # f32 operands: the rows instance at the prefill too
    if runs["flash"]["counts"] != {"flash_attention": 2 * 17,
                                   "flash_attention.rows": 2 * 17}:
        raise AssertionError(f"flash run launches {runs['flash']['counts']}")
    if runs["gather"]["counts"]:
        raise AssertionError(f"gather run launches {runs['gather']['counts']}")
    same = torch.equal(runs["flash"]["generated"], runs["gather"]["generated"])
    log(f"  f32, 2 layers of the full width, batch 8, prompt 256, gen 16: "
        f"flash and gather token-identical over 128 tokens? {same}")
    if not same:
        raise AssertionError("the flash static run diverged from gather")
    del model2, runs
    run = static_run(cfg, model, batch=8, prompt_len=128, gen_len=8,
                     policy_mode="int8")
    counts = run["counts"]
    want = 7 * cfg.n_layers * (1 + 8)
    log(f"  int8, batch 8, prompt 128, gen 8: prefill "
        f"{run['prefill_s']*1e3:.2f} ms, decode {run['decode_tok_per_s']:.2f} "
        f"tok/s | sc_matmul launches {counts.get('sc_matmul', 0)} = 7 x "
        f"{cfg.n_layers} layers x 9 forwards? "
        f"{counts.get('sc_matmul', 0) == want}; flash_attention "
        f"{counts.get('flash_attention', 0)}")
    if counts.get("sc_matmul", 0) != want or counts.get("flash_attention", 0) \
            or counts.get("paged_attention", 0):
        raise AssertionError(f"int8 static run launches {counts}, want "
                             f"sc_matmul {want} and nothing else")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(int8_prefill_ms=run["prefill_s"] * 1e3,
                int8_decode_tok_s=run["decode_tok_per_s"],
                int8_sc_matmul_launches=counts["sc_matmul"])


# ---------------------------------------------------------------------------
# phase 10: the sampler on the card
# ---------------------------------------------------------------------------

SAMPLER_NEAR_TIE = 1e-5     # relative gap of two perturbed scores
# (temperature, top_k, top_p) of the grid; every lane its own seed and
# position, two sets of them
SAMPLER_GRID = [(t, k, p) for t in (0.0, 0.5, 0.8, 1.3)
                for k, p in ((0, 1.0), (50, 0.9), (1000, 0.3), (1, 1.0))]


def check_sampler(cfg) -> dict:
    """The sampler on CUDA against the same sampler on CPU copies of the
    same (8, vocab) logits, over SAMPLER_GRID x 2 sets of per-lane seeds
    and positions: the lanes' random bits and uniforms equal exactly,
    the tokens equal. Two tokens may differ only where their perturbed
    scores, computed on the CPU, lie within SAMPLER_NEAR_TIE relative of
    each other (the two devices' exp and log round their last bits
    apart); each such near tie is printed and counted."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.serve import sampler
    b, v = 8, cfg.vocab_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    logits = (torch.randn((b, v), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    logits_cpu = logits.cpu()
    lane_sets = [(np.asarray([0, 42, 2**32 - 1, 7, 7, 123456, 1, 2],
                             np.uint32),
                  np.asarray([0, 3, 9, 0, 1, 31, 255, 4], np.int32)),
                 (np.arange(8, dtype=np.uint32) * 1000003,
                  np.arange(8, dtype=np.int32) * 17)]
    n_tokens = n_near = n_sampled = 0
    for temp, top_k, top_p in SAMPLER_GRID:
        for seed, pos in lane_sets:
            args = (np.full(b, temp, np.float32), np.full(b, top_k, np.int32),
                    np.full(b, top_p, np.float32), seed, pos)
            keys = sampler.lane_key(torch.from_numpy(seed.astype(np.int64)),
                                    torch.from_numpy(pos.astype(np.int64)))
            for fn in (prng.random_bits, prng.uniform):
                got, want = fn(keys.cuda(), (v,)).cpu(), fn(keys, (v,))
                if not torch.equal(got, want):
                    raise AssertionError(f"sampler: {fn.__name__} differ "
                                         f"between CUDA and the CPU")
            got = sampler.sample_tokens(logits, *args)
            want = sampler.sample_tokens(logits_cpu, *args)
            n_tokens += b
            n_sampled += b if temp > 0 else 0
            for lane in np.flatnonzero(got != want):
                scores = sampler.perturbed_scores(
                    logits_cpu, *sampler.lane_tensors("cpu", *args))[lane]
                s_got, s_want = (float(scores[int(got[lane])]),
                                 float(scores[int(want[lane])]))
                gap = abs(s_got - s_want) / max(abs(s_got), abs(s_want),
                                                1e-30)
                if temp <= 0 or not np.isfinite(gap) or \
                        gap > SAMPLER_NEAR_TIE:
                    raise AssertionError(
                        f"sampler: lane {lane} at (t {temp}, top_k {top_k}, "
                        f"top_p {top_p}) draws {got[lane]} on CUDA and "
                        f"{want[lane]} on the CPU, scores {s_got} and "
                        f"{s_want} (relative gap {gap:.2e})")
                n_near += 1
                log(f"  near tie: lane {lane} (t {temp}, top_k {top_k}, "
                    f"top_p {top_p}): {got[lane]} vs {want[lane]}, relative "
                    f"gap {gap:.2e}")
    t_ms = cuda_time_ms(lambda i: sampler.sample_tokens(
        logits, np.full(b, 0.8, np.float32), np.full(b, 50, np.int32),
        np.full(b, 0.9, np.float32), lane_sets[0][0], lane_sets[0][1]), 10)
    log(f"  {len(SAMPLER_GRID) * len(lane_sets)} configurations x {b} lanes "
        f"of {v} logits ({n_sampled} sampled lanes): bits and uniforms "
        f"equal; tokens equal but for {n_near} near ties | one sampled "
        f"call {t_ms:.2f} ms")
    return dict(n_tokens=n_tokens, n_near_ties=n_near, sample_ms=t_ms)


# ---------------------------------------------------------------------------
# phase 11: a mixed greedy/sampled drain at the full qwen3_8b width
# ---------------------------------------------------------------------------


def check_paged_counts(cfg, run, label) -> dict:
    """paged_attention once per layer of every forward, its tile
    instance once per layer of every prefill-chunk forward; the other
    kernels never."""
    counts = run["counts"]
    launches = counts.get("paged_attention", 0)
    by_variant = {v: counts.get(f"paged_attention.{v}", 0)
                  for v in PA_VARIANTS}
    want = cfg.n_layers * run["n_forwards"]
    want_tile = cfg.n_layers * run["n_prefill_forwards"]
    log(f"  {label}: paged_attention launches {launches} = {cfg.n_layers} "
        f"layers x {run['n_forwards']} forwards? {launches == want}; tile "
        f"{by_variant['tile']} = {cfg.n_layers} x {run['n_prefill_forwards']}"
        f" prefill-chunk forwards? {by_variant['tile'] == want_tile}; rows "
        f"{by_variant['rows']}; sc_matmul {counts.get('sc_matmul', 0)}, "
        f"flash_attention {counts.get('flash_attention', 0)}")
    if launches != want or by_variant["tile"] != want_tile or \
            not want_tile or sum(by_variant.values()) != launches:
        raise AssertionError(f"{label}: paged_attention launches "
                             f"{by_variant}, want {want} of which tile "
                             f"{want_tile}")
    if counts.get("sc_matmul", 0) or counts.get("flash_attention", 0):
        raise AssertionError(f"{label}: the exact engine path launched "
                             f"{counts}")
    return dict(launches=launches, launches_by_variant=by_variant)


def mixed_drain(cfg) -> dict:
    """Phase 5's drain with half of the requests sampled, twice on the
    same weights: sampled tokens are drawn, the two drains give the
    same tokens, and paged_attention runs as in phase 5."""
    import torch
    from repro_torch.models import transformer
    trace = smoke_trace(cfg, **MIXED)
    model = transformer.init(cfg, seed=0, device="cuda")
    drain(cfg, model, trace[:1], "fused")                 # warm-up
    runs = [drain(cfg, model, trace, "fused") for _ in range(2)]
    m = runs[0]["metrics"]
    tok_s = m["n_generated_tokens"] / runs[0]["wall_s"]
    same = all((runs[0]["results"][r] == runs[1]["results"][r]).all()
               for r in runs[0]["results"])
    log(f"  drained {m['n_done']} requests, {m['n_generated_tokens']} tokens "
        f"({m['n_sampled_tokens']} sampled) in {runs[0]['wall_s']:.3f} s "
        f"wall ({tok_s:.1f} tok/s; again {runs[1]['wall_s']:.3f} s); the "
        f"two drains token-identical? {same}")
    if not m["n_sampled_tokens"]:
        raise AssertionError("the mixed drain sampled no token")
    if not same:
        raise AssertionError("two drains of the mixed trace diverged")
    counts = check_paged_counts(cfg, runs[0], "mixed drain")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts, tok_s=tok_s, wall_s=runs[0]["wall_s"],
                n_forwards=runs[0]["n_forwards"],
                n_sampled_tokens=m["n_sampled_tokens"])


# ---------------------------------------------------------------------------
# phases 12-15: qwen2_moe_a2_7b at full width
# ---------------------------------------------------------------------------


def moe_layer_products(cfg) -> int:
    """sc_matmul launches of one MoE layer under a quantized policy: the
    4 attention projections and 3 for each of the padded and shared
    experts' FFNs (each expert quantized on its own)."""
    return 4 + 3 * (cfg.padded_experts + cfg.n_shared_experts)


def moe_drain(cfg, model) -> dict:
    """The mixed trace through the MoE engine at full width, bf16, f32
    pool, exact, fused core; then, at f32 through 2 layers of the full
    width, the gather and fused drains of the same trace must give the
    same tokens."""
    import torch
    from repro_torch.models import transformer
    trace = smoke_trace(cfg, **MIXED)
    drain(cfg, model, trace[:1], "fused")                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    run = drain(cfg, model, trace, "fused")
    m = run["metrics"]
    tok_s = m["n_generated_tokens"] / run["wall_s"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  drained {m['n_done']} requests, {m['n_generated_tokens']} tokens "
        f"({m['n_sampled_tokens']} sampled) in {run['wall_s']:.3f} s wall "
        f"({tok_s:.2f} tok/s; {run['n_forwards']} forwards, "
        f"{run['wall_s'] / run['n_forwards'] * 1e3:.2f} ms each); "
        f"{m['n_preemptions']} preemptions; peak device memory "
        f"{peak:.2f} GiB | {card_line()}")
    if not m["n_sampled_tokens"]:
        raise AssertionError("the MoE drain sampled no token")
    counts = check_paged_counts(cfg, run, "qwen2_moe drain")
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    model2 = transformer.init(cfg2, seed=0, device="cuda")
    gather = drain(cfg2, model2, trace, "gather")
    fused = drain(cfg2, model2, trace, "fused")
    if gather["counts"]:
        raise AssertionError(f"gather drain launched {gather['counts']}")
    check_paged_counts(cfg2, fused, "f32 fused drain")
    same = all((gather["results"][r] == fused["results"][r]).all()
               for r in gather["results"])
    n_tok = sum(len(v) for v in fused["results"].values())
    log(f"  f32, 2 layers of the full width: gather and fused drains "
        f"token-identical over {n_tok} tokens "
        f"({fused['metrics']['n_sampled_tokens']} sampled)? {same}")
    if not same:
        raise AssertionError("the fused MoE drain diverged from gather")
    del model2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts, tok_s=tok_s, wall_s=run["wall_s"],
                n_forwards=run["n_forwards"],
                n_prefill_forwards=run["n_prefill_forwards"],
                n_sampled_tokens=m["n_sampled_tokens"], peak_gib=peak)


def moe_static(cfg, model) -> dict:
    """`--mode static` at batch 8, prompt 1024, gen 32, exact: the flash
    tile instance once per layer at the prefill, its rows instance once
    per layer of every decode."""
    static_run(cfg, model, batch=8, prompt_len=64, gen_len=2)   # warm-up
    run = static_run(cfg, model, batch=8, prompt_len=1024, gen_len=32)
    counts = run["counts"]
    by_variant = {v: counts.get(f"flash_attention.{v}", 0)
                  for v in FA_VARIANTS}
    want = {"tile": cfg.n_layers, "rows": cfg.n_layers * 32}
    step_ms = run["decode_s"] / 32 * 1e3
    log(f"  prefill {run['prefill_s']*1e3:.2f} ms (8 x 1024 tokens) | decode "
        f"{run['decode_tok_per_s']:.2f} tok/s, {step_ms:.2f} ms per step | "
        f"{card_line()}")
    log(f"  launches: flash_attention {counts.get('flash_attention', 0)} = "
        f"{cfg.n_layers} x 33? tile {by_variant['tile']}, rows "
        f"{by_variant['rows']} (want {want}); paged_attention "
        f"{counts.get('paged_attention', 0)}, sc_matmul "
        f"{counts.get('sc_matmul', 0)}")
    if by_variant != want or counts.get("flash_attention", 0) != \
            cfg.n_layers * 33:
        raise AssertionError(f"MoE static run: flash_attention launches "
                             f"{by_variant}, want {want}")
    if counts.get("paged_attention", 0) or counts.get("sc_matmul", 0):
        raise AssertionError(f"the exact static path launched {counts}")
    return dict(prefill_ms=run["prefill_s"] * 1e3,
                decode_tok_s=run["decode_tok_per_s"], step_ms=step_ms,
                launches=counts["flash_attention"],
                launches_by_variant=by_variant)


def moe_int8_drain(cfg, model) -> dict:
    """4 requests, 8 new tokens each, int8, gather core: sc_matmul once
    per product of every layer of every forward (each expert on its
    own), paged_attention never."""
    from repro_torch.core.policy import ArithmeticPolicy
    trace = short_trace(cfg)
    run = drain(cfg, model, trace, "gather", ArithmeticPolicy(mode="int8"))
    per_layer = moe_layer_products(cfg)
    want = per_layer * cfg.n_layers * run["n_forwards"]
    launches = run["counts"].get("sc_matmul", 0)
    m = run["metrics"]
    tok_s = m["n_generated_tokens"] / run["wall_s"]
    log(f"  int8: {m['n_done']} requests, {m['n_generated_tokens']} tokens "
        f"in {run['wall_s']:.3f} s wall ({tok_s:.2f} tok/s; "
        f"{run['n_forwards']} forwards, "
        f"{run['wall_s'] / run['n_forwards'] * 1e3:.2f} ms each) | "
        f"sc_matmul launches {launches} = {per_layer} x {cfg.n_layers} "
        f"layers x {run['n_forwards']} forwards? {launches == want}; "
        f"paged_attention {run['counts'].get('paged_attention', 0)}")
    if launches != want or run["counts"].get("paged_attention", 0) or \
            run["counts"].get("flash_attention", 0):
        raise AssertionError(f"MoE int8 drain launches {run['counts']}, "
                             f"want sc_matmul {want} and nothing else")
    return dict(tok_s=tok_s, wall_s=run["wall_s"],
                n_forwards=run["n_forwards"], launches=launches)


@contextlib.contextmanager
def moe_scopes():
    """Profiler ranges around the MoE layer and its expert products, for
    the profiled forward only."""
    import importlib
    import torch
    moe = importlib.import_module("repro_torch.models.moe")
    saved = [(name, getattr(moe, name)) for name in ("moe_ffn", "expert_ffn")]

    def scoped(fn, label):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    for name, fn in saved:
        setattr(moe, name, scoped(fn, name))
    try:
        yield
    finally:
        for name, fn in saved:
            setattr(moe, name, fn)


def profile_moe_decode(cfg, model) -> dict:
    """Device time by group of one MoE decode forward (8 lanes at
    position 160, exact, fused core, f32 pool): routing and dispatch
    (the MoE layer's kernels outside its expert products), expert
    products (the routed and shared experts' FFNs), attention (the
    paged_attention kernel) and the rest; beside the bytes a decode
    forward must read, the weights (every expert runs, as in the
    reference) and the lanes' keys, at the card's memory rate."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.serve.backend import _paged_steps
    from repro_torch.serve.paged_cache import init_paged_cache
    b, page, pmax, seq = 8, 8, 21, 160
    _, decode = _paged_steps(cfg, ArithmeticPolicy(), "fused")
    kv = init_paged_cache(cfg, b * pmax + 1, page, device="cuda").kv
    bt = (1 + torch.arange(b * pmax, device="cuda", dtype=torch.int32)
          ).reshape(b, pmax)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                           dtype=torch.int32)
    seq_lens = torch.full((b,), seq, dtype=torch.int32, device="cuda")
    full = torch.ones(b, dtype=torch.bool, device="cuda")

    def fn():
        return decode(model, tokens, kv, bt, seq_lens, full)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with moe_scopes(), torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    total = attn = 0.0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type != DeviceType.CUDA or us <= 0 or \
                evt.key in ("moe_ffn", "expert_ffn"):
            continue
        total += us
        if "paged_attention" in evt.key:
            attn += us
    groups = {"routing and dispatch": 0.0, "expert products": 0.0}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        node, scope = evt, None
        while node is not None:
            if node.name == "expert_ffn":
                scope = "expert products"
                break
            if node.name == "moe_ffn":
                scope = scope or "routing and dispatch"
            node = node.cpu_parent
        if scope:
            groups[scope] += sum(k.duration for k in evt.kernels)
    groups["attention"] = attn
    groups["rest"] = total - sum(groups.values())
    groups = {k: v * 1e-3 for k, v in groups.items()}
    total *= 1e-3
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    embed = model.embed.numel() * model.embed.element_size()
    keys = 2 * cfg.n_layers * b * (seq + 1) * cfg.n_kv_heads * \
        cfg.resolved_head_dim * kv["k"].element_size()
    n_bytes = weights - embed + b * model.embed[0].numel() * \
        model.embed.element_size() + keys
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  profile, MoE decode forward: wall {wall_ms:.2f} ms, device "
        f"{total:.2f} ms ({total / wall_ms:.1%} busy) | " + " | ".join(
            f"{g} {ms:.2f}" for g, ms in groups.items())
        + f" | byte bound {bound_ms:.2f} ms ({n_bytes / 1e9:.2f} GB: the "
        f"weights, all {cfg.padded_experts} experts, and the keys) = "
        f"{bound_ms / total:.1%} of the device time | {card_line()}")
    if total <= 0 or groups["expert products"] <= 0 or attn <= 0:
        raise AssertionError(f"the MoE decode profile is missing a group: "
                             f"{groups}")
    del kv
    return dict(wall_ms=wall_ms, device_ms=total, groups=groups,
                bound_ms=bound_ms, bytes=n_bytes)


# ---------------------------------------------------------------------------
# phases 17-22: the recurrent families (rwkv6_3b, zamba2_7b) at full width
# ---------------------------------------------------------------------------

# rwkv6's products through the policy, a layer: td_w1, wr, wk, wv, wg, wo,
# cm_wk, cm_wv and cm_wr
RWKV6_LAYER_PRODUCTS = 9
# the slot engine's max_seq_len: phase 5's longest request (256 + 32) + 1
SLOT_SEQ_LEN = 289


def slot_engine_config(max_seq_len: int = SLOT_SEQ_LEN):
    """8 lanes, chunk 32, 9 state slots (8 and the trash slot), f32
    state and ring."""
    from repro_torch.serve import EngineConfig
    return EngineConfig(max_batch=8, prefill_chunk=32, n_slots=9,
                        max_seq_len=max_seq_len, cache_dtype="float32")


def init_model(cfg):
    import torch
    from repro_torch.models import model as modellib
    t0 = time.perf_counter()
    model = modellib.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in model.parameters())/1e9:.3f} B "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    return model


def free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def no_kernel_ran(counts: dict, label: str) -> None:
    """The exact recurrent paths run none of the three kernels."""
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}, want no kernel")


def sequential_tokens(cfg, model, prompt, n_new: int):
    """Greedy decode of one request alone on the static path: the whole
    prompt in one apply, then one token a step, batch 1, f32 cache (the
    reference's acceptance pin)."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    cache = modellib.init_cache(cfg, 1, len(prompt) + n_new,
                                dtype=torch.float32, device="cuda")
    tokens = torch.from_numpy(np.asarray(prompt)[None]).cuda()
    logits, cache = prefill(model, {"tokens": tokens}, cache)
    out = [steps.greedy_sample(logits)]
    for _ in range(n_new - 1):
        logits, cache = decode(model, out[-1][:, None], cache)
        out.append(steps.greedy_sample(logits))
    return torch.cat(out).cpu().numpy()


def slot_drain(cfg, model) -> dict:
    """Phase 11's mixed trace through the state-slot engine (8 lanes,
    chunk 32, 9 slots; bf16, f32 state), counts zeroed just before the
    drain and read just after: no kernel runs."""
    import torch
    trace = smoke_trace(cfg, **MIXED)
    ecfg = slot_engine_config()
    # warm-up: one short request (a prompt of 256 would be 256 applies)
    drain(cfg, model, [dataclasses.replace(
        trace[0], prompt=trace[0].prompt[:8], max_new_tokens=2)], "gather",
        ecfg=ecfg)
    torch.cuda.reset_peak_memory_stats()
    run = drain(cfg, model, trace, "gather", ecfg=ecfg)
    m = run["metrics"]
    tok_s = m["n_generated_tokens"] / run["wall_s"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  drained {m['n_done']} requests, {m['n_generated_tokens']} tokens "
        f"({m['n_sampled_tokens']} sampled) in {run['wall_s']:.3f} s wall "
        f"({tok_s:.2f} tok/s; {run['n_forwards']} forwards, "
        f"{run['n_prefill_forwards']} of them prefill chunks, "
        f"{run['n_applies']} single-token applies, "
        f"{run['wall_s'] / run['n_applies'] * 1e3:.2f} ms each); peak "
        f"device memory {peak:.2f} GiB | launches {run['counts']} | "
        f"{card_line()}")
    if not m["n_sampled_tokens"]:
        raise AssertionError("the mixed drain sampled no token")
    no_kernel_ran(run["counts"], "the recurrent engine drain")
    return dict(tok_s=tok_s, wall_s=run["wall_s"],
                n_forwards=run["n_forwards"],
                n_prefill_forwards=run["n_prefill_forwards"],
                n_applies=run["n_applies"], peak_gib=peak,
                launches=dict(run["counts"]))


def slot_pin(cfg, trace, max_seq_len: int = SLOT_SEQ_LEN) -> dict:
    """At f32: every request of the greedy `trace` through the engine
    gives the tokens of the sequential static path of that request
    alone."""
    model = init_model(cfg)
    run = drain(cfg, model, trace, "gather",
                ecfg=slot_engine_config(max_seq_len))
    no_kernel_ran(run["counts"], "the f32 engine drain")
    same = [bool((run["results"][rid] == sequential_tokens(
        cfg, model, it.prompt, it.max_new_tokens)).all())
        for rid, it in enumerate(trace)]
    n_tok = sum(len(v) for v in run["results"].values())
    log(f"  f32, {cfg.n_layers} layers of the full width: engine tokens equal "
        f"the sequential static path for {sum(same)} of {len(trace)} "
        f"requests ({n_tok} tokens, prompts "
        f"{min(len(it.prompt) for it in trace)}-"
        f"{max(len(it.prompt) for it in trace)})")
    if not all(same):
        raise AssertionError(f"engine and sequential static path diverged: "
                             f"{same}")
    del model
    free()
    return dict(n_requests=len(trace), n_tokens=n_tok)


def recurrent_static(cfg, model, want_flash: int) -> dict:
    """`--mode static` at batch 8, prompt 1024, gen 32: flash_attention
    `want_flash` times, all in its rows instance (zamba2's D 112 is no
    tile head dim; rwkv6 has no attention), the other kernels never."""
    import torch
    static_run(cfg, model, batch=8, prompt_len=64, gen_len=2)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    run = static_run(cfg, model, batch=8, prompt_len=1024, gen_len=32)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = run["counts"]
    step_ms = run["decode_s"] / 32 * 1e3
    want = {"flash_attention": want_flash,
            "flash_attention.rows": want_flash} if want_flash else {}
    got = {k: v for k, v in counts.items() if v}
    log(f"  prefill {run['prefill_s']*1e3:.2f} ms (8 x 1024 tokens) | decode "
        f"{run['decode_tok_per_s']:.2f} tok/s, {step_ms:.2f} ms per step | "
        f"peak device memory {peak:.2f} GiB | launches {got} (want {want}) "
        f"| {card_line()}")
    if got != want:
        raise AssertionError(f"static run launched {got}, want {want}")
    return dict(prefill_ms=run["prefill_s"] * 1e3,
                decode_tok_s=run["decode_tok_per_s"], step_ms=step_ms,
                peak_gib=peak, launches=counts.get("flash_attention", 0))


def rwkv6_int8(cfg, model) -> dict:
    """4 requests, prompts 16-32, 4 new tokens, int8: sc_matmul 9 times a
    layer of every single-token apply and nothing else; then the lane
    check."""
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.serve import TrafficConfig, synth_trace
    trace = synth_trace(TrafficConfig(
        n_requests=4, arrival_rate=1e9, prompt_len_min=16, prompt_len_max=32,
        gen_len_min=4, gen_len_max=4, vocab_size=cfg.vocab_size, seed=0))
    run = drain(cfg, model, trace, "gather", ArithmeticPolicy(mode="int8"),
                ecfg=slot_engine_config())
    per_apply = RWKV6_LAYER_PRODUCTS * cfg.n_layers
    want = per_apply * run["n_applies"]
    launches = run["counts"].get("sc_matmul", 0)
    m = run["metrics"]
    tok_s = m["n_generated_tokens"] / run["wall_s"]
    log(f"  int8: {m['n_done']} requests, {m['n_generated_tokens']} tokens in "
        f"{run['wall_s']:.3f} s wall ({tok_s:.2f} tok/s; "
        f"{run['n_forwards']} forwards, {run['n_applies']} applies, "
        f"{run['wall_s'] / run['n_applies'] * 1e3:.2f} ms each) | sc_matmul "
        f"launches {launches} = {RWKV6_LAYER_PRODUCTS} x {cfg.n_layers} "
        f"layers x {run['n_applies']} applies? {launches == want}")
    if launches != want or set(k for k, v in run["counts"].items() if v) \
            != {"sc_matmul"}:
        raise AssertionError(f"rwkv6 int8 drain launches {run['counts']}, "
                             f"want sc_matmul {want} and nothing else")
    return dict(tok_s=tok_s, wall_s=run["wall_s"],
                n_forwards=run["n_forwards"], n_applies=run["n_applies"],
                launches=launches, lane_check=lane_check(cfg, model))


def lane_check(cfg, model, prompt_len: int = 16) -> dict:
    """One int8 decode step of 8 live lanes (8 prompts of `prompt_len`
    tokens absorbed first), batched, against the same 8 lanes stepped one at a
    time: each alone in the 8-lane step, the other lanes idle on the
    trash slot, as the engine steps one live lane. The same kernels run
    on the same rows, and each lane's values depend on its own row only
    (its own activation scales), so every lane's logits must equal the
    batched step's bit for bit, and its token with them. Batch-1 steps
    (other GEMM kernels) are printed beside, not held."""
    import numpy as np
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.serve import state_model as sm
    policy = ArithmeticPolicy(mode="int8")
    pool, _ = sm.init_slot_pool(cfg, 9, 64, device="cuda")
    prefill = sm.make_slot_prefill_chunk(cfg, policy)
    decode = sm.make_slot_decode(cfg, policy)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    prompts = torch.randint(2, cfg.vocab_size, (8, prompt_len),
                            generator=gen, device="cuda", dtype=torch.int32)
    tok = torch.randint(2, cfg.vocab_size, (8, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    slots = torch.arange(1, 9, device="cuda")
    prefill(model, prompts, pool, slots, np.full(8, prompt_len),
            np.ones(8, bool))

    def copy():
        return sm.gather_lanes(pool, torch.arange(9, device="cuda"))

    batched = decode(model, tok, copy(), slots)[0].float()
    alone = []
    for i in range(8):
        ids = torch.full_like(slots, sm.TRASH_SLOT)
        ids[i] = slots[i]
        alone.append(decode(model, tok, copy(), ids)[0][i].float())
    alone = torch.stack(alone)
    diff = (batched - alone).abs().max().item()
    same = bool((batched.argmax(-1) == alone.argmax(-1)).all())
    batch1 = torch.cat([decode(model, tok[i:i + 1], copy(),
                               slots[i:i + 1])[0] for i in range(8)]).float()
    diff1 = (batched - batch1).abs().max().item()
    same1 = bool((batched.argmax(-1) == batch1.argmax(-1)).all())
    log(f"  {cfg.name} lane check (int8, 8 live lanes): batched vs each "
        f"lane alone in "
        f"the 8-lane step: logits max abs diff {diff:.3e} (tolerance 0, "
        f"bit-equal), tokens identical? {same} | batch-1 steps (other GEMM "
        f"kernels): max abs diff {diff1:.3e}, tokens identical? {same1}")
    if diff != 0.0 or not same:
        raise AssertionError("a batched slot step differs from its lanes "
                             "stepped one at a time")
    return dict(max_abs_diff=diff, tokens_equal=same,
                batch1_max_abs_diff=diff1, batch1_tokens_equal=same1)


@contextlib.contextmanager
def slot_scopes():
    """Profiler ranges around the recurrences and the slot gather and
    scatter, for the profiled apply only."""
    import importlib
    import torch
    targets = [("repro_torch.models.rwkv6", "_wkv_chunked", "recurrence"),
               ("repro_torch.models.mamba2", "_ssd_chunked", "recurrence"),
               ("repro_torch.serve.state_model", "gather_lanes",
                "slot gather/scatter"),
               ("repro_torch.serve.state_model", "scatter_lanes",
                "slot gather/scatter")]
    saved = []

    def scoped(fn, label):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    for mod_name, name, label in targets:
        mod = importlib.import_module(mod_name)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, scoped(getattr(mod, name), label))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


SLOT_GROUPS = ("recurrence", "slot gather/scatter")


def profile_slot_decode(cfg, model) -> dict:
    """Device time by group of one decode step of the state-slot engine
    (8 live lanes, exact): the recurrence (`_wkv_chunked` or
    `_ssd_chunked`), the slot gather and scatter, the matrix products
    (GEMM operators elsewhere) and the rest; beside the bytes the step
    must move at the card's memory rate: the weights (8 embedding rows)
    read once, the lanes' recurrent state read and written once, and
    zamba2's rings read once."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.serve import state_model as sm
    pool, _ = sm.init_slot_pool(cfg, 9, SLOT_SEQ_LEN, device="cuda")
    decode = sm.make_slot_decode(cfg, ArithmeticPolicy())
    tok = torch.randint(2, cfg.vocab_size, (8, 1), device="cuda",
                        dtype=torch.int32)
    slots = torch.arange(1, 9, device="cuda")

    def fn():
        return decode(model, tok, pool, slots)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with slot_scopes(), torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    n_kernels = 0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type != DeviceType.CUDA or us <= 0 or \
                evt.key in SLOT_GROUPS:
            continue
        total += us
        n_kernels += evt.count
    groups = dict.fromkeys(SLOT_GROUPS + ("products",), 0.0)
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        node = evt
        while node is not None and node.name not in SLOT_GROUPS:
            node = node.cpu_parent
        group = node.name if node is not None else (
            "products" if evt.name in GEMM_OPS else None)
        if group:
            groups[group] += sum(k.duration for k in evt.kernels)
    groups["rest"] = total - sum(groups.values())
    groups = {k: v * 1e-3 for k, v in groups.items()}
    total *= 1e-3
    if total <= 0 or groups["recurrence"] <= 0 or groups["products"] <= 0:
        raise AssertionError(f"the decode profile is missing a group: "
                             f"{groups}")
    lanes = sm.gather_lanes(pool, slots)
    state = sum(t.numel() * t.element_size()
                for path, t, _ in sm.lane_leaves(lanes)
                if path[0] not in ("attn_k", "attn_v"))
    rings = sum(lanes[k].numel() * lanes[k].element_size()
                for k in ("attn_k", "attn_v") if k in lanes)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    embed = model.embed.numel() * model.embed.element_size()
    n_bytes = weights - embed + 8 * model.embed[0].numel() \
        * model.embed.element_size() + 2 * state + rings
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  profile, {cfg.name} decode step (8 lanes): wall {wall_ms:.2f} ms, "
        f"device {total:.2f} ms ({total / wall_ms:.1%} busy, {n_kernels} "
        f"kernels) | " + " | ".join(f"{g} {ms:.2f}"
                                    for g, ms in groups.items())
        + f" | byte bound {bound_ms:.2f} ms ({n_bytes / 1e9:.2f} GB: "
        f"weights {(weights - embed) / 1e9:.2f}, state {state / 1e9:.3f} "
        f"read and written, rings {rings / 1e9:.3f} read) = "
        f"{bound_ms / total:.1%} of the device time | {card_line()}")
    del pool, lanes
    free()
    return dict(wall_ms=wall_ms, device_ms=total, n_kernels=n_kernels,
                groups=groups, bound_ms=bound_ms, bytes=n_bytes)


def zamba2_pin_trace(cfg):
    """4 greedy requests, prompts 32-48, 32 new tokens: with a ring of
    64 the ring wraps during decode while no prompt outruns it."""
    from repro_torch.serve import TrafficConfig, synth_trace
    return synth_trace(TrafficConfig(
        n_requests=4, arrival_rate=1e9, prompt_len_min=32, prompt_len_max=48,
        gen_len_min=32, gen_len_max=32, vocab_size=cfg.vocab_size, seed=0))


def zamba2_static_check(cfg) -> dict:
    """At f32 through 7 layers of the full width (one shared invocation
    and a 1-layer tail): the static path with the flash core and with
    the gather core gives the same tokens."""
    from repro_torch.launch.serve import serve
    model = init_model(cfg)
    runs = {impl: serve(batch=8, prompt_len=256, gen_len=16, params=model,
                        device="cuda", attn_impl=impl)["generated"]
            for impl in (None, "gather")}
    same = bool((runs[None] == runs["gather"]).all())
    log(f"  f32, {cfg.n_layers} layers of the full width, batch 8, prompt "
        f"256, gen 16: flash and gather cores token-identical? {same}")
    if not same:
        raise AssertionError("zamba2's static path: flash and gather "
                             "cores diverged")
    del model
    free()
    return dict(tokens_equal=same)


PROFILE_SCOPES = ("sc_matmul", "quantize", "int_einsum", "quant_einsum",
                  "artemis_matmul")
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul",
            "aten::baddbmm")
SC_KERNEL_NAMES = ("dot_kernel", "artemis_kernel", "artemis_scan_kernel",
                   "mxu_epilogue")
FA_KERNEL_NAMES = ("flash_attention_kernel", "flash_attention_tile_kernel")


@contextlib.contextmanager
def profile_scopes():
    """Wrap the port's quantized-path functions in profiler ranges, for
    the profiled forwards only."""
    import importlib
    import torch
    quant = importlib.import_module("repro_torch.core.quantization")
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    layers = importlib.import_module("repro_torch.models.layers")
    targets = [(quant, "quant_scale", "quantize"),
               (quant, "quantize", "quantize"),
               (am, "sc_matmul_quantized", "sc_matmul"),
               (layers, "_int_einsum", "int_einsum"),
               (layers, "_quant_einsum", "quant_einsum"),
               (layers, "artemis_matmul", "artemis_matmul")]
    saved = []

    def scoped(fn, label):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    for mod, name, label in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, scoped(fn, label))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _op_group(evt) -> str:
    """The group of the kernels an operator launched: its innermost
    enclosing scope of `profile_scopes`, and for the two quantized entry
    points whether it is a matrix product (the straight-through term's
    exact f32 product) or elementwise (casts, dequantize)."""
    node = evt
    while node is not None and node.name not in PROFILE_SCOPES:
        node = node.cpu_parent
    scope = node.name if node is not None else None
    if scope in ("quant_einsum", "artemis_matmul"):
        return "STE exact product" if evt.name in GEMM_OPS \
            else "quantize/cast"
    return {"sc_matmul": "sc_matmul", "quantize": "quantize/cast",
            "int_einsum": "attention int einsum (f64)"}.get(scope, "other")


def device_time_by_group(prof) -> tuple[dict, float]:
    """(ms by group, total ms) of the profiled device kernels. sc_matmul
    counts its kernels by name; the other groups take each operator's
    kernels by `_op_group`; "other" is the rest of the device time. The
    device rows named after a scope are the profiler's spans of those
    ranges on the device timeline, not kernels: they are left out."""
    from torch.autograd import DeviceType
    total = 0.0
    groups = {"sc_matmul": 0.0}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type != DeviceType.CUDA or us <= 0 \
                or evt.key in PROFILE_SCOPES:
            continue
        total += us
        if any(k in evt.key for k in SC_KERNEL_NAMES):
            groups["sc_matmul"] += us
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        group = _op_group(evt)
        if group in ("sc_matmul", "other"):
            continue
        for kern in evt.kernels:
            if not any(k in kern.name for k in SC_KERNEL_NAMES):
                groups[group] = groups.get(group, 0.0) + kern.duration
    groups["other"] = total - sum(groups.values())
    return {k: v * 1e-3 for k, v in groups.items()}, total * 1e-3


def profile_forwards(cfg, model, mode) -> dict:
    """Device time by group of one prefill-chunk forward (8 lanes x 32
    tokens at positions 128-159) and one decode forward (8 lanes at
    position 160) under `mode`, gather core, f32 page pool."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.serve.paged_cache import init_paged_cache
    from repro_torch.serve.paged_model import (make_paged_chunked_prefill,
                                               make_paged_decode)
    pol = ArithmeticPolicy(mode=mode)
    b, page, chunk, pmax = 8, 8, 32, 21
    kv = init_paged_cache(cfg, b * pmax + 1, page, device="cuda").kv
    bt = (1 + torch.arange(b * pmax, device="cuda", dtype=torch.int32)
          ).reshape(b, pmax)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (b, chunk), generator=gen,
                           device="cuda", dtype=torch.int32)
    full = torch.ones(b, dtype=torch.bool, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    steps = {
        "prefill_chunk": (make_paged_chunked_prefill(cfg, pol), (
            tokens, kv, bt, torch.full((b,), 128, **i32),
            torch.full((b,), chunk, **i32), full,
            torch.zeros(b, **i32))),
        "decode": (make_paged_decode(cfg, pol), (
            tokens[:, :1], kv, bt, torch.full((b,), 160, **i32), full)),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for label, (fn, args) in steps.items():
        fn(model, *args)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(model, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile_scopes(), torch.profiler.profile(activities=acts) as p:
            fn(model, *args)
            torch.cuda.synchronize()
        groups, total = device_time_by_group(p)
        out[label] = dict(wall_ms=wall_ms, device_ms=total, groups=groups)
        log(f"  {mode:11s} {label:13s}: wall {wall_ms:9.2f} ms, device "
            f"{total:9.2f} ms ({total / wall_ms:.1%} busy) | " + " | ".join(
                f"{g} {ms:.2f}" for g, ms in sorted(
                    groups.items(), key=lambda kv: -kv[1])))
        if total <= 0:
            raise AssertionError("the profiler recorded no device time")
    del kv
    return out


# ---------------------------------------------------------------------------
# phases 23-24: training (the dense family's train step at full width)
# ---------------------------------------------------------------------------

# 8 of qwen3_8b's 36 layers: f32 weights, gradients and AdamW moments take
# 16 B a parameter, 44.6 GB at 8 layers and about 131 GB at 36
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 128      # the reference trainer's defaults
TRAIN_STEPS = (("exact", 4), ("int8", 2), ("artemis_mxu", 2), ("artemis", 2))
# AdamW reads p, g, m, v and writes p, m, v: 7 f32 words a parameter
ADAMW_BYTES_PER_PARAM = 28
# the card against the CPU: exact within f32 rounding; int8 within what a
# last-bit difference does through the int8 rounding of the activations
# (values at a rounding boundary flip, and the spiky attention of random
# weights carries a flip into every gradient: measured 9.1e-5 and 7.2e-2
# on an H100 with this seed), which a missing straight-through estimator
# (about 1) still fails; the kernel itself is held bit for bit on the card
TRAIN_PIN_TOL = {"exact": dict(loss_rel=1e-5, grad_of_max=1e-4),
                 "int8": dict(loss_rel=1e-3, grad_of_max=0.25)}


@contextlib.contextmanager
def adamw_timer(into: list):
    """The device time (ms, CUDA events) of every `adamw_update` the
    train step makes inside the block, through the name
    `launch.steps` calls; the update itself runs as it is."""
    import torch
    from repro_torch.launch import steps
    real = steps.adamw_update

    def timed(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(*args, **kw)
        end.record()
        end.synchronize()
        into.append(start.elapsed_time(end))
        return out

    steps.adamw_update = timed
    try:
        yield into
    finally:
        steps.adamw_update = real


def train_full_width(cfg) -> dict:
    """Phase 23: one model of `TRAIN_LAYERS` full-width qwen3_8b layers
    (f32 master weights, bf16 compute, remat) trained through
    `make_train_step` on `make_batch` batches, 4 steps exact and 2 under
    each quantized policy. The launch counts are zeroed once, before
    the first step, and each step's launches read as the difference
    around it: sc_matmul 14 a layer of a quantized step (7 projections
    forward, 7 in the recompute), none of an exact one, and the
    attention kernels never; the phase's totals must be the sums."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    from repro_torch.optim import OptimizerConfig, adamw_init
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    n_steps = sum(n for _, n in TRAIN_STEPS)
    # the schedule `launch.train.train` sets for a run of n_steps
    opt_cfg = OptimizerConfig(total_steps=n_steps,
                              warmup_steps=max(n_steps // 20, 5))
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = modellib.init(tcfg, seed=0, device="cuda", train=True)
    opt = adamw_init(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {TRAIN_LAYERS} of {cfg.n_layers} layers (reduced: depth), f32 "
        f"master weights, bf16 compute: {n_params / 1e9:.3f} B parameters; "
        f"weights and AdamW state {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB, drawn in {time.perf_counter() - t0:.1f} s")
    want_sc = 14 * TRAIN_LAYERS
    runs, step, adamw_ms = {}, 0, []
    reset_launch_counts()
    with adamw_timer(adamw_ms):
        for mode, n in TRAIN_STEPS:
            step_fn = steps.make_train_step(tcfg, opt_cfg,
                                            ArithmeticPolicy(mode=mode))
            ms, losses, sc = [], [], 0
            for _ in range(n):
                batch = make_batch(tcfg, dcfg, step, device="cuda")
                before = dict(launch_counts)
                torch.cuda.synchronize()
                t = time.perf_counter()
                model, opt, metrics = step_fn(model, opt, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                delta = {k: v - before.get(k, 0)
                         for k, v in launch_counts.items()}
                want = 0 if mode == "exact" else want_sc
                if delta.get("sc_matmul", 0) != want:
                    raise AssertionError(
                        f"train step {step} ({mode}) launched sc_matmul "
                        f"{delta.get('sc_matmul', 0)} times, want {want}")
                if delta.get("flash_attention", 0) or \
                        delta.get("paged_attention", 0):
                    raise AssertionError(f"train step {step} ({mode}) "
                                         f"launched {delta}")
                if not math.isfinite(loss):
                    raise AssertionError(f"train step {step} ({mode}): "
                                         f"loss {loss}")
                losses.append(loss)
                sc += delta.get("sc_matmul", 0)
                step += 1
            rest = statistics.median(ms[1:] or ms)
            runs[mode] = dict(ms=ms, first_ms=ms[0], median_rest_ms=rest,
                              tok_s=TRAIN_BATCH * TRAIN_SEQ / rest * 1e3,
                              losses=losses, launches=sc,
                              grad_norm=float(metrics["grad_norm"]))
            log(f"  {mode:11s}: steps {[f'{x:.2f}' for x in ms]} ms (first "
                f"{ms[0]:.2f}, median of the rest {rest:.2f}; "
                f"{runs[mode]['tok_s']:.1f} tok/s); losses "
                f"{[round(x, 5) for x in losses]}; sc_matmul launches "
                f"{sc} = {want_sc if mode != 'exact' else 0} x {n} steps")
    counts = dict(launch_counts)
    total_sc = sum(r["launches"] for r in runs.values())
    if counts.get("sc_matmul", 0) != total_sc or \
            counts.get("flash_attention", 0) or \
            counts.get("paged_attention", 0):
        raise AssertionError(f"the phase's launch counts {counts} are not "
                             f"the sum of its steps' (sc_matmul {total_sc})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    bound_ms = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    adamw_med = statistics.median(adamw_ms[1:] or adamw_ms)
    log(f"  AdamW update: median {adamw_med:.2f} ms (first "
        f"{adamw_ms[0]:.2f}) against its byte bound {bound_ms:.2f} ms "
        f"({ADAMW_BYTES_PER_PARAM} B x {n_params / 1e9:.3f} B parameters at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak device memory "
        f"{peak:.2f} GiB")
    del model, opt, metrics
    free()
    return dict(config=f"qwen3_8b full width, {TRAIN_LAYERS} of "
                       f"{cfg.n_layers} layers, f32 master weights, bf16 "
                       f"compute, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
                       f"remat",
                reduced={"n_layers": [cfg.n_layers, TRAIN_LAYERS]},
                n_params=n_params, runs=runs, peak_gib=peak,
                adamw_ms=adamw_med, adamw_ms_all=adamw_ms,
                adamw_bound_ms=bound_ms, launches=total_sc)


@contextlib.contextmanager
def plain_sc_matmul():
    """sc_matmul's plain version in place of the kernel wrapper inside
    the block, through the name `core.artemis_matmul` calls (on CUDA
    tensors too: it is plain PyTorch)."""
    import importlib
    from repro_torch.kernels.sc_matmul import sc_matmul_ref
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real = am.sc_matmul_quantized
    am.sc_matmul_quantized = sc_matmul_ref
    try:
        yield
    finally:
        am.sc_matmul_quantized = real


def _grad_errors(grads, ref) -> list[tuple[float, str]]:
    """(max |g - ref| over max |ref|, name) per leaf, largest first."""
    out = []
    for name, g in ref.items():
        err = float((grads[name].to(g.device) - g).abs().max()
                    / g.abs().max().clamp_min(1e-30))
        out.append((err, name))
    return sorted(out, reverse=True)


def train_pin(cfg) -> dict:
    """Phase 24a: the card against the CPU. One step's loss and
    gradients (`launch.steps.loss_and_grads`, the train step's forward
    and backward) at the full width through 2 layers, f32 compute,
    batch 2 x seq 64, from the same weights, on the card (the kernels)
    and on the CPU (their plain versions), exact and int8, within
    `TRAIN_PIN_TOL`; under int8 also on the card with sc_matmul's plain
    version in place of the kernel, which must give the kernel's step
    bit for bit."""
    import torch
    from repro_torch import bridge
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    pcfg = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    card = modellib.init(pcfg, seed=0, device="cuda", train=True)
    host = bridge.params_from_numpy(bridge.params_to_numpy(card), pcfg,
                                    device="cpu", train=True)
    batch = make_batch(pcfg, DataConfig(seq_len=64, global_batch=2), 0,
                       device="cpu")
    card_batch = {k: v.cuda() for k, v in batch.items()}
    out = {}
    for mode in ("exact", "int8"):
        policy = ArithmeticPolicy(mode=mode)
        t = time.perf_counter()
        loss_c, _, grads_c = steps.loss_and_grads(card, pcfg, card_batch,
                                                  policy)
        loss_c = float(loss_c)
        grads_c = {k: g.clone() for k, g in grads_c.items()}
        card_s = time.perf_counter() - t
        if mode != "exact":
            with plain_sc_matmul():
                loss_p, _, grads_p = steps.loss_and_grads(
                    card, pcfg, card_batch, policy)
            same = float(loss_p) == loss_c and all(
                torch.equal(grads_p[k], g) for k, g in grads_c.items())
            log(f"  {mode:5s}: on the card, the kernel's step against the "
                f"plain version's: bit-equal {same}")
            if not same:
                raise AssertionError(f"{mode}: the train step through "
                                     f"sc_matmul parts from its plain "
                                     f"version on the card")
        t = time.perf_counter()
        loss_h, _, grads_h = steps.loss_and_grads(host, pcfg, batch, policy)
        host_s = time.perf_counter() - t
        rel = abs(loss_c - float(loss_h)) / abs(float(loss_h))
        errs = _grad_errors(grads_c, grads_h)
        log(f"  {mode:5s}: loss card {loss_c:.7f} CPU {float(loss_h):.7f} "
            f"({rel:.2e} relative); the farthest gradients "
            f"{[(n, f'{e:.2e}') for e, n in errs[:6]]}; leaves past "
            f"1e-4: {sum(e > 1e-4 for e, _ in errs)} of {len(errs)}; card "
            f"{card_s:.1f} s, CPU {host_s:.1f} s")
        tol = TRAIN_PIN_TOL[mode]
        if rel > tol["loss_rel"] or errs[0][0] > tol["grad_of_max"]:
            raise AssertionError(f"{mode}: the card's step parts from the "
                                 f"CPU's: loss {rel:.2e}, {errs[0]} ({tol})")
        out[mode] = dict(loss_card=loss_c, loss_cpu=float(loss_h),
                         loss_rel=rel, grad_of_max=errs[0][0],
                         worst_leaf=errs[0][1])
        del grads_c, grads_h
    del card, host
    free()
    return out


def train_resume() -> dict:
    """Phase 24b: `launch.train.train` at the smoke config for 6 steps,
    saving every 3, on the card; then again from a directory that holds
    only its step-3 checkpoint (a job that died after saving it): the
    resumed run's losses and weights equal the uninterrupted run's, bit
    for bit."""
    import torch
    from repro_torch.launch import train as trainlib
    kw = dict(steps=6, save_every=3, log_every=100, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        whole = trainlib.train(ckpt_dir=f"{tmp}/a", **kw)
        shutil.copytree(f"{tmp}/a/step_000000003",
                        f"{tmp}/b/step_000000003")
        resumed = trainlib.train(ckpt_dir=f"{tmp}/b", **kw)
    same = all(torch.equal(p, q) for p, q in zip(
        whole["model"].parameters(), resumed["model"].parameters()))
    log(f"  uninterrupted losses {whole['losses']}; resumed from step 3 "
        f"{resumed['losses']}; weights equal: {same}")
    if resumed["losses"] != whole["losses"][3:] or not same:
        raise AssertionError("the resumed run parts from the "
                             "uninterrupted one")
    return dict(losses=whole["losses"], resumed=resumed["losses"])


class Phases:
    """Logs each phase's title, and when the next one starts (or at
    `mark(None)`) the seconds the last one took, kept by its number."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._title, self._t0 = None, 0.0

    def mark(self, title: str | None) -> None:
        now = time.perf_counter()
        if self._title is not None:
            num = self._title.split(" ", 1)[0].rstrip(".")
            self.seconds[num] = now - self._t0
            log(f"  (phase {num}: {now - self._t0:.1f} s)")
        self._title, self._t0 = title, now
        if title is not None:
            log(f"== {title}")


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
        from repro_torch.kernels.flash_attention import flash_attention_all
        from repro_torch.kernels.paged_attention import paged_attention
        from repro_torch.kernels.sc_matmul import sc_matmul_quantized
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = Phases()

    phases.mark("1. card")
    card = card_line()
    log(f"  {card} | capability {torch.cuda.get_device_capability(0)}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise AssertionError("the kernels are built for sm_90a (Hopper)")

    phases.mark("2. build (one nvcc per source, all started together)")
    sources = [sys.modules[fn.__module__].SOURCE
               for fn in (paged_attention, sc_matmul_quantized,
                          flash_attention_all)]

    def timed_build(src):
        t = time.perf_counter()
        return build.build(src), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed_build, sources))
    for src, (lib, sec) in zip(sources, built):
        log(f"  {src.relative_to(ROOT)} -> {lib.relative_to(ROOT)} "
            f"in {sec:.1f} s")
        report = lib.with_suffix('.log').read_text()
        log(f"  ptxas: {ptxas_summary(report)}")
        for name, regs, spill in ptxas_instances(report):
            if any(k in name for k in ("mma_dot_kernel", "artemis_kernel",
                                       "paged_attention_tile",
                                       "flash_attention_tile")):
                log(f"    {name}: {regs} registers, {spill} bytes spill "
                    f"stores")
                if spill:
                    raise AssertionError(f"{name} spills")

    phases.mark("3. kernels against their plain versions")
    pa_err = check_paged_attention()
    n_sc_cases = check_sc_matmul()
    fa_err, n_fa_cases = check_flash_attention()

    cfg = configs.get_config("qwen3_8b")
    moe_cfg = configs.get_config("qwen2_moe_a2_7b")
    phases.mark("4. kernel timing at the full-width qwen3_8b shapes")
    timing = time_paged_attention(cfg)
    sc_rows = time_sc_matmul()
    fa_rows = time_flash_attention(cfg)
    phases.mark("4b. kernel timing at the full-width qwen2_moe_a2_7b "
                "shapes (G = 1, Hq = Hkv = 16; the expert products)")
    moe_rows = {"paged_attention": time_paged_attention(moe_cfg),
                "sc_matmul": time_sc_matmul(MOE_SC_SHAPES, MOE_SC_ROWS,
                                            "qwen2_moe_a2_7b"),
                "flash_attention": time_flash_attention(moe_cfg)}
    for rows in (moe_rows["paged_attention"], moe_rows["flash_attention"]):
        for row in rows:
            row["model"] = "qwen2_moe_a2_7b"
    zamba_cfg = configs.get_config("zamba2_7b")
    phases.mark("4c. flash_attention timing at the full-width zamba2_7b "
                "static shapes (G = 1, Hq = Hkv = 32, D 112: rows)")
    zamba_fa_rows = time_flash_attention(zamba_cfg)
    for row in zamba_fa_rows:
        row["model"] = "zamba2_7b"

    phases.mark("5. full-width qwen3_8b drain: bf16, attn_impl=fused")
    full = full_width_drain(cfg)

    phases.mark("6. f32 token identity: gather vs fused")
    identity_drains(cfg)

    phases.mark("7. full-width qwen3_8b drains under the quantized "
                "policies: bf16, attn_impl=gather")
    path_sc = set()
    with sc_path_shapes(path_sc):
        quant = quantized_drains(cfg, sc_rows, full["n_forwards"])

    phases.mark("8. full-width qwen3_8b static path: bf16, f32 cache, "
                "batch 8, prompt 1024, gen 32, exact (flash)")
    static = static_drain(cfg)

    phases.mark("9. static path: f32 token identity (flash vs gather), "
                "int8 run")
    with sc_path_shapes(path_sc):
        static.update(static_checks(cfg, static.pop("model")))
    gc.collect()
    torch.cuda.empty_cache()

    phases.mark("10. the sampler on the card: CUDA against the CPU, (8, "
                "151936) logits")
    samp = check_sampler(cfg)

    phases.mark("11. full-width qwen3_8b mixed drain: half the requests "
                "sampled (t 0.8, top-k 50, top-p 0.9), bf16, "
                "attn_impl=fused, twice")
    mixed = mixed_drain(cfg)

    phases.mark("12. full-width qwen2_moe_a2_7b drain: bf16, f32 pool, "
                "exact, attn_impl=fused, half the requests sampled")
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    moe_model = transformer.init(moe_cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in moe_model.parameters())/1e9:.3f}"
        f" B parameters ({moe_cfg.padded_experts} experts stored), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    moe = moe_drain(moe_cfg, moe_model)
    phases.mark("13. full-width qwen2_moe_a2_7b static path: batch 8, "
                "prompt 1024, gen 32, exact (flash)")
    moe.update(static=moe_static(moe_cfg, moe_model))
    phases.mark("14. full-width qwen2_moe_a2_7b int8 drain: 4 requests, 8 "
                "new tokens, attn_impl=gather")
    with sc_path_shapes(path_sc):
        moe.update(int8=moe_int8_drain(moe_cfg, moe_model))
    phases.mark("15. profile of one qwen2_moe_a2_7b decode forward (exact, "
                "fused)")
    moe.update(profile=profile_moe_decode(moe_cfg, moe_model))
    del moe_model
    gc.collect()
    torch.cuda.empty_cache()

    phases.mark("17. full-width rwkv6_3b engine drain: bf16, f32 state, 8 "
                "lanes, chunk 32, 9 slots, half the requests sampled; the "
                "f32 pin through 2 layers")
    rw_cfg = configs.get_config("rwkv6_3b")
    rw_model = init_model(rw_cfg)
    rwkv = dict(drain=slot_drain(rw_cfg, rw_model))
    rw2 = dataclasses.replace(rw_cfg, n_layers=2, compute_dtype="float32")
    rwkv.update(pin=slot_pin(rw2, smoke_trace(rw2)))
    phases.mark("18. full-width rwkv6_3b static path: batch 8, prompt 1024, "
                "gen 32, exact; profile of one decode step")
    rwkv.update(static=recurrent_static(rw_cfg, rw_model, 0),
                profile=profile_slot_decode(rw_cfg, rw_model))
    phases.mark("19. full-width rwkv6_3b int8 drain (4 requests, 4 new "
                "tokens) and the lane check")
    with sc_path_shapes(path_sc):
        rwkv.update(int8=rwkv6_int8(rw_cfg, rw_model))
    del rw_model
    free()

    phases.mark("20. full-width zamba2_7b engine drain: bf16, f32 state and "
                "ring, 8 lanes, chunk 32, 9 slots, half the requests "
                "sampled; the f32 pin through 7 layers, attn_window 64")
    zb_model = init_model(zamba_cfg)
    zamba = dict(drain=slot_drain(zamba_cfg, zb_model))
    zb7 = dataclasses.replace(zamba_cfg, n_layers=7, attn_window=64,
                              compute_dtype="float32")
    zamba.update(pin=slot_pin(zb7, zamba2_pin_trace(zb7)))
    phases.mark("21. full-width zamba2_7b static path: batch 8, prompt "
                "1024, gen 32, exact (flash rows); f32 flash vs gather "
                "through 7 layers")
    n_inv = zamba_cfg.n_layers // zamba_cfg.shared_attn_period
    zamba.update(static=recurrent_static(zamba_cfg, zb_model, n_inv * 33),
                 static_f32=zamba2_static_check(dataclasses.replace(
                     zamba_cfg, n_layers=7, compute_dtype="float32")))
    phases.mark("22. profile of one zamba2_7b decode step; its int8 lane "
                "check (prompts of 4 tokens)")
    zamba.update(profile=profile_slot_decode(zamba_cfg, zb_model))
    with sc_path_shapes(path_sc):
        zamba.update(lane_check=lane_check(zamba_cfg, zb_model, 4))
    del zb_model
    free()

    phases.mark("23. full-width qwen3_8b training: 8 of 36 layers, f32 "
                "master weights, bf16 compute, batch 8 x seq 128, remat; 4 "
                "steps exact, 2 each int8, artemis_mxu, artemis")
    with sc_path_shapes(path_sc):
        train = train_full_width(cfg)
    phases.mark("24. training pins: a step on the card against the CPU (2 "
                "layers, f32, exact and int8); train() resumed from a "
                "checkpoint on the card")
    with sc_path_shapes(path_sc):
        train.update(pin=train_pin(cfg))
    train.update(resume=train_resume())
    phases.mark("16. sc_matmul at every shape the main path gave it")
    sc_path = check_sc_path_shapes(path_sc)
    phases.mark(None)

    decode = timing[0]
    # sc_matmul's headline row: int8 at the decode shape of w_gate/w_up,
    # the one with a library call; every mode and shape is in "shapes"
    head = next(r for r in sc_rows if r["mode"] == "int8"
                and r["M"] == 8 and (r["K"], r["N"]) == (4096, 12288))
    pa_paths = {"qwen3_8b engine": full["launches"],
                "qwen3_8b mixed engine": mixed["launches"],
                "qwen2_moe_a2_7b engine": moe["launches"]}
    sc_paths = {**{f"qwen3_8b {k} engine": q["launches"]
                   for k, q in quant.items()},
                "qwen2_moe_a2_7b int8 engine": moe["int8"]["launches"],
                "rwkv6_3b int8 engine": rwkv["int8"]["launches"],
                **{f"qwen3_8b train {k}": r["launches"]
                   for k, r in train["runs"].items() if k != "exact"}}
    fa_paths = {"qwen3_8b static": static["launches"],
                "qwen2_moe_a2_7b static": moe["static"]["launches"],
                "zamba2_7b static": zamba["static"]["launches"]}
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/paged_attention.py:58",
        "launches": sum(pa_paths.values()),
        "launches_by_path": pa_paths,
        "launches_by_variant": full["launches_by_variant"],
        "max_abs_err": max(*pa_err.values(), *(
            r["max_abs_err"] for r in timing + moe_rows["paged_attention"])),
        "max_abs_err_by_variant": pa_err,
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shapes": timing + moe_rows["paged_attention"],
    }, {
        "name": "sc_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/sc_matmul/csrc/sc_matmul.cu",
        "replaces": "src/repro/kernels/sc_matmul/sc_matmul.py:49",
        "launches": sum(sc_paths.values()),
        "launches_by_path": sc_paths,
        "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "launches_by_mode": {k: q["launches"] for k, q in quant.items()},
        "cases_bit_equal": n_sc_cases + len(sc_rows)
        + len(moe_rows["sc_matmul"]) + sc_path["n_compared_here"],
        "path_shapes": sc_path,
        "shapes": sc_rows + moe_rows["sc_matmul"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:48",
        "launches": sum(fa_paths.values()),
        "launches_by_path": fa_paths,
        "launches_by_variant": static["launches_by_variant"],
        "max_abs_err": max(*fa_err.values(),
                           *(e for r in fa_rows + moe_rows["flash_attention"]
                             + zamba_fa_rows
                             for e in r["max_abs_err_by_variant"].values())),
        "max_abs_err_by_variant": {v: max(fa_err[v], *(
            r["max_abs_err_by_variant"][v] for r in fa_rows))
            for v in FA_VARIANTS},
        "ms": fa_rows[0]["ms"], "plain_ms": fa_rows[0]["plain_ms"],
        "bound_ms": fa_rows[0]["bound_ms"],
        "bound_by": fa_rows[0]["bound_by"],
        "library_ms": fa_rows[0]["library_ms"],
        "cases_within_tol": {
            v: n_fa_cases[v] + len(fa_rows) + len(moe_rows["flash_attention"])
            + sum(v in r["max_abs_err_by_variant"] for r in zamba_fa_rows)
            for v in FA_VARIANTS},
        "shapes": fa_rows + moe_rows["flash_attention"] + zamba_fa_rows,
    }]
    log(json.dumps({"kernels": kernels,
                    "drain": {"tok_s": full["tok_s"],
                              "wall_s": full["wall_s"],
                              "n_forwards": full["n_forwards"]},
                    "quantized_drains": quant,
                    "static": static, "sampler": samp,
                    "mixed_drain": mixed, "qwen2_moe_a2_7b": moe,
                    "rwkv6_3b": rwkv, "zamba2_7b": zamba,
                    "train": train, "phase_s": phases.seconds}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
