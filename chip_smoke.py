#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (`src/repro_torch`) on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

  1. the card: name and power limit (nvidia-smi), capability (9, 0);
  2. build every kernel of the serve path from the checkout's sources
     (nvcc, sm_90a), timed as set-up; the registers and spill stores of
     the tensor-core instances, of the rows instances' split path and
     merge kernels, of artemis's instances (its tile path above decode
     and that path's level scan included) and of sc_quantize (none may
     spill); each C entry's
     launch argument block (`*_launch_args_bytes()`: both attention
     kernels, sc_matmul and sc_quantize) against its wrapper's ctypes
     mirror;
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
     on operands of -128, above decode at the edges of its thread tiles,
     windows and K split, at depths 1, 20 and 128 and readouts 7, 8, 12,
     15, 17, 24 and ideal (`check_sc_artemis_tiles`); sc_quantize, the int8 quantization in front of
     sc_matmul, bit for bit (int8 and scale) at the qwen3_8b and
     qwen2_moe_a2_7b weights and activations per tensor, per row, per
     lane and with a given absmax, per column, and on ties, zeros, a NaN
     and an inf (`check_sc_quantize`); both attention kernels also at phase 36's
     head dims and groups: Dh 256 at G 8 and Dh 128 at G 5, 6 and 7
     through both instances (paged's tile instance at the parts its
     plan gives, `tile_plan`, and at one part where that is more than
     one); the rows instance's
     split path, which takes every decode step, at SPLIT_GEOMETRIES
     over 2000-key tables and caches, forced to 1 and 2 parts and at
     the plan's count, with idle lanes and rows that keep no key);
  4. at the full-width qwen3_8b shapes of the serve paths, hold each
     kernel against its plain version once more, then time it beside
     its plain version, its bound and one library call (paged_attention
     at a prefill chunk and flash_attention at the static prefill: also
     the other instance and the f32 bound; at a decode step the split
     path on the device alone (a CUDA graph) beside the library call's
     and the other instance's, and the walk of many rows it replaced,
     and a graph's replay of the call against the eager call, bit for
     bit; at the decode steps and paged_attention's prefill chunks the
     host µs a call of the kernel and of the library call: perf_counter
     around 50 back-to-back calls, a synchronize before and none
     inside, the median of 5 such runs);
     sc_matmul int8: the ratio to torch._int_mm, with B row-major and
     column-major (cuBLASLt's layout); artemis_mxu: the ratio to int8;
     artemis: the device time of each of its kernels, and its time at
     M 1024 beside M 8 and 256; at decode and expert rows its host µs a
     call; sc_quantize at the weights and
     activations, per call, on the device and its host µs, beside its
     plain version and byte bound; an sc_matmul call (artemis at M 8,
     with scratch) and an sc_quantize call replayed from a CUDA graph,
     bit-equal to the eager calls);
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
     per dense projection (7 per layer) of every forward, sc_quantize
     twice that (one an operand; every quantized path below is held to
     the same, `hold_quantize`), and
     paged_attention never; then profile one prefill-chunk forward and
     one decode forward under int8 and artemis (device time by group;
     artemis_mxu's forwards are int8's but for its sc_matmul);
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
     13 x 33 times (tile 13 at the prefill, rows 13 x 32 at the decodes,
     as `kernel_variant` gives them at D 112); at f32 through 7
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
     0.25 (a last bit flips int8 values, see `TRAIN_PIN_TOL`; zamba2
     0.5), every int8 activation of the step's first 2 products that
     the card and the CPU quantize apart within 1e-3 of a rounding tie,
     and on the card the kernel's step bit-equal to the plain version's; then
     `launch.train.train` at the smoke config, 6 steps saving every 3,
     resumed from its step-3 checkpoint: the losses and weights of the
     uninterrupted run, bit for bit;
 25. the rest of the ARTEMIS arithmetic and the paper's scripts, card
     against CPU: `benchmarks/torch_table5_calibration.py` (MUL and ACC
     rows equal, A_to_B and Softmax MAE within 1e-6 with the values that
     differ counted, the noise-calibrated ACC row within 1e-4 of the
     CPU's and of the reference's 0.00859); `prng.normal` over 2**20
     draws within 2 ulps; `artemis_softmax` at qwen3_8b's decode score
     shape (8 x 32 x 1 x 1040) and `lut_activation("silu")` at 8 x
     12288, at most 0.1 % of values apart, each by one stored LUT
     level (values that differ counted); a noisy
     `artemis` product at 8 x 4096 x 12288 (Table V's sigma) within one
     readout level at ties, with no sc_matmul launch, while the
     noiseless product on the same operands launches it once;
     `benchmarks/torch_kernel_micro.py` (every row held within 2e-4,
     µs per call); the three `examples/torch_*.py` walkthroughs, counts
     zeroed before each and read after: quickstart's artemis_mxu forward
     runs sc_matmul (counts zeroed just before that forward), its shapes
     recorded for phase 16; serve_batched runs flash_attention and
     serve_engine paged_attention, every one of those calls held against
     the plain version on the same inputs within 2e-4;
 26. musicgen_large at its full width (48 layers, d_model 2048, 32
     heads of 64 and as many KV heads, d_ff 8192, 4 codebooks; bf16, its
     embedding table f32) through the static path: batch 8, prompt 1024
     frames x 4 codebooks, gen 32, exact, counts zeroed just before and
     read just after: flash_attention 48 x 33 times (tile 48, rows 48 x
     32), paged_attention and sc_matmul never, generated (8, 32, 4); at
     f32 through 2 layers the flash and gather cores token-identical; a
     short int8 run, sc_matmul 6 times a layer of every forward (4
     attention projections, 2 FFN: no GLU), flash_attention never;
 27. the same for internvl2_1b (24 layers, d_model 896, 14 heads over 2
     KV heads of 64, d_ff 4864, tied vocab 151680): its 256-token image
     prefix before a 1024-token prompt, flash_attention 24 x 33 times,
     the cache index 1312 at the end, sc_matmul 7 times a layer of an
     int8 forward;
 28. training of both at full width and depth through `make_train_step`
     (batch 8 x seq 128 from `make_batch`, internvl's with its prefix,
     remat, f32 master weights, bf16 compute): 3 steps exact and 2 int8,
     sc_matmul 12 x 48 (musicgen) and 14 x 24 (internvl) times an int8
     step (forward and recompute) and never an exact one; ms a step,
     tok/s, peak GiB; then phase 24's card-against-CPU step through 2
     layers at f32;
 29. the same for rwkv6_3b (all 32 layers: 2 x 9 x 32 = 576 sc_matmul
     launches an int8 step) and zamba2_7b (27 of its 81 layers, reduced:
     depth, 16 B a parameter does not fit one card at 81: 4 shared
     invocations and the 3-layer tail; 2 x 2 x 27 Mamba2 products,
     forward and recompute, and 7 x 4 of the shared block, which is not
     recomputed: 136); the card against the CPU through 2 (rwkv6) and 7
     layers (zamba2: one shared invocation and a 1-layer tail);
 30. tensor-parallel serving (`EngineConfig(mesh_shards=2)`, the
     sharded paged backend) over 2 ranks spawned by `launch.mesh.spawn`
     that share the one card over gloo (NCCL refuses two ranks on one
     device; CUDA tensors staged through pinned host memory), each
     drawing its part of the seeded weights leaf by leaf: full-width
     qwen3_8b (8 KV heads, 4 a rank) drains workload 1 exact (tok/s,
     wall, each rank's peak GiB) and a short int8 trace (4 requests, 8
     new tokens) whose tokens must equal the single-device int8
     drain's, run just before in this process, or part only at a
     printed near tie (the single-device logits' top-2 margin below
     1e-3 of their scale); each rank's sc_matmul launches 7 x 36 x its
     forwards, its shapes recorded for phase 16; every rank's tokens
     equal;
 31. through 2 layers at f32, qwen3_8b (heads split) and gemma_2b (one
     KV head: the dataflow cores, ring prefill and split-KV decode)
     over 2 ranks token-identical to one device's drain of workload 1;
     `ring_attention` and `split_kv_attention` at qwen3_8b's prefill
     chunk and decode shapes within 1e-5 of one device's f32
     attention, over the 2 ranks and in a one-rank NCCL group; a short
     exact drain of full-width gemma_2b (18 layers) over 2 ranks;
 32. full-width qwen2_moe_a2_7b over 2 ranks (32 of its 64 padded
     experts and 2 of 4 shared a rank): a short exact drain; through 2
     layers at f32, token-identical to one device's drain;
 33. the sharded train step (`make_train_step(mesh=, rules=)`) over 2
     ranks sharing the card over gloo: (a) full-width qwen3_8b through
     2 layers at f32, batch 8 x 64, at (data 2) and (model 2), exact
     and int8, each rank's gradient blocks and the metrics held against
     one card's step on the same weights and batch (`TRAIN_PIN_TOL`),
     sc_matmul 7 x 2 x 2 a rank an int8 step; (b) qwen2_moe_a2_7b at
     (data 2) through 2 layers at f32, its ranks agreeing; (c)
     full-width qwen3_8b through 2 layers, f32 master weights and bf16
     compute, batch 8 x 128, at (data 2): 2 exact and 2 int8 steps, ms a
     step, tok/s, each rank's peak GiB, sc_matmul 7 x 2 x 2 a rank an
     int8 step and none an exact one (counts zeroed just before each
     step); (d) `compressed_psum` in each mode on the card against the
     same call on CPU copies, bit for bit; the phase's seconds;
 35. tensor parallelism for every family, run by phase 33's ranks after
     its jobs (2 ranks sharing the card over gloo, the same groups):
     rwkv6_3b (2 layers), zamba2_7b (7: one shared invocation and a
     tail layer), musicgen_large, internvl2_1b and qwen3_8b (2 each) at
     full width (reduced: depth, ranks), each rank its part of the
     seeded weights and a cache of its part: (a) a (model 2) f32
     prefill and 2 greedy decode steps (batch 2, prompt 64; zamba2's 80
     over a window of 64, so the ring wraps; internvl's after its
     256-token prefix), every logits row and cache leaf within
     TP_STEP_TOL of one card's same steps on the rank's part; (b) the
     same at bf16 under int8, tokens equal to one card's (or parting
     only at a printed near tie), sc_matmul once a policy product of
     every forward a rank; (c) exact bf16, flash_attention once an
     attention layer of every forward a rank; (d) each family's (model
     2) f32 train step (8 x 64) against one card's (`TRAIN_PIN_TOL`),
     as phase 33a; each family's seconds;
 36. the shipped configurations no earlier phase ran, at full width:
     gemma_2b (18 layers; MQA at Dh 256, vocab 256000), qwen3_14b (40;
     G 5), deepseek_coder_33b (62; G 7, 62 GiB of weights) at full depth
     and dbrx_132b through 8 of its 40 layers (reduced: depth; G 6, 16
     experts, top-4): the dense configs' f32 identities through 2 layers
     (fused vs gather drains, flash vs gather static runs, token-
     identical); then an exact fused drain of 8 half-sampled requests
     (prompts 64-128, 8 new tokens; paged_attention once a layer of every
     forward, its tile instance at the prefill-chunk forwards), an
     exact static run (batch 4,
     prompt 512, gen 8; flash once a layer of every forward, in the
     instance `kernel_variant` gives), and int8: a static run of the
     dense configs (batch 2, prompt 32, gen 2; sc_matmul 7 a layer of
     every forward; gemma_2b under artemis too), a drain of dbrx_132b
     (sc_matmul 4 + 3 x 16 a layer: each expert quantized on its own),
     counts zeroed just before each run and read just after; the page
     pool and the static batch sized from the memory free after the
     weights load; tok/s, ms a forward, weights and peak GiB; the phase's
     seconds against 150;
 16. (last) sc_matmul against its plain version at every shape phases
     7, 9, 14, 19, 22, 23, 24, 25, 26-29, 30, 33, 35 and 36 gave it, and
     sc_quantize at every shape, dtype and grouping they gave it;
     print the kernels line, the card line, then the result line.
Each phase's seconds are logged as it ends. Phase 4 also times each
kernel at the qwen2_moe_a2_7b shapes (4b), flash_attention at
zamba2_7b's static shapes (4c) and at musicgen_large's and
internvl2_1b's (4d: D 64, G 1 and G 7), both attention kernels at
gemma_2b's, qwen3_14b's and deepseek_coder_33b's decode and
prefill-chunk or prefill shapes (4e: the prefill shapes in the tile
instance beside the rows walk and SDPA; each beside the bound its
wrapper declares to `roofline/count.py` under HW_H100), and phase 3 holds
sc_matmul to its plain version at the expert products' shapes and
flash_attention at D 112, G 1 and at D 64, G 1 and G 7 (Sq 1280 = 256 +
1024, 1100, 8 and 1 over 1312 cache slots).

The ranks of phases 30-32 run this script's `mesh_rank` (phases 33 and
35's `shard_rank`), which the spawned processes import by name; a
failing rank fails the phase and the script.

Kernels: paged_attention (exact engine path; its rows instance at
decode, its tensor-core tile instance at a prefill chunk), sc_matmul
(the ARTEMIS MAC of the quantized policies) and sc_quantize (their
operands' int8 quantization, in sc_matmul's library) and flash_attention (exact
static path; its bf16 tensor-core tile instance at the prefill, its
rows instance at decode), all CUDA C++ for sm_90a, built in parallel.
sc_matmul and sc_quantize are held bit for bit against their plain
versions, the attention kernels within 2e-4.

The script imports nothing of `repro` (the JAX package) or of jax.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
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

# phase 34's static path: batch, prompt and generated tokens (phase 8's)
STATIC_ROOF = (8, 1024, 32)

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
# (head dim, group) of the attention of phase 36's configurations that no
# earlier phase ran: gemma_2b (256, 8), qwen3_14b (128, 5), dbrx_132b
# (128, 6), deepseek_coder_33b (128, 7)
NEW_ATTN_GEOMETRIES = ((256, 8), (128, 5), (128, 6), (128, 7))


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
    """Each case through each instance that takes it (`variant`; the
    tile one takes Dh in TILE_HEAD_DIMS), against the plain
    version within PA_TOL on every row, those that keep no key
    (`_pa_keeps_a_key`) included. Then the same with the trash page
    poisoned: no valid lane changes, the idle lane stays finite. The
    tile instance runs at the parts its plan gives (`tile_plan`: these
    small grids split each block's walk) and, where that is more than
    one, at one part too. Returns the max abs error per instance."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.paged_attention import (
        TILE_HEAD_DIMS, tile_plan)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = dict.fromkeys(PA_VARIANTS, 0.0)
    n = dict.fromkeys(PA_VARIANTS, 0)
    n_blind = 0
    plans = set()
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
    # the groups and head dims of phase 36's configurations: gemma_2b's
    # Dh 256 at G 8, qwen3_14b's G 5,
    # dbrx_132b's G 6 and deepseek_coder_33b's G 7 at Dh 128
    grid += [dict(page=8, hd=hd, group=group, window=window, s=s)
             for hd, group in NEW_ATTN_GEOMETRIES for window in (None, 3)
             for s in (1, 32)]
    for case in grid:
        errs = {}
        variants = [v for v in PA_VARIANTS
                    if v == "rows" or case["hd"] in TILE_HEAD_DIMS]
        for q_dt, kv_dt in dtypes:
            q, kp, vp, bt, pos = _pa_case(gen, q_dtype=q_dt, kv_dtype=kv_dt,
                                          **case)
            window = case["window"]
            ref = paged_attention_ref(q, kp, vp, bt, pos, window=window)
            keeps = _pa_keeps_a_key(pos, bt.shape[1] * kp.shape[1], window)
            kp2, vp2 = kp.clone(), vp.clone()
            kp2[0] = 1e3
            vp2[0] = 1e3
            parts = tile_plan(q.shape[0], kp.shape[2],
                              q.shape[2] // kp.shape[2] * q.shape[1],
                              bt.shape[1] * kp.shape[1])
            runs = [(v, None) for v in variants]
            if "tile" in variants and parts > 1:
                plans.add(parts)
                runs.append(("tile", 1))          # one block walks it all
            for variant, tile_parts in runs:
                out = paged_attention(q, kp, vp, bt, pos, window=window,
                                      variant=variant, tile_parts=tile_parts)
                torch.cuda.synchronize()
                err = (out - ref).abs()
                bad = err > PA_TOL["atol"] + PA_TOL["rtol"] * ref.abs()
                if not bool(torch.isfinite(out).all()) or bool(bad.any()):
                    raise AssertionError(
                        f"paged_attention ({variant}, tile_parts "
                        f"{tile_parts}) disagrees with its plain version: "
                        f"{case} q {q_dt} kv {kv_dt}: max err "
                        f"{err.max().item():.3e}")
                errs[variant, q_dt, kv_dt] = max(
                    errs.get((variant, q_dt, kv_dt), 0.0), err.max().item())
                worst[variant] = max(worst[variant], errs[variant, q_dt,
                                                          kv_dt])
                n[variant] += 1
                if tile_parts:
                    continue
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
            n_blind += int((~keeps).sum().item()) * q.shape[2]
        log(f"  page {case['page']:2d} Dh {case['hd']:3d} G {case['group']} "
            f"window {str(case['window']):4s} S {case['s']:2d}"
            f"{' 2000 keys' if 'starts' in case else ''} | max err " +
            " | ".join(f"{v} " + " ".join(
                f"{names[qd]}/{names[kd]} {errs[v, qd, kd]:.2e}"
                for qd, kd in dtypes) for v in variants))
    for v in PA_VARIANTS:
        log(f"paged_attention ({v}): {n[v]} cases within rtol=atol=2e-4 "
            f"(max abs err {worst[v]:.3e}); trash-poisoned pools change no "
            f"valid lane")
    log(f"  the tile instance's plan split the walk into {sorted(plans)} "
        f"parts over the cases; each of those also held at one part")
    log(f"  rows that keep no key (past the table, window 3): {n_blind} "
        f"query-head rows over the cases, held for both instances (the "
        f"plain version's mean of V over the table)")
    return worst


# (head dim, group) of the decode steps the rows instance's split path
# takes: qwen2_moe_a2_7b and zamba2_7b's G 1 (zamba2 at D 112), qwen3_8b's
# G 4, qwen3_14b's G 5, deepseek_coder_33b's and internvl2_1b's G 7 (the
# latter at D 64), gemma_2b's G 8 at Dh 256
SPLIT_GEOMETRIES = ((128, 1), (128, 4), (128, 5), (128, 7), (256, 8),
                    (112, 1), (64, 7))
# forced part counts beside the plan's own (None)
SPLIT_COUNTS = (1, 2, None)


def _pa_split_case(gen, *, hd, group, window, q_dtype, kv_dtype):
    """A decode step over long tables: lane 0 at position 1999 of a table
    of 2000 keys (page 16), lane 1 at 37, lane 2 idle (all-trash table,
    position 0), lane 3 past its table by the window (it keeps no key
    with one, every key of its table without). With B 4 and KV 2 the
    plan cuts each lane's keys into many parts, most of lane 1's and 2's
    empty."""
    import torch
    kvh, b, page = 2, 4, 16
    pmax = 2000 // page
    n_pages = 2 * pmax + 2
    h = kvh * group
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda")
    kp = torch.randn((n_pages, page, kvh, hd), generator=gen, device="cuda")
    vp = torch.randn((n_pages, page, kvh, hd), generator=gen, device="cuda")
    bt = torch.zeros((b, pmax), dtype=torch.int32, device="cuda")
    for lane, used in ((0, pmax), (1, 3), (3, pmax)):
        bt[lane, :used] = torch.randint(1, n_pages, (used,), generator=gen,
                                        device="cuda", dtype=torch.int32)
    pos = torch.tensor([[1999], [37], [0], [pmax * page - 1 + (window or 1)]],
                       dtype=torch.int32, device="cuda")
    return q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), bt, pos


def check_paged_split() -> dict:
    """The rows instance's split path (`splits`) against the plain
    version within PA_TOL on every row, at each of SPLIT_GEOMETRIES, f32
    and bf16 pools, window None and 3, over 2000-key tables with an idle
    lane and a lane whose row keeps no key (`_pa_split_case`), forced to
    1 and 2 parts and at the plan's count; comparisons stay on the device
    until the end. Returns the max abs error and the number of calls."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.paged_attention import (
        split_plan)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    errs, bads, plans = [], [], set()
    for hd, group in SPLIT_GEOMETRIES:
        for q_dt, kv_dt in ((f32, f32), (bf16, f32), (bf16, bf16)):
            for window in (None, 3):
                q, kp, vp, bt, pos = _pa_split_case(
                    gen, hd=hd, group=group, window=window, q_dtype=q_dt,
                    kv_dtype=kv_dt)
                ref = paged_attention_ref(q, kp, vp, bt, pos, window=window)
                plans.add(split_plan(4, 2, group, hd, bt.shape[1] * 16))
                for splits in SPLIT_COUNTS:
                    out = paged_attention(q, kp, vp, bt, pos, window=window,
                                          variant="rows", splits=splits)
                    err = (out - ref).abs()
                    errs.append(err.max())
                    bads.append((err > PA_TOL["atol"] + PA_TOL["rtol"]
                                 * ref.abs()).any() | ~torch.isfinite(
                                     out).all())
    torch.cuda.synchronize()
    bads = torch.stack(bads).cpu()
    if bool(bads.any()):
        i = int(bads.nonzero()[0, 0])
        raise AssertionError(f"paged_attention's split path disagrees with "
                             f"its plain version: call {i} of "
                             f"SPLIT_GEOMETRIES x dtypes x windows x "
                             f"{SPLIT_COUNTS}")
    worst = float(torch.stack(errs).max())
    log(f"paged_attention (rows, split path): {len(errs)} calls at (Dh, G) "
        f"{SPLIT_GEOMETRIES}, splits {SPLIT_COUNTS} (the plan's: "
        f"{sorted(plans)}), 2000-key tables, an idle lane and a row that "
        f"keeps no key, within rtol=atol=2e-4 (max abs err {worst:.3e})")
    return dict(max_abs_err=worst, calls=len(errs))


# ---------------------------------------------------------------------------
# phase 4: paged_attention timing at the full-width shapes
# ---------------------------------------------------------------------------


def time_paged_attention(cfg) -> list[dict]:
    """Decode (S=1) and prefill-chunk (S=32) shapes of the config's serve
    path (qwen3_8b's phase 5): 8 lanes, 288 tokens a lane, page 8, f32
    pool, bf16 queries. Each call reads another layer's pool (at least 8
    layers, and enough that the rows the calls visit fill twice the 50
    MB L2: qwen3_8b 8 of 33.6 MB), so the L2 holds none of it, as in a
    forward over all layers. Each shape runs the instance the serve path
    picks (`kernel_variant`), and the other instance, where it takes the
    head dim, is timed beside it: the rows instance is the prefill
    chunk's kernel before the tile instance. At the decode step, which
    the rows instance's split path takes, the split path is also timed
    on the device alone (a CUDA graph of 20 calls: a call's time is its
    wrapper's host time where that is longer), beside the library
    call's and the other instance's, and the rows instance's walk of
    many rows (`splits=0`, its path before the split) beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.paged_attention import (
        TILE_HEAD_DIMS, kernel_variant, split_plan, tile_plan, work)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, page, n_pages, tokens = 8, 8, 512, 288
    n_layers = max(8, math.ceil(100e6 / (2 * b * tokens * kvh * hd * 4)))
    pmax = tokens // page + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    pool = (n_layers, n_pages, page, kvh, hd)
    kp = torch.randn(pool, generator=gen, device="cuda")
    vp = torch.randn(pool, generator=gen, device="cuda")
    # each layer's pools as views made once: the timed calls index a list,
    # as the library call's do
    kps, vps = list(kp), list(vp)
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
            q, kps[i % n_layers], vps[i % n_layers], bt, pos, scale=scale), 50)
        host_ms = _host_ms(lambda i: paged_attention(
            q, kps[i % n_layers], vps[i % n_layers], bt, pos, scale=scale))
        ms_by_variant = {variant: ms}
        split = {}
        n_splits = split_plan(b, kvh, h // kvh * s, hd, pmax * page)
        if variant == "rows" and n_splits:
            # the split path on the device alone, and the rows instance's
            # walk of many rows, which took decode steps before it
            walk = paged_attention(q, kp[0], vp[0], bt, pos, scale=scale,
                                   splits=0)
            walk_err = (walk - ref).abs()
            if bool((walk_err > PA_TOL["atol"]
                     + PA_TOL["rtol"] * ref.abs()).any()):
                raise AssertionError(f"paged_attention's walk disagrees with "
                                     f"its plain version at the {label} "
                                     f"shape")
            if not _graph_matches_eager(lambda i: paged_attention(
                    q, kp[0], vp[0], bt, pos, scale=scale)):
                raise AssertionError(f"paged_attention's CUDA-graph replay "
                                     f"differs from its eager call at the "
                                     f"{label} shape")
            split = dict(
                splits=n_splits,
                device_ms=_graph_ms(lambda i: paged_attention(
                    q, kps[i % n_layers], vps[i % n_layers], bt, pos,
                    scale=scale)),
                walk_ms=cuda_time_ms(lambda i: paged_attention(
                    q, kps[i % n_layers], vps[i % n_layers], bt, pos,
                    scale=scale, splits=0), 50),
                walk_max_abs_err=walk_err.max().item())
        other = next((v for v in PA_VARIANTS if v != variant and (
            v == "rows" or hd in TILE_HEAD_DIMS)), None)
        if other:
            ms_by_variant[other] = cuda_time_ms(lambda i: paged_attention(
                q, kps[i % n_layers], vps[i % n_layers], bt, pos, scale=scale,
                variant=other), 50)
            if split:
                split["other_device_ms"] = _graph_ms(lambda i: paged_attention(
                    q, kps[i % n_layers], vps[i % n_layers], bt, pos,
                    scale=scale, variant=other))
        plain_ms = cuda_time_ms(lambda i: paged_attention_ref(
            q, kps[i % n_layers], vps[i % n_layers], bt, pos, scale=scale), 10)
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
        def sdpa(i):
            return F.scaled_dot_product_attention(
                qf, kall[i % n_layers], vall[i % n_layers], attn_mask=mask,
                scale=scale, enable_gqa=True)

        library_ms = cuda_time_ms(sdpa, 50)
        library_host_ms = _host_ms(sdpa)
        if split:
            split["library_device_ms"] = _graph_ms(sdpa)
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
        declared_ms = declared_bound_ms(*work(q, kp[0], bt, pos))
        row = dict(
            shape=label, B=b, S=s, H=h, KV=kvh, Dh=hd,
            tokens_per_lane=tokens, variant=variant,
            max_abs_err=err.max().item(), ms=ms, host_ms=host_ms,
            library_host_ms=library_host_ms, ms_by_variant=ms_by_variant,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_f32_ms=bound_f32_ms, declared_bound_ms=declared_ms,
            bytes=n_bytes, flops=flops, **split)
        if variant == "tile":
            # a chunk's call is its wrapper's host time where that is
            # longer: the kernel's own time from a CUDA graph beside it
            row.update(qk_passes=qk_passes, pv_passes=pv_passes,
                       tile_parts=tile_plan(b, kvh, h // kvh * s,
                                            pmax * page),
                       device_ms=_graph_ms(lambda i: paged_attention(
                           q, kps[i % n_layers], vps[i % n_layers], bt, pos,
                           scale=scale)))
        rows.append(row)
        other_note = (f"{other} instance {ms_by_variant[other]*1e3:8.2f} us"
                      if other else f"no other instance takes Dh {hd}")
        split_note = (f" | split path, {split['splits']} parts: device "
                      f"{split['device_ms']*1e3:7.2f} us (sdpa "
                      f"{split['library_device_ms']*1e3:7.2f}"
                      + (f", {other} {split['other_device_ms']*1e3:7.2f}"
                         if other else "")
                      + f"); the walk of many rows "
                      f"{split['walk_ms']*1e3:8.2f} us" if split else "")
        parts_note = (f", {row['tile_parts']} parts, device "
                      f"{row['device_ms']*1e3:.2f} us"
                      if variant == "tile" else "")
        log(f"  {label:13s} B {b} S {s:2d} G {h // kvh} Dh {hd} ({variant}"
            f"{parts_note}): "
            f"max err {err.max().item():.2e} | kernel {ms*1e3:8.2f} us, "
            f"host {host_ms*1e3:6.2f} us a call"
            + f" ({other_note}){split_note}"
            + f" | plain {plain_ms*1e3:8.2f} us | sdpa "
            f"{library_ms*1e3:8.2f} us, host {library_host_ms*1e3:6.2f} us "
            f"a call | bound {bound_ms*1e3:6.2f} us "
            f"({row['bound_by']}: {n_bytes/1e6:.1f} MB, {flops/1e9:.3f} "
            f"GFLOP) {bound_ms/ms:.1%} of it | f32 bound "
            f"{bound_f32_ms*1e3:6.2f} us {bound_f32_ms/ms:.1%} of it | "
            f"declared bound {declared_ms*1e3:6.2f} us "
            f"{declared_ms/ms:.1%} of it")
    del kp, vp, kps, vps
    return rows


def declared_bound_ms(flops: int, n_bytes: int) -> float:
    """The least time of a kernel call's work as the wrapper declares it
    to `roofline/count.py` (its `work`: FLOPs, bytes) under HW_H100: the
    larger of FLOPs at the bf16 peak and bytes at the memory rate."""
    from repro_torch.roofline import HW_H100
    return max(flops / HW_H100.peak_flops, n_bytes / HW_H100.hbm_bw) * 1e3


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
# the most rows a timed sc_matmul call has for its host µs to be read
SC_HOST_ROWS = 20
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
# above decode (M > 16) a warp walks all of K in 32-deep windows over a
# tile of 32 rows and 64 or 32 columns (8 x 8 or 8 x 4 outputs a thread),
# and where the grid has too few tiles K is split over blocks (the levels
# scanned by a second kernel): M on both sides of the 32 rows, 255 / 256
# (split at N 1028) and 1024 (8 x 4 at N 1028); K below a window, a
# window and a half, groups straddling windows and parts, and ragged
# against both; N below, across and past the 32 and 64 columns
SC_TILE_MS = (17, 37, 255, 256, 1024)
SC_TILE_KS = (16, 48, 100, 1013)
SC_TILE_NS = (4, 36, 1028)
# depth and readout: the table's levels (its size runs from 129 to
# 16385 floats) and ideal, the sums in lanes up to 128 * 128; past 16
# bits a level does not fit the split's 16-bit words (it hands the scan
# the sums)
SC_TILE_READOUTS = ((20, 12), (1, 8), (1, 12), (1, None), (128, 8),
                    (128, 12), (128, None), (20, 15), (14, 7), (20, 17),
                    (20, 24), (128, 24))


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
    """Records the (M, K, N, kwargs) of every sc_matmul call and the
    `_q_key` of every sc_quantize call made inside the block, through
    the names `core.artemis_matmul` calls; the wrappers themselves, and
    their launch counts, run as they are."""
    import importlib
    # the module, not the function of that name the package exports
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real, real_q = am.sc_matmul_quantized, am.quantize_int8

    def recording(aq, bq, **kw):
        into.add(_sc_key(aq.shape[0], aq.shape[1], bq.shape[1], kw))
        return real(aq, bq, **kw)

    def recording_q(x, axis=None, absmax=None):
        into.add(_q_key(x.shape, x.dtype, axis, absmax is not None))
        return real_q(x, axis, absmax)

    am.sc_matmul_quantized, am.quantize_int8 = recording, recording_q
    try:
        yield into
    finally:
        am.sc_matmul_quantized, am.quantize_int8 = real, real_q


def check_sc_path_shapes(shapes: set) -> dict:
    """Every sc_matmul shape and setting the main path ran, held against
    the plain version: those phases 3-4 compared are counted, the rest
    compared now on random operands; then every sc_quantize shape,
    dtype and grouping it ran, the same way."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    quant = {key for key in shapes if key[0] == "quantize"}
    shapes = shapes - quant
    new = sorted(shapes - SC_CHECKED, key=str)
    for m, k, n, kw in new:
        _sc_compare(_int8(gen, m, k), _int8(gen, k, n),
                    f"path shape M {m} K {k} N {n}", **dict(kw))
    log(f"sc_matmul: the main path ran {len(shapes)} shapes and settings; "
        f"{len(shapes) - len(new)} were compared in phases 3-4, {len(new)} "
        f"now, all bit-equal: "
        + ", ".join(f"{dict(kw)['mode']} {m}x{k}x{n}" for m, k, n, kw in new))
    new_q = sorted(quant - QUANT_CHECKED, key=str)
    for _, shape, dtype, axis, given in new_q:
        x = _q_input(gen, shape, getattr(torch, dtype))
        _quantize_compare(x, axis, _q_absmax(x) if given else None,
                          "path shape")
    log(f"sc_quantize: the main path ran {len(quant)} shapes, dtypes and "
        f"groupings; {len(quant) - len(new_q)} were compared in phases "
        f"3-4, {len(new_q)} now, all bit-equal (int8 and scale)")
    return dict(n_shapes=len(shapes), n_compared_here=len(new),
                quantize_shapes=len(quant), quantize_compared_here=len(new_q))


# ---------------------------------------------------------------------------
# phases 3-4 and 16: sc_quantize (the int8 quantization in front of the MAC)
# against its plain version, and its timing
# ---------------------------------------------------------------------------

# (shape, dtype name, axis, absmax given) of every call held bit for bit
# against the plain version
QUANT_CHECKED: set = set()
# the launches of sc_quantize on each path, by the path's label: two a
# product (`hold_quantize`)
QUANT_PATHS: dict = {}


def _q_key(shape, dtype, axis, given) -> tuple:
    axis = axis if axis is None or isinstance(axis, int) else tuple(axis)
    return ("quantize", tuple(shape), str(dtype).replace("torch.", ""), axis,
            bool(given))


def _q_input(gen, shape, dtype):
    """Normal values on the card, scaled as activations are."""
    import torch
    return (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)


def _q_absmax(x):
    """A given absmax, as the tensor- and data-parallel seams give one:
    the whole tensor's (here 1.5 times x's own), f32, one element."""
    return (x.detach().abs().amax().float() * 1.5).reshape(())


def _quantize_compare(x, axis, absmax, label):
    """The kernel against its plain version on the same input: the int8
    tensor and the scale's bits equal (a NaN scale against a NaN), else
    raise."""
    import torch
    from repro_torch.kernels.sc_matmul import quantize_int8, quantize_int8_ref
    q, s = quantize_int8(x, axis, absmax)
    torch.cuda.synchronize()
    rq, rs = quantize_int8_ref(x, axis, absmax)
    QUANT_CHECKED.add(_q_key(x.shape, x.dtype, axis, absmax is not None))
    nan = s.isnan()
    same = (q.shape == rq.shape and q.dtype == rq.dtype == torch.int8
            and s.shape == rs.shape and s.dtype == rs.dtype
            and torch.equal(q, rq) and torch.equal(nan, rs.isnan())
            and torch.equal(s[~nan].view(torch.int32),
                            rs[~nan].view(torch.int32)))
    if not same:
        raise AssertionError(
            f"sc_quantize {label} {tuple(x.shape)} {x.dtype} axis {axis} "
            f"absmax {'given' if absmax is not None else 'own'}: not "
            f"bit-equal to its plain version ({int((q != rq).sum())} int8 "
            f"values differ; scales {s.flatten()[:4].tolist()} vs "
            f"{rs.flatten()[:4].tolist()})")
    return q, s


def _q_ties_and_zeros(dtype):
    """Rows on rounding ties and edges: row 0 all zeros (the 1e-8
    floor), row 1 every level -127..127 and every half step between
    them (round half to even), row 2 the same halved, row 3 a NaN, row 4
    an inf; 4096 wide."""
    import torch
    x = torch.zeros((8, 4096), device="cuda")
    steps = torch.arange(-127, 128, device="cuda", dtype=torch.float32)
    x[1, :255] = steps
    x[1, 255:509] = steps[:-1] + 0.5
    x[2] = x[1] * 0.5
    x[3, :300] = x[1, :300]
    x[3, 7] = float("nan")
    x[4, :300] = x[1, :300]
    x[4, 9] = float("inf")
    return x.to(dtype)


def check_sc_quantize() -> int:
    """sc_quantize bit for bit against its plain version: the qwen3_8b
    and qwen2_moe_a2_7b weights per tensor (bf16 as served, f32 as the
    train step's master weights), their activations at M 1, 8, 20 and
    256 per tensor, per lane (every dim but the first: the recurrent
    families' lanes) and per row (axis -1), a given absmax, a weight's
    per-column scale (axis 0), ragged widths, and rows on ties, of zeros,
    of a NaN and an inf; returns the number of cases."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    n = 0
    weights = sorted(set(SC_SHAPES) | set(MOE_SC_SHAPES))
    for k, nn in weights:
        for dtype in (torch.bfloat16, torch.float32):
            _quantize_compare(_q_input(gen, (k, nn), dtype), None, None,
                              "weight")
            n += 1
    ks = sorted({k for k, _ in weights})
    for m in (1, 8, 20, 256):
        for k in ks:
            x = _q_input(gen, (m, k), torch.bfloat16)
            for axis in (None, -1):
                _quantize_compare(x, axis, None, "activation")
            _quantize_compare(x, None, _q_absmax(x), "given absmax")
            lanes = x.reshape(8, m // 8, k) if m % 8 == 0 else x[:, None]
            _quantize_compare(lanes, (1, 2), None, "per lane")
            n += 4
    for shape, axis in (((4096, 1024), 0), ((333, 45), 0), ((37, 333), None),
                        ((7, 333), -1), ((3, 5, 7, 41), (1, 2, 3))):
        for dtype in (torch.bfloat16, torch.float32):
            _quantize_compare(_q_input(gen, shape, dtype), axis, None,
                              "ragged")
            n += 1
    for dtype in (torch.bfloat16, torch.float32):
        x = _q_ties_and_zeros(dtype)
        for axis in (-1, None):
            _quantize_compare(x, axis, None, "ties and zeros")
            n += 1
    log(f"sc_quantize: {n} cases bit-equal to the plain version (int8 and "
        f"scale): weights {weights} per tensor in bf16 and f32, "
        f"activations at M 1/8/20/256 x K {ks} per tensor, per row, per "
        f"lane and with a given absmax, per-column and ragged shapes, "
        f"ties, zeros, NaN and inf")
    return n


def _q_bound(x) -> tuple[float, int]:
    """(bound ms, bytes): x read once, the int8 tensor and a scale
    written once, at the card's memory rate (no arithmetic to price)."""
    n_bytes = x.numel() * (x.element_size() + 1) + 4
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes


def time_sc_quantize(weights=SC_SHAPES, m_rows=SC_ROWS,
                     model="qwen3_8b") -> list[dict]:
    """sc_quantize per tensor at each full-width weight (bf16) and at the
    activations of every M in `m_rows` by every K (bf16): the kernel per
    call, on the device alone (a CUDA graph) and its host µs, beside its
    plain version (`core.quantization`'s ops) and its byte bound; no
    single library call computes the function. A weight's calls read
    another of 4 copies (up to 400 MB), so the 50 MB L2 holds none."""
    import torch
    from repro_torch.kernels.sc_matmul import quantize_int8, quantize_int8_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    copies = 4
    cases = [("weight", shape) for shape in weights] + [
        (label, (m, k)) for label, m in m_rows
        for k in sorted({k for k, _ in weights})]
    rows = []
    for label, shape in cases:
        xs = [_q_input(gen, shape, torch.bfloat16) for _ in range(copies)]
        _quantize_compare(xs[0], None, None, label)
        ms = _adaptive_ms(lambda i: quantize_int8(xs[i % copies]))
        device_ms = _graph_ms(lambda i: quantize_int8(xs[i % copies]))
        host_ms = _host_ms(lambda i: quantize_int8(xs[i % copies]))
        plain_ms = _adaptive_ms(lambda i: quantize_int8_ref(
            xs[i % copies]), budget_s=0.5, most=10)
        bound_ms, n_bytes = _q_bound(xs[0])
        rows.append(dict(model=model, shape=label, dims=list(shape),
                         max_abs_err=0.0, ms=ms, device_ms=device_ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms,
                         bound_by="bytes", bytes=n_bytes))
        log(f"  sc_quantize {label:13s} {str(tuple(shape)):15s}: kernel "
            f"{ms*1e3:8.2f} us (device {device_ms*1e3:8.2f}, host "
            f"{host_ms*1e3:6.2f}) | plain {plain_ms*1e3:9.2f} us | bound "
            f"{bound_ms*1e3:7.2f} us (bytes) | {bound_ms/device_ms:6.1%} of "
            f"bound on the device")
        del xs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def check_sc_graph_replays() -> dict:
    """One sc_matmul_quantized call (artemis at M 8, which takes scratch
    from the workspace) and one quantize_int8 call (a qwen3_8b weight,
    whose chunk maxima take scratch) replayed from a CUDA graph, each
    bit-equal to the eager call."""
    import torch
    from repro_torch.kernels.sc_matmul import (quantize_int8,
                                               sc_matmul_quantized)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    a, b = _int8(gen, 8, 4096), _int8(gen, 4096, 12288)
    w = _q_input(gen, (4096, 12288), torch.bfloat16)
    out = dict(sc_matmul_artemis_m8=_graph_matches_eager(
                   lambda i: sc_matmul_quantized(a, b, mode="artemis")),
               sc_quantize_weight=_graph_matches_eager(
                   lambda i: quantize_int8(w)))
    log(f"  CUDA graph replays bit-equal to the eager calls: {out}")
    if not all(out.values()):
        raise AssertionError(f"a graph's replay differs from the eager "
                             f"call: {out}")
    return out


def hold_quantize(counts: dict, label: str, noisy_products: int = 0) -> int:
    """A path's sc_quantize launches (its launch counts, zeroed just
    before it ran): two a product, one an operand, so twice its
    sc_matmul launches and its noisy artemis products (which quantize on
    the card and scan in plain torch); recorded in QUANT_PATHS."""
    got = counts.get("sc_quantize", 0)
    want = 2 * (counts.get("sc_matmul", 0) + noisy_products)
    if got != want:
        raise AssertionError(f"{label}: sc_quantize launched {got} times, "
                             f"want {want} (two a product)")
    if got:
        QUANT_PATHS[label] = got
    return got


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
    return n + check_sc_artemis_tiles(gen)


def check_sc_artemis_tiles(gen) -> int:
    """artemis above decode at the edges of its tiles and windows
    (SC_TILE_MS x SC_TILE_KS x SC_TILE_NS at depth 20, readout 8 and
    ideal), at every depth and readout of SC_TILE_READOUTS (M 17 and
    256, K 100 and 1013, N 36 and 1028), at K 12288 + 13, and on the
    all-extreme operands at M 256 (M 17's are in the split-edge cases);
    bit-equal to the plain version."""
    t0 = time.perf_counter()
    n = 0
    for m in SC_TILE_MS:
        for k in SC_TILE_KS:
            for nn in SC_TILE_NS:
                a, b = _int8(gen, m, k), _int8(gen, k, nn)
                for r in (8, None):
                    _sc_compare(a, b, f"M {m} K {k} N {nn}", mode="artemis",
                                acc_depth=20, readout_bits=r)
                    n += 1
    n_grid = n
    for m in (17, 256):
        for k in (100, 1013):
            for nn in (36, 1028):
                a, b = _int8(gen, m, k), _int8(gen, k, nn)
                for d, r in SC_TILE_READOUTS:
                    _sc_compare(a, b, f"M {m} K {k} N {nn}", mode="artemis",
                                acc_depth=d, readout_bits=r)
                    n += 1
    for m, nn in ((256, 36), (256, 1028), (1024, 36)):
        a, b = _int8(gen, m, 12288 + 13), _int8(gen, 12288 + 13, nn)
        _sc_compare(a, b, f"M {m} K 12301 N {nn}", mode="artemis")
        n += 1
    a, b = _sc_extreme(gen, 256, 12288, 136)
    for kw in (dict(acc_depth=20, readout_bits=8),
               dict(acc_depth=20, readout_bits=None),
               dict(acc_depth=128, readout_bits=None)):
        out = _sc_compare(a, b, "extreme M 256 K 12288 N 136",
                          mode="artemis", **kw)
        n += 1
        if kw["readout_bits"] is None and out[1, 2].item() != 12288 * 128:
            raise AssertionError("sc_matmul artemis above decode: a row of "
                                 "-128 against a column of -128 does not "
                                 "give 12288 products of 128")
    log(f"sc_matmul: {n} artemis tile-edge cases bit-equal above decode "
        f"({n_grid} over M {SC_TILE_MS} x K {SC_TILE_KS} x N "
        f"{SC_TILE_NS} at depth 20, readout 8 and ideal; depth/readout "
        f"{SC_TILE_READOUTS} at M 17 and 256; K 12301; -128 extremes at "
        f"M 256) in {time.perf_counter() - t0:.1f} s")
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


def _host_ms(fn, n_calls=50, repeats=5) -> float:
    """Host ms a call of fn(i): perf_counter around n_calls back-to-back
    calls, with a synchronize before and none inside, so it reads what
    the host spends to enqueue a call (the wrapper's Python, its
    allocations and the launches), not the device's time; the median of
    `repeats` such runs, as the host's cores are shared."""
    import torch
    fn(0)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_calls):
            fn(i)
        runs.append((time.perf_counter() - t0) * 1e3 / n_calls)
    torch.cuda.synchronize()
    return statistics.median(runs)


def _graph_matches_eager(fn) -> bool:
    """Whether a CUDA graph's replay of the call fn(0) gives the eager
    call's outputs bit for bit (the wrappers' workspace under capture:
    the captured call takes a buffer of its own)."""
    import torch
    eager = fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(0)
    graph.replay()
    torch.cuda.synchronize()
    pairs = (zip(eager, captured) if isinstance(eager, tuple)
             else [(eager, captured)])
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in pairs)
    del graph
    return same


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
        # the same weights column-major, the layout cuBLASLt's int8
        # kernels take
        bs_col = [b.t().contiguous().t() for b in bs]
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
                # the host's µs a call where the device's are few: decode
                # and expert rows
                host_ms = (_host_ms(lambda i: sc_matmul_quantized(
                    a, bs[i % copies], mode=mode)) if m <= SC_HOST_ROWS
                    else None)
                plain_ms = _adaptive_ms(lambda i: sc_matmul_ref(
                    a, bs[i % copies], mode=mode), budget_s=1.0, most=10)
                library_ms = library_col_ms = None
                if mode == "int8":
                    for bl in (bs, bs_col):
                        lib = torch._int_mm(a_lib, bl[0])[:m]
                        if not torch.equal(lib, out):
                            raise AssertionError("torch._int_mm disagrees "
                                                 "with the int8 kernel")
                    library_ms = _adaptive_ms(lambda i: torch._int_mm(
                        a_lib, bs[i % copies]))
                    library_col_ms = _adaptive_ms(lambda i: torch._int_mm(
                        a_lib, bs_col[i % copies]))
                bound_ms, bound_by, n_bytes, ops = _sc_bound(mode, m, k, n)
                row = dict(model=model, mode=mode, shape=label, M=m, K=k,
                           N=n, max_abs_err=0.0, ms=ms, device_ms=device_ms,
                           host_ms=host_ms, plain_ms=plain_ms,
                           library_ms=library_ms,
                           library_colmajor_ms=library_col_ms,
                           bound_ms=bound_ms,
                           bound_by=bound_by, bytes=n_bytes, ops=ops)
                if mode == "artemis":   # products and (decode) the scan
                    row["kernel_us"] = _kernel_us(lambda i: sc_matmul_quantized(
                        a, bs[i % copies], mode=mode))
                lib_txt = ""
                if library_ms is not None:
                    row["library_ratio"] = ms / library_ms
                    lib_txt = (f" | _int_mm {library_ms*1e3:9.2f} us "
                               f"(ratio {ms / library_ms:.2f}), B "
                               f"column-major {library_col_ms*1e3:9.2f} us")
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
                host_txt = ("" if host_ms is None
                            else f", host {host_ms*1e3:6.2f}")
                log(f"  {mode:11s} {label:13s} M {m:3d} K {k:5d} N {n:5d}:"
                    f" kernel {ms*1e3:9.2f} us (device {device_ms*1e3:8.2f}"
                    f"{host_txt})"
                    f" | plain {plain_ms*1e3:10.2f}"
                    f" us{lib_txt} | bound {bound_ms*1e3:8.2f} us "
                    f"({bound_by}) | {bound_ms/ms:6.1%} of bound")
        del bs, bs_col
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def time_sc_artemis_wide(m: int = 1024, shapes=SC_SHAPES) -> list[dict]:
    """artemis at M 1024 (four prefill chunks' rows) at each qwen3_8b
    projection shape, beside phase 4's M 8 and 256: bit-equal to the
    plain version once, then per call and on the device alone, beside
    its bound; each call reads another of 4 weight copies."""
    import torch
    from repro_torch.kernels.sc_matmul import sc_matmul_quantized
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    copies = 4
    rows = []
    for k, n in shapes:
        bs = [_int8(gen, k, n) for _ in range(copies)]
        a = _int8(gen, m, k)
        _sc_compare(a, bs[0], f"M {m} K {k} N {n}", mode="artemis")

        def call(i):
            return sc_matmul_quantized(a, bs[i % copies], mode="artemis")
        ms, device_ms = _adaptive_ms(call), _graph_ms(call)
        bound_ms, bound_by, n_bytes, ops = _sc_bound("artemis", m, k, n)
        rows.append(dict(model="qwen3_8b", mode="artemis",
                         shape=f"rows_{m}", M=m, K=k, N=n, max_abs_err=0.0,
                         ms=ms, device_ms=device_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=n_bytes, ops=ops))
        log(f"  artemis     rows {m:5d}     K {k:5d} N {n:5d}: kernel "
            f"{ms*1e3:9.2f} us (device {device_ms*1e3:8.2f}) | bound "
            f"{bound_ms*1e3:8.2f} us ({bound_by}) | {bound_ms/device_ms:6.1%}"
            f" of bound on the device")
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
    wrapper's tiles; phase 36's head dims and groups
    (NEW_ATTN_GEOMETRIES). Each case through the rows instance, and through
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
    # zamba2's shared attention: D 112, G 1, its windows; bf16 q over an
    # f32 ring rounded by kv_cast (the static path: both instances) and f32
    # throughout (the rows instance)
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
    # the multimodal static paths: D 64 at G 1 (musicgen_large is MHA)
    # and G 7 (internvl2_1b: 14 query heads over 2 KV heads, a group that
    # is not a power of two), bf16 q over an f32 cache of 1312 slots
    # (256 + 1024 + 32) read as strided views and rounded by kv_cast:
    # the vlm prefill's Sq 1280 = 256 + 1024, an Sq of 1100 (not a
    # multiple of 128) and decode rows near the end of the cache
    cases = []
    smax = 1312
    for hq, hkv_s in ((4, 4), (14, 2)):
        k, v = (torch.randn((2, smax, hkv_s, 64), generator=gen,
                            device="cuda").transpose(1, 2) for _ in range(2))
        for sq, q_offset, kv_len in ((1280, 0, 1280), (1100, 0, 1100),
                                     (1100, 200, smax), (1, 1295, 1296),
                                     (8, 1290, 1298)):
            q = torch.randn((2, sq, hq, 64), generator=gen,
                            device="cuda").to(bf16).transpose(1, 2)
            bq, bk = effective_tiles(sq, smax)
            kw = dict(causal=True, window=None, kv_len=kv_len,
                      q_offset=q_offset, bq=bq, bk=bk, kv_cast=bf16,
                      scale=64 ** -0.5)
            run(q, k, v, kw, dict(sq=sq, sk=smax, G=hq // hkv_s, D=64),
                cases)
    settle(cases, "D 64, G 1 and G 7 (the multimodal static shapes), Sq "
                  "1280 / 1100 / 8 / 1, Smax 1312")
    # phase 36's geometries (NEW_ATTN_GEOMETRIES: D 256 at G 8, D 128 at
    # G 5, 6, 7; both instances where they take the call), 2 KV heads: the
    # static prefill of 520 slots and a chunk past half of it, a decode
    # row and 8 rows at the end of the cache, with and without a window
    # of 3 and a kv_len that leaves later rows no key; bf16 q over an f32
    # cache rounded by kv_cast (the static path), bf16 throughout and f32
    # throughout (the f32 checks), strided views every other case
    cases = []
    smax = 520
    for d, group in NEW_ATTN_GEOMETRIES:
        for q_dt, kv_dt, kv_cast in ((bf16, f32, bf16), (bf16, bf16, None),
                                     (f32, f32, None)):
            strided = n % 2 == 1
            k = operand(hkv, smax, d, kv_dt, strided)
            v = operand(hkv, smax, d, kv_dt, strided)
            for sq, q_offset in ((512, 0), (200, 300), (1, 511), (8, 504)):
                q = operand(hkv * group, sq, d, q_dt, strided)
                for window in (None, 3):
                    for kv_len in (q_offset + sq, q_offset + (sq + 1) // 2):
                        bq, bk = effective_tiles(sq, smax)
                        kw = dict(causal=True, window=window, kv_len=kv_len,
                                  q_offset=q_offset, bq=bq, bk=bk,
                                  kv_cast=kv_cast)
                        run(q, k, v, kw, dict(sq=sq, sk=smax, G=group, D=d,
                                              q=q_dt, kv=kv_dt,
                                              strided=strided), cases)
                        n += 1
    settle(cases, "D 256 at G 8, D 128 at G 5 / 6 / 7 (phase 36's "
                  "configurations), Sq 512 / 200 / 8 / 1, Smax 520")
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


def check_flash_split() -> dict:
    """The rows instance's split path (`splits`) against the plain
    version at each of SPLIT_GEOMETRIES (B 2, 2 KV heads), forced to 1
    and 2 parts and at the plan's count, o and lse within FA_TOL and nvis
    equal, on an f32 cache of 2056 slots read as strided views and
    rounded by kv_cast (the static path), bf16 throughout and f32
    throughout: a decode row at the end of 2048 keys (the static path's
    tiles, 8 x 128), with a window of 3; a row whose visited tile keeps
    no key (kv_len below its window); one that visits no tile (kv_len
    0); a short cache in tiles of 8; and as many rows as the path takes
    (G * Sq up to 16, 8 at D 256) ending at kv_len, with a window of 5."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_all,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        split_plan)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    f32, bf16 = torch.float32, torch.bfloat16
    b, hkv, smax = 2, 2, 2056
    cases, plans = [], set()
    for d, group in SPLIT_GEOMETRIES:
        sq_many = max(1, (8 if d > 128 else 16) // group)
        # (sq, q_offset, kv_len, window, (bq, bk))
        scenarios = ((1, 2047, 2048, None, (8, 128)),
                     (1, 2047, 2048, 3, (8, 128)),
                     (1, 1999, 1990, 3, (8, 128)),
                     (1, 500, 0, None, (8, 128)),
                     (1, 40, 41, None, (8, 8)),
                     (sq_many, 2048 - sq_many, 2048, 5, (8, 128)))
        for q_dt, kv_dt, kv_cast in ((bf16, f32, bf16), (bf16, bf16, None),
                                     (f32, f32, None)):
            k, v = (torch.randn((b, smax, hkv, d), generator=gen,
                                device="cuda").to(kv_dt).transpose(1, 2)
                    for _ in range(2))
            for sq, q_offset, kv_len, window, (bq, bk) in scenarios:
                q = torch.randn((b, sq, hkv * group, d), generator=gen,
                                device="cuda").to(q_dt).transpose(1, 2)
                kw = dict(causal=True, window=window, kv_len=kv_len,
                          q_offset=q_offset, bq=bq, bk=bk, kv_cast=kv_cast)
                ref = flash_attention_ref(q, k, v, **kw)
                plans.add(split_plan(b, hkv, group * sq, d, kv_len))
                for splits in SPLIT_COUNTS:
                    err, bad = _fa_errors(flash_attention_all(
                        q, k, v, variant="rows", splits=splits, **kw), ref)
                    cases.append((dict(kw, D=d, G=group, sq=sq, q=q_dt,
                                       kv=kv_dt, splits=splits), err, bad))
    torch.cuda.synchronize()
    errs = torch.stack([e for _, e, _ in cases]).cpu()
    bads = torch.stack([x for _, _, x in cases]).cpu()
    if bool(bads.any()):
        i = int(bads.nonzero()[0, 0])
        raise AssertionError(f"flash_attention's split path disagrees with "
                             f"its plain version: {cases[i][0]}: max err "
                             f"{errs[i].item():.3e} (or nvis)")
    worst = float(errs.max())
    log(f"flash_attention (rows, split path): {len(cases)} calls at (D, G) "
        f"{SPLIT_GEOMETRIES}, splits {SPLIT_COUNTS} (the plan's: "
        f"{sorted(plans)}), 2048 keys, rows that keep or visit no key, "
        f"within rtol=atol=2e-4, nvis equal (max abs err {worst:.3e})")
    return dict(max_abs_err=worst, calls=len(cases))


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
    """The static path's two shapes at the config's full width (qwen3_8b:
    B 8, Hq 32, Hkv 8, D 128), bf16 queries read as (B, S, H, D) views,
    an f32 dense cache of Smax = P + 1024 + 32 slots (P the vlm image
    prefix: 256 for internvl2_1b, else 0) read in place as (B, KV,
    Smax, D) views and rounded to bf16 in the kernel (`kv_cast`), as
    the path calls it: a decode at index P + 1040 and the prefill of
    P + 1024 rows. Each call reads another layer's cache, of at least 4
    layers and of enough to fill twice the 50 MB L2 (qwen3_8b: 4 of 69
    MB each), so the L2 holds none of it. The cache holds bf16 values, as
    the path's does, so the library call (SDPA on f32, GQA, keys sliced
    to kv_len) computes the same function. Each shape runs the instance
    the path picks (`kernel_variant`: rows at decode, tile at the
    prefill), held against the plain version, and the other instance is
    held and timed beside it; the prefill's f32 bound is the rows
    instance's, kept beside the tile instance's. At the decode, the rows
    instance's split path is also timed on the device alone (a CUDA
    graph) beside the library call's and the other instance's, and its
    walk of many rows (`splits=0`) is held and timed beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (flash_attention_all,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_variant, split_plan, tile_takes, work)
    b, hq, hkv, d = 8, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    prefix = 256 if cfg.modality == "vlm" else 0
    smax = prefix + 1056
    n_layers = max(4, math.ceil(100e6 / (2 * b * smax * hkv * d * 4)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    shape = (n_layers, b, smax, hkv, d)
    ck = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).float()
    cv = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).float()
    # each layer's cache as (B, KV, Smax, D) views made once: the timed
    # calls index a list
    kvs = [(ck[i].transpose(1, 2), cv[i].transpose(1, 2))
           for i in range(n_layers)]
    scale = d ** -0.5
    rows = []
    for label, sq, q_offset, kv_len in (
            ("decode", 1, prefix + 1040, prefix + 1041),
            ("prefill", prefix + 1024, 0, prefix + 1024)):
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

        def kv(i):
            return kvs[i % n_layers]

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
        # the decode's host time a call (the prefill's is far under its
        # device time)
        host = ({} if sq > 1 else dict(host_ms=_host_ms(
            lambda i: flash_attention_all(q, *kv(i), **kw))))
        ms_by_variant = {variant: ms}
        split = {}
        n_splits = split_plan(b, hkv, hq // hkv * sq, d, kv_len)
        if variant == "rows" and n_splits:
            # the split path on the device alone, and the rows instance's
            # walk of many rows, which took decode steps before it
            err, bad = _fa_errors(flash_attention_all(q, *kv(0), splits=0,
                                                      **kw), ref)
            if bool(bad):
                raise AssertionError(f"flash_attention's walk disagrees with "
                                     f"its plain version at the {label} "
                                     f"shape")
            if not _graph_matches_eager(lambda i: flash_attention_all(
                    q, *kv(0), **kw)):
                raise AssertionError(f"flash_attention's CUDA-graph replay "
                                     f"differs from its eager call at the "
                                     f"{label} shape")
            split = dict(
                splits=n_splits,
                device_ms=_graph_ms(lambda i: flash_attention_all(
                    q, *kv(i), **kw)),
                walk_ms=_adaptive_ms(lambda i: flash_attention_all(
                    q, *kv(i), splits=0, **kw)),
                walk_max_abs_err=err.item())
        if other:
            ms_by_variant[other] = _adaptive_ms(lambda i: flash_attention_all(
                q, *kv(i), variant=other, **kw))
            if split:
                split["other_device_ms"] = _graph_ms(
                    lambda i: flash_attention_all(q, *kv(i), variant=other,
                                                  **kw))
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
        if host:
            host["library_host_ms"] = _host_ms(sdpa)
        if split:
            split["library_device_ms"] = _graph_ms(sdpa)
        pairs = sum(min(kv_len, r + q_offset + 1) for r in range(sq))
        args = (b, hq, hkv, sq, d, kv_len, pairs, 2, 4)
        bound_ms, bound_by, n_bytes, flops = _fa_bound(
            *args, qk_bf16=True, variant=variant)
        bound_f32_ms = _fa_bound(*args, qk_bf16=True)[0]
        declared_ms = declared_bound_ms(*work(
            q, kv(0)[0], causal=True, kv_len=kv_len, q_offset=q_offset))
        rows.append(dict(shape=label, B=b, Sq=sq, Smax=smax, Hq=hq, Hkv=hkv,
                         D=d, declared_bound_ms=declared_ms,
                         q_offset=q_offset, kv_len=kv_len, variant=variant,
                         max_abs_err=errs[variant],
                         max_abs_err_by_variant=errs, ms=ms,
                         ms_by_variant=ms_by_variant,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_max_abs_diff=lib_err, bound_ms=bound_ms,
                         bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                         bytes=n_bytes, flops=flops, **host, **split))
        host_note = (f", host {host['host_ms']*1e3:6.2f} us a call"
                     if host else "")
        lib_host_note = (f", host {host['library_host_ms']*1e3:6.2f} us a "
                         f"call" if host else "")
        other_note = (f"{other} instance {ms_by_variant[other]*1e3:9.2f} "
                      f"us, max err {errs[other]:.2e}" if other
                      else f"no other instance takes D {d}")
        split_note = (f" | split path, {split['splits']} parts: device "
                      f"{split['device_ms']*1e3:7.2f} us (sdpa "
                      f"{split['library_device_ms']*1e3:7.2f}"
                      + (f", {other} {split['other_device_ms']*1e3:7.2f}"
                         if other else "")
                      + f"); the walk of many rows "
                      f"{split['walk_ms']*1e3:8.2f} us" if split else "")
        log(f"  {label:7s} Sq {sq:4d} q_offset {q_offset:4d} kv_len "
            f"{kv_len} G {hq // hkv} D {d} ({variant}): max err "
            f"{errs[variant]:.2e} | kernel "
            f"{ms*1e3:9.2f} us{host_note} ({other_note}){split_note} | "
            f"plain {plain_ms*1e3:10.2f} us | "
            f"sdpa {library_ms*1e3:9.2f} us{lib_host_note} (max diff "
            f"{lib_err:.1e}) | "
            f"bound {bound_ms*1e3:8.2f} us ({bound_by}: {n_bytes/1e6:.1f} "
            f"MB, {flops/1e9:.2f} GFLOP) {bound_ms/ms:.1%} of it | f32 "
            f"bound {bound_f32_ms*1e3:8.2f} us {bound_f32_ms/ms:.1%} of it "
            f"| declared bound {declared_ms*1e3:8.2f} us "
            f"{declared_ms/ms:.1%} of it")
    del ck, cv, kvs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 5-6: the engine at full width
# ---------------------------------------------------------------------------


# the sampled lanes of the mixed drains: half of the requests
MIXED = dict(sampled_fraction=0.5, temperature=0.8, top_k=50, top_p=0.9)
PREFILL_CHUNK = 32                   # the engines' prefill chunk


def smoke_trace(cfg, prompt=(128, 256), gen: int = 32, **sampling):
    """8 requests (the engine's 8 lanes), prompts of `prompt` tokens,
    `gen` new tokens each."""
    from repro_torch.serve import TrafficConfig, synth_trace
    return synth_trace(TrafficConfig(
        n_requests=8, arrival_rate=1e9, prompt_len_min=prompt[0],
        prompt_len_max=prompt[1], gen_len_min=gen, gen_len_max=gen,
        vocab_size=cfg.vocab_size, seed=0, **sampling))


def engine_config(attn_impl: str, n_pages: int = 512):
    from repro_torch.serve import EngineConfig
    return EngineConfig(page_size=8, n_pages=n_pages, max_batch=8,
                        max_pages_per_seq=37, prefill_chunk=PREFILL_CHUNK,
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


# the policies whose forwards phase 7 profiles (about 10 s a profile):
# artemis_mxu's are int8's but for its sc_matmul (19.54 against 7.97 ms
# of a prefill-chunk forward's 255-272 on an H100), so a third profile
# checked nothing new
PROFILED_MODES = ("int8", "artemis")


def quantized_drains(cfg, sc_rows, n_forwards_exact) -> dict:
    """One full-width bf16 drain per quantized policy, gather core;
    then the profile of one prefill-chunk and one decode forward under
    each of PROFILED_MODES on the same weights."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.models import transformer
    trace = smoke_trace(cfg)
    model = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    drain(cfg, model, short_trace(cfg)[:1], "gather",
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
        hold_quantize(run["counts"], f"qwen3_8b {mode} engine")
        runs[mode] = dict(tok_s=tok_s, wall_s=run["wall_s"],
                          n_forwards=run["n_forwards"], launches=launches,
                          n_tokens=m["n_generated_tokens"],
                          peak_gib=peak, trace=trace_name)
    for mode in PROFILED_MODES:
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
    from repro_torch.models import frontend
    torch.cuda.synchronize()
    reset_launch_counts()
    out = serve(batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                policy_mode=policy_mode, params=model, device="cuda",
                attn_impl=attn_impl)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    gen = out["generated"]
    # audio: a token per codebook; vlm: the image prefix fills the cache
    # before the prompt
    want_shape = frontend.token_shape(cfg, batch, gen_len)
    if tuple(gen.shape) != want_shape or int(gen.min()) < 0 or \
            int(gen.max()) >= cfg.padded_vocab:
        raise AssertionError(f"static run: tokens of shape "
                             f"{tuple(gen.shape)} (want {want_shape}): {gen}")
    want_index = frontend.n_prefix_tokens(cfg) + prompt_len + gen_len
    if out["cache_index"] != want_index:
        raise AssertionError(f"static run: cache index {out['cache_index']}"
                             f", want {want_index}")
    return dict(out, counts=counts)


def static_drain(cfg, profile: bool = True) -> dict:
    """A full-width dense config (qwen3_8b; the multimodal musicgen_large
    and internvl2_1b) through `--mode static`'s serve(): bf16, f32
    cache, batch 8, prompt 1024 (after internvl's 256-token image
    prefix), gen 32, exact policy (flash core); then, with `profile`,
    the device time by group of a prefill and a decode forward."""
    import torch
    from repro_torch.models import frontend, transformer
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in model.parameters())/1e9:.3f} B "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    # warm-up: cuBLAS handles and workspaces, first-launch costs
    static_run(cfg, model, batch=8, prompt_len=64, gen_len=2)
    torch.cuda.reset_peak_memory_stats()
    run = static_run(cfg, model, batch=8, prompt_len=1024, gen_len=32)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = run["counts"]
    want = cfg.n_layers * (1 + 32)
    step_ms = run["decode_s"] / 32 * 1e3
    prefix = frontend.n_prefix_tokens(cfg)
    what = f"8 x {prefix} + 1024 tokens" if prefix else "8 x 1024 tokens"
    if cfg.modality == "audio":
        what += f" x {cfg.n_codebooks} codebooks"
    log(f"  prefill {run['prefill_s']*1e3:.2f} ms ({what}) | decode "
        f"{run['decode_tok_per_s']:.2f} tok/s, {step_ms:.2f} ms "
        f"per step | generated {tuple(run['generated'].shape)}, cache index "
        f"{run['cache_index']} | peak device memory {peak:.2f} GiB")
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
    if counts.get("paged_attention", 0) or counts.get("sc_matmul", 0) \
            or counts.get("sc_quantize", 0):
        raise AssertionError(f"the exact static path launched {counts}")
    out = dict(model=model, prefill_ms=run["prefill_s"] * 1e3,
               decode_tok_s=run["decode_tok_per_s"], step_ms=step_ms,
               peak_gib=peak, launches=counts["flash_attention"],
               launches_by_variant=by_variant,
               generated_shape=list(run["generated"].shape),
               cache_index=run["cache_index"])
    if profile:
        out.update(profile=profile_static(cfg, model))
    return out


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


def dense_projections(cfg) -> int:
    """A dense layer's products through the policy: wq, wk, wv, wo and
    the FFN's w_up and w_down, with w_gate where it is a GLU."""
    return 4 + (3 if cfg.glu else 2)


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
    per_layer = dense_projections(cfg)
    want = per_layer * cfg.n_layers * (1 + 8)
    log(f"  int8, batch 8, prompt 128, gen 8: prefill "
        f"{run['prefill_s']*1e3:.2f} ms, decode {run['decode_tok_per_s']:.2f} "
        f"tok/s | sc_matmul launches {counts.get('sc_matmul', 0)} = "
        f"{per_layer} x {cfg.n_layers} layers x 9 forwards? "
        f"{counts.get('sc_matmul', 0) == want}; flash_attention "
        f"{counts.get('flash_attention', 0)}")
    if counts.get("sc_matmul", 0) != want or counts.get("flash_attention", 0) \
            or counts.get("paged_attention", 0):
        raise AssertionError(f"int8 static run launches {counts}, want "
                             f"sc_matmul {want} and nothing else")
    hold_quantize(counts, f"{cfg.name} int8 static")
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
    instance once per layer of every prefill-chunk forward where
    `kernel_variant` sends the chunk there (a head dim the tile instance
    takes); the other kernels never."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        kernel_variant)
    counts = run["counts"]
    launches = counts.get("paged_attention", 0)
    by_variant = {v: counts.get(f"paged_attention.{v}", 0)
                  for v in PA_VARIANTS}
    want = cfg.n_layers * run["n_forwards"]
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    n_prefill = run["n_prefill_forwards"]
    want_tile = cfg.n_layers * n_prefill * (
        kernel_variant(g, PREFILL_CHUNK, hd) == "tile")
    log(f"  {label}: paged_attention launches {launches} = {cfg.n_layers} "
        f"layers x {run['n_forwards']} forwards? {launches == want}; tile "
        f"{by_variant['tile']} = {want_tile} ({cfg.n_layers} x {n_prefill} "
        f"prefill-chunk forwards at G {g}, Dh {hd} where the tile instance "
        f"takes them)? {by_variant['tile'] == want_tile}; rows "
        f"{by_variant['rows']}; sc_matmul {counts.get('sc_matmul', 0)}, "
        f"flash_attention {counts.get('flash_attention', 0)}")
    if launches != want or by_variant["tile"] != want_tile or \
            not n_prefill or sum(by_variant.values()) != launches:
        raise AssertionError(f"{label}: paged_attention launches "
                             f"{by_variant}, want {want} of which tile "
                             f"{want_tile}")
    if counts.get("sc_matmul", 0) or counts.get("flash_attention", 0) \
            or counts.get("sc_quantize", 0):
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
    if counts.get("paged_attention", 0) or counts.get("sc_matmul", 0) \
            or counts.get("sc_quantize", 0):
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
    hold_quantize(run["counts"], "qwen2_moe_a2_7b int8 engine")
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


def recurrent_static(cfg, model, n_attn: int) -> dict:
    """`--mode static` at batch 8, prompt 1024, gen 32: flash_attention
    once for each of the `n_attn` attention invocations of every forward
    (zamba2's shared block; rwkv6 has none), in the instance
    `kernel_variant` gives the path's calls (`flash_want`: zamba2's
    prefill at D 112 in the tile instance, its decodes in the rows
    instance), the other kernels never."""
    import torch
    static_run(cfg, model, batch=8, prompt_len=64, gen_len=2)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    run = static_run(cfg, model, batch=8, prompt_len=1024, gen_len=32)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = run["counts"]
    step_ms = run["decode_s"] / 32 * 1e3
    want = {}
    if n_attn:
        by_variant = flash_want(cfg, 1024, 32, torch.bfloat16, n_attn)
        want = {"flash_attention": n_attn * 33,
                **{f"flash_attention.{v}": n for v, n in by_variant.items()
                   if n}}
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
            != {"sc_matmul", "sc_quantize"}:
        raise AssertionError(f"rwkv6 int8 drain launches {run['counts']}, "
                             f"want sc_matmul {want}, sc_quantize twice "
                             f"that, and nothing else")
    hold_quantize(run["counts"], "rwkv6_3b int8 engine")
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
                   "artemis_tile_kernel", "artemis_level_scan_kernel",
                   "mxu_epilogue")
# sc_quantize's kernels, launched from its C entry (no torch op encloses
# them): the quantize/cast group by name
QUANT_KERNEL_NAMES = ("sc_quantize",)
FA_KERNEL_NAMES = ("flash_attention_kernel", "flash_attention_tile_kernel",
                   "flash_attention_split_kernel",
                   "flash_attention_merge_kernel")


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
               *([(am, "quantize_int8", "quantize")]
                 if hasattr(am, "quantize_int8") else []),
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
    exact f32 product) or elementwise (casts, dequantize); a product's
    kernel that the profiler hangs from a runtime call rather than from
    the product's op is filed by its name (`device_time_by_group`)."""
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
    and sc_quantize (in quantize/cast) count their kernels by name,
    which no torch op launches, and a GEMM kernel the profiler files
    under a runtime call in a quantized entry goes to the STE's exact
    product by its name; the other groups take each operator's
    kernels by `_op_group`; "other" is the rest of the device time. The
    device rows named after a scope are the profiler's spans of those
    ranges on the device timeline, not kernels: they are left out."""
    from torch.autograd import DeviceType
    total = 0.0
    groups = {"sc_matmul": 0.0, "quantize/cast": 0.0}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type != DeviceType.CUDA or us <= 0 \
                or evt.key in PROFILE_SCOPES:
            continue
        total += us
        if any(k in evt.key for k in SC_KERNEL_NAMES):
            groups["sc_matmul"] += us
        elif any(k in evt.key for k in QUANT_KERNEL_NAMES):
            groups["quantize/cast"] += us
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        group = _op_group(evt)
        if group in ("sc_matmul", "other"):
            continue
        for kern in evt.kernels:
            if any(k in kern.name for k in SC_KERNEL_NAMES
                   + QUANT_KERNEL_NAMES):
                continue
            if group == "quantize/cast" and "gemm" in kern.name:
                kern_group = "STE exact product"
            else:
                kern_group = group
            groups[kern_group] = groups.get(kern_group, 0.0) + kern.duration
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
# phases 28 and 29: the multimodal and recurrent configs
TRAIN_STEPS_NEW = (("exact", 3), ("int8", 2))
# zamba2_7b's f32 weights, gradients and AdamW moments take 100.6 GiB at
# 81 layers; 27 keep 4 shared invocations (period 6) and the 3-layer
# tail, 2.540 B parameters
ZAMBA2_TRAIN_LAYERS = 27
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
# zamba2's SSD state carries a flipped value through the rest of its
# sequence, and its small leaves (norm scales, conv biases) sum gradients
# that nearly cancel: measured 0.35 (norm.scale) through 7 layers on an
# H100 with this seed, where `TIE_DISTANCE` shows every flip of the
# first products at a tie
TRAIN_PIN_INT8_GRAD = {"zamba2": 0.5}
# a value quantized apart on the card and on the CPU must sit this close
# to a rounding tie k + 1/2 (in quantization steps): f32 activations
# that agree to a few ulps move x / scale (at most 127) by about 1e-5
TIE_DISTANCE = 1e-3
# the first products of a step, whose inputs differ between the devices
# by last bits only (later ones see the flips of earlier ones)
TIE_PRODUCTS = 2


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


def train_step_launches(cfg) -> int:
    """sc_matmul launches of one quantized train step with remat: every
    product through the policy in the forward, and again in the
    recompute of each rematerialized layer (all layers; zamba2's Mamba2
    layers but not its shared block)."""
    if cfg.family == "rwkv6":
        return 2 * RWKV6_LAYER_PRODUCTS * cfg.n_layers
    if cfg.family == "zamba2":
        n_inv = cfg.n_layers // cfg.shared_attn_period
        return 2 * 2 * cfg.n_layers + dense_projections(cfg) * n_inv
    return 2 * dense_projections(cfg) * cfg.n_layers


def train_full_width(cfg, n_layers: int = TRAIN_LAYERS,
                     plan=TRAIN_STEPS, roofline: dict | None = None) -> dict:
    """Phases 23, 28 and 29: one model of `n_layers` layers of a
    full-width config (f32 master weights, bf16 compute, remat) trained
    through `make_train_step` on `make_batch` batches (internvl's carry
    its 256-token image prefix), the steps of `plan` on the same model.
    The launch counts are zeroed once, before the first step, and each
    step's launches read as the difference around it: sc_matmul
    `train_step_launches` a quantized step (qwen3_8b: 7 projections a
    layer forward, 7 in the recompute), none an exact one, and the
    attention kernels never; the phase's totals must be the sums. With
    `roofline` (phase 34), one more exact step is counted on the model
    once the plan's steps are done (`roofline_train`), its results and
    seconds put there."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    from repro_torch.optim import OptimizerConfig, adamw_init
    tcfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_steps = sum(n for _, n in plan)
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
    depth = (f"{n_layers} of {cfg.n_layers} layers (reduced: depth)"
             if n_layers < cfg.n_layers else f"{n_layers} layers")
    log(f"  {cfg.name}: {depth}, f32 master weights, bf16 compute: "
        f"{n_params / 1e9:.3f} B parameters; weights and AdamW state "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    want_sc = train_step_launches(tcfg)
    runs, step, adamw_ms = {}, 0, []
    reset_launch_counts()
    with adamw_timer(adamw_ms):
        for mode, n in plan:
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
    hold_quantize(counts, f"{cfg.name} train ({n_layers} layers)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    bound_ms = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    adamw_med = statistics.median(adamw_ms[1:] or adamw_ms)
    log(f"  AdamW update: median {adamw_med:.2f} ms (first "
        f"{adamw_ms[0]:.2f}) against its byte bound {bound_ms:.2f} ms "
        f"({ADAMW_BYTES_PER_PARAM} B x {n_params / 1e9:.3f} B parameters at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak device memory "
        f"{peak:.2f} GiB")
    if roofline is not None:
        t = time.perf_counter()
        roofline.update(roofline_train(tcfg, model, opt, opt_cfg, batch))
        roofline["seconds"] = time.perf_counter() - t
    del model, opt, metrics
    free()
    return dict(config=f"{cfg.name} full width, {depth}, f32 master "
                       f"weights, bf16 compute, batch {TRAIN_BATCH} x seq "
                       f"{TRAIN_SEQ}, remat",
                reduced=({"n_layers": [cfg.n_layers, n_layers]}
                         if n_layers < cfg.n_layers else {}),
                n_params=n_params, runs=runs, peak_gib=peak,
                adamw_ms=adamw_med, adamw_ms_all=adamw_ms,
                adamw_bound_ms=bound_ms, launches=total_sc,
                launches_per_quantized_step=want_sc)


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


@contextlib.contextmanager
def first_quantized_activations(into: list, first: int = TIE_PRODUCTS):
    """Records (x / scale, the int8 values) of the activations of the
    first `first` quantized products `artemis_matmul` makes inside the
    block (on the host), through the name it calls."""
    import importlib
    am = importlib.import_module("repro_torch.core.artemis_matmul")
    real = am._quantize_pair

    def recording(a, b, policy, b_absmax=None, a_absmax=None):
        out = real(a, b, policy, b_absmax, a_absmax)
        if len(into) < first:
            into.append(((a.detach() / out[2].detach()).float().cpu(),
                         out[0].cpu()))
        return out

    am._quantize_pair = recording
    try:
        yield into
    finally:
        am._quantize_pair = real


def flips_at_ties(card: list, host: list) -> tuple[int, int, float]:
    """(int8 activations that differ, of how many, the largest distance
    of a differing one's host x / scale from a tie k + 1/2)."""
    import torch
    n_diff = n_all = 0
    worst = 0.0
    for (_, qc), (rh, qh) in zip(card, host):
        diff = qc != qh
        n_diff += int(diff.sum())
        n_all += diff.numel()
        if diff.any():
            r = rh[diff]
            worst = max(worst, float((r - torch.floor(r) - 0.5).abs().max()))
    return n_diff, n_all, worst


def _grad_errors(grads, ref) -> list[tuple[float, str]]:
    """(max |g - ref| over max |ref|, name) per leaf, largest first."""
    out = []
    for name, g in ref.items():
        err = float((grads[name].to(g.device) - g).abs().max()
                    / g.abs().max().clamp_min(1e-30))
        out.append((err, name))
    return sorted(out, reverse=True)


def train_pin(cfg, n_layers: int = 2) -> dict:
    """Phases 24a, 28 and 29: the card against the CPU. One step's loss
    and gradients (`launch.steps.loss_and_grads`, the train step's
    forward and backward) at the full width through `n_layers` layers
    (zamba2: 7, one shared invocation and a 1-layer tail), f32 compute,
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
    pcfg = dataclasses.replace(cfg, n_layers=n_layers,
                               compute_dtype="float32")
    log(f"  {cfg.name} through {n_layers} layers:")
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
        acts_c, acts_h = [], []
        with first_quantized_activations(acts_c):
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
        with first_quantized_activations(acts_h):
            loss_h, _, grads_h = steps.loss_and_grads(host, pcfg, batch,
                                                      policy)
        host_s = time.perf_counter() - t
        rel = abs(loss_c - float(loss_h)) / abs(float(loss_h))
        errs = _grad_errors(grads_c, grads_h)
        log(f"  {mode:5s}: loss card {loss_c:.7f} CPU {float(loss_h):.7f} "
            f"({rel:.2e} relative); the farthest gradients "
            f"{[(n, f'{e:.2e}') for e, n in errs[:6]]}; leaves past "
            f"1e-4: {sum(e > 1e-4 for e, _ in errs)} of {len(errs)}; card "
            f"{card_s:.1f} s, CPU {host_s:.1f} s")
        tol = dict(TRAIN_PIN_TOL[mode])
        if mode != "exact":
            tol["grad_of_max"] = TRAIN_PIN_INT8_GRAD.get(
                cfg.family, tol["grad_of_max"])
            n_diff, n_all, dist = flips_at_ties(acts_c, acts_h)
            log(f"  {mode:5s}: the first {len(acts_c)} products' int8 "
                f"activations: {n_diff} of {n_all} quantized apart on the "
                f"card and the CPU, each within {dist:.1e} of a tie (bound "
                f"{TIE_DISTANCE})")
            if len(acts_c) != TIE_PRODUCTS or dist > TIE_DISTANCE:
                raise AssertionError(f"{mode}: an int8 activation parts "
                                     f"from the CPU's {dist:.2e} from a tie")
        if rel > tol["loss_rel"] or errs[0][0] > tol["grad_of_max"]:
            raise AssertionError(f"{mode}: the card's step parts from the "
                                 f"CPU's: loss {rel:.2e}, {errs[0]} ({tol})")
        out[mode] = dict(loss_card=loss_c, loss_cpu=float(loss_h),
                         loss_rel=rel, grad_of_max=errs[0][0],
                         worst_leaf=errs[0][1], tol=tol)
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


# ---------------------------------------------------------------------------
# phase 25: the rest of the ARTEMIS arithmetic and the paper's scripts
# ---------------------------------------------------------------------------

# Table V's readout noise: sigma with E|N(0, sigma)| = the paper's MAE
ACC_SIGMA = 0.0085 / math.sqrt(2.0 / math.pi)
# the noise-calibrated ACC row's MAE of the reference's Table V script
# (benchmarks/table5_calibration.py on the CPU)
REF_NOISY_ACC_MAE = 0.00859


def _port_script(path: str):
    """A port script of the checkout, imported by its path."""
    import importlib.util
    full = ROOT / path
    spec = importlib.util.spec_from_file_location(f"_{full.stem}", full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_vs_host(card, host) -> dict:
    """max |card - host|, how many of the values differ and (`apart`)
    the differences where they do."""
    diff = (card.cpu() - host).abs()
    return dict(max_abs_err=float(diff.max()), n_differ=int((diff > 0).sum()),
                n=diff.numel(), apart=diff[diff > 0])


def table5_on_card() -> dict:
    """Table V's counterpart on the card against the same script on the
    CPU: MUL and ACC equal, A_to_B and Softmax MAE within 1e-6 (with
    the count of values that differ), the noise-calibrated ACC row
    within 1e-4 of the CPU's and of the reference's."""
    from repro_torch import prng
    from repro_torch.core import MomcapConfig, artemis_softmax, \
        readout_quantize
    t5 = _port_script("benchmarks/torch_table5_calibration.py")
    card = {r["block"]: r for r in t5.run("cuda")}
    host = {r["block"]: r for r in t5.run("cpu")}
    for block in ("Stochastic MUL", "Analog ACC"):
        if (card[block]["mae"], card[block]["max"]) != \
                (host[block]["mae"], host[block]["max"]):
            raise AssertionError(f"Table V {block}: card {card[block]} "
                                 f"CPU {host[block]}")
    for block in ("A_to_B", "Softmax"):
        if abs(card[block]["mae"] - host[block]["mae"]) > 1e-6:
            raise AssertionError(f"Table V {block}: card {card[block]} "
                                 f"CPU {host[block]}")
    noisy = "Analog ACC (noise-calibrated)"
    if abs(card[noisy]["mae"] - host[noisy]["mae"]) > 1e-4 or \
            abs(card[noisy]["mae"] - REF_NOISY_ACC_MAE) > 1e-4:
        raise AssertionError(f"Table V {noisy}: card {card[noisy]} CPU "
                             f"{host[noisy]}, reference MAE "
                             f"{REF_NOISY_ACC_MAE}")
    # the values behind the two MAEs that may part
    cfg = MomcapConfig(acc_depth=20, readout_bits=8)
    grid = [t5.linspace_f32(0.0, cfg.full_scale, 100001, d)
            for d in ("cuda", "cpu")]
    a_to_b = _card_vs_host(readout_quantize(grid[0], cfg),
                           readout_quantize(grid[1], cfg))
    ys = [prng.normal(prng.PRNGKey(1, d), (64, 64)) * 4.0
          for d in ("cuda", "cpu")]
    softmax = _card_vs_host(artemis_softmax(ys[0]), artemis_softmax(ys[1]))
    a_to_b.pop("apart")
    softmax.pop("apart")
    for block, row in card.items():
        log(f"  {block:30s} card MAE {row['mae']:.8f} max {row['max']:.8f} "
            f"{row['calib_bits']:.2f} bits | CPU MAE "
            f"{host[block]['mae']:.8f} max {host[block]['max']:.8f}")
    log(f"  values that differ, card against CPU: A_to_B {a_to_b}, "
        f"Softmax {softmax}")
    return dict(card=card, cpu=host, a_to_b_values=a_to_b,
                softmax_values=softmax)


def normals_on_card() -> dict:
    """prng.normal on the card against the CPU over 2**20 draws: within
    2 ulps, with the share that differs."""
    import torch
    from repro_torch import prng
    shape = (1 << 20,)
    card = prng.normal(prng.PRNGKey(7, "cuda"), shape).cpu()
    host = prng.normal(prng.PRNGKey(7), shape)
    ulps = (card.view(torch.int32).long()
            - host.view(torch.int32).long()).abs()
    out = dict(max_ulps=int(ulps.max()),
               share_differ=float((ulps > 0).double().mean()))
    log(f"  prng.normal, 2**20 draws: max {out['max_ulps']} ulps, "
        f"{out['share_differ']:.6%} differ")
    if out["max_ulps"] > 2:
        raise AssertionError(f"prng.normal parts from the CPU's: {out}")
    return out


def _stored_level(fn, lo: float, hi: float, device) -> float:
    """One stored-output level (8 bits) of `binned_apply`'s 256-entry
    table of fn over [lo, hi]: the table's span over 255."""
    import torch
    from repro_torch.core import binned_apply
    grid = torch.linspace(lo, hi, 256, device=device)
    table = binned_apply(fn, grid, lo, hi)
    return float(table.max() - table.min()) / 255


def luts_on_card(cfg) -> dict:
    """artemis_softmax at qwen3_8b's decode score shape (8 x heads x 1 x
    1040) and lut_activation("silu") at a d_ff row block (8 x d_ff),
    card against CPU: the same arithmetic on both, but a row's sum adds
    in another order on the card, which can move a ln-LUT lookup at a
    tie, so at most 0.1 % of the values may part, each by one stored
    level of its output LUT (counted)."""
    from repro_torch import prng, xla_math
    from repro_torch.core import artemis_softmax, lut_activation
    from repro_torch.core.lut import ACTIVATIONS, EXP_LUT_FLOOR
    out = {}
    score = (8, cfg.n_heads, 1, 1040)
    ys = [prng.normal(prng.PRNGKey(21, d), score) * 3.0
          for d in ("cuda", "cpu")]
    host = artemis_softmax(ys[1])
    # the last exp LUT's range: [max(lo - ln n, floor), 0], lo the
    # tensor-wide minimum of the shifted scores (at most -1)
    shifted = ys[1] - ys[1].amax(dim=-1, keepdim=True)
    lo = min(float(shifted.min()), -1.0) - math.log(score[-1])
    out["artemis_softmax"] = dict(
        _card_vs_host(artemis_softmax(ys[0]), host),
        level=_stored_level(xla_math.exp, max(lo, EXP_LUT_FLOOR), 0.0,
                            "cpu"))
    xs = [prng.normal(prng.PRNGKey(22, d), (8, cfg.d_ff)) * 2.0
          for d in ("cuda", "cpu")]
    host = lut_activation(xs[1], "silu")
    m = max(float(xs[1].abs().max()), 1e-6)
    out["lut_silu"] = dict(_card_vs_host(lut_activation(xs[0], "silu"),
                                         host),
                           level=_stored_level(ACTIVATIONS["silu"], -m, m,
                                               "cpu"))
    apart = {k: v.pop("apart") for k, v in out.items()}
    log(f"  artemis_softmax {score}: {out['artemis_softmax']}; "
        f"lut_activation silu (8, {cfg.d_ff}): {out['lut_silu']}")
    for k, v in out.items():
        if v["n_differ"] > v["n"] // 1000 or \
                bool(((apart[k] - v["level"]).abs()
                      > 1e-3 * v["level"]).any()):
            raise AssertionError(
                f"{k} on the card parts from the CPU in more than 0.1 % "
                f"of the values, or by other than one stored level: {v}, "
                f"differences {apart[k][:8].tolist()}")
    return out


def noisy_artemis_on_card(cfg) -> dict:
    """A noisy artemis product at M 8 x d_model x d_ff (Table V's
    sigma), card against CPU: a readout may part by one level where the
    noise lands on a rounding tie (counted); no sc_matmul launch across
    it, while the noiseless product on the same operands launches it
    once."""
    import torch
    from repro_torch import prng
    from repro_torch.core import ArithmeticPolicy, artemis_matmul
    from repro_torch.core.quantization import quant_scale
    from repro_torch.kernels import launch_counts, reset_launch_counts
    k, n = cfg.d_model, cfg.d_ff
    # drawn on the card (phase 25's normals equal the CPU's bit for bit)
    a_c = prng.normal(prng.PRNGKey(31, "cuda"), (8, k))
    b_c = prng.normal(prng.PRNGKey(32, "cuda"), (k, n)) * (
        1.0 / math.sqrt(k))
    a, b = a_c.cpu(), b_c.cpu()
    key = prng.PRNGKey(33)
    pol = ArithmeticPolicy(mode="artemis", ste=False, sigma_analog=ACC_SIGMA)
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = artemis_matmul(a_c, b_c, pol, key=key.cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    noisy_launches = dict(launch_counts)
    if noisy_launches.get("sc_matmul", 0):
        raise AssertionError(f"the noisy product launched {noisy_launches}")
    hold_quantize(noisy_launches, "noisy artemis product", noisy_products=1)
    t = time.perf_counter()
    host = artemis_matmul(a, b, pol, key=key)
    host_s = time.perf_counter() - t
    reset_launch_counts()
    quiet = artemis_matmul(a_c, b_c, ArithmeticPolicy(mode="artemis",
                                                      ste=False))
    torch.cuda.synchronize()
    quiet_launches = dict(launch_counts)
    if quiet_launches.get("sc_matmul", 0) != 1:
        raise AssertionError(f"the noiseless product launched "
                             f"{quiet_launches}, want sc_matmul once")
    hold_quantize(quiet_launches, "noiseless artemis product")
    level = float(20 * 127 / 255 * 128 * quant_scale(a) * quant_scale(b))
    out = _card_vs_host(card, host)
    apart = out.pop("apart")
    parted = apart[apart > 1e-3 * level]
    out.update(level=level, card_s=card_s, cpu_s=host_s,
               sc_matmul_launches=noisy_launches.get("sc_matmul", 0),
               noiseless_sc_matmul_launches=quiet_launches.get(
                   "sc_matmul", 0),
               noise_moved=float((card.cpu() - quiet.cpu()).abs().mean()))
    log(f"  noisy artemis (8, {k}) x ({k}, {n}), sigma {ACC_SIGMA:.6f}: "
        f"{out['n_differ']} of {out['n']} outputs part from the CPU's "
        f"(max {out['max_abs_err']:.3g}, one level = {level:.3g}); card "
        f"{card_s:.2f} s, CPU {host_s:.2f} s; sc_matmul launches: noisy "
        f"0, noiseless {out['noiseless_sc_matmul_launches']}; mean |noisy - "
        f"noiseless| {out['noise_moved']:.4g}")
    if len(parted) > max(1, card.numel() // 1000) or \
            bool(((parted - level).abs() > 1e-3 * level).any()):
        raise AssertionError(f"the noisy product parts from the CPU's by "
                             f"more than a level at a tie: {out}")
    return out


def kernel_micro_on_card() -> dict:
    """`benchmarks/torch_kernel_micro.py` on the card: every row held
    against its plain version (and flash's against the oracle) within
    2e-4, µs per call printed; its launches are comparisons, counted
    apart from the paths'."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    km = _port_script("benchmarks/torch_kernel_micro.py")
    reset_launch_counts()
    rows = km.run("cuda")
    return dict(rows=rows, launches=dict(launch_counts))


@contextlib.contextmanager
def attention_held(into: dict):
    """Every flash_attention and paged_attention call made inside the
    block, through the names the model's layers and the paged backend
    call: the wrapper runs as it is (its launch counted), then its
    output is held against the plain version on the same inputs within
    FA_TOL / PA_TOL. into[kernel] gets the calls held and the largest
    error."""
    import importlib
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import effective_tiles
    from repro_torch.kernels.paged_attention import paged_attention_ref
    layers = importlib.import_module("repro_torch.models.layers")
    paged = importlib.import_module("repro_torch.serve.paged_model")
    real_fa, real_pa = layers.flash_attention, paged.paged_attention
    for name in ("flash_attention", "paged_attention"):
        into[name] = dict(calls=0, max_abs_err=0.0)

    def hold(name, out, ref, tol):
        err = (out.float() - ref).abs()
        if not bool(torch.isfinite(out).all()) or bool(
                (err > tol["atol"] + tol["rtol"] * ref.abs()).any()):
            raise AssertionError(
                f"{name} at {tuple(out.shape)} disagrees with its plain "
                f"version on a walkthrough's inputs: max err "
                f"{err.max().item():.3e}")
        into[name]["calls"] += 1
        into[name]["max_abs_err"] = max(into[name]["max_abs_err"],
                                        err.max().item())

    def fa(q, k, v, **kw):
        out = real_fa(q, k, v, **kw)
        bq, bk = effective_tiles(q.shape[2], k.shape[2], kw.pop("bq", 128),
                                 kw.pop("bk", 128))
        lse = kw.pop("return_lse", False)
        ref = flash_attention_ref(q, k, v, bq=bq, bk=bk, **kw)[0]
        hold("flash_attention", out[0] if lse else out, ref, FA_TOL)
        return out

    def pa(q, k_pages, v_pages, block_tables, positions, **kw):
        out = real_pa(q, k_pages, v_pages, block_tables, positions, **kw)
        kw.pop("variant", None)
        hold("paged_attention", out, paged_attention_ref(
            q, k_pages, v_pages, block_tables, positions, **kw), PA_TOL)
        return out

    layers.flash_attention, paged.paged_attention = fa, pa
    try:
        yield into
    finally:
        layers.flash_attention, paged.paged_attention = real_fa, real_pa


def examples_on_card(path_sc: set) -> dict:
    """The three walkthroughs on the card, each with the launch counts
    zeroed just before and read just after: quickstart's artemis_mxu
    forward runs sc_matmul (the example zeroes the counts just before
    that forward and reads them after), its shapes recorded into
    path_sc for phase 16; serve_batched's static path runs
    flash_attention and serve_engine's paged path paged_attention, each
    call held against the plain version on the same inputs
    (`attention_held`)."""
    import runpy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out = {}
    held = {}
    with sc_path_shapes(path_sc), attention_held(held):
        reset_launch_counts()
        qs = _port_script("examples/torch_quickstart.py").main("cuda")
        out["quickstart"] = dict(launches=dict(launch_counts),
                                 forward_sc_matmul=qs["sc_matmul_launches"],
                                 logits_drift=qs["logits_drift"])
        if not 0 < qs["sc_matmul_launches"] <= launch_counts["sc_matmul"]:
            raise AssertionError(f"quickstart's artemis_mxu forward: {qs}")
        hold_quantize(out["quickstart"]["launches"],
                      "examples/torch_quickstart.py artemis_mxu forward")
        for name, kernel in (("serve_batched", "flash_attention"),
                             ("serve_engine", "paged_attention")):
            argv = sys.argv
            sys.argv = [f"examples/torch_{name}.py", "--device", "cuda"]
            before = held[kernel]["calls"]
            reset_launch_counts()
            try:
                runpy.run_path(str(ROOT / "examples" / f"torch_{name}.py"),
                               run_name="__main__")
            finally:
                sys.argv = argv
            out[name] = dict(launches=dict(launch_counts))
            if not launch_counts[kernel] or \
                    held[kernel]["calls"] - before != launch_counts[kernel]:
                raise AssertionError(
                    f"{name} launched {dict(launch_counts)}, want {kernel}, "
                    f"each call held ({held[kernel]})")
    log(f"  launches: {[(k, v['launches']) for k, v in out.items()]}; held "
        f"against the plain versions on the same inputs: {held}")
    out["held"] = held
    return out


# ---------------------------------------------------------------------------
# phases 30-32: tensor-parallel serving, 2 ranks sharing the one card
# ---------------------------------------------------------------------------

MESH_N = 2
# a token that parts the sharded int8 drain from the single-device one
# passes only where the single-device logits' top-2 margin is below this
# share of their largest magnitude (a near tie)
NEAR_TIE = 1e-3
# attention of the dataflow cores against one device's, f32
MESH_ATTN_TOL = 1e-5


def mesh_ecfg() -> dict:
    """Workload 1's engine geometry (`engine_config`), gather core."""
    return dict(page_size=8, n_pages=512, max_batch=8, max_pages_per_seq=37,
                prefill_chunk=32)


def warm_trace():
    """One request, a 32-token prompt and 2 new tokens: the warm-up of a
    rank's first drain (cuBLAS handles, the kernels' libraries)."""
    import numpy as np
    from repro_torch.serve import TraceItem
    return [TraceItem(0.0, np.arange(2, 34, dtype=np.int32), 2)]


def mesh_rank(device, jobs: list) -> list:
    """One rank of phases 30-32 (`launch.mesh.spawn` runs it in each
    rank; the rank imports this script by name). Each job is a drain
    over the group: the rank draws its part of `modellib.init(cfg,
    0)`'s weights leaf by leaf, optionally warms up on a 2-token
    request, then drains the job's trace, counts zeroed just before
    and read just after, recording sc_matmul's shapes; or a
    mesh_cases case as given."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.launch import mesh_cases
    out = []
    for job in jobs:
        if "case" in job:
            out.append(mesh_cases.run(device, [job["case"]])[0])
            continue
        cfg, policy = job["cfg"], job["policy"]
        t0 = time.perf_counter()
        params = mesh_cases.params_for(cfg, ("seed", 0),
                                       ArithmeticPolicy(mode=policy), device)
        torch.cuda.synchronize(device)
        build_s = time.perf_counter() - t0
        kw = dict(cfg=cfg, weights=("model", params), ecfg=mesh_ecfg(),
                  policy=policy)
        if job.get("warm"):
            mesh_cases.drain(device, trace=warm_trace(), **kw)
        shapes: set = set()
        with sc_path_shapes(shapes):
            run = mesh_cases.drain(device, trace=job["trace"], **kw)
        run.update(sc_shapes=shapes, build_s=build_s,
                   n_params=sum(p.numel() for p in params.parameters()))
        del params, kw
        gc.collect()
        torch.cuda.empty_cache()
        out.append(run)
    return out


def mesh_spawn(jobs: list, n: int = MESH_N) -> list:
    """Run `jobs` in n ranks on the card; {rank: results}. Raises where a
    rank failed."""
    from repro_torch.launch import mesh as meshlib
    gc.collect()
    free()
    log(f"  transport: {meshlib.transport_line(n, 'cuda')}")
    t0 = time.perf_counter()
    per_rank = meshlib.spawn(mesh_rank, n, jobs, device="cuda")
    log(f"  {n} ranks ran {len(jobs)} jobs in "
        f"{time.perf_counter() - t0:.1f} s (process start included)")
    return per_rank


def single_drain(cfg, trace, policy: str) -> dict:
    """The same drain on one device, in this process (the reference the
    ranks are held against)."""
    from repro_torch.launch import mesh_cases
    run = mesh_cases.drain("cuda", cfg=cfg, weights=("seed", 0),
                           trace=trace, ecfg=mesh_ecfg(), policy=policy)
    gc.collect()
    free()
    return run


def check_mesh_drain(label: str, runs: list, trace, cfg,
                     want: dict | None = None) -> dict:
    """Every rank's drain of `trace`: all requests done with valid tokens,
    every rank's tokens the same, and equal to `want`'s (a single-device
    drain) where given. Logs tok/s, wall, forwards and each rank's peak."""
    r0 = runs[0]
    for run in runs:
        if run["tokens"] != r0["tokens"]:
            raise AssertionError(f"{label}: rank {run['rank']}'s tokens "
                                 f"differ from rank 0's")
    if r0["metrics"]["n_done"] != len(trace):
        raise AssertionError(f"{label}: {r0['metrics']['n_done']} of "
                             f"{len(trace)} requests done")
    for rid, item in enumerate(trace):
        toks = r0["tokens"][rid]
        if len(toks) != item.max_new_tokens or min(toks) < 0 or \
                max(toks) >= cfg.padded_vocab:
            raise AssertionError(f"{label}: request {rid}: bad tokens")
    n_tok = r0["metrics"]["n_generated_tokens"]
    wall = max(run["wall_s"] for run in runs)
    log(f"  {label}: {n_tok} tokens in {wall:.3f} s wall "
        f"({n_tok / wall:.2f} tok/s; {r0['n_forwards']} forwards, "
        f"{wall / r0['n_forwards'] * 1e3:.1f} ms each); peak GiB by rank "
        f"{[round(run.get('peak_gib', 0.0), 2) for run in runs]}; each "
        f"rank's part "
        f"drawn in {[round(run['build_s'], 1) for run in runs]} s "
        f"({r0['n_params'] / 1e9:.3f} B parameters a rank)")
    out = dict(tok_s=n_tok / wall, wall_s=wall, n_tokens=n_tok,
               n_forwards=r0["n_forwards"],
               peak_gib=[run.get("peak_gib") for run in runs],
               launches=[run["counts"].get("sc_matmul", 0) for run in runs])
    if want is not None:
        same = r0["tokens"] == want["tokens"]
        log(f"  {label}: tokens equal the single-device drain's over "
            f"{n_tok} tokens? {same}")
        out.update(equal_single=same)
        if not same:
            out.update(parted=parted_at_near_ties(label, r0, want))
    return out


def parted_at_near_ties(label, run, want) -> list:
    """Where the ranks' tokens part from the single device's: each
    request's first differing token must be a near tie of the
    single-device logits (top-2 margin below NEAR_TIE of their scale);
    what follows it in that request is a different continuation."""
    parted = []
    for rid, toks in want["tokens"].items():
        got = run["tokens"][rid]
        j = next((i for i, (a, b) in enumerate(zip(toks, got)) if a != b),
                 None)
        if j is None:
            continue
        margin = want["margins"][rid][j]
        log(f"  {label}: request {rid} parts at its token {j} "
            f"({got[j]} vs {toks[j]}); the single-device logits' top-2 "
            f"margin there {margin:.3e} of their scale")
        parted.append(dict(request=rid, token=j, margin=margin))
        if margin >= NEAR_TIE:
            raise AssertionError(f"{label}: request {rid} parts at token "
                                 f"{j}, no near tie (margin {margin:.3e})")
    return parted


def mesh_qwen3(cfg, path_sc: set) -> dict:
    """Phase 30: qwen3_8b at full width over 2 ranks (8 KV heads, 4 a
    rank: the pool split on heads)."""
    from repro_torch.launch import mesh as meshlib
    log(f"  card: {card_line()}")
    short = short_trace(cfg)
    single = single_drain(cfg, short, "int8")
    runs = mesh_spawn([
        dict(cfg=cfg, policy="exact", trace=smoke_trace(cfg), warm=True),
        dict(cfg=cfg, policy="int8", trace=short, warm=True)])
    exact = check_mesh_drain("exact, 8 requests", [r[0] for r in runs],
                             smoke_trace(cfg), cfg)
    int8 = check_mesh_drain("int8, 4 requests", [r[1] for r in runs], short,
                            cfg, want=single)
    for job, label in ((0, "exact"), (1, "int8")):
        for rank, per in enumerate(runs):
            counts = per[job]["counts"]
            want = 7 * cfg.n_layers * per[job]["n_forwards"] \
                if label == "int8" else 0
            log(f"  {label} rank {rank}: sc_matmul launches "
                f"{counts.get('sc_matmul', 0)} = 7 x {cfg.n_layers} x "
                f"{per[job]['n_forwards']} forwards? "
                f"{counts.get('sc_matmul', 0) == want} (want {want}); "
                f"paged_attention {counts.get('paged_attention', 0)}")
            if counts.get("sc_matmul", 0) != want or \
                    counts.get("paged_attention", 0):
                raise AssertionError(f"{label} rank {rank} launched {counts}")
            hold_quantize(counts, f"qwen3_8b sharded {label} engine (rank "
                                  f"{rank})")
            path_sc |= per[job]["sc_shapes"]
    shard_shapes = sorted({key[:3] for per in runs
                           for key in per[1]["sc_shapes"]
                           if key[0] != "quantize"})
    log(f"  int8 shard shapes (M, K, N): {shard_shapes}")
    return dict(exact=exact, int8=int8, shard_shapes=shard_shapes,
                transport=meshlib.transport_line(MESH_N, "cuda"))


def attention_inputs(cfg, gen, prefill: bool):
    """qwen3_8b's dataflow-core shapes on workload 1: a decode (8 lanes,
    1 query) or a prefill chunk (8 x 32 queries) over the 296 slots of a
    37-page table, keys at slot positions, lanes 150-270 tokens long."""
    import numpy as np
    import torch
    b, h, kvh, d, smax = 8, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim, 37 * 8
    s = 32 if prefill else 1
    lens = torch.randint(150, 270, (b,), generator=gen)
    pos = (lens[:, None] - s + torch.arange(s)).int()
    kv_pos = torch.arange(smax, dtype=torch.int32)[None].expand(b, smax)

    def rand(*shape):
        return torch.randn(shape, generator=gen).numpy()

    return dict(q=rand(b, s, h, d), k=rand(b, smax, kvh, d),
                v=rand(b, smax, kvh, d), q_positions=pos.numpy(),
                kv_positions=np.ascontiguousarray(kv_pos.numpy()))


def attention_expected(inp):
    """One device's f32 attention over the whole view, on the card."""
    import torch
    from repro_torch.parallel.ring_attention import _chunk_attn, _repeat_kv
    t = {k: torch.from_numpy(v).to("cuda") for k, v in inp.items()}
    k, v = _repeat_kv(t["q"].shape[2], t["k"], t["v"])
    o, _, l = _chunk_attn(t["q"], k, v, t["q_positions"], t["kv_positions"],
                          t["q"].shape[-1] ** -0.5, True)
    return (o / torch.clamp_min(l, 1e-30)[..., None]).cpu().numpy()


def mesh_identities(cfg, gemma) -> dict:
    """Phase 31: f32 token identity through 2 layers (qwen3_8b
    head-partitioned, gemma_2b's one KV head through the dataflow
    cores), the cores at qwen3_8b's shapes, the one-rank NCCL group,
    and a short exact gemma_2b drain at full width."""
    import numpy as np
    import torch
    q2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    g2 = dataclasses.replace(gemma, n_layers=2, compute_dtype="float32")
    singles = {c.name: single_drain(c, smoke_trace(c), "exact")
               for c in (q2, g2)}
    gen = torch.Generator().manual_seed(31)
    attn = {"split_kv decode": ("split_kv", attention_inputs(cfg, gen, False)),
            "ring prefill chunk": ("ring", attention_inputs(cfg, gen, True))}
    expected = {k: attention_expected(inp) for k, (_, inp) in attn.items()}
    cases = [dict(case=("attention", dict(fn=fn, **inp)))
             for fn, inp in attn.values()]
    runs = mesh_spawn([
        dict(cfg=q2, policy="exact", trace=smoke_trace(q2)),
        dict(cfg=g2, policy="exact", trace=smoke_trace(g2)),
        *cases, dict(case=("backend", {})),
        dict(cfg=gemma, policy="exact", trace=short_trace(gemma),
             warm=True)])
    out = {}
    for i, c in enumerate((q2, g2)):
        label = f"{c.name} f32, 2 layers"
        out[c.name] = check_mesh_drain(label, [r[i] for r in runs],
                                       smoke_trace(c), c, want=singles[c.name])
        if not out[c.name]["equal_single"]:
            raise AssertionError(f"{label}: tokens differ from one device's")
    errs = {}
    for j, (name, (fn, _)) in enumerate(attn.items()):
        parts = [r[2 + j] for r in runs]
        got = parts[0] if fn == "split_kv" else np.concatenate(parts, axis=1)
        errs[name] = float(np.abs(got - expected[name]).max())
    log(f"  dataflow cores at qwen3_8b's shapes over {MESH_N} ranks, max "
        f"abs error against one device (f32): {errs}")
    log(f"  the 2-rank group's transport: {runs[0][4]}")
    out["gemma_2b"] = check_mesh_drain(
        f"gemma_2b exact, {gemma.n_layers} layers, 4 requests",
        [r[5] for r in runs],
        short_trace(gemma), gemma)
    one = mesh_spawn([*cases, dict(case=("backend", {}))], n=1)[0]
    nccl = {name: float(np.abs(one[j] - expected[name]).max())
            for j, name in enumerate(attn)}
    log(f"  one-rank group: {one[-1]}; max abs error {nccl}")
    # one card a rank: NCCL
    if one[-1] != "nccl":
        raise AssertionError(f"the one-rank group ran over {one[-1]}")
    worst = max(*errs.values(), *nccl.values())
    if worst > MESH_ATTN_TOL:
        raise AssertionError(f"dataflow cores {worst:.3e} from one device")
    out.update(attention_err=errs, nccl_err=nccl, transport=runs[0][4])
    return out


def mesh_moe(moe_cfg) -> dict:
    """Phase 32: qwen2_moe_a2_7b over 2 ranks (32 of 64 padded experts
    and 2 of 4 shared a rank, 8 of 16 KV heads): a short exact drain at
    full width, then f32 token identity through 2 layers."""
    m2 = dataclasses.replace(moe_cfg, n_layers=2, compute_dtype="float32")
    single = single_drain(m2, smoke_trace(m2), "exact")
    runs = mesh_spawn([
        dict(cfg=moe_cfg, policy="exact", trace=short_trace(moe_cfg),
             warm=True),
        dict(cfg=m2, policy="exact", trace=smoke_trace(m2))])
    full = check_mesh_drain(f"exact, {moe_cfg.n_layers} layers, 4 requests",
                            [r[0] for r in runs], short_trace(moe_cfg),
                            moe_cfg)
    ident = check_mesh_drain("f32, 2 layers", [r[1] for r in runs],
                             smoke_trace(m2), m2, want=single)
    if not ident["equal_single"]:
        raise AssertionError("qwen2_moe f32: tokens differ from one "
                             "device's")
    return dict(full=full, f32=ident)



# ---------------------------------------------------------------------------
# phase 33: the sharded train step, 2 ranks sharing the card
# ---------------------------------------------------------------------------

SHARD_N = 2
SHARD_PIN_LAYERS = 2
SHARD_PIN_BATCH, SHARD_PIN_SEQ = 8, 64
# the optimizer of the pins (the CPU tests'); the runs take phase 23's
SHARD_PIN_OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)
# the bf16 run's depth. Each layer adds 8 B a parameter a rank (f32
# weights, gradients and AdamW moments, halved over the data ranks) and
# about 2.3 GB a step of host-staged gathers and reduce-scatters: the
# phase's time, not the card's memory, sets it (the log prints the
# depth whose peaks would sum below SHARD_MEM_GIB)
SHARD_RUN_LAYERS = 2
SHARD_MEM_GIB = 75.0
# (its steps' ms are the host-staged transfers', so a third exact step
# repeated a timing and checked nothing new)
SHARD_RUN_STEPS = (("exact", 2), ("int8", 2))
# the gradient leaves that phase 33d hands to compressed_psum
SHARD_COMPRESS_LEAVES = ("layers.0.attn.wq", "layers.0.ffn.w_down",
                         "layers.1.ln2.scale", "final_norm.scale")


# this rank's `launch.mesh.rank_mesh` of each mesh shape, built once a
# process (its groups are collective to build, and every job reuses them)
_RANK_MESHES: dict = {}


def _rank_mesh(shape: tuple):
    from repro_torch.launch import mesh as meshlib
    if shape not in _RANK_MESHES:
        _RANK_MESHES[shape] = meshlib.rank_mesh(
            meshlib.make_smoke_mesh(*shape))
    return _RANK_MESHES[shape]


def _shard_cfg(job):
    from repro_torch import configs
    cfg = configs.get_config(job["arch"], smoke=job.get("smoke", False))
    cfg = dataclasses.replace(cfg, n_layers=job["layers"])
    if job.get("f32"):
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return cfg


def _shard_sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _compress_on_card(grads: dict, group) -> dict:
    """Phase 33d: `compressed_psum` in each mode, two steps (the second
    carries the error feedback), on the card and on CPU copies of the
    same gradients over the same group: bit for bit."""
    import torch
    from repro_torch.parallel.compress import (compressed_psum,
                                               init_compression)
    out = {}
    for mode in ("none", "bf16", "int8"):
        res = []
        for dev_grads in (grads, {k: g.cpu() for k, g in grads.items()}):
            state = init_compression(dev_grads, mode)
            steps_out = []
            for _ in range(2):
                mean, state = compressed_psum(dev_grads, state, group)
                steps_out.append((mean, state.error))
            res.append(steps_out)
        same = all(
            torch.equal(a[0][k].cpu(), b[0][k]) and (
                a[1] is None or torch.equal(a[1][k].cpu(), b[1][k]))
            for a, b in zip(*res) for k in grads)
        out[mode] = same
        if not same:
            raise AssertionError(f"compressed_psum {mode}: the card parts "
                                 f"from the CPU")
    return out


@contextlib.contextmanager
def step_gradients(into: dict, ref: dict | None, keep: tuple = ()):
    """Inside the block, each `adamw_update` the train step makes (through
    the name `launch.steps` calls) first records, per leaf, how far the
    rank's gradient block lies from `ref["grads"]` (the same block of one
    card's gradient) over that leaf's max |g| (`ref["gmax"]`), and
    clones the blocks named in `keep`; the update runs as it is."""
    from repro_torch.launch import steps
    real = steps.adamw_update

    def recording(params, grads, *args, **kw):
        if ref is not None:
            into["errs"] = {
                name: float((g - ref["grads"][name]).abs().max()
                            / ref["gmax"][name]) for name, g in grads.items()}
        into["kept"] = {k: grads[k].detach().clone() for k in keep}
        return real(params, grads, *args, **kw)

    steps.adamw_update = recording
    try:
        yield into
    finally:
        steps.adamw_update = real


def one_card_blocks(cfg, batch, pol, opt_cfg, rmesh, device) -> dict:
    """Phase 33a: one card's step on the whole model (the rank alone on
    the card, `loss_and_grads` and `adamw_update` as the unsharded step
    runs them): its loss and metrics, this rank's block of every
    gradient under the sharded step's placement, and each leaf's max
    |g|."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.parallel.sharding import param_shapes
    full = modellib.init(cfg, seed=0, device=device, train=True)
    opt = adamw_init(full)
    loss, _, grads = steps.loss_and_grads(full, cfg, batch, pol)
    grads = dict(grads)
    metrics = adamw_update(full, grads, opt, opt_cfg)
    specs = dp.train_placement(cfg, param_shapes(full), rmesh.mesh, pol)
    out = dict(metrics={k: float(v) for k, v in
                        dict(metrics, loss=loss).items()},
               grads={k: dp.cut(g, specs[k], rmesh).clone()
                      for k, g in grads.items()},
               gmax={k: float(g.abs().max().clamp_min(1e-30))
                     for k, g in grads.items()})
    del full, opt, grads
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def shard_pin(device, job) -> dict:
    """Phase 33a/b on this rank: the sharded step of a full-width config
    through 2 layers at f32 over `make_smoke_mesh(*job["mesh"])`, from
    `modellib.init(cfg, 0)`'s weights (each rank draws its part leaf by
    leaf), on batch 0 of `make_batch` (8 x 64), one `make_train_step`
    step a policy. With `against`, each rank first runs one card's step
    on the whole model in turn (`one_card_blocks`), and the step's
    gradient blocks are held against it (`step_gradients`). Returns the
    step's metrics, launch counts and seconds, and the gradients'
    errors; the parent holds them to `TRAIN_PIN_TOL`."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.parallel.tensor_parallel import named_shards
    cfg, rules = _shard_cfg(job), ShardingRules()
    rmesh = _rank_mesh(tuple(job["mesh"]))
    rank, n = dist.get_rank(), dist.get_world_size()
    opt_cfg = OptimizerConfig(**SHARD_PIN_OPT)
    batch = make_batch(cfg, DataConfig(seq_len=SHARD_PIN_SEQ,
                                       global_batch=SHARD_PIN_BATCH), 0,
                       device=device)
    label = f"{cfg.name} {meshlib.mesh_name(rmesh.mesh)}"
    out = dict(coords=rmesh.coords)
    for mode in job["modes"]:
        pol = ArithmeticPolicy(mode=mode)
        ref = None
        t0 = time.perf_counter()
        if job.get("against", True):
            for turn in range(n):
                if rank == turn:
                    ref = one_card_blocks(cfg, batch, pol, opt_cfg, rmesh,
                                          device)
                dist.barrier()
        one_s = time.perf_counter() - t0
        part = dp.init_rank_model(cfg, rmesh, pol, seed=0, device=device)
        state = adamw_init(named_shards(part))
        step = steps.make_train_step(cfg, opt_cfg, pol, mesh=rmesh,
                                     rules=rules)
        keep = SHARD_COMPRESS_LEAVES if job.get("compress") \
            and mode == "exact" else ()
        seen: dict = {}
        _shard_sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        with step_gradients(seen, ref, keep):
            part, state, metrics = step(part, state, batch)
        _shard_sync(device)
        step_s = time.perf_counter() - t0
        counts = dict(launch_counts)
        if rank == 0:
            log(f"    [{label} {mode}] one card's steps {one_s:.1f} s, the "
                f"sharded step {step_s:.1f} s")
        res = dict(metrics={k: float(v) for k, v in metrics.items()},
                   counts=counts, one_card_s=one_s, step_s=step_s,
                   errs=seen.get("errs"))
        if ref is not None:
            res.update(metrics_one_card=ref["metrics"])
        if keep:
            out["compress"] = _compress_on_card(seen["kept"],
                                                rmesh.group("data"))
        out[mode] = res
        del part, state, ref, seen
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def shard_run(device, job) -> dict:
    """Phase 33c on this rank: full-width qwen3_8b through
    `job["layers"]` layers (f32 master weights, bf16 compute, remat) at
    (data 2), batch 8 x 128 of `make_batch`, the steps of
    SHARD_RUN_STEPS on one model; each step's sc_matmul launches read
    on this rank (counts zeroed just before), its ms, the rank's peak
    memory; sc_matmul's shapes recorded for phase 16."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.parallel.tensor_parallel import named_shards
    cfg = _shard_cfg(job)
    rmesh = _rank_mesh((SHARD_N, 1))
    n_steps = sum(n for _, n in SHARD_RUN_STEPS)
    opt_cfg = OptimizerConfig(total_steps=n_steps,
                              warmup_steps=max(n_steps // 20, 5))
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    part = dp.init_rank_model(cfg, rmesh, seed=0, device=device)
    state = adamw_init(named_shards(part))
    _shard_sync(device)
    build_s = time.perf_counter() - t0
    n_local = sum(p.numel() for p in part.parameters())
    want_sc = 2 * dense_projections(cfg) * cfg.n_layers
    shapes: set = set()
    runs, step = {}, 0
    for mode, n in SHARD_RUN_STEPS:
        fn = steps.make_train_step(cfg, opt_cfg, ArithmeticPolicy(mode=mode),
                                   mesh=rmesh, rules=ShardingRules())
        ms, losses, launches, metrics = [], [], [], []
        for _ in range(n):
            batch = make_batch(cfg, dcfg, step, device=device)
            _shard_sync(device)
            reset_launch_counts()
            t = time.perf_counter()
            with sc_path_shapes(shapes):
                part, state, m = fn(part, state, batch)
            loss = float(m["loss"])
            _shard_sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
            counts = dict(launch_counts)
            # the plain version runs on the CPU (a rehearsal): no launch
            want = 0 if mode == "exact" or device.type != "cuda" else want_sc
            if counts.get("sc_matmul", 0) != want or \
                    counts.get("sc_quantize", 0) != 2 * want or \
                    counts.get("flash_attention", 0) or \
                    counts.get("paged_attention", 0):
                raise AssertionError(f"sharded step {step} ({mode}) "
                                     f"launched {counts}, want sc_matmul "
                                     f"{want}")
            if not math.isfinite(loss):
                raise AssertionError(f"sharded step {step}: loss {loss}")
            losses.append(loss)
            launches.append(counts.get("sc_matmul", 0))
            metrics.append({k: float(v) for k, v in m.items()})
            step += 1
        runs[mode] = dict(ms=ms, losses=losses, launches=launches,
                          metrics=metrics)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else 0.0)
    del part, state
    gc.collect()
    return dict(runs=runs, peak_gib=peak, build_s=build_s,
                n_local_params=n_local, launches_per_int8_step=want_sc,
                sc_shapes=shapes)


def shard_warm(device) -> None:
    """A step of smoke qwen3_8b on this rank alone: every rank loads the
    step's kernels and libraries at once, before the ranks take turns
    with one card's step."""
    import torch
    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    from repro_torch.optim import OptimizerConfig, adamw_init
    for mode in ("exact", "int8"):
        cfg = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                                  compute_dtype="float32")
        model = modellib.init(cfg, seed=0, device=device, train=True)
        steps.make_train_step(cfg, OptimizerConfig())(
            model, adamw_init(model),
            make_batch(cfg, DataConfig(seq_len=16, global_batch=4), 0,
                       device=device))
    _shard_sync(device)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()


def shard_rank(device, jobs: list) -> list:
    """One rank of phases 33 and 35 (`launch.mesh.spawn` runs it in each
    rank; the rank imports this script by name); each job's seconds."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shard_warm(device)
    run = {"pin": shard_pin, "run": shard_run, "tp_static": tp_static}
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        out.append(run[job["kind"]](device, job))
        out[-1]["job_s"] = time.perf_counter() - t0
    return out


def shard_jobs(smoke: bool = False) -> list:
    """Phase 33's jobs: (a) qwen3_8b at (data 2), with (d) on its
    gradients, and at (model 2); (b) qwen2_moe_a2_7b at (data 2); (c)
    the bf16 run."""
    pin = dict(kind="pin", layers=SHARD_PIN_LAYERS, f32=True, smoke=smoke)
    return [dict(pin, arch="qwen3_8b", mesh=(2, 1), modes=("exact", "int8"),
                 compress=True),
            dict(pin, arch="qwen3_8b", mesh=(1, 2), modes=("exact", "int8")),
            dict(pin, arch="qwen2_moe_a2_7b", mesh=(2, 1), modes=("exact",),
                 against=False),
            dict(kind="run", arch="qwen3_8b", layers=SHARD_RUN_LAYERS,
                 smoke=smoke)]


def _ranks_agree(label: str, per_rank: list) -> None:
    for other in per_rank[1:]:
        if other != per_rank[0]:
            raise AssertionError(f"{label}: the ranks' metrics differ: "
                                 f"{per_rank}")


def sharded_train(path_sc: set, smoke: bool = False) -> dict:
    """Phase 33: the sharded train step over 2 ranks sharing the card;
    its ranks then run phase 35's jobs (`tp_jobs`), whose results go to
    `out["phase35"]`."""
    from repro_torch.launch import mesh as meshlib
    device = "cpu" if smoke else "cuda"
    jobs = shard_jobs(smoke) + tp_jobs(smoke)
    if not smoke:
        gc.collect()
        free()
    log(f"  card: {card_line()}" if not smoke else "  CPU rehearsal")
    log(f"  transport: {meshlib.transport_line(SHARD_N, device)}")
    t0 = time.perf_counter()
    per_rank = meshlib.spawn(shard_rank, SHARD_N, jobs, device=device)
    log(f"  {SHARD_N} ranks ran {len(jobs)} jobs in "
        f"{time.perf_counter() - t0:.1f} s (process start included)")
    out = {}
    p35 = dict(static={}, train={}, seconds={})
    for i, job in enumerate(jobs):
        res = [r[i] for r in per_rank]
        if job.get("phase") == 35:
            p35["seconds"][f"{job['arch']} {job['kind']}"] = max(
                r["job_s"] for r in res)
        if job["kind"] == "tp_static":
            for r in res:
                path_sc |= r.pop("sc_shapes")
            p35["static"][job["arch"]] = check_tp_static(job, res, smoke)
            continue
        name = (f"{job['arch']} "
                + (meshlib.mesh_name(meshlib.make_smoke_mesh(*job["mesh"]))
                   if job["kind"] == "pin" else "data2xmodel1 run"))
        if job["kind"] == "pin":
            for mode in job["modes"]:
                _ranks_agree(f"{name} {mode}",
                             [r[mode]["metrics"] for r in res])
                r0 = res[0][mode]
                sc = [r[mode]["counts"].get("sc_matmul", 0) for r in res]
                want = (0 if mode == "exact" or smoke
                        else 2 * dense_projections(_shard_cfg(job))
                        * job["layers"])
                if any(k != want for k in sc):
                    raise AssertionError(f"{name} {mode}: sc_matmul "
                                         f"launches {sc}, want {want}")
                for rank, r in enumerate(res):
                    hold_quantize(r[mode]["counts"], f"{name} {mode} train "
                                                     f"(rank {rank})")
                line = (f"  {name} {mode}: loss {r0['metrics']['loss']:.7f}, "
                        f"the step {r0['step_s']:.1f} s, sc_matmul a rank "
                        f"{sc}")
                if r0["errs"] is not None:
                    tol = TRAIN_PIN_TOL[mode]
                    errs = sorted(((max(r[mode]["errs"][k] for r in res), k)
                                   for k in r0["errs"]), reverse=True)
                    one = r0["metrics_one_card"]
                    rel = {k: abs(r0["metrics"][k] - one[k]) / abs(one[k])
                           for k in ("loss", "grad_norm", "param_norm")}
                    line += (f"; one card {one['loss']:.7f} (relative: "
                             f"{', '.join(f'{k} {v:.2e}' for k, v in rel.items())}"
                             f"), farthest gradient {errs[0][1]} "
                             f"{errs[0][0]:.2e} of its max (bounds {tol})")
                    r0.update(worst_grad=errs[0], rel=rel, tol=tol)
                    if max(rel.values()) > tol["loss_rel"] or \
                            errs[0][0] > tol["grad_of_max"]:
                        raise AssertionError(
                            f"{name} {mode}: the sharded step parts from "
                            f"one card's: {rel}, {errs[:3]} ({tol})")
                    for r in res:
                        r[mode].pop("errs")
                log(line)
            if "compress" in res[0]:
                log(f"  (d) compressed_psum, card against CPU bit for bit: "
                    f"{[r['compress'] for r in res]}")
            out[name] = res
            if job.get("phase") == 35:
                p35["train"][job["arch"]] = dict(
                    loss=res[0]["exact"]["metrics"]["loss"],
                    step_s=res[0]["exact"]["step_s"],
                    worst_grad=res[0]["exact"].get("worst_grad"),
                    rel=res[0]["exact"].get("rel"))
            continue
        for mode, _ in SHARD_RUN_STEPS:
            _ranks_agree(f"{name} {mode}", [r["runs"][mode]["metrics"]
                                            for r in res])
        tok = TRAIN_BATCH * TRAIN_SEQ
        cfg = _shard_cfg(job)
        reduced = (f"reduced: depth {job['layers']} of "
                   f"{configs_full_layers(job['arch'])}, ranks {SHARD_N} "
                   f"sharing one card")
        for mode, _ in SHARD_RUN_STEPS:
            ms = res[0]["runs"][mode]["ms"]
            rest = statistics.median(ms[1:] or ms)
            log(f"  {name} {mode}: steps {[f'{x:.1f}' for x in ms]} ms "
                f"(median of the rest {rest:.1f}; {tok / rest * 1e3:.1f} "
                f"tok/s); losses {res[0]['runs'][mode]['losses']}; "
                f"sc_matmul a rank a step "
                f"{[r['runs'][mode]['launches'] for r in res]}")
        peak = sum(r["peak_gib"] for r in res)
        per_layer = 16 * layer_params(cfg) / 2**30
        fits = job["layers"] + int((SHARD_MEM_GIB - peak) // per_layer)
        log(f"  {name}: {reduced}; each rank's peak "
            f"{[round(r['peak_gib'], 2) for r in res]} GiB (sum "
            f"{peak:.2f}; +{per_layer:.2f} GiB a layer: the ranks' peaks "
            f"would sum below {SHARD_MEM_GIB} GiB up to about {fits} "
            f"layers); {cfg.name}, f32 master weights, bf16 compute, "
            f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat")
        tables = cfg.padded_vocab * cfg.d_model * (
            1 if cfg.tie_embeddings else 2)
        share = tables / cfg.param_count()
        log(f"  {name}: the embed and head tables are {share:.0%} of the "
            f"weights a step gathers and reduce-scatters at {job['layers']} "
            f"layers, so its ms and tok/s stand for their transfers through "
            f"the host, not for a training step's layers")
        for r in res:
            path_sc |= r.pop("sc_shapes")
        out["run"] = dict(res=res, reduced=reduced, fits_layers=fits,
                          launches=[sum(r["runs"]["int8"]["launches"])
                                    for r in res])
    total = sum(p35["seconds"].values())
    log(f"  phase 35 (in these ranks): {total:.1f} s; by family and job "
        + ", ".join(f"{k} {v:.1f} s" for k, v in p35["seconds"].items()))
    out["phase35"] = dict(p35, total_s=total)
    return out


# ---------------------------------------------------------------------------
# phase 35: tensor parallelism for every family, in phase 33's ranks
# ---------------------------------------------------------------------------

# (arch, layers): full width, reduced depth; zamba2's 7 are one shared
# invocation (period 6) and a tail layer
TP_FAMILIES = (("rwkv6_3b", 2), ("zamba2_7b", 7), ("musicgen_large", 2),
               ("internvl2_1b", 2))
# the dense family's tensor-parallel serving steps (e)
TP_DENSE = ("qwen3_8b", 2)
# the static steps: batch, prompt (after internvl's 256-token image
# prefix) and decode steps
TP_BATCH, TP_PROMPT, TP_DECODE = 2, 64, 2
# (a)'s zamba2 window: its 80-token prompt fills the ring in sequence and
# the decodes wrap it, as on one device
TP_RING_WINDOW, TP_RING_PROMPT = 64, 80
# (a): every logits row and cache leaf of the ranks within this share of
# its max abs of one card's (f32 sums in another order)
TP_STEP_TOL = 1e-4


def _tp_inputs(cfg, device, prompt: int):
    """Phase 35's prompt (and internvl's prefix) from a seeded CPU
    generator, the same on both ranks."""
    import torch
    from repro_torch.models import frontend
    from repro_torch.models.transformer import torch_dtype
    gen = torch.Generator().manual_seed(35)
    batch = {"tokens": torch.randint(
        2, cfg.vocab_size, frontend.token_shape(cfg, TP_BATCH, prompt),
        generator=gen, dtype=torch.int32).to(device)}
    if cfg.modality == "vlm":
        batch["prefix_embeds"] = torch.randn(
            (TP_BATCH, frontend.VLM_PREFIX_TOKENS, cfg.d_model),
            generator=gen).to(device, torch_dtype(cfg.compute_dtype))
    return batch


def _tp_greedy(cfg, pol, model, batch, cache, mesh=None) -> dict:
    """A prefill and TP_DECODE greedy decode steps through the serving
    steps (`mesh`: a rank's): every step's logits (f32) and tokens."""
    import torch
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(cfg, pol, mesh=mesh)
    decode = steps.make_decode_step(cfg, pol, mesh=mesh)
    out, cache = prefill(model, batch, cache)
    logits = [out.float()]
    for _ in range(TP_DECODE):
        out, cache = decode(model, steps.greedy_sample(out)[:, None], cache)
        logits.append(out.float())
    _shard_sync(logits[0].device)
    return dict(logits=logits, cache=cache,
                tokens=[steps.greedy_sample(x) for x in logits])


def _tp_variant(device, base, label: str, shapes: set) -> dict:
    """One of (a) f32 exact against one card, (b) int8 against one card,
    (c) bf16 exact alone, on this rank; launch counts zeroed just before
    the rank's steps and read just after."""
    import torch
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import mesh_cases
    from repro_torch.models import model as modellib
    from repro_torch.parallel import tensor_parallel as tpl
    from repro_torch.parallel.sharding import shard_leaf
    rmesh = _rank_mesh((1, SHARD_N))
    rank, n = rmesh.index("model"), rmesh.size("model")
    cfg = dataclasses.replace(
        base, compute_dtype="float32" if label == "a" else "bfloat16")
    prompt = TP_PROMPT
    if label == "a" and cfg.family == "zamba2":
        cfg = dataclasses.replace(cfg, attn_window=TP_RING_WINDOW)
        prompt = TP_RING_PROMPT
    pol = ArithmeticPolicy(mode="int8" if label == "b" else "exact")
    batch = _tp_inputs(cfg, device, prompt)
    max_len = prompt + TP_DECODE + batch.get(
        "prefix_embeds", torch.empty(0, 0)).shape[1]
    out = {}
    if label in ("a", "b"):
        one = _tp_greedy(cfg, pol, modellib.init(cfg, seed=0, device=device),
                         batch, modellib.init_cache(
                             cfg, TP_BATCH, max_len, dtype=torch.float32,
                             device=device))
        _tp_free(device)
    part = tpl.init_shard(cfg, rank, n, pol, seed=0, device=device)
    cache = tpl.rank_cache(cfg, n, TP_BATCH, max_len, dtype=torch.float32,
                           device=device)
    _shard_sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    with sc_path_shapes(shapes):
        mine = _tp_greedy(cfg, pol, part, batch, cache, mesh=rmesh)
    out.update(steps_s=time.perf_counter() - t0, counts=dict(launch_counts),
               tokens=[t.tolist() for t in mine["tokens"]],
               finite=all(bool(torch.isfinite(x).all())
                          for x in mine["logits"]))
    if label == "a":
        specs = mesh_cases.flatten(tpl.cache_placement(cfg, n))
        theirs = mesh_cases.flatten(one["cache"])
        errs = {f"logits {i}": float((a - b).abs().max()
                                     / b.abs().max().clamp_min(1e-30))
                for i, (a, b) in enumerate(zip(mine["logits"],
                                               one["logits"]))}
        for key, t in mesh_cases.flatten(mine["cache"]).items():
            if key == "index":
                continue
            want = shard_leaf(theirs[key], specs[key], rank, n).float()
            errs[key] = float((t.float() - want).abs().max()
                              / want.abs().max().clamp_min(1e-30))
        out.update(errs=errs)
    if label == "b":
        out.update(one_tokens=[t.tolist() for t in one["tokens"]],
                   one_margins=[[mesh_cases._top2_margin(row)
                                 for row in x.reshape(-1, x.shape[-1])]
                                for x in one["logits"]],
                   bit_equal=all(torch.equal(a, b) for a, b in zip(
                       mine["logits"], one["logits"])))
    del part, cache, mine
    _tp_free(device)
    return out


def _tp_free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        free()


def tp_static(device, job) -> dict:
    """Phase 35 (a)-(c) (and (e) for qwen3_8b) on this rank: the
    family's (model 2) static steps at full width through
    `job["layers"]` layers, from `modellib.init(cfg, 0)`'s weights
    (each rank its part, `tensor_parallel.init_shard`), a cache of its
    part (`tensor_parallel.rank_cache`); sc_matmul's shapes recorded for
    phase 16."""
    cfg = _shard_cfg(dict(job, f32=False))
    t0 = time.perf_counter()
    shapes: set = set()
    out = {label: _tp_variant(device, cfg, label, shapes)
           for label in ("a", "b", "c")}
    out.update(sc_shapes=shapes, seconds=time.perf_counter() - t0)
    return out


def tp_jobs(smoke: bool = False) -> list:
    """Phase 35's jobs: each family's static steps and its (model 2)
    train step against one card's, and qwen3_8b's static steps."""
    jobs = [dict(kind="tp_static", arch=arch, layers=layers, smoke=smoke,
                 phase=35) for arch, layers in TP_FAMILIES + (TP_DENSE,)]
    jobs += [dict(kind="pin", arch=arch, layers=layers, f32=True,
                  smoke=smoke, mesh=(1, SHARD_N), modes=("exact",),
                  phase=35) for arch, layers in TP_FAMILIES]
    return jobs


def _tp_products(cfg) -> tuple[int, int]:
    """(policy products, attention layers) of one forward of cfg."""
    if cfg.family == "rwkv6":
        return 9 * cfg.n_layers, 0
    attn = 4 + (3 if cfg.glu else 2)
    if cfg.family == "zamba2":
        inv = cfg.n_layers // cfg.shared_attn_period
        return 2 * cfg.n_layers + attn * inv, inv
    return attn * cfg.n_layers, cfg.n_layers


def check_tp_static(job, res: list, smoke: bool = False) -> dict:
    """Phase 35's parent side of one family's static steps: every rank's
    (a) errors within TP_STEP_TOL, (b) tokens equal to one card's (or
    parting only at a printed near tie of one card's logits) and
    sc_matmul once a policy product of every forward, (c) flash_attention
    once an attention layer of every forward; the ranks' tokens equal."""
    cfg = _shard_cfg(job)
    products, attn = _tp_products(cfg)
    forwards = 1 + TP_DECODE
    name = f"{job['arch']} model{SHARD_N}"
    for label in ("a", "b", "c"):
        toks = [r[label]["tokens"] for r in res]
        if any(t != toks[0] for t in toks) or \
                not all(r[label]["finite"] for r in res):
            raise AssertionError(f"{name} ({label}): the ranks' tokens differ "
                                 f"or a logit is not finite")
    errs = {k: max(r["a"]["errs"][k] for r in res)
            for k in res[0]["a"]["errs"]}
    worst = max(errs, key=errs.get)
    if errs[worst] > TP_STEP_TOL:
        raise AssertionError(f"{name} (a): {worst} parts from one card's by "
                             f"{errs[worst]:.2e} of its max")
    b = res[0]["b"]
    parted = []
    if b["tokens"] != b["one_tokens"]:
        for step, (mine, one) in enumerate(zip(b["tokens"],
                                               b["one_tokens"])):
            flat_m, flat_o = _flatten(mine), _flatten(one)
            for i, (x, y) in enumerate(zip(flat_m, flat_o)):
                if x != y:
                    margin = b["one_margins"][step][i]
                    if margin >= NEAR_TIE:
                        raise AssertionError(
                            f"{name} (b): int8 token {i} of step {step} "
                            f"parts from one card's at margin {margin:.2e}")
                    parted.append((step, i, margin))
            if parted:
                break
    want_sc = 0 if smoke else products * forwards
    want_fa = 0 if smoke else attn * forwards
    sc = [r["b"]["counts"].get("sc_matmul", 0) for r in res]
    fa = [r["c"]["counts"].get("flash_attention", 0) for r in res]
    if any(k != want_sc for k in sc) or any(k != want_fa for k in fa) or \
            any(r[v]["counts"].get("paged_attention", 0)
                for r in res for v in "abc"):
        raise AssertionError(f"{name}: sc_matmul {sc} (want {want_sc}), "
                             f"flash_attention {fa} (want {want_fa}) a rank")
    for rank, r in enumerate(res):
        hold_quantize(r["b"]["counts"], f"{name} tensor-parallel int8 "
                                        f"static (rank {rank})")
    secs = max(r["seconds"] for r in res)
    log(f"  {name} static (reduced: depth {cfg.n_layers} of "
        f"{configs_full_layers(job['arch'])}, ranks {SHARD_N} sharing one "
        f"card): (a) f32 farthest {worst} {errs[worst]:.2e} of its max; "
        f"(b) int8 tokens equal one card's: {not parted} (logits bit-equal "
        f"on rank 0: {b['bit_equal']}; parted at near ties {parted}), "
        f"sc_matmul a rank {sc}; (c) bf16 flash_attention a rank {fa}; "
        f"{secs:.1f} s")
    return dict(worst=(worst, errs[worst]), int8_equal=not parted,
                int8_bit_equal=b["bit_equal"], parted=parted,
                sc_matmul=sc, flash_attention=fa, seconds=secs,
                steps_s={v: res[0][v]["steps_s"] for v in "abc"})


def _flatten(tokens) -> list:
    out = []
    for t in tokens:
        out.extend(_flatten(t) if isinstance(t, list) else [t])
    return out


def layer_params(cfg) -> int:
    """A dense decoder layer's parameters: the attention's four
    matrices, the FFN's, the two norms (and the qk-norm scales)."""
    hd = cfg.resolved_head_dim
    attn = 2 * cfg.d_model * hd * (cfg.n_heads + cfg.n_kv_heads)
    ffn = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
    return attn + ffn + 2 * cfg.d_model + (2 * hd if cfg.qk_norm else 0)


def configs_full_layers(arch: str) -> int:
    from repro_torch import configs
    return configs.get_config(arch).n_layers


# ---------------------------------------------------------------------------
# phase 36: the shipped configurations the card had not run
# ---------------------------------------------------------------------------

# (arch, layers): full width and depth, but dbrx_132b, whose 40 layers
# take about 264 GB in bf16: 8 of them, about 55 GB (reduced: depth)
NEW_CONFIGS = (("gemma_2b", None), ("qwen3_14b", None),
               ("deepseek_coder_33b", None), ("dbrx_132b", 8))
NEW_TRACE = dict(prompt=(64, 128), gen=8)   # `smoke_trace`'s, shortened
NEW_STATIC = (4, 512, 8)          # the exact static run: batch, prompt, gen
NEW_QUANT_STATIC = (2, 32, 2)     # the int8 and artemis static runs
NEW_F32_STATIC = (4, 128, 8)      # the f32 flash-vs-gather static runs
NEW_POOL_PAGES = 512              # phase 5's page pool, where it fits
# the share of the memory free after the weights load that the page pool
# or the static cache may take; the rest holds the activations and the
# int8 path's f32 copy of a weight
NEW_FREE_SHARE = 0.5
NEW_PHASE_S = 150.0


def free_bytes() -> int:
    """Device memory a new tensor can take: free on the card and unused
    in the caching allocator."""
    import torch
    free_now, _ = torch.cuda.mem_get_info()
    return (free_now + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())


def sized_from_free(label: str, want: int, need: int, per_unit: int) -> int:
    """`want` units of `per_unit` bytes, or as many as NEW_FREE_SHARE of
    the free memory holds; fails below `need`."""
    fit = int(NEW_FREE_SHARE * free_bytes() // per_unit)
    n = min(want, fit)
    log(f"  {label}: {n} of {per_unit / 2**20:.2f} MiB each (want {want}; "
        f"{NEW_FREE_SHARE:.0%} of the {free_bytes() / 2**30:.2f} GiB free "
        f"holds {fit})")
    if n < need:
        raise AssertionError(f"{label}: {n} fit, the run needs {need}")
    return n


def flash_want(cfg, prompt_len: int, gen_len: int, q_dtype,
               n_attn: int | None = None) -> dict:
    """flash_attention launches by instance of a static run: one an
    attention layer (`n_attn`, default every layer) at the prefill and at
    each decode, in the instance `kernel_variant` gives the path's call
    (q in `q_dtype` over the f32 cache)."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_variant)
    hd = cfg.resolved_head_dim
    n_attn = cfg.n_layers if n_attn is None else n_attn
    want = dict.fromkeys(FA_VARIANTS, 0)
    for sq, n in ((prompt_len, 1), (1, gen_len)):
        want[kernel_variant(q_dtype, torch.float32, torch.bfloat16, sq,
                            hd)] += n_attn * n
    return want


def check_flash_counts(cfg, run, label, prompt_len, gen_len,
                       q_dtype) -> dict:
    """A static run's flash_attention launches by instance against
    `flash_want`; the other kernels never."""
    counts = run["counts"]
    by_variant = {v: counts.get(f"flash_attention.{v}", 0)
                  for v in FA_VARIANTS}
    want = flash_want(cfg, prompt_len, gen_len, q_dtype)
    log(f"  {label}: flash_attention {counts.get('flash_attention', 0)} = "
        f"{cfg.n_layers} layers x (1 + {gen_len}) forwards, by instance "
        f"{by_variant} (want {want})? {by_variant == want}; paged_attention "
        f"{counts.get('paged_attention', 0)}, sc_matmul "
        f"{counts.get('sc_matmul', 0)}")
    if by_variant != want or counts.get("flash_attention", 0) != \
            cfg.n_layers * (1 + gen_len) or counts.get("paged_attention", 0) \
            or counts.get("sc_matmul", 0) or counts.get("sc_quantize", 0):
        raise AssertionError(f"{label}: launches {counts}, want flash "
                             f"{want} and nothing else")
    return by_variant


def new_f32_identities(cfg) -> dict:
    """Through 2 layers of the full width at f32 (phases 6 and 9): the
    gather and fused engine drains of the greedy trace, and the flash
    and gather static runs, token-identical."""
    import torch
    from repro_torch.models import transformer
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    model2 = transformer.init(cfg2, seed=0, device="cuda")
    trace = smoke_trace(cfg2, **NEW_TRACE)
    runs = {impl: drain(cfg2, model2, trace, impl)
            for impl in ("gather", "fused")}
    if runs["gather"]["counts"]:
        raise AssertionError(f"gather drain launched "
                             f"{runs['gather']['counts']}")
    check_paged_counts(cfg2, runs["fused"], "f32 fused drain")
    same_drain = all((runs["gather"]["results"][r]
                      == runs["fused"]["results"][r]).all()
                     for r in runs["gather"]["results"])
    b, prompt, gen = NEW_F32_STATIC
    st = {impl: static_run(cfg2, model2, batch=b, prompt_len=prompt,
                           gen_len=gen, attn_impl=impl)
          for impl in ("flash", "gather")}
    check_flash_counts(cfg2, st["flash"], "f32 flash static", prompt, gen,
                       torch.float32)
    if st["gather"]["counts"]:
        raise AssertionError(f"gather static run launched "
                             f"{st['gather']['counts']}")
    same_static = torch.equal(st["flash"]["generated"],
                              st["gather"]["generated"])
    n_tok = sum(len(v) for v in runs["fused"]["results"].values())
    log(f"  f32, 2 layers of the full width: gather and fused drains "
        f"token-identical over {n_tok} tokens? {same_drain}; flash and "
        f"gather static runs (batch {b}, prompt {prompt}, gen {gen}) over "
        f"{b * gen} tokens? {same_static}")
    if not (same_drain and same_static):
        raise AssertionError("an f32 kernel run diverged from gather")
    del model2, st, runs
    free()
    return dict(drain_tokens=n_tok, static_tokens=b * gen, identical=True)


def new_config_run(arch: str, n_layers: int | None, path_sc: set) -> dict:
    """One configuration of phase 36 at full width (`n_layers` of its
    layers where given): the f32 identities through 2 layers (dense
    configs); then the seeded bf16 model: an exact fused drain of the
    half-sampled trace (paged_attention as `check_paged_counts`), an
    exact static run (flash as `flash_want`), and the quantized runs:
    dense configs a short int8 static run (gemma_2b also artemis),
    sc_matmul once a projection of every forward; dbrx_132b a short int8
    drain, sc_matmul as `moe_layer_products` says, each expert on its
    own. Every launch count zeroed just before its run and read just
    after; tok/s, ms a forward, the peak GiB."""
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import ArithmeticPolicy
    t0 = time.perf_counter()
    cfg = configs.get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    moe = cfg.family == "moe"
    out = dict(n_layers=cfg.n_layers, of_layers=configs_full_layers(arch),
               group=cfg.n_heads // cfg.n_kv_heads,
               head_dim=cfg.resolved_head_dim)
    if not moe:
        out["f32"] = new_f32_identities(cfg)
    free()
    log(f"  {arch}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held "
        f"before its weights")
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg)
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30

    kv_row = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 4 * cfg.n_layers
    n_pages = sized_from_free("f32 page pool, pages of 8 tokens",
                              NEW_POOL_PAGES, 8 * 18 + 1, 8 * kv_row)
    run = drain(cfg, model, smoke_trace(cfg, **NEW_TRACE, **MIXED), "fused",
                ecfg=engine_config("fused", n_pages))
    m = run["metrics"]
    if not m["n_sampled_tokens"]:
        raise AssertionError(f"{arch}: the mixed drain sampled no token")
    tok_s = m["n_generated_tokens"] / run["wall_s"]
    ms_fwd = run["wall_s"] / run["n_forwards"] * 1e3
    log(f"  exact fused drain: {m['n_done']} requests, "
        f"{m['n_generated_tokens']} tokens ({m['n_sampled_tokens']} "
        f"sampled) in {run['wall_s']:.3f} s wall ({tok_s:.2f} tok/s; "
        f"{run['n_forwards']} forwards, {ms_fwd:.2f} ms each); "
        f"{m['n_preemptions']} preemptions")
    out["drain"] = dict(check_paged_counts(cfg, run, f"{arch} drain"),
                        tok_s=tok_s, wall_s=run["wall_s"], ms_per_forward=ms_fwd,
                        n_forwards=run["n_forwards"],
                        n_prefill_forwards=run["n_prefill_forwards"],
                        n_pages=n_pages)

    b, prompt, gen = NEW_STATIC
    b = sized_from_free(f"static batch of {prompt} + {gen} tokens", b, 1,
                        (prompt + gen) * kv_row)
    st = static_run(cfg, model, batch=b, prompt_len=prompt, gen_len=gen)
    by_variant = check_flash_counts(cfg, st, f"{arch} static", prompt, gen,
                                    torch.bfloat16)
    out["static"] = dict(batch=b, prompt=prompt, gen=gen,
                         prefill_ms=st["prefill_s"] * 1e3,
                         decode_tok_s=st["decode_tok_per_s"],
                         step_ms=st["decode_s"] / gen * 1e3,
                         launches=sum(by_variant.values()),
                         launches_by_variant=by_variant)
    log(f"  exact static, batch {b}, prompt {prompt}, gen {gen}: prefill "
        f"{st['prefill_s']*1e3:.2f} ms | decode {st['decode_tok_per_s']:.2f} "
        f"tok/s, {st['decode_s'] / gen * 1e3:.2f} ms per step")
    del st

    out["quantized"] = {}
    with sc_path_shapes(path_sc):
        if moe:
            per_layer = moe_layer_products(cfg)
            cap = max(int(cfg.capacity_factor * 8 * cfg.top_k
                          / cfg.padded_experts), 1)
            log(f"  int8 drain: sc_matmul {per_layer} a layer of a forward "
                f"(4 attention projections, 3 for each of "
                f"{cfg.padded_experts} experts, each quantized on its own: "
                f"`moe.expert_ffn`), {per_layer * cfg.n_layers} a forward; "
                f"decode capacity max(int({cfg.capacity_factor} x 8 x "
                f"{cfg.top_k} / {cfg.padded_experts}), 1) = {cap}")
            run = drain(cfg, model, smoke_trace(cfg, (32, 64), 8), "gather",
                        ArithmeticPolicy(mode="int8"),
                        ecfg=engine_config("gather", n_pages))
            launches = run["counts"].get("sc_matmul", 0)
            want = per_layer * cfg.n_layers * run["n_forwards"]
            tok = run["metrics"]["n_generated_tokens"]
            log(f"  int8 drain: {tok} tokens in {run['wall_s']:.3f} s wall "
                f"({tok / run['wall_s']:.2f} tok/s; {run['n_forwards']} "
                f"forwards) | sc_matmul {launches} = {per_layer} x "
                f"{cfg.n_layers} x {run['n_forwards']}? {launches == want}; "
                f"paged_attention {run['counts'].get('paged_attention', 0)}")
            if launches != want or run["counts"].get("paged_attention", 0) \
                    or run["counts"].get("flash_attention", 0):
                raise AssertionError(f"{arch} int8 drain launches "
                                     f"{run['counts']}, want sc_matmul {want}")
            hold_quantize(run["counts"], f"{arch} int8 engine")
            out["quantized"]["int8"] = dict(
                engine=True, tok_s=tok / run["wall_s"], wall_s=run["wall_s"],
                n_forwards=run["n_forwards"], launches=launches,
                decode_capacity=cap)
        else:
            qb, qp, qg = NEW_QUANT_STATIC
            per_layer = dense_projections(cfg)
            for mode in ("int8",) + (("artemis",) if arch == "gemma_2b"
                                     else ()):
                run = static_run(cfg, model, batch=qb, prompt_len=qp,
                                 gen_len=qg, policy_mode=mode)
                counts = run["counts"]
                want = per_layer * cfg.n_layers * (1 + qg)
                log(f"  {mode} static, batch {qb}, prompt {qp}, gen {qg}: "
                    f"prefill {run['prefill_s']*1e3:.2f} ms, decode "
                    f"{run['decode_tok_per_s']:.2f} tok/s | sc_matmul "
                    f"{counts.get('sc_matmul', 0)} = {per_layer} x "
                    f"{cfg.n_layers} x {1 + qg} forwards? "
                    f"{counts.get('sc_matmul', 0) == want}")
                if counts.get("sc_matmul", 0) != want or \
                        counts.get("flash_attention", 0) or \
                        counts.get("paged_attention", 0):
                    raise AssertionError(f"{arch} {mode} static run launches "
                                         f"{counts}, want sc_matmul {want}")
                hold_quantize(counts, f"{arch} {mode} static")
                out["quantized"][mode] = dict(
                    engine=False, prefill_ms=run["prefill_s"] * 1e3,
                    decode_tok_s=run["decode_tok_per_s"],
                    launches=counts["sc_matmul"])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model
    free()
    out["seconds"] = time.perf_counter() - t0
    log(f"  {arch} ({cfg.n_layers} of {out['of_layers']} layers): weights "
        f"{out['weights_gib']:.2f} GiB, peak {out['peak_gib']:.2f} GiB of "
        f"the card's {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
        f"; {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 34: the roofline on the card
# ---------------------------------------------------------------------------

# card against meta: the FLOPs and the kernel calls are equal; the bytes
# within ROOF_BYTES_RTOL (the train step's norms: the dry run's one-rank
# mesh step sums the squares of its blocks through
# `data_parallel.global_norm`, one stack and sum more than the
# single-device step's `adamw.global_norm`); the counted peak within
# ROOF_PEAK_RTOL of the allocator's over the step (its 512-byte rounding
# and what the kernels keep beside their outputs)
ROOF_BYTES_RTOL = 1e-6
ROOF_PEAK_RTOL = 1e-2
ROOF_PHASE_S = 60.0


def roofline_card(hw) -> dict:
    """Phase 34(a): the card against `HW_H100`: its name holds H100 and
    its memory is the spec's within 1 GiB."""
    import torch
    props = torch.cuda.get_device_properties(0)
    name = torch.cuda.get_device_name(0)
    total_gib = props.total_memory / 2**30
    log(f"  {card_line()} | {props.multi_processor_count} SMs | "
        f"total_memory {props.total_memory} B = {total_gib:.3f} GiB | "
        f"{hw.name}: {hw.hbm_gib} GiB, {hw.peak_flops / 1e12} TFLOP/s bf16, "
        f"{hw.hbm_bw / 1e12} TB/s, {hw.ici_links} x {hw.ici_bw / 1e9} GB/s")
    if "H100" not in name:
        raise AssertionError(f"the card is {name!r}, not an H100")
    if abs(total_gib - hw.hbm_gib) > 1.0:
        raise AssertionError(f"the card holds {total_gib:.3f} GiB, "
                             f"{hw.name} says {hw.hbm_gib}")
    return dict(name=name, sms=props.multi_processor_count,
                total_memory=props.total_memory, hbm_gib=hw.hbm_gib)


def _count_on_card(step, args, inputs) -> dict:
    """step(*args) once on the card under `roofline.count.Count`, the
    kernels launching: the count, the kernels' launch-count deltas and
    the allocator's peak over the step (its peak less what was live
    before, plus the inputs, as the count counts them)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.roofline.count import Count
    torch.cuda.synchronize()
    before = dict(launch_counts)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Count(inputs) as count:
        out = step(*args)
        torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - base + count.input_bytes
    launches = {k: v - before.get(k, 0) for k, v in launch_counts.items()
                if "." not in k and v != before.get(k, 0)}
    return dict(count=count, launches=launches, alloc_peak=alloc, out=out)


def _meta_count(cfg, kind: str, batch: int, seq: int, **kw):
    """The same step through the dry run's path, on meta tensors, at a
    one-rank mesh over a fake process group."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    with dryrun.fake_group(1):
        rmesh = meshlib.rank_mesh(meshlib.make_smoke_mesh(1, 1))
        return dryrun.count_cell(cfg, ShapeCell(kind, seq, batch, kind),
                                 rmesh, **kw)["count"]


def hold_counts(label: str, card: dict, meta) -> dict:
    """34(b): the card's count against meta's (module constants)."""
    c = card["count"]
    calls = dict(c.kernel_calls)
    if c.flops != meta.flops:
        raise AssertionError(f"{label}: {c.flops} FLOPs on the card, "
                             f"{meta.flops} on meta")
    if calls != dict(meta.kernel_calls) or calls != card["launches"]:
        raise AssertionError(f"{label}: kernel calls {calls} on the card, "
                             f"{dict(meta.kernel_calls)} on meta, launches "
                             f"{card['launches']}")
    bytes_rel = abs(c.bytes - meta.bytes) / meta.bytes
    peak_rel = abs(meta.peak - card["alloc_peak"]) / card["alloc_peak"]
    log(f"  {label}: {meta.flops / 1e9:.3f} GFLOP on both; bytes card "
        f"{c.bytes / 1e9:.4f} GB, meta {meta.bytes / 1e9:.4f} GB (rel "
        f"{bytes_rel:.2e}, within {ROOF_BYTES_RTOL}); kernel calls {calls} "
        f"= launches; peak counted on meta {meta.peak / 2**30:.3f} GiB, on "
        f"the card {c.peak / 2**30:.3f}, allocator "
        f"{card['alloc_peak'] / 2**30:.3f} (rel {peak_rel:.2e}, within "
        f"{ROOF_PEAK_RTOL}; inputs {meta.input_bytes / 2**30:.3f} GiB)")
    if bytes_rel > ROOF_BYTES_RTOL:
        raise AssertionError(f"{label}: bytes differ by {bytes_rel:.2e}")
    if peak_rel > ROOF_PEAK_RTOL:
        raise AssertionError(f"{label}: the counted peak is {peak_rel:.2e} "
                             f"off the allocator's")
    return dict(flops=meta.flops, bytes_meta=meta.bytes, bytes_card=c.bytes,
                bytes_rel=bytes_rel, kernel_calls=calls,
                launches=card["launches"], peak_meta=meta.peak,
                peak_card_count=c.peak, peak_alloc=card["alloc_peak"],
                peak_rel=peak_rel, input_bytes=meta.input_bytes)


def roofline_static(cfg, model) -> dict:
    """34(b) on phase 8's model: one static prefill (batch 8, prompt 1024,
    an f32 cache of 1056 slots, flash) and one decode step at index 1024,
    each counted on the card and on meta."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model as modellib
    b, s, gen_len = STATIC_ROOF
    gen = torch.Generator(device="cuda")
    gen.manual_seed(34)
    tokens = torch.randint(2, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    cache = modellib.init_cache(cfg, b, s + gen_len, dtype=torch.float32,
                                device="cuda")
    params = dict(model.named_parameters())
    prefill = _count_on_card(steps.make_prefill_step(cfg),
                             (model, {"tokens": tokens}, cache),
                             [params, tokens, cache])
    logits, cache = prefill["out"]
    nxt = steps.greedy_sample(logits)[:, None]
    decode = _count_on_card(steps.make_decode_step(cfg), (model, nxt, cache),
                            [params, nxt, cache])
    kw = dict(cache_len=s + gen_len, cache_dtype=torch.float32)
    out = dict(
        prefill=hold_counts("prefill", prefill,
                            _meta_count(cfg, "prefill", b, s, **kw)),
        decode=hold_counts("decode", decode,
                           _meta_count(cfg, "decode", b, s, cache_index=s,
                                       **kw)))
    del prefill, decode, cache, logits
    free()
    return out


def roofline_train(tcfg, model, opt, opt_cfg, batch) -> dict:
    """34(b) on phase 23's model, once its steps are timed: one more exact
    step counted on the card and on meta."""
    from repro_torch.core.policy import ArithmeticPolicy
    from repro_torch.launch import steps
    step = steps.make_train_step(tcfg, opt_cfg, ArithmeticPolicy())
    card = _count_on_card(step, (model, opt, batch),
                          [dict(model.named_parameters()), opt, batch])
    meta = _meta_count(tcfg, "train", *batch["tokens"].shape,
                       opt_cfg=opt_cfg)
    out = hold_counts("train step", card, meta)
    del card
    return out


def roofline_shares(cfg, hw, static: dict, train: dict,
                    roof: dict) -> dict:
    """34(c): each path's measured median (phases 8 and 23) beside its
    counted terms under `hw` and its share of the bf16 peak."""
    from repro_torch.roofline import model_flops
    b, s, _ = STATIC_ROOF
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    paths = (
        ("prefill", static["prefill_ms"], roof["static"]["prefill"],
         model_flops(cfg, b * s, "prefill", kv_len=s)),
        ("decode", static["step_ms"], roof["static"]["decode"],
         model_flops(cfg, b, "decode", kv_len=s + 1)),
        ("train step", train["runs"]["exact"]["median_rest_ms"],
         roof["train"], model_flops(tcfg, TRAIN_BATCH * TRAIN_SEQ, "train",
                                    kv_len=TRAIN_SEQ)))
    out = {}
    for label, ms, counted, mflops in paths:
        t_c = counted["flops"] / hw.peak_flops * 1e3
        t_m = counted["bytes_meta"] / hw.hbm_bw * 1e3
        bound = max(t_c, t_m)
        share = mflops / (ms / 1e3 * hw.peak_flops)
        out[label] = dict(ms=ms, t_compute_ms=t_c, t_memory_ms=t_m,
                          step_time_ms=bound, bound_share=bound / ms,
                          model_flops=mflops, peak_share=share)
        log(f"  {label:10s}: measured {ms:9.2f} ms | t_compute {t_c:8.3f} "
            f"ms, t_memory {t_m:8.3f} ms, step_time {bound:8.3f} ms "
            f"({bound / ms:.1%} of the measured) | model_flops "
            f"{mflops / 1e9:.1f} GFLOP: {share:.2%} of the bf16 peak "
            f"({card_line()})")
    return out


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
        from repro_torch.kernels.sc_matmul import (quantize_int8,
                                                   sc_matmul_quantized)
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
                                       "artemis_tile_kernel",
                                       "artemis_level_scan_kernel",
                                       "sc_quantize",
                                       "paged_attention_tile",
                                       "flash_attention_tile",
                                       "attention_split", "attention_merge")):
                log(f"    {name}: {regs} registers, {spill} bytes spill "
                    f"stores")
                if spill:
                    raise AssertionError(f"{name} spills")
    # the C entries' argument blocks against their ctypes mirrors (a
    # block that drifted must never launch)
    for fn in (paged_attention, flash_attention_all, sc_matmul_quantized,
               quantize_int8):
        mod = sys.modules[fn.__module__]
        size_fn = f"{mod.NAME}_launch_args_bytes"
        build.check_launch_args(build.load(mod.SOURCE), size_fn, mod._Args)
        log(f"  {size_fn}() = {ctypes.sizeof(mod._Args)} bytes, as its "
            f"mirror {mod.__name__}._Args")

    phases.mark("3. kernels against their plain versions")
    pa_err = check_paged_attention()
    pa_split = check_paged_split()
    n_sc_cases = check_sc_matmul()
    n_q_cases = check_sc_quantize()
    fa_err, n_fa_cases = check_flash_attention()
    fa_split = check_flash_split()

    cfg = configs.get_config("qwen3_8b")
    moe_cfg = configs.get_config("qwen2_moe_a2_7b")
    phases.mark("4. kernel timing at the full-width qwen3_8b shapes")
    timing = time_paged_attention(cfg)
    sc_rows = time_sc_matmul()
    sc_wide = time_sc_artemis_wide()
    q_rows = time_sc_quantize()
    sc_graphs = check_sc_graph_replays()
    fa_rows = time_flash_attention(cfg)
    phases.mark("4b. kernel timing at the full-width qwen2_moe_a2_7b "
                "shapes (G = 1, Hq = Hkv = 16; the expert products)")
    moe_rows = {"paged_attention": time_paged_attention(moe_cfg),
                "sc_matmul": time_sc_matmul(MOE_SC_SHAPES, MOE_SC_ROWS,
                                            "qwen2_moe_a2_7b"),
                "sc_quantize": time_sc_quantize(MOE_SC_SHAPES, MOE_SC_ROWS,
                                                "qwen2_moe_a2_7b"),
                "flash_attention": time_flash_attention(moe_cfg)}
    for rows in (moe_rows["paged_attention"], moe_rows["flash_attention"]):
        for row in rows:
            row["model"] = "qwen2_moe_a2_7b"
    zamba_cfg = configs.get_config("zamba2_7b")
    phases.mark("4c. flash_attention timing at the full-width zamba2_7b "
                "static shapes (G = 1, Hq = Hkv = 32, D 112)")
    zamba_fa_rows = time_flash_attention(zamba_cfg)
    for row in zamba_fa_rows:
        row["model"] = "zamba2_7b"
    mm_cfgs = {arch: configs.get_config(arch)
               for arch in ("musicgen_large", "internvl2_1b")}
    phases.mark("4d. flash_attention timing at the full-width "
                "musicgen_large (G 1, Hq = Hkv = 32) and internvl2_1b (G 7, "
                "Hq 14 over Hkv 2; Sq 256 + 1024) static shapes, D 64")
    mm_fa_rows = []
    for arch, mcfg in mm_cfgs.items():
        for row in time_flash_attention(mcfg):
            mm_fa_rows.append(dict(row, model=arch))
    phases.mark("4e. attention timing at the full-width gemma_2b (G 8, Dh "
                "256), qwen3_14b (G 5) and "
                "deepseek_coder_33b (G 7) shapes")
    new_rows = {"paged_attention": [], "flash_attention": []}
    for arch in ("gemma_2b", "qwen3_14b", "deepseek_coder_33b"):
        ncfg = configs.get_config(arch)
        for name, timer in (("paged_attention", time_paged_attention),
                            ("flash_attention", time_flash_attention)):
            new_rows[name] += [dict(row, model=arch) for row in timer(ncfg)]

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

    from repro_torch.roofline import HW_H100
    phases.mark("34a. the roofline on the card: the card against HW_H100; "
                "phase 8's static prefill and a decode step counted on the "
                "card (kernels launching) and on meta (the dry run's path, "
                "one rank)")
    roof = dict(card=roofline_card(HW_H100))
    roof["static"] = roofline_static(cfg, static["model"])

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
                "1024, gen 32, exact (flash); f32 flash vs gather "
                "through 7 layers")
    n_inv = zamba_cfg.n_layers // zamba_cfg.shared_attn_period
    zamba.update(static=recurrent_static(zamba_cfg, zb_model, n_inv),
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
    roof["train"] = {}
    with sc_path_shapes(path_sc):
        train = train_full_width(cfg, roofline=roof["train"])
    phases.mark("34c. the roofline on the card: phases 8 and 23's measured "
                "medians beside their counted terms under HW_H100 (34b, "
                "phase 23's step counted on the card and on meta, ran "
                "inside phase 23)")
    roof["shares"] = roofline_shares(cfg, HW_H100, static, train, roof)
    phases.mark("24. training pins: a step on the card against the CPU (2 "
                "layers, f32, exact and int8); train() resumed from a "
                "checkpoint on the card")
    with sc_path_shapes(path_sc):
        train.update(pin=train_pin(cfg))
    train.update(resume=train_resume())
    free()
    phases.mark("25. the rest of the ARTEMIS arithmetic and the paper's "
                "scripts: Table V, normals, LUTs, noisy artemis at the "
                "qwen3_8b width, kernel_micro, the examples")
    arith = dict(table5=table5_on_card(), normals=normals_on_card(),
                 luts=luts_on_card(cfg), noisy=noisy_artemis_on_card(cfg),
                 kernel_micro=kernel_micro_on_card(),
                 examples=examples_on_card(path_sc))
    free()
    multimodal = {}
    for number, (arch, mcfg) in zip((26, 27), mm_cfgs.items()):
        shape = ("prompt 1024 frames x 4 codebooks" if arch == "musicgen_large"
                 else "an image prefix of 256 + a prompt of 1024")
        phases.mark(f"{number}. full-width {arch} static path: bf16, f32 "
                    f"cache, batch 8, {shape}, gen 32, exact (flash); f32 "
                    f"flash vs gather through 2 layers; a short int8 run")
        run = static_drain(mcfg, profile=False)
        with sc_path_shapes(path_sc):
            run.update(static_checks(mcfg, run.pop("model")))
        multimodal[arch] = dict(static=run)
        free()
    phases.mark("28. multimodal training at full width and depth "
                "(musicgen_large 48 layers, internvl2_1b 24): batch 8 x seq "
                "128 (internvl: + its 256-token prefix), remat, 3 steps "
                "exact and 2 int8 each; the card against the CPU through 2 "
                "layers")
    with sc_path_shapes(path_sc):
        for arch, mcfg in mm_cfgs.items():
            multimodal[arch]["train"] = train_full_width(
                mcfg, mcfg.n_layers, TRAIN_STEPS_NEW)
            multimodal[arch]["train"].update(pin=train_pin(mcfg))
    phases.mark("29. recurrent training: rwkv6_3b (32 layers) and zamba2_7b "
                "(27 of 81: 4 shared invocations and the 3-layer tail), batch "
                "8 x seq 128, remat, 3 steps exact and 2 int8 each; the card "
                "against the CPU through 2 and 7 layers")
    recurrent_train = {}
    with sc_path_shapes(path_sc):
        for arch, rcfg, n_train, n_pin in (
                ("rwkv6_3b", rw_cfg, rw_cfg.n_layers, 2),
                ("zamba2_7b", zamba_cfg, ZAMBA2_TRAIN_LAYERS, 7)):
            run = train_full_width(rcfg, n_train, TRAIN_STEPS_NEW)
            run.update(pin=train_pin(rcfg, n_pin))
            recurrent_train[arch] = run
    free()
    phases.mark("30. tensor-parallel serving: full-width qwen3_8b over 2 "
                "ranks sharing the card (gloo; 4 of 8 KV heads a rank): "
                "exact drain of workload 1, int8 drain against one device's")
    mesh = dict(qwen3_8b=mesh_qwen3(cfg, path_sc))
    phases.mark("31. the dataflow cores: f32 token identity through 2 "
                "layers (qwen3_8b, gemma_2b's 1 KV head: ring prefill, "
                "split-KV decode), the cores at qwen3_8b's shapes, a "
                "one-rank NCCL group; full-width gemma_2b drain")
    mesh.update(identities=mesh_identities(cfg, configs.get_config(
        "gemma_2b")))
    phases.mark("32. full-width qwen2_moe_a2_7b over 2 ranks (32 of 64 "
                "experts a rank): short exact drain; f32 identity through "
                "2 layers")
    mesh.update(qwen2_moe_a2_7b=mesh_moe(moe_cfg))
    phases.mark("33. the sharded train step over 2 ranks sharing the card "
                "(gloo): full-width qwen3_8b through 2 layers at f32 at "
                "(data 2) and (model 2) against one card's step, exact and "
                "int8; qwen2_moe_a2_7b at (data 2); a bf16 run at (data 2), "
                "2 exact and 2 int8 steps; compressed_psum on the card "
                "against the CPU; then, in the same ranks, phase 35's jobs")
    sharded = sharded_train(path_sc)
    phases.mark("35. tensor parallelism for every family (ran in phase 33's "
                "ranks, 2 sharing the card over gloo): rwkv6_3b, zamba2_7b, "
                "musicgen_large, internvl2_1b and qwen3_8b at full width, "
                "(model 2) static steps f32 / int8 / bf16 against one card, "
                "and the families' (model 2) train step")
    p35 = sharded["phase35"]
    log(f"  phase 35 took {p35['total_s']:.1f} s in phase 33's ranks "
        f"(under about 60 s? {p35['total_s'] <= 60.0})")
    phases.mark("36. the shipped configurations the card had not run, at "
                "full width: gemma_2b (18 layers), qwen3_14b (40), "
                "deepseek_coder_33b (62), dbrx_132b (8 of 40, reduced: "
                "depth); an exact fused drain (half sampled), an exact "
                "static run, int8 (gemma_2b: artemis too); the dense "
                "configs' f32 identities through 2 layers")
    free()
    t36 = time.perf_counter()
    new_cfgs = {arch: new_config_run(arch, n, path_sc)
                for arch, n in NEW_CONFIGS}
    t36 = time.perf_counter() - t36
    log(f"  phase 36: {t36:.1f} s (at most {NEW_PHASE_S:.0f} s? "
        f"{t36 <= NEW_PHASE_S}): " + ", ".join(
            f"{arch} {r['seconds']:.1f} s" for arch, r in new_cfgs.items()))
    phases.mark("16. sc_matmul at every shape the main path gave it")
    sc_path = check_sc_path_shapes(path_sc)
    phases.mark(None)
    roof["seconds"] = (phases.seconds["34a"] + phases.seconds["34c"]
                       + roof["train"]["seconds"])
    log(f"phase 34: {roof['seconds']:.1f} s (34a {phases.seconds['34a']:.1f}"
        f", 34b {roof['train']['seconds']:.1f}, 34c "
        f"{phases.seconds['34c']:.1f}; at most {ROOF_PHASE_S:.0f} s? "
        f"{roof['seconds'] <= ROOF_PHASE_S})")

    decode = timing[0]
    # sc_matmul's headline row: int8 at the decode shape of w_gate/w_up,
    # the one with a library call; every mode and shape is in "shapes"
    head = next(r for r in sc_rows if r["mode"] == "int8"
                and r["M"] == 8 and (r["K"], r["N"]) == (4096, 12288))
    # sc_quantize's headline row: the w_gate/w_up weight, per tensor
    q_head = next(r for r in q_rows if r["shape"] == "weight"
                  and r["dims"] == [4096, 12288])
    ex = arith["examples"]
    pa_paths = {"qwen3_8b engine": full["launches"],
                "qwen3_8b mixed engine": mixed["launches"],
                "qwen2_moe_a2_7b engine": moe["launches"],
                **{f"{arch} engine": r["drain"]["launches"]
                   for arch, r in new_cfgs.items()},
                "examples/torch_serve_engine.py":
                    ex["serve_engine"]["launches"]["paged_attention"]}
    sc_paths = {**{f"qwen3_8b {k} engine": q["launches"]
                   for k, q in quant.items()},
                "qwen2_moe_a2_7b int8 engine": moe["int8"]["launches"],
                "rwkv6_3b int8 engine": rwkv["int8"]["launches"],
                **{f"qwen3_8b train {k}": r["launches"]
                   for k, r in train["runs"].items() if k != "exact"},
                **{f"{arch} int8 static": m["static"]["int8_sc_matmul_launches"]
                   for arch, m in multimodal.items()},
                **{f"{arch} train int8": m["train"]["launches"]
                   for arch, m in multimodal.items()},
                **{f"{arch} train int8": r["launches"]
                   for arch, r in recurrent_train.items()},
                **{f"qwen3_8b sharded int8 (rank {r})": n for r, n in
                   enumerate(mesh["qwen3_8b"]["int8"]["launches"])},
                **{f"qwen3_8b sharded train int8 (rank {r})": n for r, n in
                   enumerate(sharded["run"]["launches"])},
                **{f"{arch} tensor-parallel int8 static (rank {r})": n
                   for arch, t in p35["static"].items()
                   for r, n in enumerate(t["sc_matmul"])},
                **{f"{arch} {mode} {'engine' if q['engine'] else 'static'}":
                   q["launches"] for arch, r in new_cfgs.items()
                   for mode, q in r["quantized"].items()},
                "examples/torch_quickstart.py artemis_mxu forward":
                    ex["quickstart"]["forward_sc_matmul"]}
    fa_paths = {"qwen3_8b static": static["launches"],
                "qwen2_moe_a2_7b static": moe["static"]["launches"],
                "zamba2_7b static": zamba["static"]["launches"],
                **{f"{arch} static": m["static"]["launches"]
                   for arch, m in multimodal.items()},
                **{f"{arch} tensor-parallel static (rank {r})": n
                   for arch, t in p35["static"].items()
                   for r, n in enumerate(t["flash_attention"])},
                **{f"{arch} static": r["static"]["launches"]
                   for arch, r in new_cfgs.items()},
                "examples/torch_serve_batched.py":
                    ex["serve_batched"]["launches"]["flash_attention"]}
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/paged_attention.py:58",
        "launches": sum(pa_paths.values()),
        "launches_by_path": pa_paths,
        "launches_by_variant": full["launches_by_variant"],
        "max_abs_err": max(*pa_err.values(), pa_split["max_abs_err"], *(
            r["max_abs_err"] for r in timing + moe_rows["paged_attention"]
            + new_rows["paged_attention"]),
            ex["held"]["paged_attention"]["max_abs_err"]),
        "max_abs_err_by_variant": pa_err,
        "split_path": pa_split,
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shapes": timing + moe_rows["paged_attention"]
        + new_rows["paged_attention"],
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
        "cases_bit_equal": n_sc_cases + len(sc_rows) + len(sc_wide)
        + len(moe_rows["sc_matmul"]) + sc_path["n_compared_here"],
        "path_shapes": sc_path,
        "graph_replays": sc_graphs,
        "shapes": sc_rows + sc_wide + moe_rows["sc_matmul"],
    }, {
        "name": "sc_quantize", "route": "cuda",
        "source": "src/repro_torch/kernels/sc_matmul/csrc/sc_matmul.cu",
        # no Pallas kernel: the quantization inside the reference's jitted
        # float entry of the Pallas kernel
        "replaces": "src/repro/kernels/sc_matmul/ops.py:51",
        "launches": sum(QUANT_PATHS.values()),
        "launches_by_path": dict(QUANT_PATHS),
        "max_abs_err": 0.0, "ms": q_head["ms"],
        "plain_ms": q_head["plain_ms"], "bound_ms": q_head["bound_ms"],
        "bound_by": q_head["bound_by"], "library_ms": None,
        "cases_bit_equal": n_q_cases + len(q_rows)
        + len(moe_rows["sc_quantize"]) + sc_path["quantize_compared_here"],
        "shapes": q_rows + moe_rows["sc_quantize"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:48",
        "launches": sum(fa_paths.values()),
        "launches_by_path": fa_paths,
        "launches_by_variant": static["launches_by_variant"],
        "max_abs_err": max(*fa_err.values(), fa_split["max_abs_err"],
                           *(e for r in fa_rows + moe_rows["flash_attention"]
                             + zamba_fa_rows + mm_fa_rows
                             + new_rows["flash_attention"]
                             for e in r["max_abs_err_by_variant"].values()),
                           ex["held"]["flash_attention"]["max_abs_err"]),
        "max_abs_err_by_variant": {v: max(fa_err[v], *(
            r["max_abs_err_by_variant"][v] for r in fa_rows))
            for v in FA_VARIANTS},
        "split_path": fa_split,
        "ms": fa_rows[0]["ms"], "plain_ms": fa_rows[0]["plain_ms"],
        "bound_ms": fa_rows[0]["bound_ms"],
        "bound_by": fa_rows[0]["bound_by"],
        "library_ms": fa_rows[0]["library_ms"],
        "cases_within_tol": {
            v: n_fa_cases[v] + len(fa_rows) + len(moe_rows["flash_attention"])
            + sum(v in r["max_abs_err_by_variant"]
                  for r in zamba_fa_rows + mm_fa_rows
                  + new_rows["flash_attention"])
            for v in FA_VARIANTS},
        "shapes": fa_rows + moe_rows["flash_attention"] + zamba_fa_rows
        + mm_fa_rows + new_rows["flash_attention"],
    }]
    log(json.dumps({"kernels": kernels,
                    "drain": {"tok_s": full["tok_s"],
                              "wall_s": full["wall_s"],
                              "n_forwards": full["n_forwards"]},
                    "quantized_drains": quant,
                    "static": static, "sampler": samp,
                    "mixed_drain": mixed, "qwen2_moe_a2_7b": moe,
                    "rwkv6_3b": rwkv, "zamba2_7b": zamba,
                    "train": train, "arithmetic": arith,
                    "multimodal": multimodal,
                    "recurrent_train": recurrent_train,
                    "mesh": mesh, "sharded_train": sharded,
                    "new_configs": new_cfgs,
                    "roofline": roof, "phase_s": phases.seconds}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
