"""Where the time of the PyTorch port's serve path goes, on one GPU.

Drains the chip-smoke trace (8 greedy requests, prompts of 128-256
tokens, 32 new tokens each; page 8, 512 pages, 8 lanes, chunk 32)
through the port's engine at the full qwen3_8b width (bf16,
attn_impl="fused", seeded random weights) twice: once plain, for the
wall time, and once under `torch.profiler`, for the device time of
every kernel. Prints the summed kernel time against the plain drain's
wall time (the device's busy share, the profiler's own overhead left
out) and the kernel time by group (paged_attention, matrix products,
everything else), and writes the same as JSON to
`chiprun_out/torch_serve_profile.json`.

    PYTHONPATH=src python3 benchmarks/torch_serve_profile.py [--layers N]

Needs a CUDA device; it refuses to run without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve import (EngineConfig, ServeEngine, TrafficConfig,
                               synth_trace)

OUT = pathlib.Path("chiprun_out") / "torch_serve_profile.json"
GEMM_MARKERS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")


def _group(name: str) -> str:
    low = name.lower()
    if "paged_attention" in low:
        return "paged_attention"
    if any(m in low for m in GEMM_MARKERS):
        return "matmul"
    return "other"


def _drain(cfg, model, trace, profile: bool):
    eng = ServeEngine(cfg, params=model, ecfg=EngineConfig(
        page_size=8, n_pages=512, max_batch=8, max_pages_per_seq=37,
        prefill_chunk=32, attn_impl="fused"))
    eng.submit_trace(trace)
    torch.cuda.synchronize()
    prof = None
    t0 = time.perf_counter()
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            eng.drain()
            torch.cuda.synchronize()
    else:
        eng.drain()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, eng.backend.n_forwards, prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0 = all 36)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = configs.get_config("qwen3_8b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = transformer.init(cfg, seed=0, device="cuda")
    trace = synth_trace(TrafficConfig(
        n_requests=8, arrival_rate=1e9, prompt_len_min=128,
        prompt_len_max=256, gen_len_min=32, gen_len_max=32,
        vocab_size=cfg.vocab_size, seed=0))
    _drain(cfg, model, trace[:1], profile=False)          # warm-up
    wall, n_fwd, _ = _drain(cfg, model, trace, profile=False)
    pwall, _, prof = _drain(cfg, model, trace, profile=True)

    groups: dict[str, float] = {}
    kernels: dict[str, float] = {}
    n_kernels = 0
    for evt in prof.key_averages():
        # device rows only: an operator's row repeats its kernels' time
        us = evt.self_device_time_total
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        n_kernels += evt.count
        kernels[evt.key] = kernels.get(evt.key, 0.0) + us
        groups[_group(evt.key)] = groups.get(_group(evt.key), 0.0) + us
    device_s = sum(groups.values()) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    report = {
        "card": card, "layers": cfg.n_layers, "forwards": n_fwd,
        "wall_s": wall, "ms_per_forward": wall / n_fwd * 1e3,
        "profiled_wall_s": pwall, "device_s": device_s,
        "device_busy_share": device_s / wall,
        "device_ms_per_forward": device_s / n_fwd * 1e3,
        "kernels_per_forward": n_kernels / n_fwd,
        "device_s_by_group": {k: v * 1e-6 for k, v in groups.items()},
        "top_kernels_ms": {k: v * 1e-3 for k, v in top},
    }
    print(f"{card} | qwen3_8b {cfg.n_layers} layers bf16 fused | "
          f"{n_fwd} forwards, {n_kernels / n_fwd:.0f} kernels each")
    print(f"drain wall {wall:.3f} s ({wall / n_fwd * 1e3:.2f} ms/forward) | "
          f"kernel time {device_s:.3f} s ({report['device_ms_per_forward']:.2f}"
          f" ms/forward), {report['device_busy_share']:.1%} of the "
          f"unprofiled wall | profiled drain {pwall:.3f} s")
    if device_s <= 0:
        print("the profiler recorded no device time")
    for name, sec in sorted(report["device_s_by_group"].items(),
                            key=lambda kv: -kv[1]):
        print(f"  {name:16s} {sec * 1e3:9.2f} ms  {sec / device_s:6.1%}")
    for name, ms in report["top_kernels_ms"].items():
        print(f"  {ms:9.2f} ms  {name[:100]}")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
