"""Kernel micro-benchmarks on the PyTorch port: the hand-written kernels
against their plain versions and oracles (the `benchmarks/kernel_micro.py`
rows).

sc_matmul (the ARTEMIS MAC) at 128x160x128 and 256x320x256 in the int8,
artemis and artemis_mxu modes, through the float-level wrapper
`kernels.sc_matmul.ops.sc_matmul` (per-tensor scales, no STE), held
against the same quantize-and-dequantize around its plain version
`sc_matmul_ref`, which is also the reference's oracle (the plain time
covers the same steps as the wrapper's); flash_attention causal with the
LSE at B1 H4 S256 D64 and B2 H8 S512 D64, held against its plain
version `flash_attention_ref` and the oracle `attention_ref`. Every
comparison uses the reference's tolerance, rtol = atol = 2e-4, and each
sc_matmul row records the ladder's error against the f32 product
(`rel_err_fp32`). The inputs are the reference's, drawn with
`repro_torch.prng` from the same keys.

On the card each wrapper launches its CUDA kernel, and the µs per call
come from CUDA events over 20 back-to-back calls (the plain version's
beside it), labelled with the card's name and power limit. On the CPU
the wrappers run the plain versions themselves, so only the oracle
comparison is made, and the µs are the host wall time of one call,
labelled as such.

    PYTHONPATH=src python -m benchmarks.torch_kernel_micro \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch import prng
from repro_torch.core import quantization as quantlib
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.core.quantization import SC_LEVELS
from repro_torch.device import resolve_device
from repro_torch.kernels import sc_matmul_ref
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.sc_matmul.ops import sc_matmul

SC_SHAPES = ((128, 160, 128), (256, 320, 256))
SC_MODES = ("int8", "artemis", "artemis_mxu")
FA_SHAPES = ((1, 4, 256, 64), (2, 8, 512, 64))
TOL = dict(rtol=2e-4, atol=2e-4)


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    the CPU run's label."""
    if dev.type != "cuda":
        return "cpu (plain versions, host wall time)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def timed(fn, dev: torch.device, reps: int = 20):
    """(fn(), µs per call): on the card CUDA events around `reps` more
    back-to-back calls; on the CPU the host wall time of the one call."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type != "cuda":
        return out, (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(stop) / reps * 1e3


def _hold(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |got - want|, after checking the reference's tolerance."""
    torch.testing.assert_close(got, want.to(got.device), **TOL,
                               msg=lambda m: f"{what}: {m}")
    return float((got - want.to(got.device)).abs().max())


def sc_inputs(m: int, k: int, n: int, dev) -> tuple:
    """The reference's operands: a = normal(PRNGKey(0), (m, k)),
    b = normal(fold_in(PRNGKey(0), 1), (k, n))."""
    key = prng.PRNGKey(0, dev)
    return (prng.normal(key, (m, k)),
            prng.normal(prng.fold_in(key, 1), (k, n)))


def fa_inputs(b: int, h: int, s: int, d: int, dev) -> tuple:
    """The reference's q, k, v: normals from PRNGKey(0) and its
    fold_in 2 and 3."""
    key = prng.PRNGKey(0, dev)
    return (prng.normal(key, (b, h, s, d)),
            prng.normal(prng.fold_in(key, 2), (b, h, s, d)),
            prng.normal(prng.fold_in(key, 3), (b, h, s, d)))


def sc_rows(dev: torch.device) -> list[dict]:
    card = dev.type == "cuda"
    rows = []
    for m, k, n in SC_SHAPES:
        a, b = sc_inputs(m, k, n, dev)
        exact = a @ b
        for mode in SC_MODES:
            pol = ArithmeticPolicy(mode=mode, ste=False)

            def plain(mode=mode):
                """The same float-level function on the plain version:
                per-tensor quantization, `sc_matmul_ref`, dequantize."""
                sa = quantlib.quant_scale(a, 8)
                sb = quantlib.quant_scale(b, 8)
                ref = sc_matmul_ref(quantlib.quantize(a, sa),
                                    quantlib.quantize(b, sb),
                                    mode=mode).float()
                return ref * sa * sb * (1 if mode == "int8" else SC_LEVELS)

            out, us = timed(lambda: sc_matmul(a, b, pol), dev)
            # on the CPU the wrapper runs the plain version itself
            want, plain_us = timed(plain, dev) if card else (out, us)
            err = _hold(out, want, f"sc_matmul {m}x{k}x{n} {mode}")
            rel = float(torch.linalg.norm(out - exact)
                        / torch.linalg.norm(exact))
            print(f"  {m}x{k}x{n} {mode:12s} kernel==plain (max err "
                  f"{err:.3g}) | vs fp32 rel {rel:.4f} | {us:9.2f} us/call"
                  f" (plain {plain_us:9.2f})")
            rows.append({"kernel": "sc_matmul", "shape": (m, k, n),
                         "mode": mode, "rel_err_fp32": rel,
                         "max_abs_err": err, "us": us,
                         "plain_us": plain_us})
    return rows


def fa_rows(dev: torch.device) -> list[dict]:
    card = dev.type == "cuda"
    rows = []
    for b_, h, s, d in FA_SHAPES:
        q, k, v = fa_inputs(b_, h, s, d, dev)
        (o, lse), us = timed(lambda: flash_attention(
            q, k, v, causal=True, return_lse=True), dev)
        (o_plain, lse_plain, _), plain_us = (
            timed(lambda: flash_attention_ref(q, k, v, causal=True), dev)
            if card else ((o, lse, None), us))
        o_ref, lse_ref = attention_ref(q, k, v, causal=True)
        what = f"flash_attention B{b_} H{h} S{s} D{d}"
        err = max(_hold(o, o_plain, what + " o vs plain"),
                  _hold(lse, lse_plain, what + " lse vs plain"))
        err_oracle = max(_hold(o, o_ref, what + " o vs oracle"),
                         _hold(lse, lse_ref, what + " lse vs oracle"))
        print(f"  B{b_} H{h} S{s} D{d}: kernel==plain (max err {err:.3g})"
              f", ==oracle ({err_oracle:.3g}) | {us:9.2f} us/call (plain "
              f"{plain_us:9.2f})")
        rows.append({"kernel": "flash_attention", "shape": (b_, h, s, d),
                     "max_abs_err": err, "max_abs_err_oracle": err_oracle,
                     "us": us, "plain_us": plain_us})
    return rows


def run(device="cuda") -> list[dict]:
    dev = resolve_device(device)
    label = card_label(dev)
    print(f"device: {label}")
    print("== sc_matmul (ARTEMIS MAC pipeline) ==")
    rows = sc_rows(dev)
    print("== flash_attention (LSE online-softmax) ==")
    rows += fa_rows(dev)
    for row in rows:
        row["device"] = label
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
