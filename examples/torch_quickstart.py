"""Quickstart on the PyTorch port: the ARTEMIS arithmetic ladder in a
minute (the counterpart of `examples/quickstart.py`).

The walkthrough of the reference, on `repro_torch` and its inputs (the
random numbers are jax's, drawn with `repro_torch.prng`): the TCU
multiply, a matmul under three policies, the Eq. 5 LUT softmax and a
smoke qwen3_8b forward under `artemis_mxu`, whose dense projections run
the sc_matmul kernel on the card (its launches are printed). The model's
weights come from a torch generator, so the drift differs from the
reference's.

Run: PYTHONPATH=src python examples/torch_quickstart.py
         [--device cuda|cpu]
"""
import argparse

import torch

from repro_torch import configs, prng
from repro_torch.core import (
    ARTEMIS, EXACT, INT8, ArithmeticPolicy, artemis_matmul, artemis_softmax,
    sc_multiply, sc_multiply_bitstream,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import model


def main(device="cuda") -> dict:
    """Run the walkthrough on `device`; returns the numbers it prints
    and the sc_matmul launches of the artemis_mxu forward."""
    dev = resolve_device(device)
    out = {}
    # 1. The deterministic stochastic multiply (paper §III.A.1):
    #    128-bit TCU streams; AND + popcount == floor(a*b/128).
    a, b = torch.tensor(100, device=dev), torch.tensor(90, device=dev)
    print("bitstream popcount :", int(sc_multiply_bitstream(a, b)))
    print("closed form        :", int(sc_multiply(a, b)),
          "= floor(100*90/128)")

    # 2. A matmul through the full ARTEMIS MAC pipeline: int8
    #    quantization, TCU floor-multiplies, MOMCAP group-of-20 analog
    #    accumulation, quantizing A_to_B readout, NSC sign-split reduction.
    x = prng.normal(prng.PRNGKey(0, dev), (8, 64))
    w = prng.normal(prng.PRNGKey(1, dev), (64, 32))
    exact = x @ w
    for name, policy in [("exact", EXACT), ("int8", INT8),
                         ("artemis", ARTEMIS)]:
        res = artemis_matmul(x, w, policy)
        err = float((res - exact).abs().mean() / exact.abs().mean())
        out[f"rel_err_{name}"] = err
        print(f"{name:8s} mean rel err vs fp32: {err:.4f}")

    # 3. The division-free LSE softmax with NSC LUT emulation (Eq. 5).
    y = prng.normal(prng.PRNGKey(2, dev), (4, 16)) * 3
    err = float((artemis_softmax(y, axis=-1)
                 - torch.softmax(y, dim=-1)).abs().max())
    out["softmax_max_err"] = err
    print("LUT softmax max err:", err)

    # 4. A full model forward under ARTEMIS arithmetic (qwen3-8b, smoke
    #    size); on the card every dense projection runs sc_matmul.
    cfg = configs.get_config("qwen3_8b", smoke=True)
    params = model.init(cfg, seed=3, device=dev)
    tokens = prng.randint(prng.PRNGKey(4, dev), (2, 16), 0, cfg.vocab_size)
    logits_exact, _, _ = model.apply(params, cfg, {"tokens": tokens})
    reset_launch_counts()               # count this forward's alone
    logits_artemis, _, _ = model.apply(
        params, cfg, {"tokens": tokens},
        policy=ArithmeticPolicy(mode="artemis_mxu"))
    out["sc_matmul_launches"] = launch_counts["sc_matmul"]
    drift = float((logits_artemis.float() - logits_exact.float()).abs()
                  .mean())
    out["logits_drift"] = drift
    print(f"model logits drift under ARTEMIS arithmetic: {drift:.4f} "
          f"({out['sc_matmul_launches']} sc_matmul kernel launches)")
    print("OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
