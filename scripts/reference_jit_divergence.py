"""The JAX package's serve engine against itself under a quantized
policy: the same smoke trace drained jitted and op by op
(`jax.disable_jit`), at float32 on the CPU, with the trained
`model.init` weights. The tokens part: the two ways round their f32
reductions (norms, products, softmax sums) apart in the last bits, and a
quantized policy turns such a bit now and then into another int8 value
or another artemis readout level. Cross-implementation token identity
under a quantized policy is therefore not a property the reference has
with itself; tests/test_torch_moe.py holds the port's quantized layers
to the reference's on the same inputs instead.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_jit_divergence.py \
        [--arch qwen2_moe_a2_7b] [--modes int8 artemis]

Op by op the default trace takes one to two minutes a mode on a CPU.
Prints one line per mode and a JSON summary as the last line.
"""
import argparse
import dataclasses
import json
import time

import jax
import numpy as np

from repro import configs
from repro.core.policy import ArithmeticPolicy
from repro.models import model as jmodel
from repro.serve import EngineConfig, ServeEngine, TrafficConfig, synth_trace

# the trace and engine of tests/test_torch_moe_engine.py
TRAFFIC = dict(n_requests=4, arrival_rate=2e5, prompt_len_min=3,
               prompt_len_max=12, gen_len_min=2, gen_len_max=5, seed=3)
ENGINE = dict(page_size=8, n_pages=48, max_batch=3, max_pages_per_seq=4,
              prefill_chunk=8, observability="trace")


def drain(cfg, params, mode):
    eng = ServeEngine(cfg, params=params,
                      policy=ArithmeticPolicy(mode=mode),
                      ecfg=EngineConfig(**ENGINE))
    eng.submit_trace(synth_trace(TrafficConfig(
        **TRAFFIC, vocab_size=cfg.vocab_size)))
    eng.drain()
    return eng.results()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_moe_a2_7b")
    ap.add_argument("--modes", nargs="+", default=["int8", "artemis"])
    args = ap.parse_args()
    cfg = dataclasses.replace(configs.get_config(args.arch, smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    summary = {}
    for mode in args.modes:
        t0 = time.perf_counter()
        jitted = drain(cfg, params, mode)
        t1 = time.perf_counter()
        with jax.disable_jit():
            eager = drain(cfg, params, mode)
        t2 = time.perf_counter()
        parted = {rid: {"jit": jitted[rid].tolist(),
                        "disable_jit": eager[rid].tolist()}
                  for rid in sorted(jitted)
                  if not np.array_equal(jitted[rid], eager[rid])}
        n_tok = sum(len(v) for v in jitted.values())
        print(f"{args.arch} {mode}: {len(parted)} of {len(jitted)} requests "
              f"part ({n_tok} tokens; jit {t1 - t0:.1f} s, disable_jit "
              f"{t2 - t1:.1f} s): {parted}")
        summary[mode] = dict(n_requests=len(jitted), n_parted=len(parted),
                             parted=parted)
    print(json.dumps({"arch": args.arch, "modes": summary}))


if __name__ == "__main__":
    main()
