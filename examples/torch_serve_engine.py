"""Continuous-batching engine walkthrough on the PyTorch port (the
counterpart of `examples/serve_engine.py`).

Submits a handful of mixed-length requests — greedy plus one
stochastic (temperature/top-k/top-p on its own RNG lane) — to the
`repro.serve` engine, steps it manually (so you can watch the
scheduler compose chunked prefill batches with decode into mixed
steps), then drains and prints the per-request outputs and engine
metrics.

Every family rides the same engine via the `SequenceBackend` API: the
default qwen3_8b arch serves over the paged-KV backend (watch for
"share" events — two of the requests share a resident prompt prefix
copy-on-write), while `--arch rwkv6_3b` (or zamba2_7b) serves over the
state-slot backend, where each request holds one fixed-size recurrent
state slot instead of growing KV pages.

The weights are drawn from a torch generator on `--device`, so tokens
differ from the reference's; the schedule is the reference's. On the
card the paged-KV backend's attention runs the paged_attention kernel
(`attn_impl="fused"`).

Run: PYTHONPATH=src python examples/torch_serve_engine.py
         [--arch rwkv6_3b] [--scheduler fcfs] [--prefill-chunk 8]
         [--device cuda|cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import configs
from repro_torch.serve import EngineConfig, SamplingParams, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--scheduler", default="cost",
                    choices=["cost", "fcfs"])
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens per prefill chunk (small, so "
                         "the 24-token prompt visibly spans steps)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = dataclasses.replace(configs.get_config(args.arch, smoke=True),
                              compute_dtype="float32")
    # observability="trace" retains the structured event log this
    # walkthrough reads back (the default "metrics" level keeps only
    # counters/histograms and retains no events)
    eng = ServeEngine(cfg, ecfg=EngineConfig(
        page_size=8, n_pages=64, max_batch=3, max_pages_per_seq=8,
        max_seq_len=64, prefill_chunk=args.prefill_chunk,
        scheduler=args.scheduler, observability="trace",
        attn_impl="fused"), device=args.device)
    print(f"arch {cfg.name} ({cfg.family}) served by "
          f"{type(eng.backend).__name__}")

    rng = np.random.default_rng(0)
    print(f"submitting 7 requests with mixed prompt/gen lengths "
          f"({args.scheduler} scheduler)")
    prefix = rng.integers(2, cfg.vocab_size, 17).astype(np.int32)
    for plen, glen in ((5, 8), (17, 4), (9, 12), (3, 6), (24, 5)):
        if plen == 17:
            prompt = prefix                # resident prefix for 5 and 6
        else:
            prompt = rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
        rid = eng.submit(prompt, max_new_tokens=glen)
        print(f"  request {rid}: prompt {plen} tokens, gen {glen}")
    # two late arrivals extend request 1's prompt: admission matches
    # its resident full pages and shares them copy-on-write (watch for
    # "share" events and a prefix hit rate > 0 in the metrics)
    for _ in range(2):
        prompt = np.concatenate(
            [prefix, rng.integers(2, cfg.vocab_size, 4).astype(np.int32)])
        rid = eng.submit(prompt, max_new_tokens=4, arrival_time=1e-6)
        print(f"  request {rid}: prompt {len(prompt)} tokens (shares "
              f"request 1's 17-token prompt as a prefix), gen 4")
    # one stochastic request rides the same batches on its own RNG
    # lane: its tokens are deterministic for (seed, prompt, params)
    # no matter how the scheduler packs it with the greedy lanes
    sampled = eng.submit(
        rng.integers(2, cfg.vocab_size, 7).astype(np.int32),
        max_new_tokens=6, arrival_time=1e-6,
        sampling=SamplingParams(temperature=0.9, top_k=40, top_p=0.95,
                                seed=7))
    print(f"  request {sampled}: prompt 7 tokens, gen 6 SAMPLED "
          f"(temperature 0.9, top-k 40, top-p 0.95, seed 7)")

    print("\nfirst 10 engine steps:")
    for _ in range(10):
        ev = eng.step()
        if ev is None:
            break
        kind = ev[0]
        if kind == "prefill":
            chunks = ", ".join(f"rid {r}+{n}t" for r, n in ev[1])
            print(f"  prefill  chunks [{chunks}]")
        elif kind == "decode":
            print(f"  decode   lanes={list(ev[1])}")
        elif kind == "mixed":
            chunks = ", ".join(f"rid {r}+{n}t" for r, n in ev[1])
            print(f"  mixed    chunks [{chunks}] + decode "
                  f"lanes={list(ev[2])}")
        else:
            print(f"  {kind}")
    eng.drain()

    shares = [e for e in eng.events if e[0] == "share"]
    if shares:
        print("\nprefix sharing (from the event log):")
        for _, rid, matched, _t in shares:
            print(f"  request {rid} admitted over {matched} resident "
                  f"prefix tokens (pages shared copy-on-write)")

    print("\nresults:")
    for rid, toks in eng.results().items():
        tag = "" if eng.requests[rid].sampling.greedy else "  (sampled)"
        print(f"  request {rid}: {toks[:10].tolist()}"
              f"{' ...' if len(toks) > 10 else ''}{tag}")
    m = eng.metrics()
    line = (f"\n{m['n_generated_tokens']} tokens | cache utilization "
            f"{m['cache_utilization']:.2f} (logical "
            f"{m['logical_cache_utilization']:.2f})")
    if "prefix_hit_rate" in m:      # paged-KV backend extras
        line += (f" | prefix hit rate {m['prefix_hit_rate']:.2f} | "
                 f"{m['n_cow_forks']} COW forks")
    if "n_state_slots" in m:        # state-slot backend extras
        line += f" | {m['n_state_slots']} state slots"
    print(line + f" | {m['n_sampled_tokens']} sampled tokens | "
          f"{m['n_preemptions']} preemptions | "
          f"{m['n_events']} engine events")
    print(f"energy: {m['total_energy_J']*1e6:.2f} uJ total "
          f"({m['energy_per_token_J']*1e9:.2f} nJ/token) — prefill "
          f"{m['prefill_energy_J']*1e6:.2f} uJ, decode "
          f"{m['decode_energy_J']*1e6:.2f} uJ")
    # per-request attribution: where each request's joules went
    print("per-request energy attribution (nJ):")
    for rid, a in eng.attribution().items():
        ph = a["phases"]
        print(f"  request {rid}: prefill "
              f"{ph['prefill']['energy_J']*1e9:8.1f} | decode "
              f"{ph['decode']['energy_J']*1e9:8.1f} | "
              f"{ph['sampling']['tokens']} sampled tokens")


if __name__ == "__main__":
    main()
