"""Serving launcher for the PyTorch port (counterpart of
`repro.launch.serve`).

  --mode static   (the default) one batch of prompts, prefilled once
                  over the dense KV cache, then decoded in lockstep
                  with greedy sampling. Under the exact policy every
                  attention runs through the hand-written
                  flash-attention kernel; under a quantized one the
                  projections run through sc_matmul and attention
                  through the int8 ladder.
  --mode engine   the `repro_torch.serve` engine: per-request lifecycles
                  with chunked+batched prefill composed with decode into
                  mixed steps by the ARTEMIS-cost-aware scheduler,
                  driven by a synthetic Poisson trace: the attention
                  families over the paged KV backend (COW prefix
                  sharing, `--prefix-groups` et al.), the recurrent
                  ones (rwkv6, zamba2) over the state-slot backend
                  (`--n-slots` sizes its pool). `--attn-impl fused`
                  runs attention through the hand-written
                  paged-attention kernel. With
                  `--temperature > 0` a share of the requests
                  (`--sampled-fraction`) decodes stochastically on
                  per-request RNG lanes (`--top-k`, `--top-p`,
                  `--sample-seed`); `--trace-json` exports the run's
                  event log as Chrome trace-event JSON.
                  `--policy int8|artemis|artemis_mxu` runs every dense
                  projection through the hand-written sc_matmul kernel
                  and the attention contractions through the int8
                  ladder (with `--attn-impl gather`).

It prints the same summary lines as `repro.launch.serve`. Weights are
random, drawn from `--seed` with a torch generator on `--device`
(default cuda), and so are the static prompts (from `--seed` + 1, as
the reference draws them with jax.random): the port's tokens differ
from the reference's for the same seed. The dense, MoE, rwkv6 and
zamba2 families run; the multimodal ones are not ported yet.

Wall-clock use here is intentional: the CLI reports real prefill,
decode and drain seconds next to the virtual-clock metrics.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.device import resolve_device
from repro_torch.launch import steps as stepslib
from repro_torch.models import model as modellib
from repro_torch.serve import (EngineConfig, ServeEngine, TrafficConfig,
                               export_chrome_trace, synth_trace)
from repro_torch.serve.traffic import trace_stats


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "qwen3_8b", smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 16,
          policy_mode: str = "exact", seed: int = 0, params=None,
          device="cuda", attn_impl: str | None = None) -> dict:
    """Static-batch serving: one prefill, lockstep greedy decode. The
    first decode step takes the prefill's argmax token; "generated"
    holds the gen_len tokens the decode steps sample, as the
    reference's. The f32 dense cache is updated in place. Given
    `params`, the model serves under the config it was built with
    (`params.cfg`), and `arch`/`smoke` are not read."""
    dev = resolve_device(device)
    if params is None:
        cfg = configs.get_config(arch, smoke=smoke)
        params = modellib.init(cfg, seed=seed, device=dev)
    cfg = params.cfg
    policy = ArithmeticPolicy(mode=policy_mode)
    prefill = stepslib.make_prefill_step(cfg, policy, attn_impl)
    decode = stepslib.make_decode_step(cfg, policy, attn_impl)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(2, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    cache = modellib.init_cache(cfg, batch, prompt_len + gen_len,
                                dtype=torch.float32, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    nxt = stepslib.greedy_sample(logits)
    t0 = time.perf_counter()
    for _ in range(gen_len):
        logits, cache = decode(params, nxt[:, None], cache)
        nxt = stepslib.greedy_sample(logits)
        out_tokens.append(nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {
        "generated": torch.stack(out_tokens, dim=1),
        "prompt": tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * gen_len / max(t_decode, 1e-9),
        "cache_index": cache["index"],
    }


def serve_engine(arch: str = "qwen3_8b", smoke: bool = True,
                 n_requests: int = 16, arrival_rate: float = 200.0,
                 prompt_len: int = 32, gen_len: int = 16,
                 policy_mode: str = "exact", seed: int = 0,
                 page_size: int = 8, n_pages: int = 256,
                 max_batch: int = 8, scheduler: str = "cost",
                 prefill_chunk: int = 32, prefix_sharing: bool = True,
                 prefix_groups: int = 0, prefix_len: int = 0,
                 n_slots: int = 0,
                 sampled_fraction: float = 0.0, temperature: float = 0.8,
                 top_k: int = 0, top_p: float = 1.0, sample_seed: int = -1,
                 observability: str = "metrics",
                 trace_json: str | None = None,
                 attn_impl: str = "gather", device="cuda",
                 params=None) -> dict:
    """Continuous-batching serving over a synthetic Poisson trace; the
    trace is the reference CLI's for the same arguments. With
    `sampled_fraction > 0` that share of the requests decodes
    stochastically (temperature/top-k/top-p on per-request RNG lanes,
    deterministic for a fixed trace seed); the rest stay greedy.
    `trace_json` (which implies observability="trace") exports the
    run's event log as Chrome trace-event JSON over the virtual
    clock."""
    dev = resolve_device(device)
    cfg = configs.get_config(arch, smoke=smoke)
    if trace_json is not None:
        observability = "trace"
    max_len = prefix_len + prompt_len + gen_len
    ecfg = EngineConfig(
        page_size=page_size, n_pages=n_pages, max_batch=max_batch,
        max_pages_per_seq=max(1, -(-max_len // page_size)) + 1,
        prefill_chunk=prefill_chunk, scheduler=scheduler,
        prefix_sharing=prefix_sharing, n_slots=n_slots,
        max_seq_len=max(max_len + 1, 2), observability=observability,
        attn_impl=attn_impl)
    if params is None:
        params = modellib.init(cfg, seed=seed, device=dev)
    eng = ServeEngine(cfg, params=params,
                      policy=ArithmeticPolicy(mode=policy_mode),
                      ecfg=ecfg, seed=seed, device=dev)
    trace = synth_trace(TrafficConfig(
        n_requests=n_requests, arrival_rate=arrival_rate,
        prompt_len_min=max(1, prompt_len // 2), prompt_len_max=prompt_len,
        gen_len_min=max(1, gen_len // 2), gen_len_max=gen_len,
        vocab_size=cfg.vocab_size, seed=seed,
        n_prefix_groups=prefix_groups, prefix_len=prefix_len,
        sampled_fraction=sampled_fraction, temperature=temperature,
        top_k=top_k, top_p=top_p, sample_seed=sample_seed))
    eng.submit_trace(trace)
    _sync(dev)
    t0 = time.perf_counter()
    eng.drain()
    _sync(dev)
    wall = time.perf_counter() - t0
    m = eng.metrics()
    m["wall_s"] = wall
    m["wall_tok_per_s"] = m["n_generated_tokens"] / max(wall, 1e-9)
    m["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    if trace_json is not None:
        export_chrome_trace(
            eng.events, trace_json,
            metadata={"arch": arch, "seed": seed,
                      "scheduler": scheduler, **trace_stats(trace)})
    return {"metrics": m, "results": eng.results(),
            "events": eng.events, "attribution": eng.attribution(),
            "engine": eng}


def summary_lines(m: dict) -> list[str]:
    """The reference CLI's summary lines for engine metrics `m`."""
    line = (f"engine: {m['n_done']} requests, "
            f"{m['n_generated_tokens']} tokens "
            f"({m['n_sampled_tokens']} sampled) | "
            f"{m['wall_tok_per_s']:.1f} tok/s wall | "
            f"p50 {m['p50_latency_s']*1e3:.3f}ms "
            f"p99 {m['p99_latency_s']*1e3:.3f}ms "
            f"p99-ttft {m['p99_ttft_s']*1e3:.3f}ms (virtual) | "
            f"cache util {m['cache_utilization']:.2f} "
            f"(logical {m['logical_cache_utilization']:.2f})")
    if "prefix_hit_rate" in m:       # paged-KV backend extras
        line += (f" | prefix hits {m['n_prefix_hits']} "
                 f"(rate {m['prefix_hit_rate']:.2f}) | "
                 f"{m['n_cow_forks']} COW forks")
    if "n_state_slots" in m:         # state-slot backend extras
        line += f" | {m['n_state_slots']} state slots"
    return [
        line + f" | {m['n_preemptions']} preemptions",
        (f"energy: {m['total_energy_J']*1e6:.2f} uJ total "
         f"({m['energy_per_token_J']*1e9:.2f} nJ/token) | "
         f"prefill {m['prefill_energy_J']*1e6:.2f} uJ / "
         f"decode {m['decode_energy_J']*1e6:.2f} uJ | "
         f"busy {m['busy_virtual_s']*1e3:.3f} of "
         f"{m['virtual_time_s']*1e3:.3f} virtual ms"),
    ]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="static",
                    choices=["static", "engine"])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size / engine decode lanes")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--policy", default="exact",
                    choices=["exact", "int8", "artemis", "artemis_mxu"])
    ap.add_argument("--n-requests", type=int, default=16,
                    help="engine: synthetic trace length")
    ap.add_argument("--arrival-rate", type=float, default=200.0,
                    help="engine: Poisson arrivals per virtual second")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--n-pages", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per prefill chunk")
    ap.add_argument("--scheduler", default="cost",
                    choices=["cost", "fcfs"])
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable COW prefix/page sharing")
    ap.add_argument("--n-slots", type=int, default=0,
                    help="engine: state-slot pool size for recurrent "
                         "archs (0 = auto: batch lanes + 1)")
    ap.add_argument("--prefix-groups", type=int, default=0,
                    help="shared-prefix trace groups (0 = independent "
                         "prompts)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="tokens shared within a prefix group")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights + synthetic trace seed")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="engine: sampling temperature for sampled "
                         "requests (0 = all-greedy trace)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="engine: top-k truncation for sampled "
                         "requests (0 = none)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="engine: nucleus mass for sampled requests "
                         "(1.0 = none)")
    ap.add_argument("--sample-seed", type=int, default=-1,
                    help="engine: fixed RNG-lane seed for every "
                         "sampled request (-1 = per-request seeds "
                         "from the trace rng)")
    ap.add_argument("--sampled-fraction", type=float, default=None,
                    help="engine: fraction of requests decoded "
                         "stochastically (default: 1.0 when "
                         "--temperature > 0, else 0)")
    ap.add_argument("--observability", default="metrics",
                    choices=["metrics", "trace"],
                    help="engine: 'trace' retains the structured "
                         "event log (span assembly / Perfetto export)")
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="engine: export the run as Chrome trace-event "
                         "JSON to PATH (implies --observability trace)")
    ap.add_argument("--attn-impl", default="gather",
                    choices=["gather", "fused"],
                    help="engine: paged attention core; 'fused' walks "
                         "the block table inside the paged-attention "
                         "kernel (static mode runs the flash-attention "
                         "kernel under the exact policy)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    sampled_fraction = args.sampled_fraction
    if sampled_fraction is None:
        sampled_fraction = 1.0 if args.temperature > 0 else 0.0
    elif sampled_fraction > 0 and args.temperature <= 0:
        ap.error("--sampled-fraction > 0 requires --temperature > 0")

    if args.mode == "static":
        out = serve(arch=args.arch, smoke=not args.full, batch=args.batch,
                    prompt_len=args.prompt_len, gen_len=args.gen_len,
                    policy_mode=args.policy, seed=args.seed,
                    device=args.device)
        print(f"prefill {out['prefill_s']*1e3:.0f}ms | decode "
              f"{out['decode_tok_per_s']:.1f} tok/s | "
              f"generated shape {tuple(out['generated'].shape)}")
        return
    out = serve_engine(
        arch=args.arch, smoke=not args.full, n_requests=args.n_requests,
        arrival_rate=args.arrival_rate, prompt_len=args.prompt_len,
        gen_len=args.gen_len, policy_mode=args.policy, seed=args.seed,
        page_size=args.page_size,
        n_pages=args.n_pages, max_batch=args.batch,
        scheduler=args.scheduler, prefill_chunk=args.prefill_chunk,
        prefix_sharing=not args.no_prefix_sharing,
        prefix_groups=args.prefix_groups, prefix_len=args.prefix_len,
        n_slots=args.n_slots,
        sampled_fraction=sampled_fraction, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, sample_seed=args.sample_seed,
        observability=args.observability, trace_json=args.trace_json,
        attn_impl=args.attn_impl, device=args.device)
    m = out["metrics"]
    for line in summary_lines(m):
        print(line)
    if args.trace_json:
        print(f"trace: wrote {args.trace_json} "
              f"({m['n_events']} counted events) — open at "
              f"https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
