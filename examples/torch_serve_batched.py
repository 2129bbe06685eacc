"""End-to-end static-batch serving on the PyTorch port (the counterpart
of `examples/serve_batched.py`).

Serves a small model with batched requests: one prefill over the prompt
batch, then token-by-token greedy decode, with the ARTEMIS arithmetic
ladder applied to every matmul. Under the exact policy every attention
runs the flash_attention kernel on the card.

Run: PYTHONPATH=src python examples/torch_serve_batched.py
         [--policy artemis_mxu] [--device cuda|cpu]
"""
import argparse

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--policy", default="exact")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print(f"serving {args.arch} (smoke config) with policy={args.policy} "
          f"on {args.device}")
    out = serve(arch=args.arch, smoke=True, batch=args.batch,
                prompt_len=48, gen_len=args.gen_len,
                policy_mode=args.policy, device=args.device)
    print(f"prefill: {out['prefill_s']*1e3:7.1f} ms")
    print(f"decode : {out['decode_tok_per_s']:7.1f} tok/s "
          f"({args.batch} streams)")
    print(f"tokens : {out['generated'][0][:12].tolist()} ...")
    print(f"cache index after run: {out['cache_index']}")


if __name__ == "__main__":
    main()
