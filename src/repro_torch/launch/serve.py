"""Serving launcher: batched requests against the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 6 --max-new 8

Weights are random, drawn from ``--seed`` (nothing is downloaded).  Runs
on the CUDA card by default; ``--device cpu`` (with ``--reduced``) runs
the plain PyTorch path on the CPU.  ``--kv-dtype int8|fp8`` stores the
paged pool SCLAD-compressed; ``--mode wave`` serves lockstep waves over
dense stripes instead of continuous batching.  The single-engine closed loop of
``repro.launch.serve``: every request is submitted up front and the
engine runs until the queue drains.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import kv_quant
from repro_torch.models import model as M
from repro_torch.serving.engine import PREEMPT_POLICIES, ServingEngine
from repro_torch.serving.sampler import SamplerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "continuous", "wave"],
                    help="scheduler: continuous batching (attention "
                         "families) or the lockstep wave baseline")
    ap.add_argument("--block-size", type=int, default=8,
                    help="tokens per paged-KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV block pool size (default: max_batch stripes' "
                         "worth)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="max prompt tokens prefilled per scheduler step "
                         "(0 = whole prompt in one call)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share KV blocks across requests with a common "
                         "prompt prefix")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode iterations per host sync")
    ap.add_argument("--attn-kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="paged attention implementation for decode AND "
                         "prefill: the CUDA kernels on the card with "
                         "'auto', always with 'on', the plain PyTorch "
                         "versions with 'off'")
    ap.add_argument("--preempt-policy", default="youngest",
                    choices=list(PREEMPT_POLICIES),
                    help="which in-flight request pool pressure preempts")
    ap.add_argument("--kv-dtype", default=None,
                    choices=list(kv_quant.KV_DTYPES),
                    help="paged KV pool representation: fp/bf16, or the "
                         "SCLAD compressed encodings int8/fp8 (payload + "
                         "fp32 per-position-per-head scales); f8 is not "
                         "ported")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to "
                         "every request (exercises the prefix cache)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, device=device)
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch,
        max_len=64 + args.shared_prefix + args.max_new, seed=args.seed,
        mode=args.mode, kv_dtype=args.kv_dtype,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk or None,
        prefix_cache=args.prefix_cache, decode_steps=args.decode_steps,
        attn_kernel=args.attn_kernel, preempt_policy=args.preempt_policy,
        sampler=SamplerConfig(temperature=args.temperature, top_k=50),
        device=device)

    rng = np.random.default_rng(args.seed)
    system = rng.integers(1, cfg.vocab_size, size=args.shared_prefix)
    for i in range(args.requests):
        plen = int(rng.integers(4, 17))
        prompt = np.concatenate(
            [system, rng.integers(1, cfg.vocab_size, size=plen)])
        deadline = None
        if args.preempt_policy == "deadline":
            # Demo deadlines: arrival order + a work proxy.
            deadline = float(i + len(prompt) + args.max_new)
        engine.submit(prompt, max_new_tokens=args.max_new, deadline=deadline)
    results = engine.run()
    for uid, toks in sorted(results.items())[:4]:
        print(f"req {uid}: {toks[:16]}{'...' if len(toks) > 16 else ''}")
    s = engine.stats
    kv = (f", KV block {s.kv_block_bytes} B, peak pool "
          f"{s.peak_pool_bytes} B" if engine.mode == "continuous" else "")
    print(f"{engine.mode} engine, kv_dtype {engine.cfg.kv_dtype}{kv}")
    print(f"device {device}: prefill {s.prefill_tokens} tok in "
          f"{s.prefill_s:.2f}s ({s.prefill_tokens_per_s:.1f} tok/s, mean "
          f"TTFT {s.mean_ttft_s * 1e3:.1f}ms) ({s.prefill_chunks} chunks, "
          f"prefix hit-rate {s.prefix_hit_rate:.0%}); generated "
          f"{s.generated_tokens} tok in {s.decode_s:.2f}s "
          f"({s.tokens_per_s:.1f} tok/s, lane occupancy "
          f"{s.slot_occupancy:.0%}, KV utilization "
          f"{s.block_utilization:.0%}, {s.preemptions} preemptions)")
    return results


if __name__ == "__main__":
    main()
