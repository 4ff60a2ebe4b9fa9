"""Serving launcher: batched requests against the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 6 --max-new 8

``--arch`` takes every registered config: the dense family
(tinyllama-1.1b, stablelm-1.6b, phi3-medium-14b, granite-3-8b), the moe
family (qwen2-moe-a2.7b, qwen3-moe-235b-a22b), the vlm family
(internvl2-26b, every request behind the zero patch-embedding stub, as
in ``repro.launch.serve``), and the recurrent families, served in waves
(``--mode auto`` resolves to ``wave``; ``continuous`` raises): ssm
(mamba2-1.3b) and hybrid (zamba2-7b), whose prompts longer than the SSD
chunk (256; 32 reduced) must be a multiple of it, and audio
(whisper-base, behind zero stub frames).  Weights are random, drawn from
``--seed`` (nothing is downloaded).  Runs on the CUDA card by default; ``--device
cpu`` (with ``--reduced``) runs the plain PyTorch path on the CPU.
``--kv-dtype int8|fp8`` stores the paged pool SCLAD-compressed;
``--mode wave`` serves lockstep waves over dense stripes instead of
continuous batching.  ``--spec-decode ngram`` (``--spec-k``) speculates:
drafts from each request's own history, verified in one paged prefill
pass per step.

By default the single-engine closed loop: every request is submitted up
front and the engine runs until the queue drains.  ``--frontend async``
serves an open-loop Poisson trace (``--arrival-rate`` req/s) through the
``AsyncFrontend`` (``--max-queue-depth`` backpressure, ``--breaker-*``
circuit breaker) and prints a JSON summary of client-side latency
percentiles and goodput under ``--slo-ttft``.  With ``--replicas N`` the
trace goes through a ``ReplicaRouter`` over N engines that share one set
of weights (``--router-policy``, ``--retry-budget``);
``--fault-crash-replica`` / ``--fault-crash-tick`` crash one replica,
``--fault-seed`` wraps every replica in a seeded chaos plan and
``--drain-replica`` starts one drained.  Every engine is warmed closed-loop
(``serving.warmup``) before the faults wrap it and the clock starts:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --device cpu --frontend async --replicas 2 \
      --spec-decode ngram --fault-crash-replica 1 --fault-crash-tick 6
"""
from __future__ import annotations

import argparse
import json
import warnings

import numpy as np

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import kv_quant
from repro_torch.models import model as M
from repro_torch.serving.engine import PREEMPT_POLICIES, ServingEngine
from repro_torch.serving.faults import FaultPlan, FaultyEngine
from repro_torch.serving.frontend import CircuitBreaker
from repro_torch.serving.openloop import poisson_trace, run_open_loop
from repro_torch.serving.router import ROUTER_POLICIES, run_open_loop_router
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.spec import SPEC_DECODE_MODES
from repro_torch.serving.warmup import trace_prompt_lens, warmup_prefill


def resolve_attn_kernel_arg(attn_kernel, decode_kernel) -> str:
    """Fold the deprecated ``--decode-kernel`` spelling into
    ``--attn-kernel`` (with a DeprecationWarning), defaulting to "auto"."""
    if decode_kernel is not None:
        warnings.warn(
            "--decode-kernel is deprecated; the knob now selects the "
            "prefill kernel too — use --attn-kernel",
            DeprecationWarning, stacklevel=2)
        if attn_kernel is not None and attn_kernel != decode_kernel:
            raise SystemExit(
                f"conflicting --attn-kernel {attn_kernel} and "
                f"--decode-kernel {decode_kernel}")
        return decode_kernel
    return attn_kernel or "auto"


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
    ap.add_argument("--attn-kernel", default=None,
                    choices=["auto", "on", "off"],
                    help="paged attention implementation for decode AND "
                         "prefill: the CUDA kernels on the card with "
                         "'auto', always with 'on', the plain PyTorch "
                         "versions with 'off' (default: 'auto')")
    ap.add_argument("--decode-kernel", default=None,
                    choices=["auto", "on", "off"],
                    help="DEPRECATED alias of --attn-kernel (the knob now "
                         "selects the prefill kernel too)")
    ap.add_argument("--preempt-policy", default="youngest",
                    choices=list(PREEMPT_POLICIES),
                    help="which in-flight request pool pressure preempts")
    ap.add_argument("--kv-dtype", default=None,
                    choices=list(kv_quant.KV_DTYPES),
                    help="KV cache representation: fp/bf16; f8 "
                         "(float8_e4m3fn stripes and pool, no scales, half "
                         "the bytes); or the SCLAD compressed pool "
                         "encodings int8/fp8 (payload + fp32 "
                         "per-position-per-head scales)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to "
                         "every request (exercises the prefix cache)")
    ap.add_argument("--spec-decode", default="off",
                    choices=list(SPEC_DECODE_MODES),
                    help="speculative multi-token decoding: 'ngram' drafts "
                         "continuations from each request's own history, "
                         "verifies them in one paged prefill pass and "
                         "rolls rejected K/V back")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens proposed per lane per step "
                         "(with --spec-decode)")
    ap.add_argument("--frontend", default="sync", choices=["sync", "async"],
                    help="'sync': submit everything up front and drain "
                         "closed-loop; 'async': open-loop Poisson arrivals "
                         "through the AsyncFrontend, reporting client-side "
                         "tail latency and goodput under the SLO")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="[async] open-loop Poisson arrival rate, req/s")
    ap.add_argument("--max-queue-depth", type=int, default=32,
                    help="[async] max accepted-but-unfinished requests; "
                         "submits beyond it are rejected (backpressure)")
    ap.add_argument("--slo-ttft", type=float, default=2.0,
                    help="[async] client-side TTFT SLO (seconds) for the "
                         "goodput report")
    ap.add_argument("--breaker-window", type=int, default=16,
                    help="[async] circuit breaker: sliding window of "
                         "scheduler ticks scanned for pressure")
    ap.add_argument("--breaker-trip", type=int, default=4,
                    help="[async] pressure ticks within the window that "
                         "trip the breaker open")
    ap.add_argument("--breaker-sat", type=float, default=1.0,
                    help="[async] live-block pool saturation fraction that "
                         "counts a tick as pressure")
    ap.add_argument("--breaker-cooldown", type=int, default=8,
                    help="[async] ticks the breaker stays open before "
                         "half-opening")
    ap.add_argument("--breaker-probes", type=int, default=1,
                    help="[async] probe requests admitted half-open")
    ap.add_argument("--replicas", type=int, default=1,
                    help="[async] engine replicas behind a prefix-affinity "
                         "router, all sharing one set of weights")
    ap.add_argument("--router-policy", default="affinity",
                    choices=list(ROUTER_POLICIES),
                    help="[async, --replicas > 1] placement policy")
    ap.add_argument("--fault-crash-replica", type=int, default=None,
                    help="[async, --replicas > 1] crash this replica at "
                         "--fault-crash-tick; the router fails its "
                         "in-flight requests over")
    ap.add_argument("--fault-crash-tick", type=int, default=24,
                    help="[async] engine-step index at which "
                         "--fault-crash-replica dies")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="[async] wrap every replica in a seeded chaos plan "
                         "(replica i uses seed + i)")
    ap.add_argument("--drain-replica", type=int, default=None,
                    help="[async, --replicas > 1] start with this replica "
                         "administratively drained")
    ap.add_argument("--retry-budget", type=int, default=3,
                    help="[async] max failover re-homings per request")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.replicas > 1 and args.frontend != "async":
        raise SystemExit("--replicas requires --frontend async (the "
                         "router fronts AsyncFrontend replicas)")
    for flag, val in (("--fault-crash-replica", args.fault_crash_replica),
                      ("--drain-replica", args.drain_replica)):
        if val is not None:
            if args.replicas < 2:
                raise SystemExit(f"{flag} needs --replicas >= 2 (a peer "
                                 f"must absorb the traffic)")
            if not 0 <= val < args.replicas:
                raise SystemExit(f"{flag} {val} out of range for "
                                 f"--replicas {args.replicas}")
    if args.fault_seed is not None and args.frontend != "async":
        raise SystemExit("--fault-seed requires --frontend async")
    attn_kernel = resolve_attn_kernel_arg(args.attn_kernel,
                                          args.decode_kernel)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, device=device)

    def make_engine():
        return ServingEngine(
            cfg, params, max_batch=args.max_batch,
            max_len=64 + args.shared_prefix + args.max_new, seed=args.seed,
            mode=args.mode, kv_dtype=args.kv_dtype,
            block_size=args.block_size, num_blocks=args.num_blocks,
            prefill_chunk=args.prefill_chunk or None,
            prefix_cache=args.prefix_cache, decode_steps=args.decode_steps,
            attn_kernel=attn_kernel, preempt_policy=args.preempt_policy,
            spec_decode=args.spec_decode, spec_k=args.spec_k,
            sampler=SamplerConfig(temperature=args.temperature, top_k=50),
            device=device)

    engine = make_engine()
    rng = np.random.default_rng(args.seed)
    system = rng.integers(1, cfg.vocab_size, size=args.shared_prefix)
    if args.frontend == "async":
        return serve_async(args, cfg, engine, make_engine, rng, system)
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
    if engine.spec_decode != "off":
        print(f"spec[{engine.spec_decode}] {s.spec_passes} verify passes, "
              f"draft acceptance {s.spec_acceptance_rate:.0%} "
              f"({s.spec_accepted}/{s.spec_proposed})")
    return results


def serve_async(args, cfg, engine, make_engine, rng, system) -> dict:
    """The open-loop service posture: warm every replica closed-loop, wrap
    the faulty ones, run the Poisson trace through one frontend or the
    router, print the summary JSON and return it."""
    if engine.mode != "continuous":
        raise SystemExit("--frontend async requires the continuous "
                         "scheduler (got mode=wave)")
    trace = poisson_trace(
        rng, args.requests, args.arrival_rate, cfg.vocab_size,
        prompt_len=(4, 16), budget=(args.max_new, args.max_new),
        shared_prefix=system if args.shared_prefix else None,
        prefix_fraction=0.5 if args.shared_prefix else 0.0)
    # Warm every (group size, chunk bucket) shape the trace can admit, so
    # the open-loop clock measures serving, not first use (kernel loads,
    # allocator growth).
    engines = [engine] + [make_engine() for _ in range(args.replicas - 1)]
    lens = trace_prompt_lens(trace, engine, extra=(16 + args.shared_prefix,))
    for e in engines:
        warmup_prefill(e, cfg.vocab_size, prompt_lens=lens)

    # Faults wrap AFTER warmup, so a plan's step clock starts at the trace.
    plans = {}
    if args.fault_seed is not None:
        for i in range(len(engines)):
            plans[i] = FaultPlan.seeded(args.fault_seed + i)
    if args.fault_crash_replica is not None:
        i = args.fault_crash_replica
        plans[i] = plans.get(i, FaultPlan()) \
            + FaultPlan.crash_at(args.fault_crash_tick)
    engines = [FaultyEngine(e, plans[i]) if i in plans else e
               for i, e in enumerate(engines)]

    def breaker():
        return CircuitBreaker(
            window=args.breaker_window, trip_pressure=args.breaker_trip,
            sat_threshold=args.breaker_sat,
            cooldown_ticks=args.breaker_cooldown,
            probes=args.breaker_probes)

    if args.replicas > 1:
        report, router = run_open_loop_router(
            engines, trace, policy=args.router_policy,
            max_queue_depth=args.max_queue_depth, breaker_factory=breaker,
            retry_budget=args.retry_budget,
            drain=() if args.drain_replica is None
            else (args.drain_replica,))
        out = report.summary(args.slo_ttft)
        out["routing"] = router.routing_report()
        # Blocks each replica's lanes still hold after the trace: 0 on
        # every replica that lived, or blocks leaked.
        out["routing"]["live_blocks"] = [e.live_blocks for e in engines]
        if plans:
            out["fault_plans"] = {
                str(i): p.describe() for i, p in sorted(plans.items())}
    else:
        report = run_open_loop(engines[0], trace,
                               max_queue_depth=args.max_queue_depth,
                               breaker=breaker())
        out = report.summary(args.slo_ttft)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
