#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, or when run
outside the repository.  Phases, each of which raises on failure:

  1. device report: the card's name and power limit;
  2. build: both paged attention kernels, from ``src/repro_torch/csrc``;
  3. kernel checks: each kernel against its plain PyTorch version at the
     serving path's shapes (tinyllama heads, 16-token blocks, 8 lanes,
     64-entry tables, mixed lengths, dead lanes, a shared block), bf16:
     outputs within 2e-2 element by element, prefill pools bit for bit;
     kernel, plain and
     ``scaled_dot_product_attention`` times (the last a yardstick only,
     on a pre-gathered dense copy; the port never calls it);
  4. model check: full-width tinyllama-1.1b with seeded random bf16
     weights, ``prefill_slots`` and ``decode_step`` logits with the
     kernels on vs off, and a control that reads one wrong block, which
     the same limit must catch;
  5. engine run: the port's ``ServingEngine`` serving 12 requests (16-600
     prompt tokens, a shared 64-token system prefix on half of them, 32
     new tokens each at temperature 0.8) with the kernels' launch counts
     set to 0 just before and read just after; then three decode steps
     of 8 lanes under ``torch.profiler`` (device-busy share, top kernels);
  6. a ``{"kernels": [...]}`` line, the card line, and the last line
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "tinyllama-1.1b"
B, BS, T = 8, 16, 64          # lanes, tokens per block, table width
MAX_LEN = BS * T              # 1024 tokens of context per lane
CHUNK = 128                   # prefill chunk
TOL = 2e-2                    # kernel vs plain, bf16 outputs
HBM_BYTES_PER_S = 3.35e12     # H100 SXM peak HBM3 bandwidth, dense bf16 peak below
BF16_OPS_PER_S = 989e12
WARMUP, ITERS = 3, 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Mean milliseconds of ``fn()`` over ITERS launches, after warm-up,
    timed with CUDA events."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def bound(nbytes: float, ops: float):
    """Least time the card could take: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct_rows(torch, tbl, n) -> int:
    """Distinct pool rows (block, offset) that positions p < n[b] of each
    lane reach through its table: the K (or V) token rows a function over
    those positions must read, each once, however many lanes share them."""
    keys = [torch.zeros(0, dtype=torch.long, device=tbl.device)]
    for b in range(tbl.shape[0]):
        p = torch.arange(int(n[b]), device=tbl.device)
        keys.append(tbl[b, p // BS].long() * BS + p % BS)
    return torch.unique(torch.cat(keys)).numel()


def assert_close(torch, what, out, ref):
    """Element by element, |out - ref| <= TOL + TOL * |ref|."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output is not finite")
    try:
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL,
                                   rtol=TOL)
    except AssertionError as e:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"{e}") from None
    return (out.float() - ref.float()).abs().max().item()


def check_decode(torch, cfg, gen):
    """Kernel 1 vs its plain version at the decode step's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.flash_decode import \
        paged_flash_decode
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    dev = "cuda"
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    N = B * T + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kp = torch.randn(N, BS, Hk, D, generator=gen, device=dev).bfloat16()
    vp = torch.randn(N, BS, Hk, D, generator=gen, device=dev).bfloat16()
    lens = torch.tensor([1, 17, 600, 1024, 700, 333, 64, 5],
                        dtype=torch.int32, device=dev)
    tbl = (1 + torch.randperm(N - 1, generator=gen, device=dev)[:B * T]) \
        .reshape(B, T).int()
    for b in range(B):
        tbl[b, -(-int(lens[b]) // BS):] = 0
    tbl[4] = 0               # a dead lane: stale length, all-trash table
    tbl[1, 0] = tbl[2, 0]    # a block shared by two lanes
    live = torch.ones(B, dtype=torch.bool, device=dev)
    live[4] = False

    out = paged_flash_decode(q, kp, vp, lens, tbl)
    torch.cuda.synchronize()
    ref = paged_decode_ref(q, kp, vp, lens, tbl)
    err = assert_close(torch, "paged decode kernel", out[live], ref[live])

    ms = cuda_ms(lambda: paged_flash_decode(q, kp, vp, lens, tbl))
    plain_ms = cuda_ms(lambda: paged_decode_ref(q, kp, vp, lens, tbl))
    # Yardstick: one SDPA call on a pre-gathered dense (B, Hk, T*bs, D).
    kd = kp[tbl.long()].reshape(B, T * BS, Hk, D).transpose(1, 2)
    vd = vp[tbl.long()].reshape(B, T * BS, Hk, D).transpose(1, 2)
    mask = (torch.arange(T * BS, device=dev)[None] < lens[:, None]
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True))

    # Bytes: each pool row the lanes reach counted once (the dead lane's
    # walk reaches only the trash block, the shared block counts once),
    # q and the output, lengths and the table entries walked.  Operations:
    # QK^T and PV over the live lanes' keys.
    n = lens.clamp(max=T * BS)
    nbytes = (2 * distinct_rows(torch, tbl, n) * Hk * D * 2
              + 2 * q.numel() * 2 + lens.numel() * 4
              + 4 * (-(-n // BS)).sum().item())
    ops = 4 * H * D * n[live].double().sum().item()
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_prefill(torch, cfg, gen):
    """Kernel 2 vs its plain version: a first chunk and a continuation
    (with a block-straddling start and a shared context block) at the
    prefill chunk's shapes; pools bit for bit."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill.flash_prefill import \
        paged_flash_prefill
    from repro_torch.kernels.flash_prefill.ref import prefill_attention_ref
    dev = "cuda"
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    N, S = B * T + 1, CHUNK
    kp = torch.randn(N, BS, Hk, D, generator=gen, device=dev).bfloat16()
    vp = torch.randn(N, BS, Hk, D, generator=gen, device=dev).bfloat16()
    q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
    kn = torch.randn(B, S, Hk, D, generator=gen, device=dev).bfloat16()
    vn = torch.randn(B, S, Hk, D, generator=gen, device=dev).bfloat16()
    lens = torch.tensor([128, 1, 77, 16, 128, 3, 100, 50],
                        dtype=torch.int32, device=dev)
    real = torch.arange(S, device=dev)[None] >= (S - lens)[:, None]
    results = {}
    for name, start in (
            ("first", None),
            ("continuation", torch.tensor([64, 5, 16, 300, 31, 600, 64, 1],
                                          dtype=torch.int32, device=dev))):
        st = torch.zeros(B, dtype=torch.int32, device=dev) \
            if start is None else start
        tbl = (1 + torch.randperm(N - 1, generator=gen, device=dev)
               [:B * T]).reshape(B, T).int()
        for b in range(B):
            tbl[b, -(-int(st[b] + lens[b]) // BS):] = 0
        if start is not None:
            tbl[0, 0] = tbl[6, 0]  # a shared, read-only context block
        k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        out, _, _ = paged_flash_prefill(q, kn, vn, k1, v1, lens, tbl,
                                        start=start)
        torch.cuda.synchronize()
        ref, _, _ = prefill_attention_ref(q, kn, vn, k2, v2, lens, tbl,
                                          start=start)
        err = assert_close(torch, f"paged prefill kernel ({name})",
                           out[real], ref[real])
        if not (torch.equal(k1.view(torch.int16), k2.view(torch.int16))
                and torch.equal(v1.view(torch.int16), v2.view(torch.int16))):
            raise AssertionError(f"paged prefill pools ({name}) differ "
                                 f"from the plain scatter")

        k1, v1 = kp.clone(), vp.clone()
        ms = cuda_ms(lambda: paged_flash_prefill(q, kn, vn, k1, v1, lens,
                                                 tbl, start=start))
        plain_ms = cuda_ms(lambda: prefill_attention_ref(
            q, kn, vn, k1, v1, lens, tbl, start=start))
        # Yardstick: one SDPA call on the pre-gathered [context | chunk].
        ctx = T * BS if start is not None else 0
        kd, vd = kn, vn
        sidx = torch.arange(S, device=dev)
        mask = (sidx[None, None] <= sidx[None, :, None]) \
            & (sidx[None] >= (S - lens)[:, None])[:, None, :]
        if ctx:
            kd = torch.cat([kp[tbl.long()].reshape(B, ctx, Hk, D), kn], 1)
            vd = torch.cat([vp[tbl.long()].reshape(B, ctx, Hk, D), vn], 1)
            cmask = (torch.arange(ctx, device=dev)[None] < st[:, None])
            mask = torch.cat([cmask[:, None].expand(B, S, ctx), mask], -1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kd, vd))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))

        # Bytes of the real rows only (pad rows' outputs are junk by
        # contract): q and the output, k/v_new read and scattered into the
        # pool, and the context rows counted once each through the tables.
        n_new = lens.double().sum().item()
        nbytes = (2 * n_new * H * D * 2                  # q, output
                  + 2 * 2 * n_new * Hk * D * 2           # k/v_new, scatter
                  + 2 * distinct_rows(torch, tbl, st) * Hk * D * 2
                  + 4 * (2 * lens.numel()
                         + (-(-(st + lens) // BS)).sum().item()))
        # Visible (query, key) pairs of the real rows.
        pairs = sum(int(lens[b]) * int(st[b])
                    + int(lens[b]) * (int(lens[b]) + 1) // 2
                    for b in range(B))
        bound_ms, bound_by = bound(nbytes, 4 * H * D * pairs)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
    return results


def check_model(torch, cfg, params):
    """prefill_slots (first chunk, continuation) and decode_step logits
    with the kernels on vs off, full width.  Tolerance: 5% of the logits'
    range — 22 bf16 layers amplify the kernels' fp32-vs-bf16 rounding
    differences in the attention outputs.  A control shows the limit is
    tight enough to matter: the plain path's decode step with one table
    entry of one lane pointed at the trash block (16 of its 80 keys read
    from the wrong block) must differ from the right one by more than it."""
    from dataclasses import replace
    from repro_torch.models import model as M
    dev = "cuda"
    rng = torch.Generator(device=dev).manual_seed(1)
    nb = 4
    N = nb * T + 1
    tbl = torch.arange(1, N, dtype=torch.int32, device=dev).reshape(nb, T)
    lens = torch.tensor([64, 40, 9, 1], dtype=torch.int32, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (nb, 64), generator=rng,
                         device=dev)
    toks[torch.arange(64, device=dev)[None] < (64 - lens)[:, None]] = 0
    l2 = torch.tensor([16, 3, 16, 1], dtype=torch.int32, device=dev)
    t2 = torch.randint(1, cfg.vocab_size, (nb, 16), generator=rng,
                       device=dev)
    tok1 = torch.randint(1, cfg.vocab_size, (nb, 1), generator=rng,
                         device=dev)
    wrong = tbl.clone()
    wrong[0, 0] = 0
    logits = {}
    for mode in ("on", "off", "wrong"):
        c = replace(cfg, attn_kernel="off" if mode == "wrong" else mode)
        cache = M.init_paged_cache(c, N, BS, device=dev)
        a, cache = M.prefill_slots(c, params, cache, toks, lens, tbl)
        b, cache = M.prefill_slots(c, params, cache, t2, l2, tbl,
                                   start=lens, all_logits=True)
        d, cache = M.decode_step(c, params, cache, tok1, lens + l2,
                                 block_tables=wrong if mode == "wrong"
                                 else tbl)
        torch.cuda.synchronize()
        logits[mode] = (a.float(), b[:, -1].float(), d[:, 0].float())
    errs = []
    for name, on, off in zip(("prefill", "continuation", "decode"),
                             logits["on"], logits["off"]):
        if not torch.isfinite(on).all():
            raise AssertionError(f"model {name} logits are not finite")
        span = (off.max() - off.min()).item()
        err = (on - off).abs().max().item()
        agree = (on.argmax(-1) == off.argmax(-1)).float().mean().item()
        print(f"model check {name}: max|on-off| {err:.4g} of range "
              f"{span:.4g} (limit {0.05 * span:.4g}); argmax agreement "
              f"{agree:.2f}")
        if err > 0.05 * span:
            raise AssertionError(f"model {name}: kernels on vs off differ "
                                 f"by {err} (range {span})")
        errs.append(err)
    off, bad = logits["off"][2], logits["wrong"][2]
    span = (off.max() - off.min()).item()
    err = (bad - off).abs().max().item()
    print(f"model check control (decode reading one wrong block): "
          f"max|wrong-off| {err:.4g} of range {span:.4g} (must exceed "
          f"{0.05 * span:.4g})")
    if err <= 0.05 * span:
        raise AssertionError("model check cannot see a decode that reads "
                             "one wrong block: its limit is too loose")
    return max(errs)


def run_engine(torch, cfg, params, card):
    """The main path: ServingEngine over the kernels, counts read."""
    import numpy as np
    from repro_torch.kernels.flash_decode.flash_decode import \
        paged_flash_decode
    from repro_torch.kernels.flash_prefill.flash_prefill import \
        paged_flash_prefill
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampler import SamplerConfig

    eng = ServingEngine(
        cfg, params, max_batch=B, max_len=MAX_LEN, eos_id=-1,
        block_size=BS, prefill_chunk=CHUNK, attn_kernel="auto", seed=0,
        sampler=SamplerConfig(temperature=0.8, top_k=50), device="cuda")
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, size=64)
    reqs = []
    for i in range(12):
        n = int(rng.integers(16, 601))
        p = rng.integers(1, cfg.vocab_size, size=n)
        if i % 2:
            p = np.concatenate([system, p])[:600]
        reqs.append(p)
    # Both prefill forms are certain: the first admission into the empty
    # pool is a first chunk, and a prompt longer than one chunk (or a
    # prefix-cache hit, asserted below) continues from cached context.
    if max(len(p) for p in reqs) <= CHUNK:
        raise AssertionError("no prompt spans more than one prefill chunk")
    torch.cuda.reset_peak_memory_stats()
    paged_flash_decode.launches = 0
    paged_flash_prefill.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=32) for p in reqs]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_flash_decode": paged_flash_decode.launches,
                "paged_flash_prefill": paged_flash_prefill.launches}
    s = eng.stats
    L = cfg.num_layers
    for u in uids:
        toks = out[u]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {u} returned {toks}")
    if launches["paged_flash_decode"] != L * s.decode_steps or \
            s.decode_steps == 0:
        raise AssertionError(f"decode launches {launches} vs "
                             f"{s.decode_steps} steps x {L} layers")
    if launches["paged_flash_prefill"] != L * s.prefill_chunks:
        raise AssertionError(f"prefill launches {launches} vs "
                             f"{s.prefill_chunks} chunks x {L} layers")
    if s.cached_prompt_tokens <= 0:
        raise AssertionError("no prefix-cache hits on the shared prefix")
    print(f"engine [{card}]: {len(uids)} requests, wall {wall:.2f} s; "
          f"decode {s.tokens_per_s:.1f} tok/s ({s.decode_steps} steps, "
          f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step); prefill "
          f"{s.prefill_tokens_per_s:.1f} tok/s ({s.prefill_tokens} tokens, "
          f"{s.prefill_chunks} chunks); cached prompt tokens "
          f"{s.cached_prompt_tokens}; preemptions {s.preemptions}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"engine launches: {launches}")
    return launches, eng


def profile_decode(torch, eng, cfg, card):
    """Where a decode step's time goes, after the main path: the same
    engine with all 8 lanes decoding, three steps under torch.profiler.
    Prints the device-busy share of the (profiled) wall time, launches per
    step, and the kernels with the most device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    for _ in range(B):
        eng.submit(rng.integers(1, cfg.vocab_size, size=64),
                   max_new_tokens=8)
    eng.step()  # admission, one prefill chunk, the first decode step
    steps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    per_kernel, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
            n += 1
    if not per_kernel:
        print("decode profile: device time not measured (the profiler "
              "recorded no device events)")
        return
    busy = sum(per_kernel.values())
    print(f"decode profile [{card}]: {steps} steps of {B} lanes, wall "
          f"{wall / steps * 1e3:.2f} ms/step under the profiler, device "
          f"busy {busy / steps:.2f} ms/step "
          f"({busy / (wall * 1e3):.1%}), {n / steps:.0f} device "
          f"operations/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"  {ms / steps:8.3f} ms/step  {name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M

    # 1. Device report.
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. Build.
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. Kernel checks.
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = check_decode(torch, cfg, gen)
    pre = check_prefill(torch, cfg, gen)
    for name, r in [("paged_flash_decode", dec)] + [
            (f"paged_flash_prefill[{k}]", v) for k, v in pre.items()]:
        print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")

    # 4. Model check, full width.
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    print(f"params: {M.param_count(cfg) / 1e9:.3f} B bf16 in "
          f"{time.perf_counter() - t0:.1f} s")
    check_model(torch, cfg, params)

    # 5. The main path, then a profile of its decode step.
    launches, eng = run_engine(torch, cfg, params, card)
    profile_decode(torch, eng, cfg, card)

    # 6. Result lines.
    cont = pre["continuation"]
    kernels = [
        dict(name="paged_flash_decode", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/flash_decode/flash_decode.py:183",
             launches=launches["paged_flash_decode"],
             max_abs_err=dec["err"], ms=dec["ms"],
             plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=dec["bound_by"], library_ms=dec["library_ms"]),
        dict(name="paged_flash_prefill", route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/flash_prefill/flash_prefill.py:231",
             launches=launches["paged_flash_prefill"],
             max_abs_err=max(r["err"] for r in pre.values()),
             ms=cont["ms"], plain_ms=cont["plain_ms"],
             bound_ms=cont["bound_ms"], bound_by=cont["bound_by"],
             library_ms=cont["library_ms"]),
    ]
    for k in kernels:
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k['name']}: {key} is {v}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
