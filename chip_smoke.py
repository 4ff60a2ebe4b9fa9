#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, or when run
outside the repository.  Phases, each of which raises on failure:

  1. device report: the card's name and power limit;
  2. build: every kernel source in ``src/repro_torch/csrc``, one ``nvcc``
     each, all started together; what ptxas reports (registers, spills)
     and, from ``cuobjdump -sass``, the count of tensor-core instructions
     (``HMMA``/``HGMMA``) of each kernel function, which must be above 0
     for the tensor-core bodies of the SCLD matmul, flash attention,
     the two decode kernels (``decode_tc_kernel``), the paged prefill
     (``prefill_tc_kernel``) and the SSD scan's chunk-state and
     chunk-output passes;
  3. kernel checks, each kernel against its plain PyTorch version at the
     serving path's shapes (tinyllama heads, 16-token blocks, 8 lanes,
     64-entry tables, mixed lengths, dead lanes, a shared block), bf16
     compute, outputs within |out - ref| <= 2e-2 + 2e-2 |ref| element by
     element: paged decode and paged prefill on a bf16 pool and on int8
     and fp8 SCLAD pools (prefill pools and scales bit for bit; a first
     chunk, one with a 16-token patch prefix, and a continuation, also
     at internvl2-26b's heads, 48 over 8 kv heads of 128: rep 6, with a
     first chunk behind its 256 patch positions, and at qwen2-moe-a2.7b's,
     16 over 16 of 128: rep 1), the dense decode of the wave path, and
     the paged decode at qwen2-moe-a2.7b's and internvl2-26b's heads and
     the dense decode at internvl2-26b's; the decode kernels also on a
     second length set straddling their 128-position split boundaries
     (and a stale length past the table or stripe), each bitwise equal
     from launch to launch; kernel, plain and
     ``scaled_dot_product_attention`` times (the last a yardstick only,
     on a pre-gathered, pre-dequantized dense copy; the port never calls
     it) beside each kernel's bound;
  4. model checks: full-width tinyllama-1.1b with seeded random bf16
     weights, ``prefill_slots`` and ``decode_step`` logits with the
     kernels on vs off on bf16, int8 and fp8 pools, a control that reads
     one wrong block, which the same limit must catch, and the int8/fp8
     pools vs the bf16 pool within the quantization gates;
  5. engine runs, each with the kernels' launch counts set to 0 just
     before and read just after: the port's ``ServingEngine`` serving 12
     requests (16-600 prompt tokens, a shared 64-token system prefix on
     half of them, 32 new tokens each at temperature 0.8) on a bf16, an
     int8 and an fp8 pool, and in ``mode="wave"`` (dense stripes, the
     dense decode kernel); a bf16 / int8 pair at the same pool bytes with
     16 lanes (blocks, block bytes, mean live lanes, preemptions, decode
     tok/s of each); then under ``torch.profiler`` one continuation
     chunk of 8 rows (device-busy share, top kernels, the prefill
     kernel by name) and three decode steps of 8 lanes (the decode
     kernels' split and combine passes by name);
  6. the last three kernels, each against its plain version at the
     full width of a config the repo carries, with the JAX package's
     kernel tolerances: the SCLD matmul at tinyllama-1.1b's MLP
     projections (x (128, 2048) bf16 times W (2048, 5632), and
     (128, 5632) times (5632, 2048), at C = 16, 8 and 6 stored units of
     16), the SSD chunk scan at mamba2-1.3b's widths (64 heads of 64,
     state 128, 2048 positions, bf16, chunk 256 and 128) and zamba2-7b's
     (112 heads of 64, state 64, chunk 256), bitwise equal launch to
     launch, within a per-head relative limit that a planted control (a
     shifted by one position) must fail, with the device time of each of
     its three passes
     (``torch.profiler``), blocked flash attention at tinyllama-1.1b's
     heads (2048 positions, 32 heads, 4 kv heads, bf16, causal; causal
     at 512 queries over 2048 keys; 128 queries over 2048 keys not
     causal); kernel, plain, bound and library times (``torch.matmul``
     on the decompressed weight, none for the scan,
     ``scaled_dot_product_attention``), and for all three the achieved
     TFLOP/s and GB/s and the share of the bound (bound ms / kernel ms);
  7. their entry points, each with its launch count set to 0 just before
     and read just after: the SCLD example (``repro_torch.examples.
     sclad_sparsity``) through ``SCLDLinear`` on the card, whose system
     lines must equal the JAX package's; ``ops.ssd`` at mamba2-1.3b's
     widths (one kernel launch); ``ops.attention`` at tinyllama-1.1b's
     heads, both against their plain versions;
  8. the other attention families at full width, each with seeded random
     bf16 weights built on the card (init peak memory beside the
     weights' bytes) and freed before the next: qwen2-moe-a2.7b (moe)
     and internvl2-26b (vlm, 256 patch positions) through the model
     checks on bf16 and int8 pools, the 12-request trace on a bf16 pool
     (internvl2-26b: every other request of the shared prefix carries
     one of two random images, which must hit the prefix cache past the
     patches; the rest the zero stub), a wave run of 4 requests of 8 new
     tokens, and for qwen2-moe-a2.7b a profiled decode step (device time
     of each MoE stage); stablelm-1.6b, phi3-medium-14b and granite-3-8b
     through the model checks on a bf16 pool and a 4-request run of 16
     new tokens; each run's launch counts as the 12-request runs';
  9. a ``{"kernels": [...]}`` line, the card line, and the last line
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
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
#: Quantized vs bf16 pool, as a share of the logit range: the JAX
#: package's LOGIT_ERR_GATE (int8 0.15, fp8 0.35) over its span of ~3.
QUANT_GATE = {"int8": 0.05, "fp8": 0.12}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM peak HBM3 bandwidth, dense bf16 peak below
BF16_OPS_PER_S = 989e12
WARMUP, ITERS = 3, 20
SPIN_CYCLES = 100_000_000     # ~50 ms at the H100's ~2 GHz
#: The JAX package's kernel tolerances (tests/test_kernels.py): SCLD
#: (atol, rtol) with bf16 x and with fp32 x (the SCLD example's); the SSD
#: scan five times the bf16 attention tolerance (TOL, as above).
SCLD_TOL = (1e-1, 5e-2)
SCLD_TOL_FP32 = (1e-4, 2e-2)
SSD_TOL = 5 * TOL
#: Beside SSD_TOL, which exceeds typical SSD values (y ~0.2, the state
#: ~0.07 at ssd_inputs' magnitudes, ~10x less through ops.ssd): per head,
#: ||out - ref|| / ||ref|| of y and of the state at most SSD_REL.  On an
#: H100 the bf16 kernel reads at most 3.1e-3 here (check_ssd's cases and
#: ops.ssd); handed a shifted by one position (what a cumsum shifted by
#: one computes) it reads 7.9e-2 or more, and check_ssd fails unless that
#: control exceeds 3 * SSD_REL.
SSD_REL = 1e-2
#: mamba2-1.3b's SSD widths (src/repro/configs/mamba2_1_3b.py: d_model
#: 2048, expand 2, head dim 64 -> 64 heads, state 128, chunk 256).
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, SSD_CHUNK = 64, 64, 128, 256
#: The SSD cases timed: name -> (heads, head dim, state, chunk); zamba2-7b's
#: widths from src/repro/configs/zamba2_7b.py (d_model 3584, expand 2, head
#: dim 64 -> 112 heads, state 64).
SSD_CASES = {
    "mamba2-1.3b, chunk 256": (SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, SSD_CHUNK),
    "mamba2-1.3b, chunk 128": (SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, 128),
    "zamba2-7b, chunk 256": (112, 64, 64, 256)}
SSD_PASSES = ("ssd_chunk_state_tc_kernel", "ssd_state_pass_kernel",
              "ssd_chunk_out_tc_kernel")
SEQ = 2048  # positions of the SSD and attention checks
#: The SCLD example's system section as the JAX package's ``core`` gives
#: it (tests/test_torch_sclad.py holds the port's copies to it bitwise).
SCLD_SYSTEM_LINES = [
    "  sparsity=0.0 tco_delta= +0.0% perplexity=8.34",
    "  sparsity=0.3 tco_delta= +0.0% perplexity=8.35",
    "  sparsity=0.5 tco_delta=-16.9% perplexity=8.4",
    "  sparsity=0.6 tco_delta=-16.9% perplexity=8.6",
    "  sparsity=0.7 tco_delta=-16.9% perplexity=9.67",
    "  max model scale at 60%: 1.64x",
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: The kernel functions that must run on the tensor cores: library ->
#: function-name stems of its bf16 bodies.
TENSOR_CORE_BODIES = {"sclad_matmul": ("sclad_matmul_tc_kernel",),
                      "flash_attention": ("flash_attention_tc_kernel",),
                      "paged_decode": ("decode_tc_kernel",),
                      "dense_decode": ("decode_tc_kernel",),
                      "paged_prefill": ("prefill_tc_kernel",),
                      "ssd_scan": ("ssd_chunk_state_tc_kernel",
                                   "ssd_chunk_out_tc_kernel")}


def sass_mma_counts(build):
    """library -> {kernel function (mangled): its HMMA/HGMMA instructions}
    from ``cuobjdump -sass`` of each built library; None where the
    toolkit has no cuobjdump."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    counts = {}
    for name in build.SOURCES:
        out = subprocess.run([str(tool), "-sass",
                              str(build.library_path(name))],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        per, fn = {}, None
        for line in out.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                per[fn] = 0
            elif fn is not None and re.search(r"\bHG?MMA\.", line):
                per[fn] += 1
        counts[name] = per
    return counts


def report_tensor_cores(build, card) -> None:
    """Print each library's tensor-core instruction count by kernel
    function; raise if a bf16 body named in TENSOR_CORE_BODIES (one or two
    of every kernel) has none."""
    counts = sass_mma_counts(build)
    if counts is None:
        print("tensor-core instructions: not measured (no cuobjdump)")
        return
    for name, per in counts.items():
        parts = [f"{short_name(fn)} {n}" for fn, n in sorted(per.items())]
        print(f"  {name} SASS [{card}]: {sum(per.values())} HMMA/HGMMA "
              f"({'; '.join(parts)})")
    for name, stems in TENSOR_CORE_BODIES.items():
        for stem in stems:
            fns = [fn for fn in counts[name] if stem in fn]
            if not fns or any(counts[name][fn] == 0 for fn in fns):
                raise AssertionError(f"{name}: {stem} has no tensor-core "
                                     f"instructions in its SASS")


def ptxas_report(log: str):
    """{kernel function (mangled): (registers, spill bytes)} from a
    ``-Xptxas -v`` build log."""
    per, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            per[fn] = [0, 0]
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                per[fn][1] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                per[fn][0] = int(m.group(1))
    return per


def short_name(fn: str) -> str:
    """A mangled kernel name as its stem and template arguments."""
    stem = re.search(r"\d+([a-z_]+_kernel)", fn)  # <length><name>
    targs = re.search(r"_kernel(I.+?E)E?v", fn)
    return (f"{stem.group(1) if stem else fn}"
            f"{targs.group(1) if targs else ''}")


def rates(r) -> str:
    """Achieved TFLOP/s and GB/s of a timed kernel, and its share of the
    bound."""
    return (f"; {r['ops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{r['nbytes'] / r['ms'] / 1e6:.0f} GB/s, "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def cuda_ms(fn) -> float:
    """Mean milliseconds of ``fn()`` over ITERS launches, after warm-up,
    timed with CUDA events.  The card first spins for ~50 ms, so the host
    queues the launches ahead of it and a call shorter than its Python
    wrapper's host time is timed by the card, not by the host (a call
    that synchronizes inside is timed as before)."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
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


def assert_close(torch, what, out, ref, atol=TOL, rtol=TOL):
    """Element by element, |out - ref| <= atol + rtol * |ref|."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output is not finite")
    try:
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    except AssertionError as e:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"{e}") from None
    return (out.float() - ref.float()).abs().max().item()


def rel_err(torch, what, out, ref, limit=SSD_REL):
    """The largest ||out - ref|| / ||ref|| over the heads (dim 0); raises
    above ``limit``."""
    e = (out.float() - ref.float()).flatten(1)
    r = (e.norm(dim=1) / ref.float().flatten(1).norm(dim=1)).max().item()
    if not r <= limit:
        raise AssertionError(f"{what}: per-head relative error {r:.3g} "
                             f"above {limit:g}")
    return r


def row_bytes(kv_dtype: str, D: int) -> int:
    """Pool bytes of one (position, kv head) row: the D-vector's payload
    plus, for a SCLAD pool, its fp32 scale."""
    return D * 2 if kv_dtype == "bf16" else D + 4


def make_pool(torch, gen, N, Hk, D, kv_dtype):
    """A random K (or V) pool: bf16, or bf16 values quantized by the
    port's codec -> (payload, scales or None)."""
    from repro_torch.models import kv_quant
    x = torch.randn(N, BS, Hk, D, generator=gen, device="cuda").bfloat16()
    if kv_dtype == "bf16":
        return x, None
    return kv_quant.quantize(x, kv_dtype)


def dense_copy(torch, pool, scale, tbl, dtype):
    """The (B, T*bs, Hk, D) per-lane copy of a pool through its tables,
    dequantized to ``dtype``: the SDPA yardstick's input."""
    from repro_torch.models import kv_quant
    t = tbl.long()
    x = kv_quant.raw(pool)[t].view(pool.dtype)
    x = x.reshape(t.shape[0], -1, *pool.shape[2:])
    if scale is None:
        return x.to(dtype)
    return kv_quant.dequantize(x, scale[t].reshape(t.shape[0], -1,
                                                   pool.shape[2]), dtype)


def same_bits(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def same_launches(torch, what, out, again) -> None:
    """Raise unless a second launch gives ``out`` bit for bit."""
    if not same_bits(torch, out, again()):
        raise AssertionError(f"{what}: two launches differ")


def split_lengths_check(torch, what, out, ref, lens) -> float:
    """The second length set: rows with positions within TOL of their
    plain version, rows of length 0 exactly zero."""
    live = lens > 0
    if not (out[~live] == 0).all():
        raise AssertionError(f"{what}: a row of length 0 is not zero")
    return assert_close(torch, f"{what} (split boundaries)", out[live],
                        ref[live])


def check_decode(torch, cfg, gen, kv_dtype="bf16"):
    """Kernel 1 (bf16 pool) or its SCLAD body (int8/fp8 pool) vs its
    plain version at the decode step's shapes, then on lengths that
    straddle the split boundaries; bitwise equal launch to launch."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.flash_decode import (
        SPLIT, paged_flash_decode)
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    dev = "cuda"
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    N = B * T + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kp, ks = make_pool(torch, gen, N, Hk, D, kv_dtype)
    vp, vs = make_pool(torch, gen, N, Hk, D, kv_dtype)
    scales = None if ks is None else (ks, vs)
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

    out = paged_flash_decode(q, kp, vp, lens, tbl, kv_scales=scales)
    torch.cuda.synchronize()
    ref = paged_decode_ref(q, kp, vp, lens, tbl, kv_scales=scales)
    what = f"paged decode kernel ({kv_dtype} pool)"
    err = assert_close(torch, what, out[live], ref[live])
    same_launches(torch, what, out, lambda: paged_flash_decode(
        q, kp, vp, lens, tbl, kv_scales=scales))
    # Lengths straddling the split boundaries, the whole table and a
    # stale length past it, over full tables; a row of length 0 -> zeros.
    lens2 = torch.tensor([SPLIT - 1, SPLIT, SPLIT + 1, T * BS, T * BS + 300,
                          2 * SPLIT - 1, 2 * SPLIT + 1, 0],
                         dtype=torch.int32, device=dev)
    tbl2 = (1 + torch.randperm(N - 1, generator=gen, device=dev)[:B * T]) \
        .reshape(B, T).int()
    out2 = paged_flash_decode(q, kp, vp, lens2, tbl2, kv_scales=scales)
    torch.cuda.synchronize()
    ref2 = paged_decode_ref(q, kp, vp, lens2, tbl2, kv_scales=scales)
    err = max(err, split_lengths_check(torch, what, out2, ref2, lens2))
    same_launches(torch, what + " (split boundaries)", out2,
                  lambda: paged_flash_decode(q, kp, vp, lens2, tbl2,
                                             kv_scales=scales))

    ms = cuda_ms(lambda: paged_flash_decode(q, kp, vp, lens, tbl,
                                            kv_scales=scales))
    plain_ms = cuda_ms(lambda: paged_decode_ref(q, kp, vp, lens, tbl,
                                                kv_scales=scales))
    # Yardstick: one SDPA call on a pre-gathered, pre-dequantized dense
    # (B, Hk, T*bs, D) copy.
    kd = dense_copy(torch, kp, ks, tbl, q.dtype).transpose(1, 2)
    vd = dense_copy(torch, vp, vs, tbl, q.dtype).transpose(1, 2)
    mask = (torch.arange(T * BS, device=dev)[None] < lens[:, None]
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True))

    # Bytes: each pool row the lanes reach counted once (the dead lane's
    # walk reaches only the trash block, the shared block counts once),
    # payload plus scale, q and the output, lengths and the table entries
    # walked.  Operations: QK^T and PV over the live lanes' keys.
    n = lens.clamp(max=T * BS)
    nbytes = (2 * distinct_rows(torch, tbl, n) * Hk * row_bytes(kv_dtype, D)
              + 2 * q.numel() * 2 + lens.numel() * 4
              + 4 * (-(-n // BS)).sum().item())
    ops = 4 * H * D * n[live].double().sum().item()
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes,
                ops=ops)


#: internvl2-26b's heads (H, Hk, D): 48 over 8 kv heads of 128 (rep 6),
#: the prefill checks' second head shape beside tinyllama-1.1b's.
REP6_HEADS = (48, 8, 128)
PATCH_PREFIX = 16  # the patch-prefix case's prefix
VLM_PREFIX = 256   # internvl2-26b's patch prefix (num_patches)


def check_prefill(torch, heads, gen, kv_dtype="bf16", cases=None):
    """Kernel 2 (bf16 pool) or its SCLAD body (int8/fp8 pool) vs its
    plain version at the prefill chunk's shapes with ``heads`` = (H, Hk,
    D): a first chunk, a first chunk behind a 16-position patch prefix
    (sharing the chunk's 128 rows), a first chunk behind internvl2-26b's
    256 patch positions (ahead of a whole chunk: 384 rows) and a
    continuation (with a block-straddling start and a shared context
    block); pools (and scales) bit for bit, bitwise equal launch to
    launch.  ``cases`` picks some of them (default: all but the
    256-position prefix)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill.flash_prefill import \
        paged_flash_prefill
    from repro_torch.kernels.flash_prefill.ref import prefill_attention_ref
    from repro_torch.models import kv_quant
    dev = "cuda"
    H, Hk, D = heads
    N = B * T + 1
    kp, ks = make_pool(torch, gen, N, Hk, D, kv_dtype)
    vp, vs = make_pool(torch, gen, N, Hk, D, kv_dtype)
    pool = [kp, vp] + ([] if ks is None else [ks, vs])
    kvd = None if ks is None else kv_dtype
    all_cases = (
        ("first", None, 0),
        (f"first, prefix {PATCH_PREFIX}", None, PATCH_PREFIX),
        (f"first, prefix {VLM_PREFIX}", None, VLM_PREFIX),
        ("continuation", torch.tensor([64, 5, 16, 300, 31, 600, 64, 1],
                                      dtype=torch.int32, device=dev), 0))
    if cases is None:
        cases = [c[0] for c in all_cases if c[2] != VLM_PREFIX]
    rows = max(CHUNK + c[2] * (c[2] >= CHUNK) for c in all_cases
               if c[0] in cases)
    q_all = torch.randn(B, rows, H, D, generator=gen, device=dev).bfloat16()
    kn_all = torch.randn(B, rows, Hk, D, generator=gen, device=dev).bfloat16()
    vn_all = torch.randn(B, rows, Hk, D, generator=gen, device=dev).bfloat16()
    all_lens = torch.tensor([128, 1, 77, 16, 128, 3, 100, 50],
                            dtype=torch.int32, device=dev)

    results = {}
    for name, start, prefix in all_cases:
        if name not in cases:
            continue
        # A prefix shorter than the chunk shares its 128 rows (lengths
        # clamped); a longer one comes ahead of a whole chunk.
        S = CHUNK + prefix * (prefix >= CHUNK)
        q, kn, vn = (x[:, :S].contiguous() for x in (q_all, kn_all, vn_all))
        lens = all_lens.clamp(max=S - prefix)
        sidx = torch.arange(S, device=dev)
        # Real rows and keys: the patch prefix and the prompt tokens.
        real = (sidx[None] < prefix) | (sidx[None] >= (S - lens)[:, None])
        n_real = prefix + lens
        st = torch.zeros(B, dtype=torch.int32, device=dev) \
            if start is None else start
        tbl = (1 + torch.randperm(N - 1, generator=gen, device=dev)
               [:B * T]).reshape(B, T).int()
        for b in range(B):
            tbl[b, -(-int(st[b] + n_real[b]) // BS):] = 0
        if start is not None:
            tbl[0, 0] = tbl[6, 0]  # a shared, read-only context block

        def call(fn, p):
            sc = None if len(p) == 2 else (p[2], p[3])
            return fn(q, kn, vn, p[0], p[1], lens, tbl, start=start,
                      prefix=prefix, kv_scales=sc, kv_dtype=kvd)[0]

        p1 = [x.clone() for x in pool]
        p2 = [x.clone() for x in pool]
        out = call(paged_flash_prefill, p1)
        torch.cuda.synchronize()
        ref = call(prefill_attention_ref, p2)
        what = f"paged prefill kernel ({name}, {kv_dtype} pool, heads {heads})"
        err = assert_close(torch, what, out[real], ref[real])
        if not torch.isfinite(out).all():
            raise AssertionError(f"{what}: a pad row is not finite")
        if not all(same_bits(torch, a, b) for a, b in zip(p1, p2)):
            raise AssertionError(f"{what}: pools differ from the plain "
                                 f"scatter")
        if same_bits(torch, p1[0], kp):
            raise AssertionError(f"{what}: the scatter wrote nothing")
        # The scatter writes positions >= start only, which no launch
        # reads: a second launch on the written pool gives the same bits.
        same_launches(torch, what, out, lambda: call(paged_flash_prefill, p1))

        p1 = [x.clone() for x in pool]
        ms = cuda_ms(lambda: call(paged_flash_prefill, p1))
        plain_ms = cuda_ms(lambda: call(prefill_attention_ref, p1))
        # Yardstick: one SDPA call on the pre-gathered, pre-dequantized
        # [context | chunk] (the chunk fake-quantized on a SCLAD pool).
        ctx = T * BS if start is not None else 0
        kd, vd = kn, vn
        if kvd is not None:
            kd = kv_quant.fake_quant(kn, kvd)
            vd = kv_quant.fake_quant(vn, kvd)
        mask = (sidx[None, None] <= sidx[None, :, None]) & real[:, None, :]
        if ctx:
            kd = torch.cat([dense_copy(torch, kp, ks, tbl, q.dtype), kd], 1)
            vd = torch.cat([dense_copy(torch, vp, vs, tbl, q.dtype), vd], 1)
            cmask = (torch.arange(ctx, device=dev)[None] < st[:, None])
            mask = torch.cat([cmask[:, None].expand(B, S, ctx), mask], -1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kd, vd))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))

        # Bytes of the real rows only (pad rows' outputs are junk by
        # contract): q and the output, k/v_new read and stored into the
        # pool (payload plus scale on a SCLAD pool), and the context rows
        # counted once each through the tables.
        n_new = n_real.double().sum().item()
        nbytes = (2 * n_new * H * D * 2                      # q, output
                  + 2 * n_new * Hk * (D * 2 + row_bytes(kv_dtype, D))
                  + 2 * distinct_rows(torch, tbl, st) * Hk
                  * row_bytes(kv_dtype, D)
                  + 4 * (2 * lens.numel()
                         + (-(-(st + n_real) // BS)).sum().item()))
        # Visible (query, key) pairs of the real rows: the patch prefix
        # and the prompt tokens are one causal run after the context.
        pairs = sum(int(n_real[b]) * int(st[b])
                    + int(n_real[b]) * (int(n_real[b]) + 1) // 2
                    for b in range(B))
        ops = 4 * H * D * pairs
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, nbytes=nbytes, ops=ops)
    return results


def check_dense_decode(torch, cfg, gen, S=MAX_LEN):
    """Kernel 3 (dense stripes, the wave path's decode) vs its plain
    version: 8 rows of (S, Hk, D) bf16 stripes at ``cfg``'s heads (S =
    1024 by default; internvl2-26b's wave stripes add its 256 patch
    positions), mixed lengths, then lengths that straddle the split
    boundaries; bitwise equal launch to launch."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.flash_decode import (
        SPLIT, flash_decode)
    from repro_torch.kernels.flash_decode.ref import decode_ref
    dev = "cuda"
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kc = torch.randn(B, S, Hk, D, generator=gen, device=dev).bfloat16()
    vc = torch.randn(B, S, Hk, D, generator=gen, device=dev).bfloat16()
    lens = torch.tensor([1, 17, 600, 1024, 0, 333, 64, 5],
                        dtype=torch.int32, device=dev)
    live = lens > 0
    out = flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    ref = decode_ref(q, kc, vc, lens)
    what = f"dense decode kernel (heads {H}/{Hk}/{D}, stripes of {S})"
    err = assert_close(torch, what, out[live], ref[live])
    same_launches(torch, what, out, lambda: flash_decode(q, kc, vc, lens))
    lens2 = torch.tensor([SPLIT - 1, SPLIT, SPLIT + 1, S, S + 300,
                          2 * SPLIT - 1, 2 * SPLIT + 1, 0],
                         dtype=torch.int32, device=dev)
    out2 = flash_decode(q, kc, vc, lens2)
    torch.cuda.synchronize()
    err = max(err, split_lengths_check(torch, what, out2,
                                       decode_ref(q, kc, vc, lens2), lens2))
    same_launches(torch, what + " (split boundaries)", out2,
                  lambda: flash_decode(q, kc, vc, lens2))
    ms = cuda_ms(lambda: flash_decode(q, kc, vc, lens))
    plain_ms = cuda_ms(lambda: decode_ref(q, kc, vc, lens))
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]
            )[:, None, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True))
    n = lens.clamp(max=S).double().sum().item()
    nbytes = 2 * n * Hk * D * 2 + 2 * q.numel() * 2 + lens.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * H * D * n)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes,
                ops=4 * H * D * n)


def check_sclad(torch, cfg):
    """Kernel 6 vs its plain version at tinyllama-1.1b's MLP projections:
    x (128, d_model) bf16 times the gate/up weight (d_model, d_ff), and
    (128, d_ff) times the down weight (d_ff, d_model), each block-
    compressed to C = 16, 8 and 6 units a tile, bf16 units."""
    import numpy as np
    from repro_torch.kernels.sclad_matmul.ref import (decompress_torch,
                                                      sclad_matmul_ref)
    from repro_torch.kernels.sclad_matmul.sclad_matmul import (
        block_compress, sclad_matmul)
    rng = np.random.default_rng(0)
    M = 128
    results = {}
    for proj, K, N in (("gate/up", cfg.d_model, cfg.d_ff),
                       ("down", cfg.d_ff, cfg.d_model)):
        w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                             ).to("cuda", torch.bfloat16)
        for C in (16, 8, 6):
            vals, rows = block_compress(w, C)
            v = torch.from_numpy(vals).to("cuda", torch.bfloat16)
            r = torch.from_numpy(rows).cuda()
            y = sclad_matmul(x, v, r)
            torch.cuda.synchronize()
            err = assert_close(torch, f"sclad_matmul ({proj}, C={C})", y,
                               sclad_matmul_ref(x, v, r), *SCLD_TOL)
            ms = cuda_ms(lambda: sclad_matmul(x, v, r))
            plain_ms = cuda_ms(lambda: sclad_matmul_ref(x, v, r))
            dense = decompress_torch(v, r)
            lib_ms = cuda_ms(lambda: torch.matmul(x, dense))
            # Bytes: x, the stored units (C/16 of dense) and rows, y.
            # Operations: the dense products the kernel does.
            nbytes = (x.numel() * 2 + v.numel() * 2 + r.numel() * 4
                      + M * N * 2)
            ops = 2 * M * K * N
            bound_ms, bound_by = bound(nbytes, ops)
            results[proj, C] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, nbytes=nbytes,
                                    ops=ops)
    return results


def ssd_inputs(torch, gen, BH, S, P, N):
    """The JAX suite's magnitudes: xdt ~ 0.1 N(0,1), a = -0.1 |N(0,1)|,
    b, c ~ 0.3 N(0,1), bf16."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return ((rnd(BH, S, P) * 0.1).bfloat16(),
            (-rnd(BH, S).abs() * 0.1).bfloat16(),
            (rnd(BH, S, N) * 0.3).bfloat16(), (rnd(BH, S, N) * 0.3).bfloat16())


def check_ssd(torch, gen, card):
    """Kernel 4 vs its plain version (the step-by-step recurrence), bf16,
    2048 positions: mamba2-1.3b's widths (BH = 64 heads of P = 64, N =
    128) at its chunk of 256 and the op's default of 128, and zamba2-7b's
    (112 heads of 64, N = 64) at 256; outputs and the final state within
    SSD_TOL and SSD_REL, each bitwise equal from launch to launch; the
    planted control (a shifted by one position) must fail SSD_REL by 3x;
    and the device time of each of the kernel's three passes under
    torch.profiler.  No one PyTorch call
    computes this scan, so it has no library time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    S = SEQ
    results, plain = {}, {}
    for name, (BH, P, N, chunk) in SSD_CASES.items():
        xdt, a, b, c = ssd_inputs(torch, gen, BH, S, P, N)
        y_ref, st_ref = ssd_scan_ref(xdt, a, b, c)
        if (BH, P, N) not in plain:
            plain[BH, P, N] = cuda_ms(lambda: ssd_scan_ref(xdt, a, b, c))
        y, st = ssd_scan(xdt, a, b, c, chunk=chunk)
        y2, st2 = ssd_scan(xdt, a, b, c, chunk=chunk)
        torch.cuda.synchronize()
        what = f"ssd_scan ({name})"
        err = max(assert_close(torch, what, y, y_ref, SSD_TOL, SSD_TOL),
                  assert_close(torch, what + " state", st, st_ref, SSD_TOL,
                               SSD_TOL))
        if not (same_bits(torch, y, y2) and same_bits(torch, st, st2)):
            raise AssertionError(f"{what}: two launches differ")
        rel = (rel_err(torch, what, y, y_ref),
               rel_err(torch, what + " state", st, st_ref))
        yx, stx = ssd_scan(xdt, torch.roll(a, 1, 1), b, c, chunk=chunk)
        control = tuple(rel_err(torch, what, o, r, float("inf"))
                        for o, r in ((yx, y_ref), (stx, st_ref)))
        print(f"ssd_scan ({name}) per-head relative error [{card}]: y "
              f"{rel[0]:.4g}, state {rel[1]:.4g} (limit {SSD_REL:g}); "
              f"control, a shifted by one: y {control[0]:.4g}, state "
              f"{control[1]:.4g} (must exceed {3 * SSD_REL:g})")
        if not min(control) > 3 * SSD_REL:
            raise AssertionError(f"{what}: the relative check would pass "
                                 f"the shifted-decay control {control}")
        ms = cuda_ms(lambda: ssd_scan(xdt, a, b, c, chunk=chunk))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                ssd_scan(xdt, a, b, c, chunk=chunk)
            torch.cuda.synchronize()
        per_kernel, _ = device_times(torch, prof)
        split = {stem: sum(v for k, v in per_kernel.items() if stem in k)
                 / ITERS for stem in SSD_PASSES}
        print(f"ssd_scan ({name}) passes [{card}]: "
              + (", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                 if per_kernel else "device time not measured (the "
                 "profiler recorded no device events)"))
        # Bytes: xdt, a, b, c read and y written (bf16), the fp32 state
        # written.  Operations of the chunked form: per chunk, the causal
        # half of (C B^T) and of its product with xdt, C state^T, and the
        # state update.
        nbytes = 2 * (2 * BH * S * P + BH * S + 2 * BH * S * N) \
            + 4 * BH * P * N
        q = chunk
        ops = BH * (S // q) * (q * (q + 1) // 2 * (2 * N + 2 * P)
                               + 4 * q * P * N)
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(err=err, ms=ms, plain_ms=plain[BH, P, N],
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by, nbytes=nbytes, ops=ops)
    return results


def check_attention(torch, cfg, gen):
    """Kernel 5 vs its plain version at tinyllama-1.1b's heads (32 query
    heads, 4 kv heads, head dim 64), batch 1, bf16: causal over 2048
    positions, causal with 512 queries over 2048 keys (bottom-right
    aligned), and 128 queries over 2048 keys not causal."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    results = {}
    for name, Sq, Sk, causal in (("causal", SEQ, SEQ, True),
                                 ("causal Sq<Sk", 512, SEQ, True),
                                 ("cross", 128, SEQ, False)):
        q = torch.randn(1, Sq, H, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(1, Sk, Hk, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(1, Sk, Hk, D, generator=gen, device="cuda").bfloat16()
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = assert_close(torch, f"flash_attention ({name})", out,
                           attention_ref(q, k, v, causal=causal))
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal))
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # SDPA's is_causal aligns top-left: give it the bottom-right mask
        # when Sq < Sk.
        mask = None
        if causal and Sq != Sk:
            mask = torch.ones(Sq, Sk, dtype=torch.bool,
                              device="cuda").tril(Sk - Sq)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True))
        pairs = sum(min(Sk, i + 1 + Sk - Sq) for i in range(Sq)) \
            if causal else Sq * Sk
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        ops = 4 * D * H * pairs
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, nbytes=nbytes, ops=ops)
    return results


def run_slice3_entry_points(torch, cfg, gen, card):
    """The entry points of the last three kernels, each with its launch
    count set to 0 just before and read just after: the SCLD example
    through SCLDLinear on the card (its system lines must equal the JAX
    package's, its kernel outputs its plain version's), then ops.ssd at
    mamba2-1.3b's widths and ops.attention at tinyllama-1.1b's heads,
    each against its plain version."""
    from repro_torch.examples import sclad_sparsity
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.sclad_matmul.sclad_matmul import sclad_matmul
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    launches = {}

    sclad_matmul.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = sclad_sparsity.main([])
    launches["sclad_matmul"] = sclad_matmul.launches
    for line in buf.getvalue().splitlines():
        print(f"sclad example [{card}]: {line}")
    if res["system"] != SCLD_SYSTEM_LINES:
        raise AssertionError(f"SCLD example system lines {res['system']} "
                             f"differ from the JAX package's")
    if launches["sclad_matmul"] != len(res["kernel"]):
        raise AssertionError(f"SCLD example: {launches['sclad_matmul']} "
                             f"launches for {len(res['kernel'])} layers")
    for units, (y, ref) in res["kernel"].items():
        assert_close(torch, f"SCLD example (units={units})", y, ref,
                     *SCLD_TOL_FP32)

    BH, S, P, N = SSD_HEADS, SEQ, SSD_HEAD_DIM, SSD_STATE
    x, _, b, c = ssd_inputs(torch, gen, BH, S, P, N)
    dt = (torch.rand(BH, S, generator=gen, device="cuda") * 0.1).bfloat16()
    A = -torch.rand(BH, generator=gen, device="cuda").bfloat16() * 4
    ssd_scan.launches = 0
    y, st = ssd_ops.ssd(x, dt, A, b, c, chunk=SSD_CHUNK)
    torch.cuda.synchronize()
    launches["ssd_scan"] = ssd_scan.launches
    if launches["ssd_scan"] != 1:
        raise AssertionError(f"ops.ssd: {launches['ssd_scan']} kernel "
                             f"launches for one call")
    yr, sr = ssd_scan_ref(x * dt[..., None], dt * A[:, None], b, c)
    e1 = max(assert_close(torch, "ops.ssd", y, yr, SSD_TOL, SSD_TOL),
             assert_close(torch, "ops.ssd state", st, sr, SSD_TOL, SSD_TOL))
    r1 = max(rel_err(torch, "ops.ssd", y, yr),
             rel_err(torch, "ops.ssd state", st, sr))

    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn(1, SEQ, H, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, SEQ, Hk, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, SEQ, Hk, D, generator=gen, device="cuda").bfloat16()
    flash_attention.launches = 0
    out = attn_ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches["flash_attention"] = flash_attention.launches
    e2 = assert_close(torch, "ops.attention", out,
                      attention_ref(q, k, v, causal=True))
    print(f"entry points [{card}]: ops.ssd max|err| {e1:.3g} (per-head "
          f"relative {r1:.3g}), ops.attention "
          f"max|err| {e2:.3g}; launches {launches}")
    return launches


def model_logits(torch, cfg, params, kv_dtype, mode, wrong=False):
    """Full-width logits of a first chunk, a continuation's last position
    and a decode step, on a ``kv_dtype`` pool with ``attn_kernel=mode``
    (a vlm first chunk behind random patch embeddings, and its
    continuation's start counting them); ``wrong`` points the table entry
    of lane 0's first prompt tokens at the trash block for the decode
    step."""
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
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    patches = None
    if prefix:
        patches = torch.randn(nb, prefix, cfg.d_model, generator=rng,
                              device=dev).bfloat16()
    dtbl = tbl.clone()
    if wrong:
        dtbl[0, prefix // BS] = 0
    c = replace(cfg, attn_kernel=mode, kv_dtype=kv_dtype)
    cache = M.init_paged_cache(c, N, BS, device=dev)
    a, cache = M.prefill_slots(c, params, cache, toks, lens, tbl,
                               patch_embeds=patches)
    b, cache = M.prefill_slots(c, params, cache, t2, l2, tbl,
                               start=prefix + lens, all_logits=True)
    d, cache = M.decode_step(c, params, cache, tok1, lens + l2,
                             block_tables=dtbl)
    torch.cuda.synchronize()
    return a.float(), b[:, -1].float(), d[:, 0].float()


def compare_logits(torch, what, got, want, share, card, enforce=True):
    """Each of the three logit sets within ``share`` of want's range (only
    printed when not ``enforce``)."""
    worst = 0.0
    for name, x, y in zip(("prefill", "continuation", "decode"), got, want):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{what} {name} logits are not finite")
        span = (y.max() - y.min()).item()
        err = (x - y).abs().max().item()
        agree = (x.argmax(-1) == y.argmax(-1)).float().mean().item()
        print(f"model check {what} {name} [{card}]: max|diff| {err:.4g} of "
              f"range {span:.4g} (limit {share * span:.4g}); argmax "
              f"agreement {agree:.2f}")
        if enforce and err > share * span:
            raise AssertionError(f"model {what} {name}: differ by {err} "
                                 f"(range {span}, limit {share * span})")
        worst = max(worst, err / span)
    return worst


@contextlib.contextmanager
def routing(torch, log, replay):
    """Record each ``models.moe.route`` call's expert choice into ``log``,
    or (``replay``) route every call to ``log``'s choices in order, with
    weights renormalised from this run's router probabilities at those
    experts; a replay must use the whole log."""
    from repro_torch.models import moe
    route, it = moe.route, iter(log)

    def recorded(cfg, router_w, x):
        weights, experts, aux = route(cfg, router_w, x)
        if not replay:
            log.append(experts)
            return weights, experts, aux
        experts = next(it)
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        weights = probs.gather(1, experts)
        return weights / weights.sum(-1, keepdim=True).clamp(min=1e-9), \
            experts, aux

    moe.route = recorded
    try:
        yield
    finally:
        moe.route = route
    if replay and next(it, None) is not None:
        raise AssertionError("routing replay: calls differ from the log")


def check_model(torch, cfg, params, card, pools=("bf16", "int8", "fp8"),
                quant_gate=True):
    """prefill_slots (first chunk, continuation) and decode_step logits
    with the kernels on vs off, full width, on each of ``pools`` (bf16
    first).  Tolerance: 5% of the logits' range — 22 bf16 layers (24-48
    on the other configs) amplify the kernels' fp32-vs-bf16 rounding
    differences in the attention outputs.  An MoE's top-k routing is
    discontinuous: a token whose k-th and (k+1)-th expert probabilities
    lie within that rounding picks another expert, whatever the kernels'
    accuracy; so the kernels' run takes the plain run's expert choices
    (``routing``), and the free-routing difference is printed beside it.
    A control shows the limit is tight enough to matter: the plain path's
    decode step with one table entry of one lane pointed at the trash
    block (16 of its 80 keys read from the wrong block; of 336 behind
    internvl2-26b's patches) must differ from the right one by more than
    it.  Then the quantized pools against the bf16 pool, kernels on,
    within QUANT_GATE of the range — a gate set on tinyllama-1.1b, only
    printed with ``quant_gate`` False."""
    on = {}
    for kv_dtype in pools:
        picks = []
        with routing(torch, picks, replay=False):
            off = model_logits(torch, cfg, params, kv_dtype, "off")
        with routing(torch, picks, replay=True):
            on[kv_dtype] = model_logits(torch, cfg, params, kv_dtype, "on")
        compare_logits(torch, f"{cfg.name} {kv_dtype} pool, kernels on vs "
                       f"off", on[kv_dtype], off, 0.05, card)
        if kv_dtype == "bf16" and picks:
            free = model_logits(torch, cfg, params, kv_dtype, "on")
            compare_logits(torch, f"{cfg.name} {kv_dtype} pool, kernels on "
                           f"vs off, free routing", free, off, 0.05, card,
                           enforce=False)
        if kv_dtype == "bf16":
            with routing(torch, picks, replay=True):
                bad = model_logits(torch, cfg, params, "bf16", "off",
                                   wrong=True)
            span = (off[2].max() - off[2].min()).item()
            err = (bad[2] - off[2]).abs().max().item()
            print(f"model check {cfg.name} control (decode reading one "
                  f"wrong block) [{card}]: max|wrong-off| {err:.4g} of "
                  f"range {span:.4g} (must exceed {0.05 * span:.4g})")
            if err <= 0.05 * span:
                raise AssertionError("model check cannot see a decode that "
                                     "reads one wrong block: its limit is "
                                     "too loose")
    for kv_dtype in pools[1:]:
        compare_logits(torch, f"{kv_dtype} vs bf16 pool", on[kv_dtype],
                       on["bf16"], QUANT_GATE[kv_dtype], card, quant_gate)


def trace(cfg, n=12):
    """The 12-request trace: 16-600 prompt tokens, a shared 64-token
    system prefix on every other request."""
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, size=64)
    reqs = []
    for i in range(n):
        p = rng.integers(1, cfg.vocab_size, size=int(rng.integers(16, 601)))
        if i % 2:
            p = np.concatenate([system, p])[:600]
        reqs.append(p)
    return reqs


def launch_counts():
    from repro_torch.kernels.flash_decode.flash_decode import (
        flash_decode, paged_flash_decode)
    from repro_torch.kernels.flash_prefill.flash_prefill import \
        paged_flash_prefill
    return {"paged_flash_decode": paged_flash_decode,
            "paged_flash_prefill": paged_flash_prefill,
            "flash_decode": flash_decode}


def run_engine(torch, cfg, params, card, kv_dtype="bf16", mode="auto",
               reqs=None, images=None, max_new=32, expect_hits=True):
    """One path of the main path: ServingEngine over the kernels on
    ``reqs`` (default: the 12-request trace; ``images``: a vlm request's
    patch embeddings or None, the zero stub), ``max_new`` tokens each,
    launch counts set to 0 before and read after; with ``expect_hits``
    the continuous path must hit the prefix cache past any patch
    prefix."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampler import SamplerConfig

    eng = ServingEngine(
        cfg, params, max_batch=B, max_len=MAX_LEN, eos_id=-1,
        block_size=BS, prefill_chunk=CHUNK, attn_kernel="auto", seed=0,
        sampler=SamplerConfig(temperature=0.8, top_k=50), device="cuda",
        kv_dtype=kv_dtype, mode=mode)
    reqs = trace(cfg) if reqs is None else reqs
    images = [None] * len(reqs) if images is None else images
    # Both prefill forms are certain on the continuous path: the first
    # admission into the empty pool is a first chunk, and a prompt longer
    # than one chunk (or a prefix-cache hit, asserted below) continues from
    # cached context.
    if eng.mode != "wave" and max(len(p) for p in reqs) <= CHUNK:
        raise AssertionError("no prompt spans more than one prefill chunk")
    torch.cuda.reset_peak_memory_stats()
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=max_new, patch_embeds=pe)
            for p, pe in zip(reqs, images)]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    s = eng.stats
    L = cfg.num_layers
    what = f"engine {cfg.name} ({eng.mode}, {kv_dtype})"
    for u in uids:
        toks = out[u]
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"{what}: request {u} returned {toks}")
    if eng.mode == "wave":
        # Every decode step but each wave's last (which only samples);
        # waves group the requests by prompt length, B at most.
        sizes = {}
        for p in reqs:
            sizes[len(p)] = sizes.get(len(p), 0) + 1
        waves = sum(-(-n // B) for n in sizes.values())
        want = {"flash_decode": L * (s.decode_steps - waves),
                "paged_flash_decode": 0, "paged_flash_prefill": 0}
        if launches != want or want["flash_decode"] <= 0:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
    else:
        want = {"paged_flash_decode": L * s.decode_steps,
                "paged_flash_prefill": L * s.prefill_chunks,
                "flash_decode": 0}
        if launches != want or s.decode_steps == 0:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
        if expect_hits and s.cached_prompt_tokens <= 0:
            raise AssertionError(f"{what}: no prefix-cache hits on the "
                                 f"shared prefix")
    kv = "" if eng.mode == "wave" else (
        f"; KV block {s.kv_block_bytes} B, peak pool "
        f"{s.peak_pool_bytes / 2**20:.1f} MiB")
    print(f"{what} [{card}]: {len(uids)} requests, wall {wall:.2f} s; "
          f"decode {s.tokens_per_s:.1f} tok/s ({s.decode_steps} steps, "
          f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step); prefill "
          f"{s.prefill_tokens_per_s:.1f} tok/s ({s.prefill_tokens} tokens, "
          f"{s.prefill_chunks} chunks); cached prompt tokens "
          f"{s.cached_prompt_tokens}; preemptions {s.preemptions}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{kv}")
    print(f"{what} launches [{card}]: {launches}")
    return launches, eng


def run_same_bytes_pair(torch, cfg, params, card):
    """A bf16 pool and an int8 pool of the same device bytes (the bf16
    pool holds 8 lanes of ~600-token requests), 16 lanes, 24 requests:
    the SCLAD pool's extra blocks become extra live lanes."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampler import SamplerConfig
    rng = np.random.default_rng(2)
    reqs = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(500, 601)))
            for _ in range(24)]
    bf16_blocks = 8 * (-(-(600 + 32) // BS))
    rows = {}
    wrappers = launch_counts()
    for kv_dtype in ("bf16", "int8"):
        probe = ServingEngine(cfg, params, max_batch=1, max_len=BS,
                              block_size=BS, num_blocks=1, device="cuda",
                              kv_dtype=kv_dtype)
        block_bytes = probe.kv_block_bytes
        del probe
        if kv_dtype == "bf16":
            pool_bytes = bf16_blocks * block_bytes
        blocks = pool_bytes // block_bytes
        eng = ServingEngine(
            cfg, params, max_batch=16, max_len=MAX_LEN, eos_id=-1,
            block_size=BS, num_blocks=blocks, prefill_chunk=CHUNK,
            attn_kernel="auto", seed=0, kv_dtype=kv_dtype, device="cuda",
            sampler=SamplerConfig(temperature=0.8, top_k=50))
        for w in wrappers.values():
            w.launches = 0
        for p in reqs:
            eng.submit(p, max_new_tokens=32)
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        s = eng.stats
        if len(out) != len(reqs) or any(len(t) != 32 for t in out.values()):
            raise AssertionError(f"same-bytes {kv_dtype} run lost requests")
        rows[kv_dtype] = s
        print(f"same-bytes pair {kv_dtype} [{card}]: {blocks} blocks x "
              f"{s.kv_block_bytes} B = {blocks * s.kv_block_bytes / 2**20:.1f}"
              f" MiB pool; mean live lanes {s.mean_active_requests:.2f} "
              f"(peak {s.peak_decode_lanes}); preemptions {s.preemptions}; "
              f"decode {s.tokens_per_s:.1f} tok/s ({s.decode_steps} steps, "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step); wall "
              f"{wall:.2f} s; launches {launches}")
    if rows["int8"].peak_decode_lanes <= rows["bf16"].peak_decode_lanes:
        raise AssertionError("the int8 pool held no more lanes than the "
                             "bf16 pool of the same bytes")


def device_times(torch, prof, skip=()):
    """{kernel name: device ms} and the device operation count of a
    profile; ``skip``: span names, whose device-side ranges are not
    operations."""
    per_kernel, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in skip:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
            n += 1
    return per_kernel, n


def profile_prefill(torch, eng, cfg, card):
    """Where a prefill chunk's time goes, after the main path: the same
    engine prefilling 8 prompts of 300 tokens, its second chunk (a
    continuation over 128 cached positions, no decode step yet) under
    torch.profiler.  Prints the device-busy ms and share of the profiled
    wall time, device operations per chunk, the kernels with the most
    device time, and the prefill kernel's ms per chunk by name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    for _ in range(B):
        eng.submit(rng.integers(1, cfg.vocab_size, size=300),
                   max_new_tokens=4)
    eng.step()  # admission and the first chunk
    chunks = eng.stats.prefill_chunks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if eng.stats.prefill_chunks != chunks + 1:
        raise AssertionError("prefill profile: the step ran no chunk")
    eng.run()
    per_kernel, n = device_times(torch, prof)
    if not per_kernel:
        print("prefill profile: device time not measured (the profiler "
              "recorded no device events)")
        return
    busy = sum(per_kernel.values())
    print(f"prefill profile [{card}]: one continuation chunk of {B} rows x "
          f"{CHUNK} tokens, wall {wall:.2f} ms under the profiler, device "
          f"busy {busy:.3f} ms ({busy / wall:.1%}), {n} device operations")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms/chunk  {name[:90]}")
    stem = "prefill_tc_kernel"
    ms = sum(v for k, v in per_kernel.items() if stem in k)
    calls = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and stem in e.name)
    print(f"prefill profile {stem} [{card}]: {ms:.4f} ms/chunk, {calls} "
          f"launches/chunk")
    if calls != cfg.num_layers:
        raise AssertionError(f"prefill profile: {calls} {stem} launches "
                             f"in a chunk of {cfg.num_layers} layers")


@contextlib.contextmanager
def spans(torch, module, names):
    """Run each of ``module``'s functions ``names`` inside a
    torch.profiler span of its name while the context lasts (callers in
    the module reach them through its globals)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


#: The MoE FFN's stages (``models.moe``), each a span of the MoE decode
#: profile: routing, slot assignment, the gather into expert buffers, the
#: expert products, the weighted combine and the shared expert.
MOE_SPANS = ("route", "_dispatch_indices", "_gather", "_expert_ffn",
             "_combine", "apply_shared")


def profile_decode(torch, eng, cfg, card, moe_spans=False):
    """Where a decode step's time goes, after the main path: the same
    engine with all 8 lanes decoding, three steps under torch.profiler.
    Prints the device-busy share of the (profiled) wall time, launches per
    step, and the kernels with the most device time; with ``moe_spans``
    also the device time of each MoE stage (MOE_SPANS) a step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import moe
    rng = np.random.default_rng(1)
    for _ in range(B):
        eng.submit(rng.integers(1, cfg.vocab_size, size=64),
                   max_new_tokens=8)
    eng.step()  # admission, one prefill chunk, the first decode step
    steps = 3
    names = MOE_SPANS if moe_spans else ()
    torch.cuda.synchronize()
    with spans(torch, moe, names), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    per_kernel, n = device_times(torch, prof, skip=names)
    if not per_kernel:
        print("decode profile: device time not measured (the profiler "
              "recorded no device events)")
        return
    busy = sum(per_kernel.values())
    print(f"decode profile {cfg.name} [{card}]: {steps} steps of {B} "
          f"lanes, wall "
          f"{wall / steps * 1e3:.2f} ms/step under the profiler, device "
          f"busy {busy / steps:.2f} ms/step "
          f"({busy / (wall * 1e3):.1%}), {n / steps:.0f} device "
          f"operations/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"  {ms / steps:8.3f} ms/step  {name[:90]}")
    for stem in ("decode_tc_kernel", "decode_combine_kernel"):
        ms = sum(v for k, v in per_kernel.items() if stem in k)
        calls = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and stem in e.name)
        print(f"decode profile {stem} [{card}]: {ms / steps:.4f} ms/step, "
              f"{calls / steps:.0f} launches/step")
    if names:
        # A span's device time: the kernels launched inside it (the CPU
        # range's subtree), summed over its calls.
        cpu = torch.autograd.DeviceType.CPU
        by_span = {n: sum(getattr(e, "device_time_total", None)
                          or e.cuda_time_total for e in prof.events()
                          if e.name == n and e.device_type == cpu) / 1e3
                   for n in names}
        print(f"decode profile MoE stages [{card}]: " + ", ".join(
            f"{n} {ms / steps:.3f} ms/step" for n, ms in by_span.items())
            + f" (of {busy / steps:.3f} ms/step busy)")


#: The other attention families' configs at full width, the slice's own
#: paths: moe and vlm served on a bf16 pool and in wave mode, the three
#: other dense configs on a short continuous run.
MOE_ARCH, VLM_ARCH = "qwen2-moe-a2.7b", "internvl2-26b"
DENSE_ARCHS = ("stablelm-1.6b", "phi3-medium-14b", "granite-3-8b")


def images(cfg, n):
    """Two seeded random patch-embedding images (num_patches, d_model)
    fp32 and, for the 12-request trace, request i's image: every other
    request of the shared system prefix takes one of the two in turn
    (same-image requests then hit the prefix cache past the patches),
    the rest the zero stub."""
    import numpy as np
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((cfg.num_patches, cfg.d_model))
            .astype(np.float32) for _ in range(2))
    return [(a if i % 4 == 1 else b) if i % 2 else None for i in range(n)]


def run_family(torch, arch, card):
    """One config at full width with seeded random bf16 weights, freed
    afterwards: init (peak memory beside the weights' bytes),
    check_model, then its engine runs, each with its launch counts set to
    0 before and read after.  moe and vlm: kernels on vs off on bf16 and
    int8 pools, the 12-request trace on a bf16 pool (vlm: two images and
    the stub), a wave run of 4 requests of distinct lengths and 8 new
    tokens, and (moe) a profiled decode step.  Dense: bf16 pool, 4
    requests of 16 new tokens.  Returns {run: launches}."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    print(f"params {arch} [{card}]: {M.param_count(cfg) / 1e9:.3f} B, "
          f"{weights / 2**30:.2f} GiB bf16 in {time.perf_counter() - t0:.1f}"
          f" s; init peak {peak / 2**30:.2f} GiB ({peak / weights:.3f}x)")
    launches = {}
    if cfg.family == "dense":
        check_model(torch, cfg, params, card, pools=("bf16",))
        launches["continuous"], _ = run_engine(
            torch, cfg, params, card, reqs=trace(cfg, 4), max_new=16,
            expect_hits=False)
    else:
        check_model(torch, cfg, params, card, pools=("bf16", "int8"),
                    quant_gate=False)
        reqs = trace(cfg)
        imgs = images(cfg, len(reqs)) if cfg.family == "vlm" else None
        launches["continuous"], eng = run_engine(
            torch, cfg, params, card, reqs=reqs, images=imgs)
        if cfg.family == "moe":
            profile_decode(torch, eng, cfg, card, moe_spans=True)
        del eng
        wave = [reqs[i] for i in (0, 1, 2, 3)]
        if len({len(p) for p in wave}) != len(wave):
            raise AssertionError("wave run: prompt lengths repeat")
        launches["wave"], _ = run_engine(
            torch, cfg, params, card, mode="wave", reqs=wave,
            images=None if imgs is None else imgs[:4], max_new=8)
    del params
    torch.cuda.empty_cache()
    return launches


def kernel_entry(name, source, replaces, launches, r, err=None):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=r["err"] if err is None
                else err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"])


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

    # 2. Build, and what ptxas reports: registers (fewest-most over the
    # template instances) and spill bytes.
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build [{card}]: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log").read_text()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
        print(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes of spills")
        if name in TENSOR_CORE_BODIES:
            for fn, (nreg, spill) in sorted(ptxas_report(log).items()):
                print(f"    {short_name(fn)}: {nreg} registers, {spill} "
                      f"bytes of spills")
    report_tensor_cores(_build, card)

    # 3. Kernel checks.
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = {kd: check_decode(torch, cfg, gen, kd)
           for kd in ("bf16", "int8", "fp8")}
    tiny = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    pre = {kd: check_prefill(torch, tiny, gen, kd)
           for kd in ("bf16", "int8", "fp8")}
    pre6 = {kd: check_prefill(torch, REP6_HEADS, gen, kd,
                              cases=("first", f"first, prefix {VLM_PREFIX}",
                                     "continuation"))
            for kd in ("bf16", "int8", "fp8")}
    dense = check_dense_decode(torch, cfg, gen)
    # The new families' heads: qwen2-moe-a2.7b 16 over 16 of 128 (rep 1),
    # internvl2-26b 48 over 8 of 128 (rep 6).
    moe_cfg, vlm_cfg = get_config(MOE_ARCH), get_config(VLM_ARCH)
    moe_heads = (moe_cfg.num_heads, moe_cfg.num_kv_heads, moe_cfg.head_dim)
    dec_moe = check_decode(torch, moe_cfg, gen)
    dec_vlm = check_decode(torch, vlm_cfg, gen)
    pre_moe = check_prefill(torch, moe_heads, gen,
                            cases=("first", "continuation"))
    dense_vlm = check_dense_decode(torch, vlm_cfg, gen,
                                   S=MAX_LEN + VLM_PREFIX)
    rows = [(f"paged_flash_decode[{kd}]", r) for kd, r in dec.items()]
    rows += [(f"paged_flash_prefill[{kd}, {k}]", v)
             for kd, res in pre.items() for k, v in res.items()]
    rows += [(f"paged_flash_prefill[{kd}, {k}, heads {REP6_HEADS}]", v)
             for kd, res in pre6.items() for k, v in res.items()]
    rows.append(("flash_decode[dense]", dense))
    rows += [(f"paged_flash_decode[bf16, heads {moe_heads}]", dec_moe),
             (f"paged_flash_decode[bf16, heads {REP6_HEADS}]", dec_vlm)]
    rows += [(f"paged_flash_prefill[bf16, {k}, heads {moe_heads}]", v)
             for k, v in pre_moe.items()]
    rows.append((f"flash_decode[dense, heads {REP6_HEADS}]", dense_vlm))
    for name, r in rows:
        print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}){rates(r) if 'ops' in r else ''}")

    # 6. The last three kernels at full width, beside the other checks.
    sclad = check_sclad(torch, cfg)
    ssd = check_ssd(torch, gen, card)
    attn = check_attention(torch, cfg, gen)
    rows = [(f"sclad_matmul[{p}, C={c}]", r) for (p, c), r in sclad.items()]
    rows += [(f"ssd_scan[{n}]", r) for n, r in ssd.items()]
    rows += [(f"flash_attention[{n}]", r) for n, r in attn.items()]
    for name, r in rows:
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
              f"{rates(r) if 'ops' in r else ''}")

    # 4. Model checks, full width.
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    print(f"params: {M.param_count(cfg) / 1e9:.3f} B bf16 in "
          f"{time.perf_counter() - t0:.1f} s")
    check_model(torch, cfg, params, card)

    # 5. The main path, one run per pool encoding and mode, then the
    # same-bytes pair and a profile of the bf16 engine's decode step.
    launches = {}
    for kv_dtype, mode in (("bf16", "auto"), ("int8", "auto"),
                           ("fp8", "auto"), ("bf16", "wave")):
        launches[kv_dtype, mode], eng = run_engine(
            torch, cfg, params, card, kv_dtype=kv_dtype, mode=mode)
        if (kv_dtype, mode) == ("bf16", "auto"):
            bf16_engine = eng
    run_same_bytes_pair(torch, cfg, params, card)
    profile_prefill(torch, bf16_engine, cfg, card)
    profile_decode(torch, bf16_engine, cfg, card)

    # 7. The last three kernels' entry points.
    slice3 = run_slice3_entry_points(torch, cfg, gen, card)

    # 8. The other attention families at full width, one at a time.
    del params, bf16_engine, eng
    family = {arch: run_family(torch, arch, card)
              for arch in (MOE_ARCH, VLM_ARCH) + DENSE_ARCHS}

    # 9. Result lines.  The quantized bodies report their int8 times (fp8
    # on the lines above) and the launches of both the int8 and fp8 runs.
    def runs(kernel, *keys):
        return sum(launches[k][kernel] for k in keys)

    quant = (("int8", "auto"), ("fp8", "auto"))
    dec_src = "src/repro_torch/csrc/paged_decode.cu"
    pre_src = "src/repro_torch/csrc/paged_prefill.cu"
    dec_tpu = "src/repro/kernels/flash_decode/flash_decode.py"
    pre_tpu = "src/repro/kernels/flash_prefill/flash_prefill.py"
    kernels = [
        kernel_entry("paged_flash_decode", dec_src, f"{dec_tpu}:183",
                     runs("paged_flash_decode", ("bf16", "auto")),
                     dec["bf16"]),
        kernel_entry("paged_flash_decode[int8/fp8 pool]", dec_src,
                     f"{dec_tpu}:151",
                     runs("paged_flash_decode", *quant), dec["int8"],
                     err=max(dec["int8"]["err"], dec["fp8"]["err"])),
        kernel_entry("paged_flash_prefill", pre_src, f"{pre_tpu}:231",
                     runs("paged_flash_prefill", ("bf16", "auto")),
                     pre["bf16"]["continuation"],
                     err=max(r["err"] for res in (pre, pre6)
                             for r in res["bf16"].values())),
        kernel_entry("paged_flash_prefill[int8/fp8 pool]", pre_src,
                     f"{pre_tpu}:202",
                     runs("paged_flash_prefill", *quant),
                     pre["int8"]["continuation"],
                     err=max(r["err"] for res in (pre, pre6)
                             for kd in ("int8", "fp8")
                             for r in res[kd].values())),
        kernel_entry("flash_decode", "src/repro_torch/csrc/dense_decode.cu",
                     f"{dec_tpu}:78", runs("flash_decode", ("bf16", "wave")),
                     dense),
        kernel_entry(f"paged_flash_decode[heads {moe_heads}]", dec_src,
                     f"{dec_tpu}:183",
                     family[MOE_ARCH]["continuous"]["paged_flash_decode"],
                     dec_moe),
        kernel_entry(f"paged_flash_decode[heads {REP6_HEADS}]", dec_src,
                     f"{dec_tpu}:183",
                     family[VLM_ARCH]["continuous"]["paged_flash_decode"],
                     dec_vlm),
        kernel_entry(f"paged_flash_prefill[heads {moe_heads}]", pre_src,
                     f"{pre_tpu}:231",
                     family[MOE_ARCH]["continuous"]["paged_flash_prefill"],
                     pre_moe["continuation"],
                     err=max(r["err"] for r in pre_moe.values())),
        kernel_entry(f"paged_flash_prefill[heads {REP6_HEADS}, prefix "
                     f"{VLM_PREFIX}]", pre_src, f"{pre_tpu}:231",
                     family[VLM_ARCH]["continuous"]["paged_flash_prefill"],
                     pre6["bf16"][f"first, prefix {VLM_PREFIX}"],
                     err=max(r["err"] for r in pre6["bf16"].values())),
        kernel_entry(f"flash_decode[heads {REP6_HEADS}]",
                     "src/repro_torch/csrc/dense_decode.cu", f"{dec_tpu}:78",
                     family[VLM_ARCH]["wave"]["flash_decode"], dense_vlm),
        kernel_entry("sclad_matmul", "src/repro_torch/csrc/sclad_matmul.cu",
                     "src/repro/kernels/sclad_matmul/sclad_matmul.py:66",
                     slice3["sclad_matmul"], sclad["gate/up", 6],
                     err=max(r["err"] for r in sclad.values())),
        kernel_entry("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/ssd_scan.py:66",
                     slice3["ssd_scan"], ssd["mamba2-1.3b, chunk 256"],
                     err=max(r["err"] for r in ssd.values())),
        kernel_entry("flash_attention",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/flash_attention.py:72",
                     slice3["flash_attention"], attn["causal"],
                     err=max(r["err"] for r in attn.values())),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launches on the main "
                                 f"path")
        if k["library_ms"] is None and k["name"] != "ssd_scan":
            raise AssertionError(f"{k['name']}: no library time")
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
