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
     chunk-output passes (bf16 and, in 3xTF32, fp32);
  3. kernel checks, each kernel against its plain PyTorch version at the
     serving path's shapes (tinyllama heads, 16-token blocks, 8 lanes,
     64-entry tables, mixed lengths, dead lanes, a shared block), bf16
     compute, outputs within |out - ref| <= 2e-2 + 2e-2 |ref| element by
     element: paged decode and paged prefill on a bf16 pool, an f8 pool
     (float8_e4m3fn, no scales; a chunk row planted with values past 448
     and subnormals, stored as the card's PyTorch casts them, whose
     behaviour past 464 is printed) and int8 and fp8 SCLAD pools
     (prefill pools and scales bit for bit; a first
     chunk, one with a 16-token patch prefix, and a continuation, also
     at internvl2-26b's heads, 48 over 8 kv heads of 128: rep 6, with a
     first chunk behind its 256 patch positions, and at qwen2-moe-a2.7b's,
     16 over 16 of 128: rep 1), the dense decode of the wave path, and
     the paged decode at qwen2-moe-a2.7b's and internvl2-26b's heads and
     the dense decode at internvl2-26b's; on the f8 pool also K1 and K2
     at qwen2-moe-a2.7b's heads and K1 at internvl2-26b's, and the dense
     decode on f8 stripes at head dims 64, 112 (zamba2-7b's 32 over 32)
     and 128 (internvl2-26b's); the decode kernels also on a
     second length set straddling their 128-position split boundaries
     (and a stale length past the table or stripe), each bitwise equal
     from launch to launch; kernel, plain and
     ``scaled_dot_product_attention`` times (the last a yardstick only,
     on a pre-gathered, pre-dequantized dense copy; the port never calls
     it) beside each kernel's bound;
  4. model checks: full-width tinyllama-1.1b with seeded random bf16
     weights, ``prefill_slots`` and ``decode_step`` logits with the
     kernels on vs off on bf16, int8, fp8 and f8 pools, a control that
     reads one wrong block (bf16 and f8 pools), which the same limit must
     catch, and the int8/fp8/f8 pools vs the bf16 pool within the
     quantization gates;
  5. engine runs, each with the kernels' launch counts set to 0 just
     before and read just after: the port's ``ServingEngine`` serving 12
     requests (16-600 prompt tokens, a shared 64-token system prefix on
     half of them, 32 new tokens each at temperature 0.8) on a bf16, an
     int8, an fp8 and an f8 pool (180224 bytes a block), and in
     ``mode="wave"`` (dense stripes, the dense decode kernel) on bf16 and
     f8 stripes, the trace's first WAVE_REQUESTS = 6 requests (one wave
     each: cut from 12 for the whole script's time); a bf16 / int8 / f8 trio at the same pool bytes with 16
     lanes (blocks, block bytes, mean live lanes, preemptions, decode
     tok/s of each; the f8 pool twice the bf16 blocks); then under
     ``torch.profiler`` one continuation
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
  8. speculative decoding and the async front end: the paged prefill
     kernel at the verify pass's shape (8 lanes of SPEC_K + 1 = 5 rows,
     lengths 1-5, starts 1-1000, tinyllama-1.1b's heads on bf16, int8,
     fp8 and f8 pools, and internvl2-26b's on bf16) against its plain
     version as above; full-width tinyllama-1.1b's verify pass
     (``prefill_slots`` over 5 tokens behind a cached context) against
     five ``decode_step``s from a copy of the same pool, within the model
     checks' limit on bf16 and int8 pools, with a wrong-block control that
     must fail it; the 12-request trace's first SPEC_REQUESTS (6; cut in
     PR 29 for the whole script's time) at temperature 0 with speculation
     off and on (``spec_k`` 4) on bf16, int8 and f8 pools (no decode-kernel
     launch under speculation, prefill-kernel launches 22 x (chunks +
     verify passes),
     every request ends, pool invariants hold, no block stays live; the
     share of requests equal to the spec-off run is printed); and
     ``repro_torch.launch.serve`` in process through the async front end
     and a two-replica router with speculation on and replica 1 crashing
     (a failover, every request accounted for, no leaked block; client
     TTFT and ITL percentiles and tok/s);
  9. the other attention families at full width, each with seeded random
     bf16 weights built on the card (init peak memory beside the
     weights' bytes) and freed before the next: qwen2-moe-a2.7b (moe)
     and internvl2-26b (vlm, 256 patch positions) through the model
     checks on bf16 and int8 pools, the 12-request trace on a bf16 pool
     (internvl2-26b: every other request of the shared prefix carries
     one of two random images, which must hit the prefix cache past the
     patches; the rest the zero stub), a wave run of 4 requests of 8 new
     tokens (internvl2-26b also on f8 stripes), and for qwen2-moe-a2.7b a
     profiled decode step (device time
     of each MoE stage); stablelm-1.6b, phi3-medium-14b and granite-3-8b
     on DENSE_DEPTH's half of their layers (cut in PR 29 for the whole
     script's time) through the model checks on a bf16 pool and a
     4-request run of 16 new tokens; each run's launch counts as the
     12-request runs';
     internvl2-26b also serves 4 requests (two behind images) greedy
     with speculation off and on, checked as in phase 8;
 10. the recurrent families at full width, one at a time as in phase 9
     (mamba2-1.3b ssm, zamba2-7b hybrid on RECURRENT_DEPTH's 45 of its 81
     layers — seven groups of six and the tail of three, cut for the
     whole script's time — and whisper-base audio): init peak
     memory beside the weights' bytes; the SSD kernel at the model's
     prefill shapes (8 rows x heads folded into rows, B and C one row a
     group as the model hands them, at every wave prompt length, 16-512
     positions, fp32, chunk min(256, S)) against its plain version
     within SSD_TOL and a per-head relative limit of 1e-5 that the
     shifted-decay control must fail, bitwise launch to launch and
     bitwise the same launch on B and C repeated to every row
     (heads_per_group 1), each pass's device time, its bf16 tensor-core
     body timed beside; the dense decode
     kernel at zamba2-7b's shared-attention heads (32 over 32 of 112)
     and at whisper-base's (8 over 8 of 64) as in phase 3, with a
     control at 112 (the plain output with columns 96-111 zeroed must
     fail the check); ``prefill`` and two ``decode_step``s with the
     kernels on vs off, on the weights cast to fp32 at 64 and 512
     prompt tokens (whisper-base: 4) within 0.5% of the logits' range
     (whisper-base 0.1%), with a control that must fail it (row 0
     decoding from row 1's Mamba-2 caches or stripes); on the bf16
     weights within 5% for whisper-base, printed for mamba2-1.3b and
     zamba2-7b beside a witness (kernels off, scan chunk 128 vs 256);
     then the wave engine (``mode="auto"``): 12 requests of 16-512
     prompt tokens (mamba2-1.3b, zamba2-7b) or 8 of 4-64 (whisper-base),
     32 new tokens each, with the SSD kernel launched once a Mamba-2
     block a wave and the dense decode kernel once an attention layer a
     decode step, the paged kernels never; zamba2-7b and whisper-base
     again on f8 stripes, 4 requests of 8 new tokens (whisper-base's
     cache, its cross K/V included, checked float8_e4m3fn);
 11. training on one card, the kernels' launch counts set to 0 before
     each run and read after: full-width tinyllama-1.1b (bf16 weights
     from seed 0) takes TRAIN_STEPS AdamW steps on one TokenStream batch
     of 4 x 2048 tokens, with no kernel launch (the grad path is plain
     autograd), finite losses and grad norms, and a last loss LOSS_DROP
     below the first (ms a step after a warm-up step, tok/s, peak memory,
     model-FLOP share 6 N tokens / (t x 989 TFLOP/s)); its no-grad
     ``forward`` on the same batch launches the flash-attention kernel
     once a layer and agrees with the kernels-off forward within
     FORWARD_SHARE of the logits' range on the bf16 weights and on the
     weights cast to fp32, where K5 called non-causal (the control) must
     fail both; K5 alone at the forward's shape (4 x 2048, 32 over 4
     heads of 64) against its plain version and SDPA; mamba2-1.3b at
     full width: every gradient leaf finite and non-zero, two train steps
     of 2 x 512 tokens with no kernel launch, then a no-grad forward that
     launches the SSD kernel once a block; a reduced fp32 tinyllama's
     loss and every gradient on the card against the CPU port's; and
     ``repro_torch.launch.train`` in process (reduced): 3 steps and a
     restart to 6 against 6 uninterrupted steps;
 12. tensor-parallel serving over a (data=1, model=m) mesh naming the
     one card m times (each shard its own contiguous weights, pool slice
     and kernel launches; no speedup is expected or claimed): full-width
     tinyllama-1.1b on 6 of its 22 layers (SHARD_LAYERS: the whole
     script's time) at 2 and 4 shards, ``prefill_slots`` and
     ``decode_step`` logits against the meshless run's within the model
     checks' limit on bf16 and int8 pools, K2 launched m x layers times a
     chunk and K1 m x layers a decode step, the decode step's collectives
     moving exactly their psum / all_gather / broadcast bytes (no pool
     byte), and a control that hands shard 1 shard 0's query heads, which
     must fail the limit; K1 and K2 against their plain versions at the
     per-shard heads (16 over 2, 8 over 1) on bf16 and int8 pools (16
     over 2 also on an f8 pool) as in phase 3, and the sharded dispatch
     (pools placed once) against one
     launch on every head (outputs within the kernel tolerance, written
     pools and scales bit for bit; whether the outputs are bit for bit
     printed); the 12-request trace greedy meshless and on a 1-way mesh
     (the same layer loop with and without shards; each twice), at 2 and
     at 4 shards on bf16 and int8 pools (every request ends, no block
     stays live, launches m x layers a step or chunk; ms per decode step of
     each, and the share of requests equal to the meshless run's,
     printed: bf16 near-ties flip); then qwen2-moe-a2.7b and
     internvl2-26b at 2 shards: K1 and K2 at their per-shard heads (8
     over 8, 24 over 4; internvl2-26b's first chunk behind its 256 patch
     rows too) checked as above, the meshless logits, that model freed,
     the shards drawn leaf by leaf from the same seed (init peak memory),
     the logits check on a bf16 pool (the MoE replaying the meshless
     expert choices) and 4 greedy requests;
 13. training over a (data, model) mesh naming the card d x m times
     (``make_train_step(mesh=)``: FSDP over data x TP over model, one
     controller): full-width tinyllama-1.1b, one AdamW step of phase
     11's 4 x 2048 batch meshless and at (2, 1), (1, 2) and (2, 2) —
     loss, grad norm, every leaf's first moment and update against the
     meshless step with the same batch split (``split_step``; the
     meshless step itself read twice; ``MESH_*`` limits, the worst and
     the median leaf named), no kernel launch, the bytes each step
     counts by kind equal to ``dryrun.train_collectives`` exactly, ms a
     step and peak memory printed; the data-parallel meshes' larger
     distance from the unsplit step reproduced at the embedding outside
     the mesh (``embedding_check``); a control that leaves the gradients
     unsummed over the data axis, which must fail the limits;
     the 22 blocks as 2 pipeline stages (``pipeline_apply``, 4
     microbatches of 2 x 512, no grad) against the sequential stack,
     ppermute bytes = ticks x stages x a microbatch; qwen2-moe-a2.7b's
     MoE layer at full width through ``apply_moe_manual`` at (2, 2)
     against the auto path in 2 dispatch groups (99% of tokens within 2%
     of scale, aux within 0.05) with its bytes equal to the count;
 14. waves over a (data=1, model=m) mesh naming the card m times, every
     family (``run_wave_sharded``; each config at full width, freed
     before the next): tinyllama-1.1b at 2 and 4 shards (11 of its 22
     layers), qwen2-moe-a2.7b at 2 (12 of 24), mamba2-1.3b at 2 and 4
     (24 of 48; these three cut for the whole script's time), zamba2-7b
     at 2 (13 of its 81 layers: two groups of six and a tail of one) and
     whisper-base at 2.  The
     dense decode kernel at each per-shard head shape (16 over 2 and 8
     over 1 of 64; 8 over 8 of 128; 16 over 16 of 112; 4 over 4 of 64)
     on bf16 and f8 stripes and the SSD kernel at each per-shard row
     count (8 x 32 and 8 x 16; 8 x 56) at 64 and 512 positions in fp32,
     each against its plain version as in phases 3 and 10, and each
     sharded dispatch against one launch on every head (outputs within
     the kernel tolerance, whether bit for bit printed; the written
     stripes and the states bit for bit); ``prefill`` and two
     ``decode_step``s sharded against meshless within 5% of the range
     (bf16 weights; the MoE replaying the meshless expert choices),
     0.5% (mamba2-1.3b, zamba2-7b) or 0.1% (whisper-base) on the weights
     cast to fp32, a control that hands shard 1 shard 0's stripes or
     states, which must fail the limit; K4 launched m x the Mamba-2
     blocks in the prefill and K3 m x the attention layers a decode
     step, K1 and K2 never; the last decode step's bytes between shards
     exactly the count of its psums, all_gathers and broadcasts (no
     stripe, state or window byte); and 4 greedy requests of 8 tokens
     in waves meshless and at each shard count on bf16 and f8 stripes
     (every request ends, launches counted as above; ms per decode step,
     prefill tok/s and the share of requests equal to the meshless
     run's printed);
 15. the recurrent families' training over a (data, model) mesh naming
     the card d x m times (``run_recurrent_mesh_training``), on the
     seeded weights cast to fp32: mamba2-1.3b (48 blocks, 4 x 512
     tokens) at (1, 2), (1, 4) and (2, 2), zamba2-7b (13 of its 81
     layers, 2 x 512) and whisper-base (6 + 6 layers, 1500 stub frames,
     its vocab cut on d_model over data; 4 x 256) at (1, 2) and (2, 2):
     one AdamW step of ``make_train_step(mesh=)`` at each against the
     meshless step with the same batch split by phase 13's limits (loss,
     grad norm, every leaf's moment and update), the bytes each step
     counts by kind equal to ``dryrun.train_collectives``, no kernel
     launch; two controls at (1, 2) on mamba2-1.3b, whose second half
     of heads is scaled x 8 throughout — the gated norm's mean taken per
     shard, and the B / C gradient partials left unsummed over
     ``model`` — each of which must fail the limits; ms a step and peak
     memory by mesh;
 16. serving over a (data, model) mesh with data axes above 1, naming
     the card d x m times (``run_data_serving``; one controller, lanes
     cut by their slot over data, each data place on its own replica of
     the paged pool, whose written rows are gathered to the others):
     full-width tinyllama-1.1b on DATA_DEPTH's 11 of its 22 layers (cut
     in PR 29 for the whole script's time) at (2, 1) and (2, 2) — K1 and K2 at one
     place's shapes (4 lanes of 8; q (4, 32, 64) and (4, 16, 64)) against
     their plain versions as in phase 3, and K1, K2 and K3 launched once
     per data place on its lanes against one launch on all 8 (within
     TOL; whether bit for bit printed); ``prefill_slots`` and
     ``decode_step`` logits against the meshless run's within the model
     checks' limit on bf16, int8 and f8 pools, every data replica of the
     pool bit for bit the others after a chunk, K1 and K2 launched d x m
     x 11 times a step or chunk, the bytes of each call equal to
     ``dryrun.serve_collectives``; a lane on data place 1 reading a
     shared prefix that place 0 wrote, within the limit, and beyond it
     with the gather skipped (the control); the 12-request trace greedy
     meshless and at each mesh on bf16 and int8 pools (every request
     ends, no block stays live, K1 once a place a layer a step, K2 once
     a layer for each place holding a chunk's lanes; ms a decode step and
     the share of requests equal to the meshless run's printed);
     internvl2-26b at (2, 1) on 12 of its 48 layers (weights' bytes and
     init peak, the model check on a bf16 pool, 4 requests, two behind
     images, peak memory); waves — tinyllama-1.1b and mamba2-1.3b at
     (2, 2), whisper-base at (2, 1): K3 or K4 at one place's rows (2 of
     a 4-row wave, the shard's heads) against the plain version,
     ``prefill`` and two ``decode_step``s against meshless within phase
     14's limits (the recurrent ones on the weights cast to fp32), K4
     and K3 launched once a place a block or layer, a control handing
     data place 1 place 0's stripes or states, which must fail the
     limit, and 4 greedy requests meshless and over the mesh;
 17. the moe family served over a (data, model) mesh with data axes
     above 1, naming the card d x m times (``run_moe_data_serving``; the
     experts cut on E over data as the serve rule places them, each
     call dispatched in the reference's groups of its rows): full-width
     qwen2-moe-a2.7b on MOE_DATA_DEPTH's 10 of its 24 layers at (2, 1)
     and (2, 2) — K1 and K2 at one place's shapes against their plain
     versions and each place's launch against one launch on all 8 lanes
     (K3 too; bit for bit printed), each place holding only its E / d
     experts' d / m slice, ``prefill_slots`` and ``decode_step`` logits
     on bf16 and int8 pools against the meshless run under the same data
     axes (``hint_of``: the same groups) within 5% of the range, the
     meshless run's expert choices replayed by token (``by_places``),
     the replicas bit for bit, K1 / K2 launched once a place a layer,
     the bytes equal to ``dryrun.serve_collectives``; a cohort of lanes
     0 and 1 (one data place) at capacity factor MOE_CONTROL_FACTOR
     within the limit, and beyond it with slots formed by data place
     (the group control); the 12-request trace greedy on both pools at
     both meshes (ms a decode step, peak memory, launches); waves at (2,
     2): K3 at one place's 2 rows, ``prefill`` and two ``decode_step``s
     against the meshless run with the choices replayed, K3 launched
     once a place a layer, 4 requests; then qwen3-moe-235b-a22b on
     QWEN3_DEPTH's 4 of its 94 layers (about 22 GB) at (4, 1) and (2,
     2): K1 and K2 at rep 16, D 128 (one place's heads) as above, a
     first chunk, a continuation and QWEN3_DECODES decode steps against
     the meshless run under the same data axes within 5% of the range,
     launches and bytes as above, ms a decode step and peak memory;
 18. training on a batch that does not divide the data axes
     (``run_uneven_training``; ``place_batch`` keeps its 3 rows whole on
     every data place, each computing every row), on meshes naming the
     card d x m times: full-width tinyllama-1.1b, one AdamW step of a 3
     x 1024 batch meshless and at (2, 1) and (2, 2) — loss, grad norm,
     every leaf's first moment and update against the unsplit meshless
     step by phase 13's ``MESH_*`` limits (worst and median leaf named),
     the bytes by kind equal to ``dryrun.train_collectives``, ms a step
     and peak memory printed — and a control that sums the data places'
     losses, which must fail the limits; mamba2-1.3b on its weights cast
     to fp32 at (2, 2) on 3 x 512 alike; no kernel launch;
     qwen2-moe-a2.7b's MoE layer at full width at (2, 2) on 3 x 1024
     (the manual path on token slices of 1.5 rows, against the plain
     ``_routed`` in the same two contiguous token groups) and 3 x 1023
     (T odd: the grouped path on the E / d-cut experts, against the
     meshless layer in one group), each by phase 13's criterion with its
     bytes equal to ``dryrun.moe_layer_collectives``;
 19. each phase's seconds, a ``{"kernels": [...]}`` line, the card
     line, and the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# A fixed cuBLAS workspace, set before torch loads: the training phase's
# restart check runs under deterministic algorithms, which need it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "tinyllama-1.1b"
B, BS, T = 8, 16, 64          # lanes, tokens per block, table width
MAX_LEN = BS * T              # 1024 tokens of context per lane
CHUNK = 128                   # prefill chunk
TOL = 2e-2                    # kernel vs plain, bf16 outputs
#: Quantized vs bf16 pool, as a share of the logit range: the JAX
#: package's LOGIT_ERR_GATE (int8 0.15, fp8 0.35) over its span of ~3.
#: The f8 pool (float8_e4m3fn, no scales) takes fp8's: both keep 3
#: mantissa bits an element, and f8 loses more only below 2^-6 (its
#: subnormals, absolute error at most 2^-10) or past 448 (which K/V do
#: not reach).
QUANT_GATE = {"int8": 0.05, "fp8": 0.12, "f8": 0.12}
#: A chunk K row planted into the f8 prefill checks (tiled over D): values
#: past 448, where PyTorch builds cast differently (NaN or +-448), the
#: round-to-even tie at 464, and subnormals.
F8_PLANTED = (440.0, 447.0, 448.0, 460.0, 463.9, 464.0, 470.0, 1e3, 1e4,
              -500.0, -1e4, 1e-3, 2.0 ** -9, 2.0 ** -11, 3e-3, -2.0 ** -8)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM peak HBM3 bandwidth, dense bf16 peak below
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12        # fp32 outside the tensor cores
#: fp32-accurate products on the tensor cores: three TF32 products (495
#: TFLOP/s dense) for each (the SSD scan's fp32 body).
TF32X3_OPS_PER_S = 495e12 / 3
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
#: The fp32 body's passes (the score pass runs in the first's launch).
SSD_PASSES_FP32 = ("ssd_chunk_state_tf32_kernel", "ssd_state_pass_kernel",
                   "ssd_chunk_out_tf32_kernel")
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
                                   "ssd_chunk_out_tc_kernel",
                                   "ssd_chunk_state_tf32_kernel",
                                   "ssd_chunk_out_tf32_kernel")}


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
    """A mangled kernel name as its stem and template arguments: the
    <length><name> piece naming a ``..._kernel`` (the length's digits may
    follow a hash's)."""
    stem = None
    for m in re.finditer(r"\d+", fn):
        for i in range(m.start(), m.end()):
            name = fn[m.end():m.end() + int(fn[i:m.end()])]
            if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
                stem = name
                break
        if stem:
            break
    targs = re.search(r"_kernel(I.+?E)E?v", fn)
    return f"{stem or fn}{targs.group(1) if targs else ''}"


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


def bound(nbytes: float, ops: float, peak: float = BF16_OPS_PER_S):
    """Least time the card could take at ``peak`` operations a second:
    (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
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
    """Pool bytes of one (position, kv head) row: the D-vector (2 bytes an
    element in bf16, 1 in f8 and the SCLAD payloads) plus, for a SCLAD
    pool, its fp32 scale."""
    return {"bf16": 2 * D, "f8": D}.get(kv_dtype, D + 4)


def make_pool(torch, gen, N, Hk, D, kv_dtype):
    """A random K (or V) pool: bf16, the bf16 values cast to f8, or
    quantized by the port's codec -> (payload, scales or None)."""
    from repro_torch.models import kv_quant
    x = torch.randn(N, BS, Hk, D, generator=gen, device="cuda").bfloat16()
    if kv_dtype in ("bf16", "f8"):
        return x.to(torch.float8_e4m3fn if kv_dtype == "f8" else x.dtype), \
            None
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


def check_decode(torch, cfg, gen, kv_dtype="bf16", lanes=slice(None)):
    """Kernel 1 (bf16 or f8 pool) or its SCLAD body (int8/fp8 pool) vs its
    plain version at the decode step's shapes, then on lengths that
    straddle the split boundaries; bitwise equal launch to launch.
    ``lanes``: the lanes of the 8 taken (one data place's)."""
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
    q, lens, tbl, live = (x[lanes].contiguous()
                          for x in (q, lens, tbl, live))

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
    lens2, tbl2 = lens2[lanes].contiguous(), tbl2[lanes].contiguous()
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
#: zamba2-7b's shared attention: 32 over 32 heads of 112.
ZAMBA_HEADS = (32, 32, 112)
#: An f8 pool block at full width: tinyllama-1.1b's 22 layers x 16
#: positions x 4 kv heads x 64, K and V, one byte each (bf16 360448).
F8_BLOCK_BYTES = 22 * 16 * 4 * 64 * 2
PATCH_PREFIX = 16  # the patch-prefix case's prefix
VLM_PREFIX = 256   # internvl2-26b's patch prefix (num_patches)
SPEC_K = 4         # drafts per verify pass: P = SPEC_K + 1 rows per lane
#: Phase 8's spec runs serve the trace's first 6 requests (from PR 29:
#: the whole script's time).
SPEC_REQUESTS = 6
VERIFY = "verify"  # check_prefill's case of the speculative verify pass


def check_prefill(torch, heads, gen, kv_dtype="bf16", cases=None,
                  lanes=slice(None)):
    """Kernel 2 (bf16 or f8 pool) or its SCLAD body (int8/fp8 pool) vs its
    plain version at the prefill chunk's shapes with ``heads`` = (H, Hk,
    D): a first chunk, a first chunk behind a 16-position patch prefix
    (sharing the chunk's 128 rows), a first chunk behind internvl2-26b's
    256 patch positions (ahead of a whole chunk: 384 rows), a
    continuation (with a block-straddling start and a shared context
    block) and the speculative verify pass (``VERIFY``: SPEC_K + 1 = 5
    rows, lengths 1-5, starts 1-1000, a shared context block); pools (and
    scales) bit for bit, bitwise equal launch to launch.  On an f8 pool
    the last row of lane 0 carries F8_PLANTED in kv head 0, so the written
    pool holds values past 448 cast as this PyTorch build casts them.
    ``cases`` picks some of them (default: all but the 256-position prefix
    and the verify pass); ``lanes`` the lanes of the 8 taken (one data
    place's)."""
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
    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    chunk_lens = i32(128, 1, 77, 16, 128, 3, 100, 50)
    # (name, starts or None, prefix, chunk rows, lengths)
    all_cases = (
        ("first", None, 0, CHUNK, chunk_lens),
        (f"first, prefix {PATCH_PREFIX}", None, PATCH_PREFIX, CHUNK,
         chunk_lens),
        (f"first, prefix {VLM_PREFIX}", None, VLM_PREFIX, CHUNK, chunk_lens),
        ("continuation", i32(64, 5, 16, 300, 31, 600, 64, 1), 0, CHUNK,
         chunk_lens),
        (VERIFY, i32(64, 1, 1000, 300, 17, 5, 777, 128), 0, SPEC_K + 1,
         i32(5, 1, 4, 5, 2, 3, 5, 5)))
    if cases is None:
        cases = [c[0] for c in all_cases
                 if c[2] != VLM_PREFIX and c[0] != VERIFY]
    rows = max(c[3] + c[2] * (c[2] >= c[3]) for c in all_cases
               if c[0] in cases)
    q_all = torch.randn(B, rows, H, D, generator=gen, device=dev).bfloat16()
    kn_all = torch.randn(B, rows, Hk, D, generator=gen, device=dev).bfloat16()
    vn_all = torch.randn(B, rows, Hk, D, generator=gen, device=dev).bfloat16()

    results = {}
    for name, start, prefix, P, all_lens in all_cases:
        if name not in cases:
            continue
        # A prefix shorter than the chunk shares its P rows (lengths
        # clamped); a longer one comes ahead of a whole chunk.
        S = P + prefix * (prefix >= P)
        q, kn, vn = (x[:, :S].clone(memory_format=torch.contiguous_format)
                     for x in (q_all, kn_all, vn_all))
        if kv_dtype == "f8":
            kn[0, -1, 0] = torch.tensor(F8_PLANTED, device=dev).repeat(
                D // len(F8_PLANTED)).to(kn.dtype)
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
        q, kn, vn, lens, real, n_real, st, tbl = (
            x[lanes].contiguous() for x in (q, kn, vn, lens, real, n_real,
                                            st, tbl))
        start = None if start is None else st

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
            mask = torch.cat([cmask[:, None].expand(len(st), S, ctx), mask],
                             -1)
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
                    for b in range(len(st)))
        ops = 4 * H * D * pairs
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, nbytes=nbytes, ops=ops)
    return results


def check_dense_decode(torch, heads, gen, S=MAX_LEN, kv_dtype="bf16",
                       lanes=slice(None)):
    """Kernel 3 (dense stripes, the wave path's decode) vs its plain
    version: 8 rows of (S, Hk, D) bf16 (or, ``kv_dtype="f8"``, the bf16
    values cast to float8_e4m3fn) stripes at ``heads`` (H, Hk, D)
    (S = 1024 by default; internvl2-26b's wave stripes add its 256 patch
    positions), mixed lengths, then lengths that straddle the split
    boundaries; bitwise equal launch to launch.  At a D that is not a
    multiple of 32 (zamba2-7b's 112) a control: the plain output with
    its columns past the last multiple of 32 zeroed must fail the
    check.  ``lanes``: the rows of the 8 taken (one data place's)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.flash_decode import (
        SPLIT, flash_decode)
    from repro_torch.kernels.flash_decode.ref import decode_ref
    dev = "cuda"
    H, Hk, D = heads
    sd = torch.float8_e4m3fn if kv_dtype == "f8" else torch.bfloat16
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kc = torch.randn(B, S, Hk, D, generator=gen, device=dev).bfloat16().to(sd)
    vc = torch.randn(B, S, Hk, D, generator=gen, device=dev).bfloat16().to(sd)
    lens = torch.tensor([1, 17, 600, 1024, 0, 333, 64, 5],
                        dtype=torch.int32, device=dev)
    q, kc, vc, lens = (x[lanes].contiguous() for x in (q, kc, vc, lens))
    live = lens > 0
    out = flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    ref = decode_ref(q, kc, vc, lens)
    what = (f"dense decode kernel (heads {H}/{Hk}/{D}, {kv_dtype} stripes "
            f"of {S})")
    err = assert_close(torch, what, out[live], ref[live])
    same_launches(torch, what, out, lambda: flash_decode(q, kc, vc, lens))
    lens2 = torch.tensor([SPLIT - 1, SPLIT, SPLIT + 1, S, S + 300,
                          2 * SPLIT - 1, 2 * SPLIT + 1, 0],
                         dtype=torch.int32, device=dev)[lanes].contiguous()
    out2 = flash_decode(q, kc, vc, lens2)
    torch.cuda.synchronize()
    err = max(err, split_lengths_check(torch, what, out2,
                                       decode_ref(q, kc, vc, lens2), lens2))
    same_launches(torch, what + " (split boundaries)", out2,
                  lambda: flash_decode(q, kc, vc, lens2))
    if D % 32:
        cut = ref.clone()
        cut[..., D // 32 * 32:] = 0
        try:
            assert_close(torch, what + " control", cut[live], ref[live])
        except AssertionError:
            print(f"{what}: control with columns {D // 32 * 32}-{D - 1} "
                  f"zeroed fails the check, as it must")
        else:
            raise AssertionError(f"{what}: the check passes an output "
                                 f"missing its last {D % 32} columns")
    ms = cuda_ms(lambda: flash_decode(q, kc, vc, lens))
    plain_ms = cuda_ms(lambda: decode_ref(q, kc, vc, lens))
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]
            )[:, None, None, :]
    # SDPA's yardstick on a dense bf16 copy (f8 stripes widened first).
    kt, vt = (x.to(q.dtype).transpose(1, 2) for x in (kc, vc))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True))
    n = lens.clamp(max=S).double().sum().item()
    nbytes = (2 * n * Hk * D * kc.element_size() + 2 * q.numel() * 2
              + lens.numel() * 4)
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


def ssd_inputs(torch, gen, BH, S, P, N, dtype=None):
    """The JAX suite's magnitudes: xdt ~ 0.1 N(0,1), a = -0.1 |N(0,1)|,
    b, c ~ 0.3 N(0,1), in ``dtype`` (bf16 by default)."""
    dtype = dtype or torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return ((rnd(BH, S, P) * 0.1).to(dtype),
            (-rnd(BH, S).abs() * 0.1).to(dtype),
            (rnd(BH, S, N) * 0.3).to(dtype), (rnd(BH, S, N) * 0.3).to(dtype))


def ssd_work(BH, S, P, N, chunk, elem, groups=None):
    """(bytes, operations) of one SSD scan: xdt, a, b, c read and y
    written in ``elem``-byte elements, the fp32 state written; the
    chunked form's operations: per chunk, the causal half of (C B^T) and
    of its product with xdt and the state update, and for every chunk
    after the first C h_in^T (the first chunk's h_in is zero).
    ``groups``: the rows of b and c (BH: one a row), each read once,
    their causal C B^T formed once a group row and chunk."""
    G = BH if groups is None else groups
    nbytes = elem * (2 * BH * S * P + BH * S + 2 * G * S * N) \
        + 4 * BH * P * N
    q, nc = chunk, S // chunk
    tri = q * (q + 1) // 2
    ops = nc * (BH * (tri * 2 * P + 2 * q * P * N) + G * tri * 2 * N) \
        + (nc - 1) * BH * 2 * q * P * N
    return nbytes, ops


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
        nbytes, ops = ssd_work(BH, S, P, N, chunk, 2)
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(err=err, ms=ms, plain_ms=plain[BH, P, N],
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by, nbytes=nbytes, ops=ops)
    return results


def time_attention(torch, gen, B, Sq, Sk, H, Hk, D, causal):
    """Kernel 5 vs its plain version on random bf16 q (B, Sq, H, D) and
    k/v (B, Sk, Hk, D): max error, kernel, plain and
    ``scaled_dot_product_attention`` times, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, Sk, Hk, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, Sk, Hk, D, generator=gen, device="cuda").bfloat16()
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = assert_close(torch, f"flash_attention (B={B}, Sq={Sq}, Sk={Sk}, "
                       f"causal={causal})", out,
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
    ops = 4 * D * H * pairs * B
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes,
                ops=ops)


def check_attention(torch, cfg, gen):
    """Kernel 5 vs its plain version at tinyllama-1.1b's heads (32 query
    heads, 4 kv heads, head dim 64), batch 1, bf16: causal over 2048
    positions, causal with 512 queries over 2048 keys (bottom-right
    aligned), and 128 queries over 2048 keys not causal."""
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {name: time_attention(torch, gen, 1, Sq, Sk, H, Hk, D, causal)
            for name, Sq, Sk, causal in (("causal", SEQ, SEQ, True),
                                         ("causal Sq<Sk", 512, SEQ, True),
                                         ("cross", 128, SEQ, False))}


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


def first_chunk(torch, cfg, seed):
    """The model checks' first prefill chunk: 4 lanes of 64, 40, 9 and 1
    prompt tokens left-padded to 64 over their own 64-block tables.
    Returns (generator, pool blocks, tables, lengths, tokens)."""
    dev = "cuda"
    rng = torch.Generator(device=dev).manual_seed(seed)
    nb = 4
    N = nb * T + 1
    tbl = torch.arange(1, N, dtype=torch.int32, device=dev).reshape(nb, T)
    lens = torch.tensor([64, 40, 9, 1], dtype=torch.int32, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (nb, 64), generator=rng,
                         device=dev)
    toks[torch.arange(64, device=dev)[None] < (64 - lens)[:, None]] = 0
    return rng, N, tbl, lens, toks


def model_logits(torch, cfg, params, kv_dtype, mode, wrong=False,
                 mesh=None, log=None, after_chunk=None):
    """Full-width logits of a first chunk, a continuation's last position
    and a decode step, on a ``kv_dtype`` pool with ``attn_kernel=mode``
    (a vlm first chunk behind random patch embeddings, and its
    continuation's start counting them); ``wrong`` points the table entry
    of lane 0's first prompt tokens at the trash block for the decode
    step.  With a ``mesh`` (``params`` placed on it) the pool and every
    step are sharded, and the mesh's byte counters are cleared just
    before the decode step; with a ``log`` list they are read into it and
    cleared after each of the three calls.  ``after_chunk(cache)`` runs
    after the first chunk."""
    from dataclasses import replace
    from repro_torch.models import model as M
    dev = "cuda"
    rng, N, tbl, lens, toks = first_chunk(torch, cfg, 1)
    nb = len(lens)
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
    def read():
        if log is not None:
            log.append(dict(mesh.moved_bytes))
            mesh.moved_bytes.clear()

    cache = M.init_paged_cache(c, N, BS, device=dev, mesh=mesh)
    if mesh is not None:
        mesh.moved_bytes.clear()
    a, cache = M.prefill_slots(c, params, cache, toks, lens, tbl,
                               patch_embeds=patches, mesh=mesh)
    read()
    if after_chunk is not None:
        after_chunk(cache)
    b, cache = M.prefill_slots(c, params, cache, t2, l2, tbl,
                               start=prefix + lens, all_logits=True,
                               mesh=mesh)
    read()
    if mesh is not None:
        mesh.moved_bytes.clear()
    d, cache = M.decode_step(c, params, cache, tok1, lens + l2,
                             block_tables=dtbl, mesh=mesh)
    read()
    torch.cuda.synchronize()
    return a.float(), b[:, -1].float(), d[:, 0].float()


def compare_logits(torch, what, got, want, share, card, enforce=True,
                   names=("prefill", "continuation", "decode")):
    """Each logit set (one per name) within ``share`` of want's range (only
    printed when not ``enforce``)."""
    worst = 0.0
    for name, x, y in zip(names, got, want):
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


def verify_vs_decode(torch, cfg, params, kv_dtype, wrong=False):
    """Full-width logits of SPEC_K + 1 = 5 tokens after a cached context
    (4 lanes of 64, 40, 9 and 1 prompt tokens), scored from copies of one
    pool two ways, kernels on: one verify pass (``prefill_slots`` with
    ``start`` and ``all_logits``: the paged prefill kernel) and five
    ``decode_step``s (the paged decode kernel).  ``wrong`` points the
    decode steps' table entry of lane 0's first block at the trash block.
    Returns both as (20, vocab) fp32."""
    from dataclasses import replace
    from repro_torch.models import model as M
    dev = "cuda"
    rng, N, tbl, lens, toks = first_chunk(torch, cfg, 2)
    nb, P = len(lens), SPEC_K + 1
    draft = torch.randint(1, cfg.vocab_size, (nb, P), generator=rng,
                          device=dev)
    c = replace(cfg, attn_kernel="on", kv_dtype=kv_dtype)
    cache = M.init_paged_cache(c, N, BS, device=dev)
    _, cache = M.prefill_slots(c, params, cache, toks, lens, tbl)
    copy = {k: v.clone() for k, v in cache.items()}
    full = torch.full((nb,), P, dtype=torch.int32, device=dev)
    ver, _ = M.prefill_slots(c, params, cache, draft, full, tbl, start=lens,
                             all_logits=True)
    dtbl = tbl.clone()
    if wrong:
        dtbl[0, 0] = 0
    dec = []
    for j in range(P):
        d, copy = M.decode_step(c, params, copy, draft[:, j:j + 1], lens + j,
                                block_tables=dtbl)
        dec.append(d[:, 0])
    torch.cuda.synchronize()
    return (ver.float().reshape(nb * P, -1),
            torch.stack(dec, 1).float().reshape(nb * P, -1))


def check_verify_model(torch, cfg, params, card):
    """The verify pass against decode at the model level, on bf16 and
    int8 pools: within check_model's limit (5% of the logits' range);
    a decode that reads one wrong block (16 of lane 0's 65-69 keys) must
    differ from the verify pass by more than that limit."""
    for kv_dtype in ("bf16", "int8"):
        ver, dec = verify_vs_decode(torch, cfg, params, kv_dtype)
        compare_logits(torch, f"{cfg.name} {kv_dtype} pool, verify pass vs "
                       f"{SPEC_K + 1} decode steps", (ver,), (dec,), 0.05,
                       card, names=("verify",))
    ver, bad = verify_vs_decode(torch, cfg, params, "bf16", wrong=True)
    span = (ver.max() - ver.min()).item()
    err = (bad - ver).abs().max().item()
    print(f"model check {cfg.name} control (decode steps reading one wrong "
          f"block vs the verify pass) [{card}]: max|diff| {err:.4g} of "
          f"range {span:.4g} (must exceed {0.05 * span:.4g})")
    if err <= 0.05 * span:
        raise AssertionError("verify check cannot see a decode that reads "
                             "one wrong block: its limit is too loose")


def run_spec(torch, cfg, params, card, kv_dtype="bf16", reqs=None,
             images=None, max_new=32):
    """The same requests at temperature 0 with speculation off, then
    ``spec_decode="ngram"`` (``spec_k`` SPEC_K), each run's launch counts
    set to 0 before and read after.  Asserts: every request ends with
    ``max_new`` tokens, pool invariants hold and no block stays live
    after either run; the spec run launches no decode kernel and the
    prefill kernel once per layer per prefill chunk and verify pass.
    Prints decode tok/s, ms per verify pass, the acceptance rate and the
    share of requests whose tokens equal the spec-off run's (printed, not
    gated: kernels score decode positions through another kernel under
    speculation).  Returns the spec run's launches."""
    from repro_torch.serving.engine import ServingEngine
    reqs = trace(cfg) if reqs is None else reqs
    images = [None] * len(reqs) if images is None else images
    wrappers = launch_counts()
    outs = {}
    for spec in ("off", "ngram"):
        eng = ServingEngine(
            cfg, params, max_batch=B, max_len=MAX_LEN, eos_id=-1,
            block_size=BS, prefill_chunk=CHUNK, attn_kernel="auto", seed=0,
            device="cuda", kv_dtype=kv_dtype, spec_decode=spec,
            spec_k=SPEC_K)
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
        what = f"engine {cfg.name} (spec {spec}, {kv_dtype}, greedy)"
        for u in uids:
            toks = out[u]
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
                raise AssertionError(f"{what}: request {u} returned {toks}")
        eng._alloc.check_invariants()
        if eng.live_blocks:
            raise AssertionError(f"{what}: {eng.live_blocks} blocks live "
                                 f"after the run")
        L = cfg.num_layers
        if spec == "off":
            want = {"paged_flash_decode": L * s.decode_steps,
                    "paged_flash_prefill": L * s.prefill_chunks,
                    "flash_decode": 0, "ssd_scan": 0}
            step = f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step"
        else:
            want = {"paged_flash_decode": 0,
                    "paged_flash_prefill": L * (s.prefill_chunks
                                                + s.spec_passes),
                    "flash_decode": 0, "ssd_scan": 0}
            step = (f"{s.decode_s / max(s.spec_passes, 1) * 1e3:.2f} ms per "
                    f"verify pass, {s.spec_passes} passes, acceptance "
                    f"{s.spec_acceptance_rate:.3f} ({s.spec_accepted}/"
                    f"{s.spec_proposed})")
            if s.spec_passes == 0:
                raise AssertionError(f"{what}: no verify pass ran")
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
        outs[spec] = [out[u] for u in uids]
        print(f"{what} [{card}]: {len(uids)} requests, wall {wall:.2f} s; "
              f"decode {s.tokens_per_s:.1f} tok/s ({s.decode_steps} steps, "
              f"{step}); prefill {s.prefill_chunks} chunks; launches "
              f"{launches}")
    same = sum(a == b for a, b in zip(outs["off"], outs["ngram"])) / len(reqs)
    print(f"engine {cfg.name} ({kv_dtype}) spec vs off [{card}]: "
          f"{same:.2f} of requests token for token equal")
    return launches


def run_launcher(torch, card):
    """``repro_torch.launch.serve.main`` in process, full-width
    tinyllama-1.1b: an open-loop Poisson trace through the async front end
    and a two-replica router, speculation on, replica 1 crashing at its
    4th engine step.  Asserts: its summary parses, replica 1 died and at
    least one request failed over, every request completed or surfaced as
    a rejection, timeout or error, no block is live on either replica
    afterwards, and the verify passes launched the prefill kernel and no
    decode kernel (launches counted from two pump threads)."""
    from repro_torch.launch import serve
    n = 16
    argv = ["--arch", ARCH, "--frontend", "async", "--replicas", "2",
            "--spec-decode", "ngram", "--spec-k", str(SPEC_K),
            "--fault-crash-replica", "1", "--fault-crash-tick", "4",
            "--requests", str(n), "--max-new", "16", "--arrival-rate", "20",
            "--temperature", "0", "--max-batch", "4"]
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    out = json.loads(buf.getvalue())
    ft, routing = out["fault_tolerance"], out["routing"]
    ended = sum(out[k] for k in ("completed", "rejected_backpressure",
                                 "shed_breaker", "timeouts", "errors"))
    what = "launcher (async, 2 replicas, spec, crash)"
    if ft["replica_deaths"] != 1 or ft["failovers"] < 1 \
            or ft["health"][1] != "dead":
        raise AssertionError(f"{what}: no failover: {ft}")
    if out["requests"] != n or ended != n:
        raise AssertionError(f"{what}: {n} requests, {ended} ended: {out}")
    if routing["live_blocks"] != [0, 0]:
        raise AssertionError(f"{what}: blocks leaked: "
                             f"{routing['live_blocks']}")
    if launches["paged_flash_prefill"] <= 0 \
            or launches["paged_flash_decode"] != 0:
        raise AssertionError(f"{what}: launches {launches}")
    tok_s = routing["generated_tokens"] / out["wall_s"]
    print(f"{what} [{card}]: {n} requests at 20 req/s, completed "
          f"{out['completed']}, failovers {ft['failovers']}, wall "
          f"{out['wall_s']:.2f} s of {wall:.2f} s (warmup included); TTFT "
          f"p50 {out['client_p50_ttft_s'] * 1e3:.1f} ms, p99 "
          f"{out['client_p99_ttft_s'] * 1e3:.1f} ms; ITL p50 "
          f"{out['client_p50_itl_s'] * 1e3:.1f} ms, p99 "
          f"{out['client_p99_itl_s'] * 1e3:.1f} ms; {tok_s:.1f} tok/s "
          f"({routing['generated_tokens']} tokens); launches {launches}")
    return launches


@contextlib.contextmanager
def routing(torch, log, replay):
    """Record each ``models.moe._route_stats`` call's expert choice (the
    routing of every MoE layer) into ``log``, or (``replay``) route every
    call to ``log``'s choices in order, with weights renormalised from
    this run's router probabilities at those experts; a replay must use
    the whole log."""
    from repro_torch.models import moe
    route, it = moe._route_stats, iter(log)

    def recorded(cfg, router_w, x):
        weights, experts, me, ce = route(cfg, router_w, x)
        if not replay:
            log.append(experts)
            return weights, experts, me, ce
        experts = next(it)
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        weights = probs.gather(1, experts)
        return weights / weights.sum(-1, keepdim=True).clamp(min=1e-9), \
            experts, me, ce

    moe._route_stats = recorded
    try:
        yield
    finally:
        moe._route_stats = route
    if replay and next(it, None) is not None:
        raise AssertionError("routing replay: calls differ from the log")


def check_model(torch, cfg, params, card,
                pools=("bf16", "int8", "fp8", "f8"), quant_gate=True):
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
    it; on an f8 pool the same control runs on the f8 pool.  Then the
    int8 / fp8 / f8 pools against the bf16 pool, kernels on, within
    QUANT_GATE of the range — a gate set on tinyllama-1.1b, only printed
    with ``quant_gate`` False."""
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
        if kv_dtype in ("bf16", "f8"):
            with routing(torch, picks, replay=True):
                bad = model_logits(torch, cfg, params, kv_dtype, "off",
                                   wrong=True)
            span = (off[2].max() - off[2].min()).item()
            err = (bad[2] - off[2]).abs().max().item()
            print(f"model check {cfg.name} control (decode reading one "
                  f"wrong block, {kv_dtype} pool) [{card}]: max|wrong-off| "
                  f"{err:.4g} of range {span:.4g} (must exceed "
                  f"{0.05 * span:.4g})")
            if err <= 0.05 * span:
                raise AssertionError("model check cannot see a decode that "
                                     "reads one wrong block: its limit is "
                                     "too loose")
    for kv_dtype in pools[1:]:
        compare_logits(torch, f"{kv_dtype} vs bf16 pool", on[kv_dtype],
                       on["bf16"], QUANT_GATE[kv_dtype], card, quant_gate)


#: Phase 5's wave runs serve the trace's first 6 requests: a wave each
#: (waves group prompts by length), 192 decode steps, not 384.
WAVE_REQUESTS = 6


def trace(cfg, n=12):
    """The 12-request trace (its first ``n``: the generator draws them
    in order): 16-600 prompt tokens, a shared 64-token system prefix on
    every other request."""
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
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    return {"paged_flash_decode": paged_flash_decode,
            "paged_flash_prefill": paged_flash_prefill,
            "flash_decode": flash_decode, "ssd_scan": ssd_scan}


def recurrent_layers(cfg):
    """(attention layers, Mamba-2 blocks) a wave step runs: the attention
    families' layers are all attention; an ssm stack has none; a
    hybrid's attention is its shared block once a group; whisper's
    decoder layers each have one self-attention."""
    from repro_torch.models import model as M
    if cfg.family == "ssm":
        return 0, cfg.num_layers
    if cfg.family == "hybrid":
        return M.hybrid_layout(cfg)[0], cfg.num_layers
    return cfg.num_layers, 0


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
        # The dense decode kernel once an attention layer every decode
        # step but each wave's last (which only samples), the SSD kernel
        # once a Mamba-2 block a wave; waves group the requests by prompt
        # length, B at most.
        sizes = {}
        for p in reqs:
            sizes[len(p)] = sizes.get(len(p), 0) + 1
        waves = sum(-(-n // B) for n in sizes.values())
        attn, ssm = recurrent_layers(cfg)
        want = {"flash_decode": attn * (s.decode_steps - waves),
                "paged_flash_decode": 0, "paged_flash_prefill": 0,
                "ssd_scan": ssm * waves}
        if launches != want or want["flash_decode"] + want["ssd_scan"] <= 0:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
    else:
        want = {"paged_flash_decode": L * s.decode_steps,
                "paged_flash_prefill": L * s.prefill_chunks,
                "flash_decode": 0, "ssd_scan": 0}
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
    """A bf16 pool, an int8 pool and an f8 pool of the same device bytes
    (the bf16 pool holds 8 lanes of ~600-token requests), 16 lanes, 24
    requests: the compressed pools' extra blocks become extra live
    lanes.  Returns {kv_dtype: (blocks, EngineStats)}."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampler import SamplerConfig
    rng = np.random.default_rng(2)
    reqs = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(500, 601)))
            for _ in range(24)]
    bf16_blocks = 8 * (-(-(600 + 32) // BS))
    rows = {}
    wrappers = launch_counts()
    for kv_dtype in ("bf16", "int8", "f8"):
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
        rows[kv_dtype] = blocks, s
        print(f"same-bytes pair {kv_dtype} [{card}]: {blocks} blocks x "
              f"{s.kv_block_bytes} B = {blocks * s.kv_block_bytes / 2**20:.1f}"
              f" MiB pool; mean live lanes {s.mean_active_requests:.2f} "
              f"(peak {s.peak_decode_lanes}); preemptions {s.preemptions}; "
              f"decode {s.tokens_per_s:.1f} tok/s ({s.decode_steps} steps, "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step); wall "
              f"{wall:.2f} s; launches {launches}")
    for kv_dtype in ("int8", "f8"):
        if rows[kv_dtype][1].peak_decode_lanes <= \
                rows["bf16"][1].peak_decode_lanes:
            raise AssertionError(f"the {kv_dtype} pool held no more lanes "
                                 f"than the bf16 pool of the same bytes")
    if rows["f8"][0] != 2 * rows["bf16"][0]:
        raise AssertionError(f"the f8 pool holds {rows['f8'][0]} blocks, not "
                             f"twice the bf16 pool's {rows['bf16'][0]}")
    return rows


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
MOE_SPANS = ("_route_stats", "_dispatch_indices", "_gather",
             "_expert_ffn", "_combine", "apply_shared")


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
#: Phase 9's dense configs on half their layers (from PR 29: the whole
#: script's time): stablelm-1.6b 12 of 24, phi3-medium-14b and
#: granite-3-8b 20 of 40.
DENSE_DEPTH = {"stablelm-1.6b": 12, "phi3-medium-14b": 20,
               "granite-3-8b": 20}


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
    tokens (vlm: again on f8 stripes), (moe) a profiled decode step and
    (vlm) 4 requests of 16 greedy tokens with speculation off and on
    (``run_spec``).  Dense: on DENSE_DEPTH layers, bf16 pool, 4 requests
    of 16 new tokens.  Returns {run: launches}."""
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if arch in DENSE_DEPTH:
        cfg = replace(cfg, num_layers=DENSE_DEPTH[arch])
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
        if cfg.family == "vlm":
            launches["wave f8"], _ = run_engine(
                torch, cfg, params, card, kv_dtype="f8", mode="wave",
                reqs=wave, images=imgs[:4], max_new=8)
            # Speculation behind the patch prefix: two requests carry an
            # image, two the stub.
            launches["spec"] = run_spec(torch, cfg, params, card,
                                        reqs=reqs[:4], images=imgs[:4],
                                        max_new=16)
    del params
    torch.cuda.empty_cache()
    return launches


#: The recurrent families' configs at full width, served in waves.
SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH = "mamba2-1.3b", "zamba2-7b", "whisper-base"
#: Their prefill scans' rows as the model hands them to the kernel, and
#: the fp32 body's per-head relative limit (the CPU tests' 1e-5).
SSD_ROWS, SSD_REL_FP32 = 8, 1e-5
#: The wave runs' prompt lengths: every SSD chunk form (shorter than a
#: chunk, one chunk, two), and whisper-base's short transcripts.
RECURRENT_LENS = (16, 64, 128, 256, 512)
AUDIO_LENS = (4, 16, 32, 64)
#: Phase 10's depth cut: zamba2-7b on 45 of its 81 layers (seven groups of
#: six and the tail of three, every width full), for the script's time.
RECURRENT_DEPTH = {"zamba2-7b": 45}


def check_ssd_model(torch, cfg, gen, card, ways=1, lens=RECURRENT_LENS,
                    rows=SSD_ROWS):
    """Kernel 4 at ``cfg``'s prefill shapes as the model hands them to it
    (``ssm.ssd_via_kernel``): ``rows`` (SSD_ROWS; one data place's) x H
    heads folded into rows (H / ``ways``: one shard's heads), b and c one
    row a group (``heads_per_group`` = the heads a group), at every wave
    prompt length (``lens``), fp32 (the 3xTF32 body), chunk
    min(``ssm.chunk_size``, S); against the plain recurrence within
    SSD_TOL and per head within SSD_REL_FP32, which the shifted-decay
    control must exceed 3x; bitwise equal launch to launch, and bitwise
    the launch on b and c repeated to every row (``heads_per_group`` 1),
    timed beside.  Prints each pass's device time and the bound (3xTF32
    operations with C B^T once a group, each byte once) beside the old
    one (the CUDA cores' fp32 rate, C B^T a head).  The bf16 tensor-core
    body, which takes b and c a row, is timed on the same inputs with b
    and c repeated to every row, rounded to bf16.  Returns {S: result}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    s = cfg.ssm
    H = s.nheads(cfg.d_model) // ways
    G = s.ngroups  # a model shard holds every group (mamba_spec)
    BH, P, N, hpg = rows * H, s.head_dim, s.state_size, H // G
    results = {}
    for S in lens:
        chunk = min(s.chunk_size, S)
        xdt, a = ssd_inputs(torch, gen, BH, S, P, N, torch.float32)[:2]
        b, c = ssd_inputs(torch, gen, rows * G, S, P, N, torch.float32)[2:]
        scan = functools.partial(ssd_scan, chunk=chunk, heads_per_group=hpg)
        y_ref, st_ref = ssd_scan_ref(xdt, a, b, c, heads_per_group=hpg)
        y, st = scan(xdt, a, b, c)
        torch.cuda.synchronize()
        what = (f"ssd_scan ({cfg.name} prefill, {rows} x {H}, {S}, fp32, "
                f"{hpg} heads a group)")
        err = max(assert_close(torch, what, y, y_ref, SSD_TOL, SSD_TOL),
                  assert_close(torch, what + " state", st, st_ref, SSD_TOL,
                               SSD_TOL))
        same_launches(torch, what, torch.cat([y.flatten(), st.flatten()]),
                      lambda: torch.cat([t.flatten() for t in scan(
                          xdt, a, b, c)]))
        rel = max(rel_err(torch, what, y, y_ref, SSD_REL_FP32),
                  rel_err(torch, what + " state", st, st_ref, SSD_REL_FP32))
        yx, stx = scan(xdt, torch.roll(a, 1, 1), b, c)
        control = min(rel_err(torch, what, o, r, float("inf"))
                      for o, r in ((yx, y_ref), (stx, st_ref)))
        if not control > 3 * SSD_REL_FP32:
            raise AssertionError(f"{what}: the relative check would pass "
                                 f"the shifted-decay control {control}")
        br, cr = (t.repeat_interleave(hpg, 0) for t in (b, c))
        rows_out = ssd_scan(xdt, a, br, cr, chunk=chunk)
        if not all(same_bits(torch, o, r)
                   for o, r in zip(rows_out, (y, st))):
            raise AssertionError(f"{what}: b and c repeated to every row "
                                 f"differ from the launch by group")
        ms = cuda_ms(lambda: scan(xdt, a, b, c))
        rows_ms = cuda_ms(lambda: ssd_scan(xdt, a, br, cr, chunk=chunk))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                scan(xdt, a, b, c)
            torch.cuda.synchronize()
        per_kernel, _ = device_times(torch, prof)
        split = {stem: sum(v for k, v in per_kernel.items() if stem in k)
                 / ITERS for stem in SSD_PASSES_FP32}
        plain_ms = cuda_ms(lambda: ssd_scan_ref(xdt, a, b, c,
                                                heads_per_group=hpg))
        xb, ab, bb, cb = (t.bfloat16() for t in (xdt, a, br, cr))
        bf16_ms = cuda_ms(lambda: ssd_scan(xb, ab, bb, cb, chunk=chunk))
        nbytes, ops = ssd_work(BH, S, P, N, chunk, 4, rows * G)
        bound_ms, bound_by = bound(nbytes, ops, TF32X3_OPS_PER_S)
        old_bound = bound(*ssd_work(BH, S, P, N, chunk, 4), FP32_OPS_PER_S)
        bf16_bound = bound(*ssd_work(BH, S, P, N, chunk, 2))
        name = (f"ssd_scan[{cfg.name} prefill, {rows} x {H} rows, {S} "
                f"positions, chunk {chunk}]")
        print(f"kernel {name} passes [{card}]: "
              + (", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                 if per_kernel else "device time not measured (the "
                 "profiler recorded no device events)")
              + f"; bound {bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, "
              f"{ops} operations at 3xTF32), was {old_bound[0]:.6f} ms "
              f"({old_bound[1]}, the CUDA cores' fp32, C B^T a head)")
        print(f"kernel {name} [{card}]: max|err| {err:.3g}, per-head "
              f"relative {rel:.3g} (limit {SSD_REL_FP32:g}; control "
              f"{control:.3g}); fp32 body {ms:.4f} ms (b and c a row "
              f"{rows_ms:.4f} ms; bound {bound_ms:.6f} ms, {bound_by}), "
              f"bf16 tensor-core body {bf16_ms:.4f} ms (bound "
              f"{bf16_bound[0]:.6f} ms, {bf16_bound[1]}), plain "
              f"{plain_ms:.4f} ms")
        results[S] = dict(err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by, nbytes=nbytes, ops=ops,
                          rows_ms=rows_ms, bf16_ms=bf16_ms,
                          bf16_bound_ms=bf16_bound[0], passes=split)
    return results


def recurrent_logits(torch, cfg, params, mode, S, swap=False):
    """Full-width logits of a wave's prefill (4 rows of S tokens; audio's
    behind zero frames, a transcript's opening special tokens) and two
    decode steps with ``attn_kernel=mode``.  ``swap`` hands row 0 row 1's
    Mamba-2 caches (every block's SSM state and conv window: ssm, hybrid)
    or self-attention stripes (audio) before the decode steps."""
    from dataclasses import replace
    from repro_torch.models import model as M
    dev = "cuda"
    rng = torch.Generator(device=dev).manual_seed(3)
    nb = 4
    toks = torch.randint(1, cfg.vocab_size, (nb, S + 2), generator=rng,
                         device=dev)
    batch = {"tokens": toks[:, :S]}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(nb, cfg.encdec.encoder_seq_len,
                                      cfg.d_model, dtype=torch.bfloat16,
                                      device=dev)
    c = replace(cfg, attn_kernel=mode)
    first, cache = M.prefill(c, params, batch, S + 8)
    if swap:
        # Batch is axis 1 of the stacked leaves, axis 2 of a hybrid's
        # (groups, per, B, ...) ones.
        if cfg.family == "audio":
            leaves = [(cache["k"], 1), (cache["v"], 1)]
        elif cfg.family == "ssm":
            leaves = [(x, 1) for x in cache.values()]
        else:
            leaves = [(x, 2) for x in cache["groups"].values()] \
                + [(x, 1) for x in cache.get("tail", {}).values()]
        for x, axis in leaves:
            x.select(axis, 0).copy_(x.select(axis, 1))
    out = [first.float()]
    for i in range(2):
        d, cache = M.decode_step(c, params, cache, toks[:, S + i:S + i + 1],
                                 S + i)
        out.append(d[:, 0].float())
    torch.cuda.synchronize()
    return out


def as_fp32(tree):
    """A parameter tree with every leaf cast to fp32."""
    if isinstance(tree, dict):
        return {k: as_fp32(v) for k, v in tree.items()}
    return tree.float()


#: The fp32-weight kernels-on-vs-off limit, a share of the logits'
#: range, per family.  Set between the sound readings and the swapped-row
#: control on an NVIDIA H100 80GB HBM3 (700 W): sound mamba2-1.3b
#: 0.15-0.18%, zamba2-7b 0.08-0.10%, whisper-base 0.0015%; control
#: 64-66% (ssm, hybrid) and 0.78% (whisper-base, whose random-weight
#: logits barely depend on the self-attention context).
RECURRENT_FP32_SHARE = {"ssm": 0.005, "hybrid": 0.005, "audio": 0.001}
#: The prompt lengths of the model checks: a chunk shorter than
#: ssm.chunk_size and two full chunks (whisper: a transcript's opening).
MODEL_LENS = {"ssm": (64, 512), "hybrid": (64, 512), "audio": (4,)}


def check_recurrent_model(torch, cfg, params, card):
    """recurrent_logits with the kernels on vs off on the seeded weights
    cast to fp32, at each of MODEL_LENS, within RECURRENT_FP32_SHARE of
    the range, and a control that must exceed it: row 0 decoding from row
    1's caches.  The fp32 run takes the same SSD body as serving (the
    model scans in fp32 either way) and the dense decode's fp32 body (the
    bf16 one is held to its plain version above).  With the bf16 weights
    on vs off is held to the model checks' 5% for whisper-base; for ssm
    and hybrid it is printed, as an MoE's free routing is in check_model,
    beside a witness of its cause: off vs off with only the scan's
    summation order changed (chunk 128 for 256).  48-81 bf16 Mamba-2
    blocks turn such rounding-level differences into a sizeable share of
    the range."""
    from dataclasses import replace
    names = ("prefill", "decode 1", "decode 2")
    share = RECURRENT_FP32_SHARE[cfg.family]
    p32 = as_fp32(params)
    for S in MODEL_LENS[cfg.family]:
        off = recurrent_logits(torch, cfg, p32, "off", S)
        on = recurrent_logits(torch, cfg, p32, "on", S)
        compare_logits(torch, f"{cfg.name} wave, {S} tokens, fp32 weights, "
                       f"kernels on vs off", on, off, share, card,
                       names=names)
    bad = recurrent_logits(torch, cfg, p32, "off", S, swap=True)
    span = (off[1].max() - off[1].min()).item()
    err = (bad[1] - off[1]).abs().max().item()
    print(f"model check {cfg.name} control (row 0 decoding from row 1's "
          f"{'stripes' if cfg.family == 'audio' else 'Mamba-2 caches'}) "
          f"[{card}]: max|wrong-off| {err:.4g} of range {span:.4g} (must "
          f"exceed {share * span:.4g})")
    if err <= share * span:
        raise AssertionError(f"model check {cfg.name} cannot see a wrong "
                             f"decode: its limit is too loose")
    del p32, off, on, bad
    torch.cuda.empty_cache()
    off = recurrent_logits(torch, cfg, params, "off", S)
    compare_logits(torch, f"{cfg.name} wave, bf16 weights, kernels on vs "
                   f"off", recurrent_logits(torch, cfg, params, "on", S),
                   off, 0.05, card, enforce=cfg.family == "audio",
                   names=names)
    if cfg.family != "audio":
        c128 = replace(cfg, ssm=replace(cfg.ssm, chunk_size=128))
        compare_logits(torch, f"{cfg.name} wave, bf16 weights, witness: "
                       f"kernels off, chunk 128 vs 256",
                       recurrent_logits(torch, c128, params, "off", S), off,
                       0.05, card, enforce=False, names=names)


def run_recurrent(torch, arch, gen, card):
    """One recurrent config at full width with seeded random bf16 weights
    (the Mamba-2 leaves the reference fixes at its values), freed
    afterwards: init peak memory, its kernels at the model's shapes (K4
    at the prefill's, K3 at the attention heads'), check_recurrent_model,
    and the wave engine on 12 requests (8 for audio) of 32 new tokens;
    hybrid and audio also on f8 stripes, 4 requests of 8 new tokens (the
    audio cache's stripes, cross K/V included, checked f8).  Returns
    (kernel results, the engine run's launches, the f8 run's or None)."""
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if arch in RECURRENT_DEPTH:
        cfg = replace(cfg, num_layers=RECURRENT_DEPTH[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    print(f"params {arch} [{card}]: {M.param_count(cfg) / 1e9:.3f} B, "
          f"{weights / 2**30:.2f} GiB in {time.perf_counter() - t0:.1f} s; "
          f"init peak {peak / 2**30:.2f} GiB ({peak / weights:.3f}x)")
    kernels = {}
    if cfg.family != "audio":
        kernels["ssd"] = check_ssd_model(torch, cfg, gen, card)
    if cfg.family != "ssm":
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        r = check_dense_decode(torch, heads, gen)
        print(f"kernel flash_decode[dense, heads {heads}] [{card}]: max|err|"
              f" {r['err']:.3g}; kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}){rates(r)}")
        kernels["dense"] = r
    check_recurrent_model(torch, cfg, params, card)
    rng = np.random.default_rng(5)
    lens = AUDIO_LENS * 2 if cfg.family == "audio" \
        else [RECURRENT_LENS[i % 5] for i in range(12)]
    reqs = [rng.integers(1, cfg.vocab_size, size=n) for n in lens]
    launches, _ = run_engine(torch, cfg, params, card, reqs=reqs)
    f8 = None
    if cfg.family != "ssm":
        if cfg.family == "audio":
            from dataclasses import replace
            c8 = replace(cfg, kv_dtype="f8")
            _, cache = M.prefill(c8, params, {
                "tokens": torch.ones(1, 4, dtype=torch.int32, device="cuda"),
                "frames": torch.zeros(1, cfg.encdec.encoder_seq_len,
                                      cfg.d_model, dtype=torch.bfloat16,
                                      device="cuda")}, 8)
            dts = {k: str(v.dtype) for k, v in cache.items()}
            print(f"{arch} f8 wave cache [{card}]: {dts}")
            if set(dts.values()) != {"torch.float8_e4m3fn"}:
                raise AssertionError(f"{arch}: an f8 wave cache holds {dts}")
            del cache
        f8, _ = run_engine(torch, cfg, params, card, kv_dtype="f8",
                           reqs=reqs[:4], max_new=8)
    del params
    torch.cuda.empty_cache()
    return kernels, launches, f8


#: The training phase's tinyllama-1.1b batch and run: one TokenStream batch
#: of TRAIN_B x TRAIN_S tokens (S = 2048: the plain attention takes its
#: blockwise path under autograd) repeated for TRAIN_STEPS AdamW steps,
#: warmup 1, cosine to 0.1 x TRAIN_LR at the last step.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 2048, 8, 1e-3
#: The last of those losses must sit this far below the first (nats): on
#: one repeated batch the unigram statistics alone are worth several nats.
LOSS_DROP = 1.0
#: The no-grad forward with the kernels on vs off, as a share of the
#: logits' range: on the bf16 weights check_model's 5%; on the weights
#: cast to fp32 (K5's fp32 body against the plain fp32 attention) 0.1%.
FORWARD_SHARE = {"bf16": 0.05, "fp32": 0.001}
#: mamba2-1.3b's train steps: B x S = 2 x 512, two SSD chunks of 256.
MAMBA_B, MAMBA_S, MAMBA_STEPS = 2, 512, 2
#: Card against CPU: each gradient leaf within this share of its largest
#: element (fp32 summed in another order; the embedding's gradient
#: accumulates with atomics on the card), the loss within 1e-5 relative.
GRAD_TOL = 1e-4
#: The launcher's restart: final parameters of 3 steps + a restart to 6
#: against 6 uninterrupted steps, under deterministic algorithms.
RESTART_TOL = 1e-5


def all_kernels():
    """Every kernel wrapper, by name (the engine's four and the two no
    served path calls)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.sclad_matmul.sclad_matmul import sclad_matmul
    return dict(launch_counts(), flash_attention=flash_attention,
                sclad_matmul=sclad_matmul)


def zero_launches():
    for w in all_kernels().values():
        w.launches = 0


def read_launches():
    return {k: w.launches for k, w in all_kernels().items()}


def train_batch(torch, cfg, B, S, seed=0):
    """Batch 0 of the port's TokenStream on the card."""
    from repro_torch.training import data
    b = data.TokenStream(data.DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=S, global_batch=B,
                                         seed=seed)).batch(0)
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def event_ms(torch, fn, iters=3):
    """Mean ms of ``fn()`` over ``iters`` calls after one warm-up, CUDA
    events around the loop."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_train_steps(torch, cfg, params, batch, card):
    """TRAIN_STEPS of ``make_train_step`` on ``batch``, kernel launch
    counts set to 0 before and read after (all must stay 0: the grad path
    is plain autograd).  The first step is the warm-up; each later one is
    timed by CUDA events.  Gates: finite losses, grad norms above 0, the
    last loss LOSS_DROP below the first."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    step = steps.make_train_step(cfg, opt.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS))
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    metrics, ms = [], []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step(params, opt_state, batch)
        end.record()
        metrics.append(m)
        if i:
            ms.append((start, end))
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    step_ms = sum(s.elapsed_time(e) for s, e in ms) / len(ms)
    tokens = batch["tokens"].numel()
    flops = 6 * M.param_count(cfg) * tokens
    print(f"train {cfg.name} B={batch['tokens'].shape[0]} "
          f"S={batch['tokens'].shape[1]} [{card}]: losses "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in norms]}; {step_ms:.1f} ms/step (mean of "
          f"{len(ms)} after a warm-up step), {tokens / step_ms * 1e3:.0f} "
          f"tok/s, peak memory {peak / 2**30:.2f} GiB, model-FLOP share "
          f"{flops / (step_ms * 1e-3 * BF16_OPS_PER_S):.2%} of 989 "
          f"TFLOP/s; launches {launches}")
    if not all(math.isfinite(x) for x in losses + norms) \
            or min(norms) <= 0:
        raise AssertionError(f"train {cfg.name}: losses {losses}, grad "
                             f"norms {norms}")
    if any(launches.values()):
        raise AssertionError(f"train {cfg.name}: a kernel launched on the "
                             f"grad path: {launches}")
    return params, opt_state, losses, step_ms


def forward_logits(torch, cfg, params, batch, mode):
    """The no-grad full-sequence forward's logits with attn_kernel=mode."""
    from dataclasses import replace
    from repro_torch.models import model as M
    with torch.no_grad():
        logits, _ = M.forward(replace(cfg, attn_kernel=mode), params,
                              {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    return logits.float()


@contextlib.contextmanager
def non_causal_flash_attention():
    """The control: every ``ops.attention`` call the forward makes runs
    K5 non-causal (each position also sees the ones after it)."""
    from repro_torch.models import layers
    real = layers.attn_ops.attention
    layers.attn_ops.attention = \
        lambda q, k, v, causal=True, **kw: real(q, k, v, causal=False, **kw)
    try:
        yield
    finally:
        layers.attn_ops.attention = real


def check_forward(torch, cfg, params, batch, card):
    """The no-grad forward through K5 (kernels on) against the plain one
    (off) on the training batch: K5 launches once a layer; logits within
    FORWARD_SHARE of the range on the bf16 weights and on the weights
    cast to fp32; the non-causal control must exceed both limits.  Also
    the forward's ms on and off.  Returns the kernels-on run's K5
    launches."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    zero_launches()
    on = forward_logits(torch, cfg, params, batch, "auto")
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.num_layers
    print(f"forward {cfg.name} no-grad launches [{card}]: {launches}")
    if launches != want:
        raise AssertionError(f"forward: launches {launches}, want {want}")
    off = forward_logits(torch, cfg, params, batch, "off")

    def forward(mode):
        from dataclasses import replace
        from repro_torch.models import model as M
        with torch.no_grad():
            M.forward(replace(cfg, attn_kernel=mode), params,
                      {"tokens": batch["tokens"]})

    times = {m: event_ms(torch, lambda: forward(m))
             for m in ("auto", "off")}
    print(f"forward {cfg.name} B={TRAIN_B} S={TRAIN_S} no-grad [{card}]: "
          f"kernels on {times['auto']:.1f} ms, off {times['off']:.1f} ms")
    compare_logits(torch, f"{cfg.name} forward bf16, kernels on vs off",
                   [on], [off], FORWARD_SHARE["bf16"], card,
                   names=("logits",))
    with non_causal_flash_attention():
        bad = forward_logits(torch, cfg, params, batch, "auto")
    del on
    p32 = as_fp32(params)
    off32 = forward_logits(torch, cfg, p32, batch, "off")
    compare_logits(torch, f"{cfg.name} forward fp32 weights, kernels on vs "
                   f"off", [forward_logits(torch, cfg, p32, batch, "auto")],
                   [off32], FORWARD_SHARE["fp32"], card, names=("logits",))
    with non_causal_flash_attention():
        bad32 = forward_logits(torch, cfg, p32, batch, "auto")
    for what, x, ref, share in (("bf16", bad, off, FORWARD_SHARE["bf16"]),
                                ("fp32", bad32, off32,
                                 FORWARD_SHARE["fp32"])):
        span = (ref.max() - ref.min()).item()
        err = (x - ref).abs().max().item()
        print(f"forward control (K5 non-causal, {what} weights) [{card}]: "
              f"max|wrong-off| {err:.4g} of range {span:.4g} (must exceed "
              f"{share * span:.4g})")
        if err <= share * span:
            raise AssertionError(f"forward check ({what}) cannot see a "
                                 f"non-causal attention: its limit is too "
                                 f"loose")
    flash_attention.launches = 0
    return launches["flash_attention"]


def check_mamba_training(torch, card):
    """mamba2-1.3b at full width, bf16 (the reference's fp32 A_log, D,
    dt_bias): every leaf's gradient finite and non-zero, MAMBA_STEPS
    train steps with no kernel launch, then one no-grad forward over the
    same batch through K4, once a Mamba-2 block.  Returns that forward's
    K4 launches."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    cfg = get_config(SSM_ARCH)
    params = M.init_params(cfg, seed=0, device="cuda")
    batch = train_batch(torch, cfg, MAMBA_B, MAMBA_S)
    zero_launches()
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = M.loss_fn(cfg, tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    bad = [path for (path, _), g in zip(tree.flatten(params), grads)
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    names = sorted({p.rsplit("/", 1)[-1] for p, _ in tree.flatten(params)})
    print(f"train {cfg.name} gradients [{card}]: loss {loss.item():.4f}; "
          f"{len(grads)} leaves ({', '.join(names)}), "
          f"{len(grads) - len(bad)} finite and non-zero")
    if bad:
        raise AssertionError(f"{cfg.name}: zero or non-finite gradients "
                             f"in {bad}")
    del leaves, loss, grads
    step = steps.make_train_step(cfg, opt.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=MAMBA_STEPS))
    opt_state = opt.init(params)
    losses = []
    for _ in range(MAMBA_STEPS):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    launches = read_launches()
    print(f"train {cfg.name} B={MAMBA_B} S={MAMBA_S} [{card}]: losses "
          f"{[round(x, 4) for x in losses]}; launches {launches}")
    if any(launches.values()) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{cfg.name} train steps: losses {losses}, "
                             f"launches {launches}")
    logits = forward_logits(torch, cfg, params, batch, "auto")
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want["ssd_scan"] = cfg.num_layers
    print(f"forward {cfg.name} no-grad launches [{card}]: {launches}")
    if launches != want or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} forward: launches {launches}, "
                             f"want {want}")
    del params, opt_state, logits
    torch.cuda.empty_cache()
    return want["ssd_scan"]


def check_card_against_cpu(torch, card):
    """A reduced tinyllama (d_model 256, 4 heads over 2 of 64, 2 layers)
    in fp32 with every parameter from one numpy draw: loss and every
    gradient on the card against the CPU port's, within GRAD_TOL of each
    leaf's largest element."""
    import numpy as np
    from dataclasses import replace
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = replace(get_config(ARCH).reduced(), d_model=256, num_heads=4,
                  num_kv_heads=2, head_dim=64)
    rng = np.random.default_rng(0)
    host = tree.map_leaves(
        lambda p: torch.from_numpy(
            0.05 * rng.standard_normal(p.shape).astype(np.float32)),
        M.init_params(cfg, 0, device="cpu", dtype=torch.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 257)))
    out = []
    for dev in ("cuda", "cpu"):
        leaves = [p.detach().to(dev).requires_grad_(True)
                  for p in tree.leaves(host)]
        loss = M.loss_fn(cfg, tree.unflatten(host, leaves),
                         {"tokens": toks[:, :-1].to(dev),
                          "labels": toks[:, 1:].to(dev)})
        out.append((loss.item(), [g.cpu() for g in
                                  torch.autograd.grad(loss, leaves)]))
    (card_loss, card_grads), (cpu_loss, cpu_grads) = out
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(card_grads, cpu_grads))
    print(f"card vs CPU {cfg.name} fp32 [{card}]: loss {card_loss:.6f} vs "
          f"{cpu_loss:.6f}; worst gradient leaf max|Δ| / max|g| "
          f"{worst:.3g} over {len(cpu_grads)} leaves (limit {GRAD_TOL})")
    if abs(card_loss - cpu_loss) > 1e-5 * abs(cpu_loss) \
            or not worst <= GRAD_TOL:
        raise AssertionError("card vs CPU: the loss or a gradient differs")


def check_restart(torch, card):
    """``repro_torch.launch.train`` in process on the card: 6 steps
    uninterrupted against 3 steps, then a restart from their checkpoint
    to 6; the final parameters within RESTART_TOL.  Reduced: a
    full-width checkpoint is ~13 GB of npz (bf16 weights and two fp32
    moments, saved as fp32).  Deterministic algorithms are on for the
    run (cuBLAS's workspace is fixed at the top of this script), so the
    two runs take the same reductions."""
    import shutil
    from repro_torch import tree
    from repro_torch.launch import train as train_cli
    root = ROOT / "build" / "train_restart"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "64",
            "--ckpt-every", "3", "--device", "cuda"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            full = train_cli.main(args + ["--steps", "6", "--ckpt",
                                          str(root / "a")])
            train_cli.main(args + ["--steps", "3", "--ckpt",
                                   str(root / "b")])
            resumed = train_cli.main(args + ["--steps", "6", "--ckpt",
                                             str(root / "b")])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    worst = max((a.float() - b.float()).abs().max().item() for a, b in
                zip(tree.leaves(full.params), tree.leaves(resumed.params)))
    lines = [ln for ln in buf.getvalue().splitlines() if "finished" in ln]
    print(f"launcher restart [{card}]: {lines}; step "
          f"{int(resumed.opt_state.step)}; final parameters max|Δ| "
          f"{worst:.3g} (limit {RESTART_TOL})")
    if resumed.step != 6 or int(resumed.opt_state.step) != 6 \
            or not worst <= RESTART_TOL:
        raise AssertionError("the restarted run did not resume the "
                             "uninterrupted one")


def run_training(torch, gen, card):
    """The training phase: full-width tinyllama-1.1b train steps, its
    no-grad forward through K5 against the plain forward (and K5 alone at
    the forward's shape), mamba2-1.3b's gradients and train steps, the
    card against the CPU, and the launcher's restart.  Returns (K5's
    timings at the forward's shape, the forward's K5 launches, the
    mamba2 forward's K4 launches)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    params = M.init_params(cfg, seed=0, device="cuda")
    batch = train_batch(torch, cfg, TRAIN_B, TRAIN_S)
    trained, _, losses, _ = run_train_steps(torch, cfg, params, batch, card)
    if not losses[-1] < losses[0] - LOSS_DROP:
        raise AssertionError(f"train {cfg.name}: the loss fell from "
                             f"{losses[0]:.4f} to {losses[-1]:.4f}, less "
                             f"than {LOSS_DROP}")
    del trained
    torch.cuda.empty_cache()
    k5_launches = check_forward(torch, cfg, params, batch, card)
    del params
    torch.cuda.empty_cache()
    k5 = time_attention(torch, gen, TRAIN_B, TRAIN_S, TRAIN_S,
                        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True)
    print(f"kernel flash_attention[forward, B={TRAIN_B}] [{card}]: max|err| "
          f"{k5['err']:.3g}; kernel {k5['ms']:.4f} ms, plain "
          f"{k5['plain_ms']:.4f} ms, sdpa {k5['library_ms']:.4f} ms, bound "
          f"{k5['bound_ms']:.6f} ms ({k5['bound_by']}){rates(k5)}; "
          f"{k5_launches} launches a forward")
    k4_launches = check_mamba_training(torch, card)
    check_card_against_cpu(torch, card)
    check_restart(torch, card)
    return k5, k5_launches, k4_launches


#: The tensor-parallel phase's meshes: m model shards on the one card.
SHARD_WAYS = (2, 4)


def card_mesh(m, d=1):
    """A (data=d, model=m) mesh naming the card d x m times."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((d, m), ("data", "model"), "cuda")


def mesh_name(mesh):
    """"m-way mesh" for (1, m); "(d, m) mesh" with data axes above 1."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    return f"{m}-way mesh" if d == 1 else f"({d}, {m}) mesh"


def decode_collective_bytes(cfg, m, nb=4):
    """Bytes model_logits' sharded decode step (nb lanes, T-entry tables)
    must move, pool-free: the embedding's psum and two psums a layer
    (attention, FFN) of (nb, 1, d) bf16, each 2 (m - 1) times its bytes;
    the logits' all_gather, (m - 1) x (nb, vocab) bf16; and the
    broadcasts of the tokens (int64), positions and tables (int32)."""
    act = nb * cfg.d_model * 2
    return {"psum": 2 * (m - 1) * act * (1 + 2 * cfg.num_layers),
            "all_gather": (m - 1) * nb * cfg.vocab_size * 2,
            "broadcast": (m - 1) * (nb * 8 + nb * 4 + nb * T * 4)}


def sharded_logits(torch, cfg, placed, kv_dtype, mesh, want, card,
                   what=""):
    """model_logits over ``mesh`` with the kernels on, held to ``want``
    (the meshless run's) within check_model's limit: K2 launched once a
    shard a layer a chunk, K1 once a shard a layer, the decode step's
    collectives moving exactly ``decode_collective_bytes`` (no pool
    byte).  Returns the logits."""
    m, L = len(mesh.axis_devices()), cfg.num_layers
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    got = model_logits(torch, cfg, placed, kv_dtype, "on", mesh=mesh)
    launches = {k: w.launches for k, w in wrappers.items()}
    moved = dict(mesh.moved_bytes)
    name = f"{cfg.name} {kv_dtype} pool, {m} shards vs none{what}"
    if launches != {"paged_flash_decode": m * L,
                    "paged_flash_prefill": 2 * m * L,
                    "flash_decode": 0, "ssd_scan": 0}:
        raise AssertionError(f"{name}: launches {launches}")
    print(f"sharded decode step {name} [{card}]: bytes between shards "
          f"{moved}")
    if cfg.name == ARCH and moved != decode_collective_bytes(cfg, m):
        raise AssertionError(f"{name}: the decode step moved {moved}, want "
                             f"{decode_collective_bytes(cfg, m)}")
    compare_logits(torch, name, got, want, 0.05, card)
    return got


def wrong_head_slice(placed):
    """``placed`` with shard 1 handed shard 0's query-head slice (its
    ``wq`` part): its heads attend with another shard's queries."""
    from repro_torch.parallel import sharding
    wq = placed["blocks"]["attn"]["wq"]
    bad = sharding.Sharded((wq.parts[0],) * len(wq.parts), wq.dim, wq.mesh)
    return dict(placed, blocks=dict(
        placed["blocks"], attn=dict(placed["blocks"]["attn"], wq=bad)))


def shard_vs_solo(torch, cfg, mesh, gen, kv_dtype="bf16", prefix=0):
    """K1 and K2 through the sharded dispatch (the pools placed once on
    the mesh, one launch a shard on its head slice) against one launch on
    every head, at ``cfg``'s decode and prefill shapes on a ``kv_dtype``
    pool: a continuation chunk, and with ``prefix`` also a first chunk
    behind that many patch rows.  Outputs must agree within TOL and the
    written pools (and scales) bit for bit; whether the outputs agree bit
    for bit is returned (decode, prefill) and printed."""
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_prefill import ops as prefill_ops
    from repro_torch.parallel import sharding
    dev, H, Hk, D = "cuda", cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sp = sharding.paged_attn_specs()
    N = B * T + 1
    kp, ks = make_pool(torch, gen, N, Hk, D, kv_dtype)
    vp, vs = make_pool(torch, gen, N, Hk, D, kv_dtype)
    pool = [kp, vp] + ([] if ks is None else [ks, vs])
    kvd = None if ks is None else kv_dtype

    def placed(xs):
        return [sharding.shard(x, sp["pool"] if i < 2 else sp["scale"], mesh)
                for i, x in enumerate(xs)]

    def scales(xs):
        return tuple(xs[2:]) or None

    tbl = (1 + torch.randperm(N - 1, generator=gen, device=dev)[:B * T]) \
        .reshape(B, T).int()
    lens = torch.tensor([1, 17, 600, 1024, 700, 333, 64, 5],
                        dtype=torch.int32, device=dev)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    dec = [decode_ops.decode_attention(q, *p[:2], lens, tbl, kernel="on",
                                       kv_scales=scales(p), mesh=mm)
           for p, mm in ((pool, None), (placed(pool), mesh))]
    what = f"sharded dispatch vs one launch, {cfg.name}, {kv_dtype} pool"
    assert_close(torch, f"{what}, decode", dec[1], dec[0])
    same = [same_bits(torch, *dec)]
    cl = torch.full((B,), CHUNK, dtype=torch.int32, device=dev)
    cases = [("continuation",
              torch.full((B,), 300, dtype=torch.int32, device=dev), 0)]
    if prefix:
        cases.append((f"first, prefix {prefix}", None, prefix))
    for name, st, pre in cases:
        S = CHUNK + pre
        qc = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        kn, vn = (torch.randn(B, S, Hk, D, generator=gen, device=dev)
                  .bfloat16() for _ in range(2))
        outs = []
        for p, mm in (([x.clone() for x in pool], None),
                      (placed(pool), mesh)):
            out = prefill_ops.prefill_attention(
                qc, kn, vn, p[0], p[1], cl, tbl, start=st, prefix=pre,
                kernel="on", kv_scales=scales(p), kv_dtype=kvd, mesh=mm)
            outs.append([sharding.gather(x) for x in out])
        torch.cuda.synchronize()
        assert_close(torch, f"{what}, prefill {name}", outs[1][0], outs[0][0])
        for i, (a, b) in enumerate(zip(outs[0][1:], outs[1][1:])):
            if not same_bits(torch, a, b):
                raise AssertionError(f"{what}, prefill {name}: pool leaf {i} "
                                     f"differs from one launch's write")
        same.append(same_bits(torch, outs[0][0], outs[1][0]))
    return same[0], all(same[1:])


def run_mesh_trace(torch, cfg, params, card, mesh=None, reqs=None,
                   images=None, max_new=32, kv_dtype="bf16", what=""):
    """The requests (default: the 12-request trace) greedy on a
    ``kv_dtype`` pool, meshless or over ``mesh`` (``params`` placed
    there), launch counts set to 0 before and read after: every request
    ends with ``max_new`` tokens, pool invariants hold, no block stays
    live, K1 launches once a place a layer a decode step (every place
    holds lanes) and K2 once a layer a chunk for each place holding
    some of the chunk's lanes (``places_with_rows``: every place on a
    (1, m) mesh).  Returns (outputs, ms per decode step, launches)."""
    from repro_torch.serving.engine import ServingEngine
    m = 1 if mesh is None else mesh.devices.size
    reqs = trace(cfg) if reqs is None else reqs
    images = [None] * len(reqs) if images is None else images
    eng = ServingEngine(cfg, params, max_batch=B, max_len=MAX_LEN, eos_id=-1,
                        block_size=BS, prefill_chunk=CHUNK,
                        attn_kernel="auto", seed=0, device="cuda",
                        mesh=mesh, kv_dtype=kv_dtype)
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    uids = [eng.submit(p, max_new_tokens=max_new, patch_embeds=pe)
            for p, pe in zip(reqs, images)]
    with places_with_rows(mesh, B) as calls:
        out = eng.run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    s, L = eng.stats, cfg.num_layers
    where = "no mesh" if mesh is None else mesh_name(mesh)
    what = f"engine {cfg.name} ({where}, {kv_dtype}, greedy{what})"
    for u in uids:
        if len(out[u]) != max_new:
            raise AssertionError(f"{what}: request {u} returned {out[u]}")
    eng._alloc.check_invariants()
    if eng.live_blocks:
        raise AssertionError(f"{what}: {eng.live_blocks} blocks live")
    chunks = s.prefill_chunks if mesh is None else sum(calls)
    want = {"paged_flash_decode": m * L * s.decode_steps,
            "paged_flash_prefill": L * chunks,
            "flash_decode": 0, "ssd_scan": 0}
    if launches != want or s.decode_steps == 0:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    ms = s.decode_s / s.decode_steps * 1e3
    print(f"{what} [{card}]: {len(uids)} requests, {ms:.2f} ms per decode "
          f"step ({s.decode_steps} steps), prefill {s.prefill_chunks} "
          f"chunks, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    return [out[u] for u in uids], ms, launches


@contextlib.contextmanager
def places_with_rows(mesh, width):
    """A list that gets, for each ``prefill_slots`` call over ``mesh``
    while the block runs, the places that must run it, counted from the
    lane slots the engine hands it (its ``lanes`` argument) and not from
    the port's split: a data index holds the slots s with s // (width /
    d) equal to it, and each of its m model places runs when it holds
    one; every place runs every call where d does not divide ``width``
    (the engine's ``max_batch``).  Empty without a mesh."""
    from repro_torch.models import model as M
    calls = []
    prefill_slots = M.prefill_slots

    def spy(*args, **kwargs):
        if mesh is not None:
            d, m = mesh.shape["data"], mesh.shape["model"]
            slots = kwargs["lanes"].slots
            calls.append(d * m if width % d else
                         m * len({s // (width // d) for s in slots}))
        return prefill_slots(*args, **kwargs)

    M.prefill_slots = spy
    try:
        yield calls
    finally:
        M.prefill_slots = prefill_slots


def per_shard_kernels(torch, cfg, m, gen, card, kv_dtype="bf16",
                      cases=("first", "continuation"), prefix=0):
    """K1 and K2 against their plain versions at ``cfg``'s per-shard heads
    on an m-shard mesh, as in phase 3 (bitwise launch to launch, pools bit
    for bit), and the sharded dispatch against one launch on every head
    (``shard_vs_solo``).  Returns (heads, K1 result, {case: K2 result})."""
    from dataclasses import replace
    from repro_torch.parallel import sharding
    mesh = card_mesh(m)
    a = sharding.attn_shard_size(mesh, cfg.num_kv_heads)
    heads = (cfg.num_heads // a, cfg.num_kv_heads // a, cfg.head_dim)
    dec = check_decode(torch, replace(cfg, num_heads=heads[0],
                                      num_kv_heads=heads[1]), gen, kv_dtype)
    pre = check_prefill(torch, heads, gen, kv_dtype, cases=cases)
    same = shard_vs_solo(torch, cfg, mesh, gen, kv_dtype, prefix)
    print(f"kernels {cfg.name} at {m} shards, heads {heads}, {kv_dtype} pool "
          f"[{card}]: sharded dispatch vs one launch on every head, bit for "
          f"bit: decode {same[0]}, prefill {same[1]}")
    for name, r in [(f"paged_flash_decode[{kv_dtype}, heads {heads}]", dec)] \
            + [(f"paged_flash_prefill[{kv_dtype}, {k}, heads {heads}]", v)
               for k, v in pre.items()]:
        print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}){rates(r)}")
    return heads, dec, pre


def sharded_entries(cfg, m, heads, dec, pre, kv_dtype, row, launches):
    """The kernels line's two entries of one sharded shape: (name, kernel,
    SCLAD pool?, launches, result, worst error)."""
    tag = f"{cfg.name}, {m} shards, heads {heads}" \
        + ("" if kv_dtype == "bf16" else f", {kv_dtype} pool")
    quant = kv_dtype != "bf16"
    return [(f"paged_flash_decode[{tag}]", "decode", quant,
             launches["paged_flash_decode"], dec, dec["err"]),
            (f"paged_flash_prefill[{tag}]", "prefill", quant,
             launches["paged_flash_prefill"], pre[row],
             max(r["err"] for r in pre.values()))]


#: Phase 12's tinyllama-1.1b depth: 6 of its 22 layers (every width
#: full), to hold the whole script's time (11 until phase 18 came).
SHARD_LAYERS = 6


def run_sharded(torch, gen, card):
    """The tensor-parallel phase: full-width tinyllama-1.1b on
    SHARD_LAYERS layers at 2 and 4 shards, then qwen2-moe-a2.7b and
    internvl2-26b at 2, each mesh naming the one card.  Returns the
    kernels line's entries (``sharded_entries``)."""
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    cfg = replace(get_config(ARCH), num_layers=SHARD_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda")
    want = {kd: model_logits(torch, cfg, params, kd, "on")
            for kd in ("bf16", "int8")}
    kernels = {}
    for m in SHARD_WAYS:
        mesh = card_mesh(m)
        placed = sharding.place_serve(cfg, params, mesh)
        for kd in ("bf16", "int8"):
            sharded_logits(torch, cfg, placed, kd, mesh, want[kd], card)
        if m == SHARD_WAYS[0]:
            bad = model_logits(torch, cfg, wrong_head_slice(placed), "bf16",
                               "on", mesh=mesh)
            worst = max((x - y).abs().max().item()
                        / (y.max() - y.min()).item()
                        for x, y in zip(bad, want["bf16"]))
            print(f"model check {ARCH} control (shard 1 handed shard 0's "
                  f"query heads) [{card}]: worst max|diff| {worst:.4g} of "
                  f"the range (must exceed 0.05)")
            if worst <= 0.05:
                raise AssertionError("the sharded logits check cannot see "
                                     "a shard on the wrong head slice")
        del placed
        for kd in ("bf16", "int8"):
            kernels[m, kd] = per_shard_kernels(torch, cfg, m, gen, card, kd)
        if m == 2:  # K1 and K2 on an f8 pool's slice, 16 over 2 heads
            per_shard_kernels(torch, cfg, m, gen, card, "f8")
    # The greedy trace: meshless and on a 1-way mesh (the same layer loop
    # with and without Sharded parts) before and after the 2- and 4-shard
    # runs, then the 4-shard ones on int8 pools.
    one = card_mesh(1)
    runs = {"no mesh": run_mesh_trace(torch, cfg, params, card),
            "1-way mesh": run_mesh_trace(
                torch, cfg, sharding.place_serve(cfg, params, one), card,
                one)}
    entries = []
    for m in SHARD_WAYS:
        mesh = card_mesh(m)
        placed = sharding.place_serve(cfg, params, mesh)
        runs[f"{m} shards"] = run_mesh_trace(torch, cfg, placed, card, mesh)
        same = sum(a == b for a, b in zip(runs["no mesh"][0],
                                          runs[f"{m} shards"][0])) \
            / len(runs["no mesh"][0])
        print(f"engine {ARCH} {m} shards vs none, greedy [{card}]: {same:.2f}"
              f" of requests token for token equal (printed: bf16 near-ties "
              f"flip)")
        q8 = run_mesh_trace(torch, cfg, placed, card, mesh, kv_dtype="int8")
        for kd, run in (("bf16", runs[f"{m} shards"]), ("int8", q8)):
            entries += sharded_entries(cfg, m, *kernels[m, kd], kd,
                                       "continuation", run[2])
        del placed
    runs["1-way mesh, again"] = run_mesh_trace(
        torch, cfg, sharding.place_serve(cfg, params, one), card, one,
        what=", again")
    runs["no mesh, again"] = run_mesh_trace(torch, cfg, params, card,
                                            what=", again")
    print(f"engine {ARCH} ms per decode step [{card}]: "
          + ", ".join(f"{k} {r[1]:.2f}" for k, r in runs.items()))
    del params
    torch.cuda.empty_cache()
    for arch in (MOE_ARCH, VLM_ARCH):
        entries += run_sharded_family(torch, get_config(arch), gen, card)
    return entries


def run_sharded_family(torch, cfg, gen, card, m=2):
    """A moe or vlm config at full width on an m-shard mesh: K1 and K2 at
    its per-shard heads (``per_shard_kernels``; vlm: the first chunk
    behind its 256-row patch prefix too), the meshless logits (bf16 pool,
    kernels on) first, that model freed, then the shards drawn leaf by
    leaf from the same seed (peak memory near one copy of the weights),
    the sharded logits held to the meshless ones (an MoE replaying the
    meshless run's expert choices, every shard routing alike; the
    free-routing difference printed), and 4 requests of 16 greedy tokens
    (vlm: two behind images).  Returns its kernels-line entries."""
    from repro_torch.models import model as M
    vlm = cfg.family == "vlm"
    cases = ("first", f"first, prefix {VLM_PREFIX}", "continuation") if vlm \
        else ("first", "continuation")
    heads, dec, pre = per_shard_kernels(torch, cfg, m, gen, card, "bf16",
                                        cases, VLM_PREFIX if vlm else 0)
    params = M.init_params(cfg, seed=0, device="cuda")
    picks = []
    with routing(torch, picks, replay=False):
        want = model_logits(torch, cfg, params, "bf16", "on")
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mesh = card_mesh(m)
    t0 = time.perf_counter()
    placed = M.init_params(cfg, seed=0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    print(f"params {cfg.name}, {m} shards [{card}]: {held / 2**30:.2f} GiB "
          f"in {time.perf_counter() - t0:.1f} s; init peak "
          f"{peak / 2**30:.2f} GiB ({peak / held:.3f}x)")
    with routing(torch, [e for e in picks for _ in range(m)], replay=True):
        sharded_logits(torch, cfg, placed, "bf16", mesh, want, card)
    if picks:
        free = model_logits(torch, cfg, placed, "bf16", "on", mesh=mesh)
        compare_logits(torch, f"{cfg.name} bf16 pool, {m} shards vs none, "
                       f"free routing", free, want, 0.05, card,
                       enforce=False)
    reqs = trace(cfg, 4)
    imgs = images(cfg, 4) if vlm else None
    run = run_mesh_trace(torch, cfg, placed, card, mesh, reqs=reqs,
                         images=imgs, max_new=16)
    del placed
    torch.cuda.empty_cache()
    return sharded_entries(cfg, m, heads, dec, pre, "bf16",
                           cases[1] if vlm else "continuation", run[2])


#: The mesh training phase: (data, model) meshes naming the card d x m
#: times, one AdamW step of full-width tinyllama-1.1b on phase 11's
#: batch (bf16 weights, fp32 moments) at each, against the meshless
#: step from the same start.
TRAIN_MESHES = ((2, 1), (1, 2), (2, 2))
#: Limits of a sharded step against the meshless step run with the
#: same batch split (``split_step``: a (d, m) mesh's d row blocks each
#: back-propagated alone, their bf16 gradients added in block order, as
#: the reduce-scatter and ``sum_replicas`` add them): the loss within
#: MESH_LOSS_REL relative, the grad norm within MESH_NORM_REL; each
#: leaf's first moment (the clipped gradient, fp32) within
#: MESH_MOMENT_REL of its norm; each leaf's update (new minus old
#: weights) within MESH_UPDATE_REL of the reference update's norm —
#: AdamW's first step moves an element by about lr * sign(g), so
#: elements whose gradient is at bf16 noise level may move 2 lr apart.
#: Against the unsplit meshless step a data-parallel mesh reads more at
#: the embedding, which ``embedding_check`` reproduces outside the mesh
#: within EMBED_FACTOR.  The control (gradients not summed over the data
#: axis) must exceed the limits.
MESH_LOSS_REL, MESH_NORM_REL = 5e-3, 1e-2
MESH_MOMENT_REL, MESH_UPDATE_REL = 5e-2, 0.3
EMBED_FACTOR = 2.0
#: qwen2-moe-a2.7b's one MoE layer: B x S tokens, the manual path at
#: (2, 2) against the auto path in 2 dispatch groups.
MOE_B, MOE_S = 4, 512
#: The pipeline check: tinyllama-1.1b's 22 blocks as 2 stages of 11, 4
#: microbatches of 2 x 512, against the sequential stack within the
#: model checks' share of the output's range.
PIPE_STAGES, PIPE_MB, PIPE_ROWS, PIPE_S = 2, 4, 2, 512
PIPE_SHARE = 0.05


def rel_norm(torch, a, b):
    """||a - b|| / ||b|| in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@contextlib.contextmanager
def unsummed_over_data():
    """The control: each data shard keeps its own gradient — the
    all_gather's transpose takes the place's own cotangent instead of
    the group's sum, and the replicated leaves' sums are skipped (on a
    (data, 1) mesh every gather and every replica is over data)."""
    from repro_torch.parallel import sharding
    bwd, sums = sharding._Gather.bwd, sharding.sum_replicas

    def own(self, gs):
        out = [None] * len(gs)
        for g in self.grps:
            for i, k in enumerate(g):
                out[k] = gs[k].chunk(len(g), self.dim)[i]
        return out
    sharding._Gather.bwd, sharding.sum_replicas = own, lambda s: s
    try:
        yield
    finally:
        sharding._Gather.bwd, sharding.sum_replicas = bwd, sums


def train_opt():
    from repro_torch.training import optimizer as opt
    return opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                           total_steps=TRAIN_STEPS)


def mesh_step(torch, cfg, params, batch, mesh, timed=True):
    """One AdamW step of ``make_train_step(mesh=)`` (meshless with None)
    from ``params``: (metrics, whole new weights and first moments by
    path, ms of a second step from the same start (CUDA events; None
    unless ``timed``), peak memory of the first, bytes by kind of the
    first)."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding
    from repro_torch.training import optimizer as opt
    step = steps.make_train_step(cfg, train_opt(), mesh=mesh)
    p, b = params, batch
    if mesh is not None:
        p = sharding.place_train(cfg, params, mesh)
        b = sharding.place_batch(cfg, batch, mesh)
        mesh.moved_bytes.clear()
    o = opt.init(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new, o1, m = step(p, o, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    moved = dict(mesh.moved_bytes) if mesh is not None else {}
    whole = {k: sharding.to_whole(v) for k, v in tree_lib.flatten(new)}
    moments = {k: sharding.to_whole(v) for k, v in tree_lib.flatten(o1.m)}
    metrics = {k: float(v) for k, v in m.items()}
    del new, o1
    if not timed:
        return metrics, whole, moments, None, peak, moved
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(p, o, b)
    end.record()
    torch.cuda.synchronize()
    return metrics, whole, moments, start.elapsed_time(end), peak, moved


def split_step(torch, cfg, params, batch, d, keep=()):
    """The meshless step with the batch split as a (d, m) mesh splits
    it: each of the d row blocks' mean loss over d back-propagated alone
    (``loss_fn``, bf16 gradients as the parameters), the blocks'
    gradients added in block order in bf16, then AdamW (``update``).
    With d = 1 it is the meshless step's arithmetic.  -> (metrics, whole
    new weights and first moments by path, the gradient of each leaf in
    ``keep`` a block)."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    paths = [k for k, _ in tree_lib.flatten(params)]
    leaves = [v.detach().requires_grad_(True)
              for v in tree_lib.leaves(params)]
    tree = tree_lib.unflatten(params, leaves)
    grads, loss, kept = None, 0.0, {k: [] for k in keep}
    for i in range(d):
        block = {n: v.chunk(d)[i] for n, v in batch.items()}
        with torch.enable_grad():
            part = M.loss_fn(cfg, tree, block) / d
            g = torch.autograd.grad(part, leaves)
        for k in keep:
            kept[k].append(g[paths.index(k)])
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
        loss += float(part.detach())
    new, o1, m = opt.update(train_opt(), tree_lib.unflatten(params, grads),
                            opt.init(params), params)
    metrics = dict({k: float(v) for k, v in m.items()}, loss=loss)
    return (metrics, dict(tree_lib.flatten(new)),
            dict(tree_lib.flatten(o1.m)), kept)


def leaf_readings(torch, got, want, old):
    """Per leaf: the first moment's and the update's distance from the
    reference's, relative to the reference's norm."""
    (_, gw, gmo), (_, ww, wmo) = got, want
    moment = {k: rel_norm(torch, gmo[k], wmo[k]) for k in wmo}
    update = {k: rel_norm(torch, gw[k].float() - old[k].float(),
                          ww[k].float() - old[k].float()) for k in ww}
    return moment, update


def worst(readings):
    """(path, value) of the largest reading, and the median value."""
    k = max(readings, key=readings.get)
    vals = sorted(readings.values())
    return k, readings[k], vals[len(vals) // 2]


def compare_step(torch, what, got, want, old, card, enforce=True):
    """A step against a reference by the MESH_* limits; prints the
    worst leaf of each reading by path, and the median leaf; returns
    (the limits failed, the per-leaf moment readings).  With
    ``enforce`` False (the control) only reports."""
    (gm, _, _), (wm, _, _) = got, want
    loss = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    norm = abs(gm["grad_norm"] - wm["grad_norm"]) / wm["grad_norm"]
    moments, updates = leaf_readings(torch, got, want, old)
    mk, moment, m_med = worst(moments)
    uk, update, u_med = worst(updates)
    fails = [name for name, v, lim in (
        ("loss", loss, MESH_LOSS_REL), ("grad norm", norm, MESH_NORM_REL),
        ("moments", moment, MESH_MOMENT_REL),
        ("updates", update, MESH_UPDATE_REL)) if not v <= lim]
    print(f"train step {what} [{card}]: loss {gm['loss']:.6f} vs "
          f"{wm['loss']:.6f} (rel {loss:.2e} <= {MESH_LOSS_REL}), grad "
          f"norm {gm['grad_norm']:.5f} vs {wm['grad_norm']:.5f} (rel "
          f"{norm:.2e} <= {MESH_NORM_REL}), worst leaf moment {moment:.2e} "
          f"at {mk} (<= {MESH_MOMENT_REL}; median leaf {m_med:.2e}), worst "
          f"leaf update {update:.3f} at {uk} (<= {MESH_UPDATE_REL}; median "
          f"leaf {u_med:.3f})"
          f"{'; fails ' + ', '.join(fails) if fails else ''}")
    if enforce and fails:
        raise AssertionError(f"train step {what}: {fails}")
    return fails, moments


def embed_cotangent(torch, loss, embed):
    """The cotangent of the rows ``embed`` looked up (B, S, d), caught by
    a pre-hook on the backward node that scatters them into ``embed``'s
    gradient, and that gradient."""
    seen, todo, node = set(), [loss.grad_fn], None
    while todo and node is None:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        for f, _ in n.next_functions:
            if getattr(f, "variable", None) is embed:
                node = n
            todo.append(f)
    got = {}
    handle = node.register_prehook(lambda go: got.update(dh=go[0]))
    (grad,) = torch.autograd.grad(loss, [embed])
    handle.remove()
    return got["dh"], grad


def embedding_check(torch, cfg, params, batch, d, reading, norms, card):
    """Why a data-parallel step reads more than a model-parallel one
    against the unsplit meshless step, at the leaf where it reads most:
    the embedding's gradient is a scatter-add of the looked-up rows'
    cotangents over the batch's Zipf-distributed tokens, and PyTorch's
    ``index_put_`` backward rounds a row to bf16 after each addition, so
    a frequent token's row is a long chain of bf16 additions; split d
    ways, each block's chain is 1/d as long.  On the meshless step's own
    cotangents: the whole batch's bf16 scatter (autograd's gradient,
    bit for bit) against the d blocks' bf16 scatters added in bf16, each
    against an fp32 scatter.  The whole-vs-split distance must reproduce
    ``reading`` (the step's embed moment, (d, 1) vs unsplit) within
    EMBED_FACTOR; ``norms`` (the unsplit and split steps' grad norms)
    against the embedding's share of their difference."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import model as M
    paths = [k for k, _ in tree_lib.flatten(params)]
    leaves = [v.detach().requires_grad_(True)
              for v in tree_lib.leaves(params)]
    embed = leaves[paths.index("embed")]
    with torch.enable_grad():
        loss = M.loss_fn(cfg, tree_lib.unflatten(params, leaves), batch)
        dh, grad = embed_cotangent(torch, loss, embed)
    tok = batch["tokens"].long()

    def scatter(rows, dtype):
        out = torch.zeros(embed.shape, dtype=dtype, device=embed.device)
        return out.index_put_((tok[rows].reshape(-1),), dh[rows].reshape(
            -1, dh.shape[-1]).to(dtype), accumulate=True)

    whole = scatter(slice(None), torch.bfloat16)
    split = None
    for rows in torch.arange(tok.shape[0]).chunk(d):
        block = scatter(rows, torch.bfloat16)
        split = block if split is None else split + block
    exact = scatter(slice(None), torch.float32)
    same = bool(torch.equal(whole, grad))
    r_ws = rel_norm(torch, split, whole)
    r_w, r_s = rel_norm(torch, whole, exact), rel_norm(torch, split, exact)
    d_embed = float(split.float().norm() ** 2 - whole.float().norm() ** 2)
    d_total = norms[1] ** 2 - norms[0] ** 2
    print(f"embedding check {cfg.name} d={d} [{card}]: autograd's embed "
          f"gradient is the bf16 scatter bit for bit: {same}; most frequent "
          f"token {int(torch.bincount(tok.reshape(-1)).max())} of "
          f"{tok.numel()} positions; split vs whole scatter {r_ws:.2e} "
          f"(step reading {reading:.2e}, within {EMBED_FACTOR}x); vs an fp32 "
          f"scatter: whole {r_w:.2e}, split {r_s:.2e}; the embedding's "
          f"|g|^2 moves {d_embed:+.2f} of the grad norm^2's {d_total:+.2f}")
    if not (same and reading / EMBED_FACTOR <= r_ws
            <= reading * EMBED_FACTOR):
        raise AssertionError(f"embedding check: {same}, {r_ws} vs "
                             f"{reading}")


def check_bytes(what, moved, want, card):
    """The bytes a step counted, by kind, against the dry run's count."""
    want = {k: int(round(v)) for k, v in want.items() if v}
    print(f"{what} bytes between places [{card}]: {moved}; dry-run count "
          f"{'equal' if moved == want else want}")
    if moved != want:
        raise AssertionError(f"{what}: counted {moved}, dry run {want}")


def moe_layer(torch, cfg, gen):
    """One MoE layer's random leaves (``moe.param_shapes``): the router
    fp32, the rest bf16, N(0, 1/fan_in)."""
    from repro_torch.models import layers, moe
    return {k: ({n: layers.dense_init(gen, s) for n, s in v.items()}
                if isinstance(v, dict) else layers.dense_init(
                    gen, v, dtype=torch.float32 if k == "router"
                    else torch.bfloat16))
            for k, v in moe.param_shapes(cfg).items()}


def check_moe_manual(torch, gen, card):
    """qwen2-moe-a2.7b's MoE layer at full width (60 experts top-4 plus
    the shared expert, d 2048): ``apply_moe_manual`` on a (2, 2) mesh
    against the auto path in 2 dispatch groups by the reference's
    criterion (99% of tokens within 2% of the output's scale, aux within
    0.05), and its bytes against the dry run's count."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M, moe
    from repro_torch.parallel import sharding
    cfg = get_config(MOE_ARCH)
    p = moe_layer(torch, cfg, gen)
    x = (torch.randn(MOE_B, MOE_S, cfg.d_model, device="cuda",
                     generator=gen) * 0.5).bfloat16()
    mesh = card_mesh(2, d=2)
    with torch.no_grad():
        with sharding.use_axes(sharding.AxisState(
                (("data", 2), ("model", 1)))):
            ref, aux_ref = moe.apply_moe(cfg, p, x)
        experts = ("w_gate", "w_up", "w_down")
        placed = M._tree_map(lambda v: v[0], sharding.place_train(
            cfg, {"blocks": {"moe": M._tree_map(lambda v: v[None], p)}},
            mesh)["blocks"]["moe"])
        placed = M.gather_data(placed, keep=lambda path: path[-1] in experts
                               and "shared" not in path)
        xs = sharding.place_batch(cfg, {"x": x}, mesh)["x"]
        if not moe.expert_parallel(cfg, mesh, xs):
            raise AssertionError("the manual MoE path does not apply")
        mesh.moved_bytes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = moe.apply_moe(cfg, placed, xs, mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    got = torch.cat([out.parts[g[0]] for g in sharding.groups(mesh, "model")])
    tok = ((got.float() - ref.float()).abs().amax(-1)
           / (ref.float().abs().max() + 1e-9))
    frac = float((tok < 0.02).float().mean())
    aux_err = max(abs(float(a) - float(aux_ref)) for a in aux.parts)
    print(f"moe manual {cfg.name} (2, 2) vs auto G=2 [{card}]: "
          f"{frac:.4%} of tokens within 2% of scale (>= 99%), aux "
          f"{float(aux.parts[0]):.5f} vs {float(aux_ref):.5f} (|d| "
          f"{aux_err:.2e} < 0.05), {ms:.1f} ms host wall")
    if frac < 0.99 or not aux_err < 0.05:
        raise AssertionError(f"moe manual: {frac}, aux {aux_err}")
    check_bytes(f"moe manual {cfg.name} (2, 2)", dict(mesh.moved_bytes),
                dryrun.moe_layer_collectives(cfg, MOE_B, MOE_S, mesh),
                card)


def check_pipeline(torch, cfg, params, card):
    """tinyllama-1.1b's blocks as PIPE_STAGES stages through
    ``pipeline_apply`` against the sequential stack, no grad; the
    activations' ppermute bytes against ticks x stages x one
    microbatch."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel.pipeline import (pipeline_apply,
                                               split_microbatches)
    L = cfg.num_layers // PIPE_STAGES
    staged = M._tree_map(lambda v: v.reshape((PIPE_STAGES, L)
                                             + tuple(v.shape[1:])),
                         params["blocks"])
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MB * PIPE_ROWS, PIPE_S),
                         device="cuda", generator=g)
    pos = torch.arange(PIPE_S, device="cuda")

    def run(blocks, x):
        return M.backbone(cfg, {"blocks": blocks}, x, pos)[0]

    mesh = make_mesh((PIPE_STAGES,), ("stage",), "cuda")
    with torch.no_grad():
        h = params["embed"][toks]
        ref = run(params["blocks"], h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_apply(run, staged, split_microbatches(h, PIPE_MB),
                             mesh).reshape(h.shape)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    share = float((out.float() - ref.float()).abs().max()
                  / (ref.float().max() - ref.float().min()))
    ticks = PIPE_MB + PIPE_STAGES - 1
    act = PIPE_ROWS * PIPE_S * cfg.d_model * 2
    want = ticks * PIPE_STAGES * act
    print(f"pipeline {cfg.name} {PIPE_STAGES} stages x {L} blocks, "
          f"{PIPE_MB} microbatches of {PIPE_ROWS} x {PIPE_S} [{card}]: "
          f"max|out - seq| {share:.3%} of the range (<= {PIPE_SHARE:.0%}); "
          f"ppermute {mesh.moved_bytes.get('ppermute')} bytes = {ticks} "
          f"ticks x {PIPE_STAGES} stages x {act} ({ticks * act} a stage); "
          f"{ms:.1f} ms host wall")
    if not share <= PIPE_SHARE:
        raise AssertionError(f"pipeline: {share}")
    if mesh.moved_bytes.get("ppermute") != want:
        raise AssertionError(f"pipeline bytes {mesh.moved_bytes}")


def run_mesh_training(torch, gen, card):
    """The mesh training phase: full-width tinyllama-1.1b, one AdamW step
    meshless and at each TRAIN_MESHES mesh on the one card (loss, grad
    norm, every leaf's moment and update against the meshless step with
    the same batch split; bytes by kind equal to the dry run's count; ms
    a step and peak memory), the embedding check, the unsummed-gradients
    control at (2, 1); qwen2-moe-a2.7b's manual MoE layer; the pipeline
    schedule."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    params = M.init_params(cfg, seed=0, device="cuda")
    batch = train_batch(torch, cfg, TRAIN_B, TRAIN_S)
    old = dict(tree_lib.flatten(params))
    zero_launches()
    base = mesh_step(torch, cfg, params, batch, None)
    again = split_step(torch, cfg, params, batch, 1)
    compare_step(torch, f"{cfg.name} meshless, read twice (split_step d=1 "
                 f"vs make_train_step)", again[:3], base[:3], old, card)
    del again
    rows = [("meshless", base[3], base[4])]
    split, unsplit = {1: base[:3]}, {}
    for shape in TRAIN_MESHES:
        d = shape[0]
        if d not in split:
            split[d] = split_step(torch, cfg, params, batch, d)[:3]
        mesh = card_mesh(shape[1], d=d)
        got = mesh_step(torch, cfg, params, batch, mesh)
        compare_step(torch, f"{cfg.name} {shape} vs meshless"
                     + (f" split {d} ways" if d > 1 else ""), got[:3],
                     split[d], old, card)
        if d > 1:
            _, moments = compare_step(
                torch, f"{cfg.name} {shape} vs meshless unsplit (not "
                f"gated: see the embedding check)", got[:3], base[:3], old,
                card, enforce=False)
            unsplit.setdefault(d, moments["embed"])
        check_bytes(f"train step {cfg.name} {shape}", got[5],
                    dryrun.train_collectives(cfg, TRAIN_B, TRAIN_S, mesh,
                                             params), card)
        rows.append((str(shape), got[3], got[4]))
        del got
        torch.cuda.empty_cache()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the grad path: "
                             f"{launches}")
    embedding_check(torch, cfg, params, batch, 2, unsplit[2],
                    (base[0]["grad_norm"], split[2][0]["grad_norm"]), card)
    with unsummed_over_data():
        ctrl = mesh_step(torch, cfg, params, batch, card_mesh(1, d=2))
    if not compare_step(torch, f"{cfg.name} (2, 1) control (gradients not "
                        f"summed over data) vs meshless split 2 ways",
                        ctrl[:3], split[2], old, card, enforce=False)[0]:
        raise AssertionError("the unsummed-gradients control passed")
    del ctrl, split
    print(f"train step {cfg.name} B={TRAIN_B} S={TRAIN_S} by mesh [{card}]: "
          + "; ".join(f"{n} {ms:.1f} ms/step, peak {pk / 2**30:.2f} GiB"
                      for n, ms, pk in rows)
          + " (one card holds every place: no speedup is expected)")
    del base
    torch.cuda.empty_cache()
    check_pipeline(torch, cfg, params, card)
    del params
    torch.cuda.empty_cache()
    check_moe_manual(torch, gen, card)
    print(f"mesh training phase [{card}]: {time.perf_counter() - t0:.1f} s")


#: Phase 14: waves over a model axis.  (config, shard counts), every width
#: full, on WAVE_DEPTH's layers: zamba2-7b 13 of its 81 (two groups of
#: six and a tail of one); tinyllama-1.1b 11 of 22, qwen2-moe-a2.7b 12 of
#: 24 and mamba2-1.3b 24 of 48, to hold the whole script's time.
WAVE_SHARDS = (("tinyllama-1.1b", (2, 4)), ("qwen2-moe-a2.7b", (2,)),
               ("mamba2-1.3b", (2, 4)), ("zamba2-7b", (2,)),
               ("whisper-base", (2,)))
WAVE_DEPTH = {"zamba2-7b": 13, "tinyllama-1.1b": 11, "qwen2-moe-a2.7b": 12,
              "mamba2-1.3b": 24}
#: Sharded vs meshless logits, a share of the meshless logits' range: the
#: attention families on their bf16 weights (phase 12's limit), the
#: recurrent ones on the weights cast to fp32 (phase 10's: random bf16
#: Mamba-2 stacks are chaotic).
WAVE_SHARE = {"dense": 0.05, "moe": 0.05, **RECURRENT_FP32_SHARE}
#: The phase's prompt lengths: the model checks' (whisper: a
#: transcript's opening), the K4 checks', the engine's 4 requests.
WAVE_S = {"audio": 4}
WAVE_SSD_LENS = (64, 512)
WAVE_REQ_LENS = {"audio": (4, 4, 16, 16)}


def wave_cfg(arch):
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if arch in WAVE_DEPTH:
        cfg = replace(cfg, num_layers=WAVE_DEPTH[arch])
    return cfg


def wave_steps(torch, cfg, params, mesh=None, control=False, axes=None):
    """A wave's prefill (4 rows of WAVE_S tokens, 64 by default; whisper
    behind zero frames) and two decode steps, kernels on, over ``mesh``
    (``params`` placed there).  ``control``: after the prefill place 1's
    parts of every stripe and Mamba-2 state take place 0's (model shard
    1 reads shard 0's heads); ``control="data"`` the first place of data
    index 1 takes them (data place 1 reads place 0's rows).  The mesh's
    byte counters are cleared before the last decode step.  ``axes``: the
    axis state to run under (default: the mesh's).  Returns (logits,
    prefill launches, decode launches)."""
    from dataclasses import replace
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    dev = "cuda"
    rng = torch.Generator(device=dev).manual_seed(3)
    nb, S = 4, WAVE_S.get(cfg.family, 64)
    toks = torch.randint(1, cfg.vocab_size, (nb, S + 2), generator=rng,
                         device=dev)
    batch = {"tokens": toks[:, :S]}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(nb, cfg.encdec.encoder_seq_len,
                                      cfg.d_model, dtype=torch.bfloat16,
                                      device=dev)
    c = replace(cfg, attn_kernel="on")
    wrappers = launch_counts()
    counts = []
    for w in wrappers.values():
        w.launches = 0
    with sharding.use_axes(mesh if axes is None else axes):
        first, cache = M.prefill(c, params, batch, S + 8, mesh=mesh)
        torch.cuda.synchronize()
        counts.append({k: w.launches for k, w in wrappers.items()})
        for w in wrappers.values():
            w.launches = 0
        if control:
            from repro_torch.models import kv_quant
            to = 1 if control is True else mesh.shape["model"]
            for path, x in M.tree_lib.flatten(cache):
                if path.rsplit("/", 1)[-1] in ("k", "v", "attn_k", "attn_v",
                                               "cross_k", "cross_v",
                                               "state"):
                    kv_quant.raw(x.parts[to]).copy_(
                        kv_quant.raw(x.parts[0]))
        out = [first.float()]
        for i in range(2):
            if mesh is not None and i == 1:
                mesh.moved_bytes.clear()
            d, cache = M.decode_step(c, params, cache,
                                     toks[:, S + i:S + i + 1], S + i,
                                     mesh=mesh)
            out.append(d[:, 0].float())
    torch.cuda.synchronize()
    counts.append({k: w.launches for k, w in wrappers.items()})
    return out, counts[0], counts[1]


def wave_decode_bytes(cfg, nb, m, item):
    """The collectives of one wave decode step of nb rows at m shards in
    ``item``-byte activations (the weights' dtype): the embedding (a psum
    of the masked lookups; an all_gather of the d_model columns where the
    vocab does not divide); per attention layer a psum of ``wo``'s
    partials where the heads are cut and of the MLP's (an MoE's routed
    experts', its shared expert's; whisper's cross-attention's) where
    their hidden dim is; per Mamba-2 block, where its heads are cut, the
    gated norm's fp32 sum of squares and ``out_proj``'s psum; the logits
    (an all_gather of the vocab columns; a psum of d_model partials where
    the vocab does not divide); the broadcast tokens (int64) and
    positions (int32).  A psum moves 2 (m - 1) times its bytes, an
    all_gather and a broadcast m - 1."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    mesh = card_mesh(m)
    heads = sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1
    act = nb * cfg.d_model * item
    logits = nb * cfg.vocab_size * item
    if cfg.family in ("ssm", "hybrid"):
        attn = M.hybrid_layout(cfg)[0] if cfg.hybrid else 0
        mamba = cfg.num_layers \
            if sharding.mamba_shard_size(mesh, cfg) > 1 else 0
    else:
        attn, mamba = cfg.num_layers, 0
    per = heads + (cfg.d_ff % m == 0)
    if cfg.family == "audio":
        per += heads
    if cfg.moe is not None and cfg.moe.shared_d_ff:
        per += cfg.moe.shared_d_ff % m == 0
    psum = act * (per * attn + mamba) + nb * 4 * mamba
    gather = 0
    if cfg.vocab_size % m:
        gather += act
        psum += logits
    else:
        psum += act
        gather += logits
    return {"psum": 2 * (m - 1) * psum, "all_gather": (m - 1) * gather,
            "broadcast": (m - 1) * (nb * 8 + nb * 4)}


def dense_shard_vs_solo(torch, cfg, mesh, gen, kv_dtype="bf16"):
    """K3 through the sharded dispatch (stripes placed once on the mesh,
    one launch a shard on its head slice) against one launch on every
    head, after the same new row is stored into both (``kv_quant.put``;
    f8 as bytes): the outputs within TOL, the written stripes bit for
    bit.  Returns whether the outputs are bit for bit."""
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.models import kv_quant
    from repro_torch.parallel import sharding
    dev, H, Hk, D = "cuda", cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sd = torch.float8_e4m3fn if kv_dtype == "f8" else torch.bfloat16
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randn(B, MAX_LEN, Hk, D, generator=gen,
                          device=dev).bfloat16().to(sd) for _ in range(2))
    new = [torch.randn(B, Hk, D, generator=gen, device=dev).bfloat16()
           for _ in range(2)]
    lens = torch.tensor([1, 17, 600, 1024, 700, 333, 64, 5],
                        dtype=torch.int32, device=dev)
    rows = (torch.arange(B, device=dev), (lens - 1).long())
    cut = sharding.attn_shard_size(mesh, Hk) > 1
    spec = sharding.P(None, None, "model" if cut else None, None)
    placed = [sharding.shard(x.clone(), spec, mesh) for x in (kc, vc)]
    for cache, pc, x in zip((kc, vc), placed, new):
        kv_quant.put(cache, rows, x)
        kv_quant.put(pc, rows, sharding.shard(x, spec[1:], mesh))
    solo = decode_ops.decode_attention(q, kc, vc, lens, kernel="on")
    shard = decode_ops.decode_attention(q, *placed, lens, kernel="on",
                                        mesh=mesh)
    torch.cuda.synchronize()
    m = len(mesh.axis_devices())
    what = (f"sharded dense dispatch vs one launch, {cfg.name}, {m} shards, "
            f"{kv_dtype} stripes")
    assert_close(torch, what, shard, solo)
    for whole, pc in zip((kc, vc), placed):
        if not same_bits(torch, sharding.gather(pc), whole):
            raise AssertionError(f"{what}: the written stripes differ")
    return same_bits(torch, shard, solo)


def ssd_shard_vs_solo(torch, cfg, m, gen, S):
    """K4 through ``ssm.ssd_via_kernel`` once a shard on its heads (b x
    H/m folded rows) against one launch on every head, fp32 as served:
    y within SSD_TOL, the states bit for bit.  Returns whether y is bit
    for bit."""
    from repro_torch.models import ssm
    dev, s = "cuda", cfg.ssm
    H, P, N = s.nheads(cfg.d_model), s.head_dim, s.state_size
    x = torch.randn(SSD_ROWS, S, H, P, generator=gen, device=dev) * 0.5
    dt = torch.rand(SSD_ROWS, S, H, generator=gen, device=dev) * 0.1
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    b, c = (torch.randn(SSD_ROWS, S, 1, N, generator=gen, device=dev)
            for _ in range(2))
    y, st = ssm.ssd_via_kernel(x, dt, A, b, c, s.chunk_size)
    parts = [ssm.ssd_via_kernel(x[:, :, h].contiguous(), dt[:, :, h], A[h],
                                b, c, s.chunk_size)
             for h in torch.arange(H, device=dev).chunk(m)]
    torch.cuda.synchronize()
    ys, sts = (torch.cat(t, dim) for t, dim in zip(zip(*parts), (2, 1)))
    what = f"sharded ssd_via_kernel vs one launch, {cfg.name}, {m} shards, {S}"
    assert_close(torch, what, ys, y, SSD_TOL, SSD_TOL)
    if not same_bits(torch, sts, st):
        raise AssertionError(f"{what}: the states differ")
    return same_bits(torch, ys, y)


def wave_kernels(torch, cfg, m, gen, card):
    """K3 and K4 at the per-shard shapes phase 15 launches at m shards:
    K3 (bf16 and f8 stripes) as phase 3 checks it, K4 (fp32, WAVE_SSD_LENS
    positions) as phase 10 does, and each sharded dispatch against one
    launch on every head.  Returns {name: result}."""
    from repro_torch.parallel import sharding
    mesh = card_mesh(m)
    out = {}
    attn, ssm = recurrent_layers(cfg)
    if attn:
        a = sharding.attn_shard_size(mesh, cfg.num_kv_heads)
        heads = (cfg.num_heads // a, cfg.num_kv_heads // a, cfg.head_dim)
        for kd in ("bf16", "f8"):
            r = check_dense_decode(torch, heads, gen, kv_dtype=kd)
            r["bitwise"] = dense_shard_vs_solo(torch, cfg, mesh, gen, kd)
            out[f"flash_decode[{cfg.name}, {m} shards, heads {heads}, "
                f"{kd}]"] = r
    if ssm:
        res = check_ssd_model(torch, cfg, gen, card, ways=m,
                              lens=WAVE_SSD_LENS)
        H = cfg.ssm.nheads(cfg.d_model) // m
        for S, r in res.items():
            r["bitwise"] = ssd_shard_vs_solo(torch, cfg, m, gen, S)
            out[f"ssd_scan[{cfg.name}, {m} shards, {SSD_ROWS} x {H} rows, "
                f"{S}]"] = r
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
              f"sharded dispatch bit for bit one launch: {r['bitwise']}")
    return out


def wave_engine(torch, cfg, params, card, mesh=None):
    """4 requests of 8 greedy tokens in waves (WAVE_REQ_LENS; two waves
    of two), over ``mesh`` or none: every request ends; K3 launched m x
    attention layers a decode step but each wave's last, K4 m x Mamba-2
    blocks a wave, K1 and K2 never.  Returns (outputs, ms per decode
    step, prefill tok/s, launches)."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    m = 1 if mesh is None else mesh.devices.size
    rng = np.random.default_rng(5)
    reqs = [rng.integers(1, cfg.vocab_size, size=n)
            for n in WAVE_REQ_LENS.get(cfg.family, (64, 64, 512, 512))]
    eng = ServingEngine(cfg, params, max_batch=B, max_len=MAX_LEN,
                        eos_id=-1, attn_kernel="auto", seed=0,
                        device="cuda", mesh=mesh, mode="wave")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    uids = [eng.submit(p, max_new_tokens=8) for p in reqs]
    out = eng.run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    s = eng.stats
    where = "no mesh" if mesh is None else mesh_name(mesh)
    name = f"engine {cfg.name} (wave, {cfg.kv_dtype} stripes, {where}, " \
        f"greedy)"
    for u in uids:
        if len(out[u]) != 8:
            raise AssertionError(f"{name}: request {u} returned {out[u]}")
    waves = len(set(len(p) for p in reqs))
    attn, ssm = recurrent_layers(cfg)
    want = {"flash_decode": m * attn * (s.decode_steps - waves),
            "paged_flash_decode": 0, "paged_flash_prefill": 0,
            "ssd_scan": m * ssm * waves}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    ms = s.decode_s / s.decode_steps * 1e3
    print(f"{name} [{card}]: {len(uids)} requests, {ms:.2f} ms per decode "
          f"step ({s.decode_steps} steps), prefill "
          f"{s.prefill_tokens_per_s:.1f} tok/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    return [out[u] for u in uids], ms, s.prefill_tokens_per_s, launches


def wave_logits_check(torch, cfg, placed, mesh, want, card):
    """wave_steps over ``mesh`` held to the meshless ``want`` within
    WAVE_SHARE: K4 m x Mamba-2 blocks in the prefill, K3 m x attention
    layers a decode step, K1 and K2 never, the last decode step's bytes
    between shards exactly ``wave_decode_bytes``.  Returns the worst
    share."""
    m = len(mesh.axis_devices())
    attn, ssm = recurrent_layers(cfg)
    share = WAVE_SHARE[cfg.family]
    got, pre, dec = wave_steps(torch, cfg, placed, mesh)
    name = f"{cfg.name} wave, {m} shards vs none"
    zero = {"paged_flash_decode": 0, "paged_flash_prefill": 0}
    if pre != {**zero, "flash_decode": 0, "ssd_scan": m * ssm} or \
            dec != {**zero, "flash_decode": 2 * m * attn, "ssd_scan": 0}:
        raise AssertionError(f"{name}: launches prefill {pre}, decode {dec}")
    moved = dict(mesh.moved_bytes)
    item = 4 if placed["embed"].dtype == torch.float32 else 2
    want_bytes = wave_decode_bytes(cfg, 4, m, item)
    print(f"sharded wave decode step {name} [{card}]: bytes between shards "
          f"{moved} (count {want_bytes})")
    if moved != want_bytes:
        raise AssertionError(f"{name}: the decode step moved {moved}, want "
                             f"{want_bytes}")
    return compare_logits(torch, name, got, want, share, card,
                          names=("prefill", "decode 1", "decode 2"))


def mesh_cuts_caches(cfg, mesh):
    """Whether the wave caches' heads are cut over ``mesh`` (else every
    shard holds them whole and there is no other shard's slice to
    read)."""
    from repro_torch.parallel import sharding
    return sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1 \
        or sharding.mamba_shard_size(mesh, cfg) > 1


def control_fails(torch, cfg, placed, mesh, want, card):
    """wave_steps with shard 1 reading shard 0's stripes and states must
    leave wave_logits_check's limit."""
    ssm = recurrent_layers(cfg)[1]
    share = WAVE_SHARE[cfg.family]
    name = f"{cfg.name} wave, {len(mesh.axis_devices())} shards vs none"
    bad = wave_steps(torch, cfg, placed, mesh, control=True)[0]
    ctl = max((x - y).abs().max().item() / (y.max() - y.min()).item()
              for x, y in zip(bad, want))
    print(f"model check {name} control (shard 1 reading shard 0's "
          f"{'state' if ssm else 'heads'}) [{card}]: worst max|diff| "
          f"{ctl:.4g} of the range (must exceed {share})")
    if ctl <= share:
        raise AssertionError(f"{name}: the check cannot see a shard reading "
                             f"another's slice")


def run_wave_sharded(torch, arch, ways, gen, card):
    """Phase 14 for one config at full width (``wave_cfg``), freed
    afterwards: ``wave_kernels`` at each shard count; the meshless
    greedy engine run, then the meshless ``wave_steps`` (the attention
    families on the bf16 weights, recording an MoE's expert choices; the
    recurrent ones on the weights cast to fp32); at each shard count the
    weights placed, ``wave_logits_check`` (an MoE replaying the meshless
    choices, every shard routing alike), ``control_fails`` where the
    caches are cut, and the engine on bf16 and f8
    stripes (not for ssm: no stripes).  Returns
    (kernel results by shard count, {(m, kv_dtype): launches})."""
    from dataclasses import replace
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    cfg = wave_cfg(arch)
    kernels = {}
    for m in ways:
        kernels[m] = wave_kernels(torch, cfg, m, gen, card)
    recurrent = cfg.family in ("ssm", "hybrid", "audio")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"params {cfg.name}, {cfg.num_layers} layers [{card}]: "
          f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB, init "
          f"peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} "
          f"GiB")
    c8 = replace(cfg, kv_dtype="f8")
    stripes = ("bf16",) if cfg.family == "ssm" else ("bf16", "f8")
    runs = {(1, kd): wave_engine(torch, c8 if kd == "f8" else cfg, params,
                                 card) for kd in stripes}
    if recurrent:
        params32 = as_fp32(params)
        want = wave_steps(torch, cfg, params32, None)[0]
    else:
        picks = []
        with routing(torch, picks, replay=False):
            want = wave_steps(torch, cfg, params, None)[0]
        del params  # the shards are drawn leaf by leaf below
        torch.cuda.empty_cache()
    worst = {}
    for m in ways:
        mesh = card_mesh(m)
        if recurrent:
            placed = sharding.place_serve(cfg, params32, mesh)
            worst[m] = wave_logits_check(torch, cfg, placed, mesh, want,
                                         card)
        else:
            placed = M.init_params(cfg, seed=0, device="cuda", mesh=mesh)
            with routing(torch, [e for e in picks for _ in range(m)],
                         replay=True):
                worst[m] = wave_logits_check(torch, cfg, placed, mesh,
                                             want, card)
        if mesh_cuts_caches(cfg, mesh):
            control_fails(torch, cfg, placed, mesh, want, card)
        if recurrent:
            del placed
            placed = sharding.place_serve(cfg, params, mesh)
        for kd in stripes:
            runs[m, kd] = wave_engine(torch, c8 if kd == "f8" else cfg,
                                      placed, card, mesh)
        del placed
        torch.cuda.empty_cache()
    for (m, kd), run in runs.items():
        if m > 1:
            same = sum(a == b for a, b in zip(runs[1, kd][0], run[0])) \
                / len(run[0])
            print(f"engine {cfg.name} wave {kd}, {m} shards vs none, greedy "
                  f"[{card}]: {same:.2f} of requests token for token equal "
                  f"(printed: near-ties flip)")
    print(f"engine {cfg.name} wave ms per decode step / prefill tok/s "
          f"[{card}]: " + ", ".join(
              f"{m} shard{'s' * (m > 1)} {kd} {r[1]:.2f} / {r[2]:.1f}"
              for (m, kd), r in runs.items()))
    print(f"model check {cfg.name} wave sharded logits [{card}]: worst "
          f"share of the range " + ", ".join(f"{m} shards {w:.4g}"
                                             for m, w in worst.items()))
    if recurrent:
        del params, params32
    torch.cuda.empty_cache()
    return kernels, {k: r[3] for k, r in runs.items()}


def wave_entries(results):
    """The kernels line's phase 14 entries: one per per-shard shape
    (K3 on bf16 and f8 stripes, K4 at 512 positions, the worst error
    over both lengths), its launches from that shard count's engine
    run."""
    dense = ("src/repro_torch/csrc/dense_decode.cu",
             "src/repro/kernels/flash_decode/flash_decode.py:78")
    ssd = ("src/repro_torch/csrc/ssd_scan.cu",
           "src/repro/kernels/ssd_scan/ssd_scan.py:66")
    out = []
    for arch, (kernels, launches) in results.items():
        for m, res in kernels.items():
            ssd_err = max((r["err"] for n, r in res.items()
                           if n.startswith("ssd_scan")), default=0.0)
            for name, r in res.items():
                if name.startswith("flash_decode"):
                    kd = "f8" if name.endswith("f8]") else "bf16"
                    out.append(kernel_entry(
                        name, *dense, launches[m, kd]["flash_decode"], r))
                elif name.endswith(f", {max(WAVE_SSD_LENS)}]"):
                    out.append(kernel_entry(
                        name, *ssd, launches[m, "bf16"]["ssd_scan"], r,
                        err=ssd_err))
    return out


#: Phase 15: the recurrent families' training over a (data, model) mesh
#: naming the card d x m times.  (config, layers kept (None: all), rows,
#: positions, meshes): each config at full width, zamba2-7b at
#: WAVE_DEPTH's 13 of its 81 layers (two groups of six and a tail of
#: one; its fp32 copy, moments and results must fit beside each other);
#: whisper-base behind 1500 stub frames, its 51865-token vocab cut on
#: d_model over data (it does not divide model).  The meshes of one data
#: size run together, so that one split_step reference is held at a time.
RECURRENT_TRAIN = (
    ("mamba2-1.3b", None, 4, 512, ((1, 2), (1, 4), (2, 2))),
    ("zamba2-7b", WAVE_DEPTH["zamba2-7b"], 2, 512, ((1, 2), (2, 2))),
    ("whisper-base", None, 4, 256, ((1, 2), (2, 2))))
#: The gated-norm control's lever (as the wave tests' control): model shard
#: 1 of 2's z and x columns scaled by this in every Mamba-2 block, so
#: that a per-shard mean of the gated norm reads far from the whole
#: d_inner's.  The sound steps run on the same weights.
HEAD_SCALE = 8.0


def scale_second_heads(torch, cfg, params):
    """``params`` with every Mamba-2 block's z and x columns of its
    second half of heads multiplied by HEAD_SCALE."""
    d_inner = cfg.ssm.d_inner(cfg.d_model)
    w = params["blocks"]["mamba"]["in_proj"]
    scale = torch.ones(w.shape[-1], dtype=w.dtype, device=w.device)
    for lo in (d_inner // 2, d_inner + d_inner // 2):
        scale[lo:lo + d_inner // 2] = HEAD_SCALE
    mamba = dict(params["blocks"]["mamba"], in_proj=w * scale)
    return dict(params, blocks=dict(params["blocks"], mamba=mamba))


@contextlib.contextmanager
def per_shard_norm_mean():
    """The first control: the gated norm's sum of squares over each
    shard's own columns, times the shard count (its psum skipped)."""
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding
    whole = ssm._sum_squares

    def own(g, mesh):
        m = sharding.axes_size(mesh, sharding.TP_AXIS)
        return sharding.smap(lambda t: t.square().sum(-1, keepdim=True) * m,
                             g, mesh=mesh)
    ssm._sum_squares = own
    try:
        yield
    finally:
        ssm._sum_squares = whole


@contextlib.contextmanager
def unsummed_components():
    """The second control: the B and C columns' gradient partials (every
    model shard holds them whole) not summed over ``model``."""
    from repro_torch.parallel import sharding
    summed = sharding.sum_components
    sharding.sum_components = lambda s: s
    try:
        yield
    finally:
        sharding.sum_components = summed


def stub_frames(torch, cfg, B):
    """whisper's stub encoder input: B x 1500 seeded random frames."""
    g = torch.Generator(device="cuda").manual_seed(1)
    return torch.randn(B, cfg.encdec.encoder_seq_len, cfg.d_model,
                       device="cuda", generator=g)


def controls(torch, cfg, params, batch, want, old, card):
    """Phase 15's two controls at (1, 2) against the meshless step
    ``want``: each must fail compare_step's limits."""
    for what, control in (("gated-norm mean per shard", per_shard_norm_mean),
                          ("B/C gradients unsummed over model",
                           unsummed_components)):
        torch.cuda.empty_cache()
        with control():
            ctrl = mesh_step(torch, cfg, params, batch, card_mesh(2),
                             timed=False)
        if not compare_step(torch, f"{cfg.name} (1, 2) control ({what}) vs "
                            f"meshless", ctrl[:3], want, old, card,
                            enforce=False)[0]:
            raise AssertionError(f"the control ({what}) passed")


def run_recurrent_mesh_training(torch, card):
    """Phase 15: for each RECURRENT_TRAIN config, the seeded weights cast
    to fp32 (random bf16 Mamba-2 stacks are chaotic), one AdamW step at
    each mesh against the meshless step with the same batch split
    (``split_step``; ``compare_step``'s limits), its bytes by kind equal
    to ``dryrun.train_collectives``, no kernel launch; mamba2-1.3b's
    second half of heads scaled (HEAD_SCALE) for the two controls at (1,
    2), each of which must fail the limits; ms a step and peak memory by
    mesh."""
    from dataclasses import replace
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    for arch, depth, B, S, meshes in RECURRENT_TRAIN:
        cfg = get_config(arch)
        if depth is not None:
            cfg = replace(cfg, num_layers=depth)
        torch.cuda.empty_cache()
        params = as_fp32(M.init_params(cfg, seed=0, device="cuda"))
        if cfg.family == "ssm":
            params = scale_second_heads(torch, cfg, params)
        batch = train_batch(torch, cfg, B, S)
        if cfg.family == "audio":
            batch["frames"] = stub_frames(torch, cfg, B)
        old = dict(tree_lib.flatten(params))
        rows, split = [], {}
        zero_launches()
        for shape in meshes:
            d, m = shape
            if d not in split:
                split.clear()
                torch.cuda.empty_cache()
                split[d] = split_step(torch, cfg, params, batch, d)[:3]
            mesh = card_mesh(m, d=d)
            got = mesh_step(torch, cfg, params, batch, mesh)
            compare_step(torch, f"{cfg.name} fp32 {shape} vs meshless split "
                         f"{d} way{'s' * (d > 1)}", got[:3], split[d], old,
                         card)
            check_bytes(f"train step {cfg.name} {shape}", got[5],
                        dryrun.train_collectives(cfg, B, S, mesh, params),
                        card)
            rows.append((shape, got[3], got[4]))
            del got
            if cfg.family == "ssm" and shape == (1, 2):
                controls(torch, cfg, params, batch, split[1], old, card)
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"{cfg.name}: a kernel launched on the "
                                 f"grad path: {launches}")
        print(f"train step {cfg.name} fp32 {cfg.num_layers} layers B={B} "
              f"S={S} by mesh [{card}]: " + "; ".join(
                  f"{shape} {ms:.1f} ms/step, peak {pk / 2**30:.2f} GiB"
                  for shape, ms, pk in rows)
              + " (one card holds every place: no speedup is expected)")
        del params, old, split, batch
        torch.cuda.empty_cache()
    print(f"recurrent mesh training phase [{card}]: "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 16: serving over a (data, model) mesh with data axes above 1
# ---------------------------------------------------------------------------

#: The paged meshes (data, model), each naming the card d x m times.
DATA_MESHES = ((2, 1), (2, 2))
#: The model checks' pools, and the 12-request trace's.
DATA_POOLS = ("bf16", "int8", "f8")
DATA_TRACE_POOLS = ("bf16", "int8")
#: internvl2-26b at (2, 1) on 12 of its 48 layers (every width full).
DATA_VLM_DEPTH = 12
#: The paged part's tinyllama-1.1b on 11 of its 22 layers (from PR 29:
#: the whole script's time, phase 17 added).
DATA_DEPTH = 11
#: Waves over a (data, model) mesh: (config, (data, model)); the
#: recurrent ones on the weights cast to fp32, as in phase 14.
DATA_WAVES = (("tinyllama-1.1b", (2, 2)), ("mamba2-1.3b", (2, 2)),
              ("whisper-base", (2, 1)))
#: One data place's lanes of the kernel checks' 8 at d = 2 (place 1's
#: four: a dead lane among them), and of a 4-row wave (two).
PLACE_LANES, PLACE_WAVE_ROWS = slice(4, 8), slice(2, 4)


def split_vs_one(torch, heads, gen):
    """K1, K2 (a continuation) and K3 launched once per data place on its
    lanes (the 8 lanes cut 4 / 4) against one launch on all 8: each
    place's output within TOL of the matching rows, and the written pool
    bit for bit.  Returns {kernel: whether the outputs are bit for bit}
    (printed)."""
    from repro_torch.kernels.flash_decode.flash_decode import (
        flash_decode, paged_flash_decode)
    from repro_torch.kernels.flash_prefill.flash_prefill import \
        paged_flash_prefill
    dev, (H, Hk, D) = "cuda", heads
    N = B * T + 1
    halves = (slice(0, B // 2), slice(B // 2, B))
    kp, _ = make_pool(torch, gen, N, Hk, D, "bf16")
    vp, _ = make_pool(torch, gen, N, Hk, D, "bf16")
    tbl = (1 + torch.randperm(N - 1, generator=gen, device=dev)[:B * T]) \
        .reshape(B, T).int()
    lens = torch.tensor([1, 17, 600, 1024, 700, 333, 64, 5],
                        dtype=torch.int32, device=dev)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    same = {}

    def compare(name, whole, parts):
        got = torch.cat(parts)
        assert_close(torch, f"{name} per data place vs one launch", got,
                      whole)
        same[name] = same_bits(torch, got, whole)

    compare("K1", paged_flash_decode(q, kp, vp, lens, tbl),
            [paged_flash_decode(q[h].contiguous(), kp, vp,
                                lens[h].contiguous(), tbl[h].contiguous())
             for h in halves])
    st = torch.tensor([64, 5, 16, 300, 31, 600, 64, 1], dtype=torch.int32,
                      device=dev)
    cl = torch.tensor([128, 1, 77, 16, 128, 3, 100, 50], dtype=torch.int32,
                      device=dev)
    qc = torch.randn(B, CHUNK, H, D, generator=gen, device=dev).bfloat16()
    kn, vn = (torch.randn(B, CHUNK, Hk, D, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    pools = [[kp.clone(), vp.clone()] for _ in range(2)]
    whole = paged_flash_prefill(qc, kn, vn, *pools[0], cl, tbl, start=st)[0]
    parts = [paged_flash_prefill(
        qc[h].contiguous(), kn[h].contiguous(), vn[h].contiguous(),
        *pools[1], cl[h].contiguous(), tbl[h].contiguous(),
        start=st[h].contiguous())[0] for h in halves]
    real = torch.arange(CHUNK, device=dev)[None] >= (CHUNK - cl)[:, None]
    compare("K2", whole[real], [p[real[h]] for p, h in zip(parts, halves)])
    if not all(same_bits(torch, a, b) for a, b in zip(*pools)):
        raise AssertionError("K2 per data place: the written pool differs "
                             "from one launch's")
    kc, vc = (torch.randn(B, MAX_LEN, Hk, D, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    compare("K3", flash_decode(q, kc, vc, lens),
            [flash_decode(q[h].contiguous(), kc[h], vc[h],
                          lens[h].contiguous()) for h in halves])
    torch.cuda.synchronize()
    return same


def data_kernels(torch, cfg, gen, card, meshes=DATA_MESHES):
    """K1 and K2 on a bf16 pool at ``cfg``'s per-place shapes of
    ``meshes`` (4 lanes of 8, data place 1's at d = 2; every head at
    (d, 1), one model shard's at (2, 2)) against their plain versions as
    in phase 3, and ``split_vs_one`` at each.  Returns {(d, m): (heads,
    K1 result, K2 results)}."""
    from dataclasses import replace
    from repro_torch.parallel import sharding
    out = {}
    for d, m in meshes:
        a = sharding.attn_shard_size(card_mesh(m, d=d), cfg.num_kv_heads)
        heads = (cfg.num_heads // a, cfg.num_kv_heads // a, cfg.head_dim)
        dec = check_decode(torch, replace(cfg, num_heads=heads[0],
                                          num_kv_heads=heads[1]), gen,
                           lanes=PLACE_LANES)
        pre = check_prefill(torch, heads, gen, cases=("first",
                                                      "continuation"),
                            lanes=PLACE_LANES)
        same = split_vs_one(torch, heads, gen)
        print(f"kernels {cfg.name} at {(d, m)}, one place's 4 lanes, heads "
              f"{heads} [{card}]: per data place vs one launch on all 8 "
              f"lanes, bit for bit: {same}")
        for name, r in [(f"paged_flash_decode[q (4, {heads[0]}, "
                         f"{heads[2]})]", dec)] + [
                (f"paged_flash_prefill[{k}, 4 lanes, heads {heads}]", v)
                for k, v in pre.items()]:
            print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
                  f"({r['bound_by']}){rates(r)}")
        out[d, m] = heads, dec, pre
    return out


def replicas_equal(torch, cache, mesh, what):
    """Every data replica of every pool leaf bit for bit the others' (the
    trash block, each replica's own sink, aside)."""
    from repro_torch.models import kv_quant
    d, m = mesh.shape["data"], mesh.shape["model"]
    for k, x in cache.items():
        for j in range(m):
            ref = kv_quant.raw(x.parts[j])[:, 1:]
            for i in range(1, d):
                if not torch.equal(kv_quant.raw(x.parts[i * m + j])[:, 1:],
                                   ref):
                    raise AssertionError(f"{what}: {k} replica {i} of model "
                                         f"shard {j} differs")


def data_logits(torch, cfg, placed, kv_dtype, mesh, want, card):
    """model_logits over ``mesh`` held to the meshless ``want`` within
    check_model's limit: after the first chunk every data replica of the
    pool equal to the others bit for bit; K2 launched d x m x layers
    times a chunk and K1 d x m x layers a decode step (4 lanes: every
    place holds some); the bytes of each call equal
    ``dryrun.serve_collectives``.  Returns the worst share."""
    from dataclasses import replace
    from repro_torch.launch import dryrun
    n, L = mesh.devices.size, cfg.num_layers
    name = f"{cfg.name} {kv_dtype} pool, {mesh_name(mesh)} vs none"
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    log = []
    got = model_logits(torch, cfg, placed, kv_dtype, "on", mesh=mesh,
                       log=log, after_chunk=lambda c: replicas_equal(
                           torch, c, mesh, f"{name}, after a chunk"))
    launches = {k: w.launches for k, w in wrappers.items()}
    if launches != {"paged_flash_decode": n * L,
                    "paged_flash_prefill": 2 * n * L,
                    "flash_decode": 0, "ssd_scan": 0}:
        raise AssertionError(f"{name}: launches {launches}")
    c = replace(cfg, kv_dtype=kv_dtype)
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    lens, l2 = (64, 40, 9, 1), (16, 3, 16, 1)
    kw = dict(table_width=T, act=2, token_bytes=8)
    count = [dryrun.serve_collectives(c, mesh, 4, chunk=64, written=sum(
                 lens) + 4 * prefix, **kw),
             dryrun.serve_collectives(c, mesh, 4, chunk=16, written=sum(l2),
                                      first=False, all_logits=True, **kw),
             dryrun.serve_collectives(c, mesh, 4, written=4, active=False,
                                      **kw)]
    print(f"bytes between places {name} [{card}]: first chunk, "
          f"continuation, decode step {log}")
    if log != count:
        raise AssertionError(f"{name}: moved {log}, count {count}")
    return compare_logits(torch, name, got, want, 0.05, card)


def prefix_read(torch, cfg, params, mesh=None, gather=True):
    """Lane 0 (data place 0 of 2 over 8 lanes) prefills 64 tokens into
    blocks 1-4; lanes 1 (place 0) and 4 (place 1) then continue 16
    tokens each from those blocks.  Returns lane 4's last-position
    logits; ``gather=False`` skips copying place 0's written rows to the
    other replicas."""
    from dataclasses import replace
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    dev, c = "cuda", replace(cfg, attn_kernel="on")
    rng = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(1, cfg.vocab_size, (2, 64), generator=rng,
                         device=dev)
    tbl = torch.zeros(2, T, dtype=torch.int32, device=dev)
    tbl[:, :4] = torch.arange(1, 5, dtype=torch.int32, device=dev)
    tbl[0, 4], tbl[1, 4] = 5, 6

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    cache = M.init_paged_cache(c, 7, BS, device=dev, mesh=mesh)
    keep = sharding.gather_writes
    if not gather:
        sharding.gather_writes = lambda *a: None
    try:
        M.prefill_slots(c, params, cache, toks[:1], i32(64), tbl[:1],
                        mesh=mesh, lanes=sharding.Lanes((0,), B))
        out, _ = M.prefill_slots(c, params, cache, toks[:, :16], i32(16, 16),
                                 tbl, start=i32(64, 64), mesh=mesh,
                                 lanes=sharding.Lanes((1, 4), B))
    finally:
        sharding.gather_writes = keep
    torch.cuda.synchronize()
    return out[1:].float()


def gather_control(torch, cfg, params, placed, mesh, card):
    """prefix_read over ``mesh`` within 5% of the meshless logits' range;
    with the gather of written rows skipped (lane 4 on data place 1 reads
    place 0's prefix blocks as its replica's zeros) beyond it."""
    want = prefix_read(torch, cfg, params)
    name = f"{cfg.name} shared prefix read across data places, " \
        f"{mesh_name(mesh)} vs none"
    compare_logits(torch, name, [prefix_read(torch, cfg, placed, mesh)],
                   [want], 0.05, card, names=("lane 4",))
    bad = compare_logits(torch, name + " control (gather skipped)",
                         [prefix_read(torch, cfg, placed, mesh, False)],
                         [want], 0.05, card, enforce=False,
                         names=("lane 4",))
    if bad <= 0.05:
        raise AssertionError(f"{name}: the check cannot see a replica "
                             f"missing another place's writes")


def run_data_paged(torch, gen, card):
    """Phase 16's paged part: full-width tinyllama-1.1b on DATA_DEPTH of
    its layers at DATA_MESHES —
    ``data_kernels``; ``data_logits`` on bf16, int8 and f8 pools against
    the meshless run; ``gather_control``; the 12-request trace greedy on
    bf16 and int8 pools meshless and at each mesh (``run_mesh_trace``:
    every request ends, no block stays live, K1 once a place a layer a
    decode step, K2 once a layer for each place holding some of a
    chunk's lanes; ms a decode step and the share of requests equal to
    the meshless run printed).  Then internvl2-26b at (2, 1) on
    DATA_VLM_DEPTH layers: the weights' bytes and init peak, the model
    check on a bf16 pool, 4 requests (two behind images).  Returns its
    kernels-line entries."""
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    cfg = replace(get_config(ARCH), num_layers=DATA_DEPTH)
    kernels = data_kernels(torch, cfg, gen, card)
    params = M.init_params(cfg, seed=0, device="cuda")
    want = {kd: model_logits(torch, cfg, params, kd, "on")
            for kd in DATA_POOLS}
    runs = {(1, 1, kd): run_mesh_trace(torch, cfg, params, card, kv_dtype=kd)
            for kd in DATA_TRACE_POOLS}
    worst = {}
    for d, m in DATA_MESHES:
        mesh = card_mesh(m, d=d)
        placed = sharding.place_serve(cfg, params, mesh)
        for kd in DATA_POOLS:
            worst[d, m, kd] = data_logits(torch, cfg, placed, kd, mesh,
                                          want[kd], card)
        gather_control(torch, cfg, params, placed, mesh, card)
        for kd in DATA_TRACE_POOLS:
            runs[d, m, kd] = run_mesh_trace(torch, cfg, placed, card, mesh,
                                            kv_dtype=kd)
        del placed
    for (d, m, kd), run in runs.items():
        if d > 1:
            same = sum(a == b for a, b in zip(runs[1, 1, kd][0], run[0])) \
                / len(run[0])
            print(f"engine {ARCH} {kd}, {(d, m)} vs no mesh, greedy "
                  f"[{card}]: {same:.2f} of requests token for token equal "
                  f"(printed: bf16 near-ties flip)")
    print(f"engine {ARCH} ms per decode step [{card}]: " + ", ".join(
        f"{'no mesh' if d == 1 else (d, m)} {kd} {r[1]:.2f}"
        for (d, m, kd), r in runs.items()))
    print(f"model check {ARCH} over data axes [{card}]: worst share of the "
          f"range " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))
    del params
    torch.cuda.empty_cache()

    entries = []
    src = {"decode": ("src/repro_torch/csrc/paged_decode.cu",
                      "src/repro/kernels/flash_decode/flash_decode.py:183"),
           "prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                       "src/repro/kernels/flash_prefill/flash_prefill.py"
                       ":231")}
    for d, m in DATA_MESHES:
        heads, dec, pre = kernels[d, m]
        launches = runs[d, m, "bf16"][2]
        tag = f"{ARCH}, {(d, m)} place, 4 lanes, heads {heads}"
        entries += [kernel_entry(f"paged_flash_decode[{tag}]",
                                 *src["decode"],
                                 launches["paged_flash_decode"], dec),
                    kernel_entry(f"paged_flash_prefill[{tag}]",
                                 *src["prefill"],
                                 launches["paged_flash_prefill"],
                                 pre["continuation"],
                                 err=max(r["err"] for r in pre.values()))]

    vcfg = replace(get_config(VLM_ARCH), num_layers=DATA_VLM_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vparams = M.init_params(vcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    print(f"params {vcfg.name}, {DATA_VLM_DEPTH} layers [{card}]: "
          f"{held / 2**30:.2f} GiB, init peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB")
    vwant = model_logits(torch, vcfg, vparams, "bf16", "on")
    mesh = card_mesh(1, d=2)
    placed = sharding.place_serve(vcfg, vparams, mesh)
    data_logits(torch, vcfg, placed, "bf16", mesh, vwant, card)
    torch.cuda.reset_peak_memory_stats()
    run = run_mesh_trace(torch, vcfg, placed, card, mesh,
                         reqs=trace(vcfg, 4), images=images(vcfg, 4),
                         max_new=16)
    print(f"engine {vcfg.name} {DATA_VLM_DEPTH} layers (2, 1) [{card}]: "
          f"{run[1]:.2f} ms a decode step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (weights "
          f"{held / 2**30:.2f} GiB, one copy for both data places)")
    del vparams, placed
    torch.cuda.empty_cache()
    return entries


def run_data_waves(torch, arch, shape, gen, card):
    """Phase 16's waves for one config at full width over a (data, model)
    mesh: K3 and K4 at one place's shapes (2 rows of the wave's 4, the
    shard's heads) against their plain versions; ``wave_steps`` over the
    mesh against meshless within WAVE_SHARE (the recurrent families on
    the weights cast to fp32), K4 once a place a Mamba-2 block in the
    prefill and K3 once a place an attention layer a decode step; a
    control handing data place 1 place 0's stripes and states, which
    must fail the limit; 4 greedy requests meshless and over the mesh
    (``wave_engine``).  Returns its kernels-line entries."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    from repro_torch.configs.base import get_config
    d, m = shape
    cfg = get_config(arch)
    mesh = card_mesh(m, d=d)
    attn, ssm = recurrent_layers(cfg)
    res = {}
    if attn:
        a = sharding.attn_shard_size(mesh, cfg.num_kv_heads)
        heads = (cfg.num_heads // a, cfg.num_kv_heads // a, cfg.head_dim)
        res["flash_decode", heads] = check_dense_decode(
            torch, heads, gen, lanes=PLACE_WAVE_ROWS)
    if ssm:
        ways = sharding.mamba_shard_size(mesh, cfg)
        res["ssd_scan", cfg.ssm.nheads(cfg.d_model) // ways] = \
            check_ssd_model(torch, cfg, gen, card, ways=ways,
                            lens=WAVE_SSD_LENS, rows=2)[max(WAVE_SSD_LENS)]
    params = M.init_params(cfg, seed=0, device="cuda")
    recurrent = cfg.family in ("ssm", "hybrid", "audio")
    p = as_fp32(params) if recurrent else params
    want = wave_steps(torch, cfg, p, None)[0]
    placed = sharding.place_serve(cfg, p, mesh)
    got, pre, dec = wave_steps(torch, cfg, placed, mesh)
    n = mesh.devices.size
    name = f"{cfg.name} wave, {shape} vs none"
    zero = {"paged_flash_decode": 0, "paged_flash_prefill": 0}
    if pre != {**zero, "flash_decode": 0, "ssd_scan": n * ssm} or \
            dec != {**zero, "flash_decode": 2 * n * attn, "ssd_scan": 0}:
        raise AssertionError(f"{name}: launches prefill {pre}, decode {dec}")
    print(f"waves {name} [{card}]: K4 {pre['ssd_scan']} launches in the "
          f"prefill ({n} places x {ssm} blocks), K3 {dec['flash_decode']} "
          f"in two decode steps ({n} places x {attn} layers x 2); bytes "
          f"of the last step {dict(mesh.moved_bytes)}")
    share = WAVE_SHARE[cfg.family]
    compare_logits(torch, name, got, want, share, card,
                   names=("prefill", "decode 1", "decode 2"))
    bad = wave_steps(torch, cfg, placed, mesh, control="data")[0]
    ctl = max((x - y).abs().max().item() / (y.max() - y.min()).item()
              for x, y in zip(bad, want))
    print(f"model check {name} control (data place 1 handed place 0's "
          f"{'states' if ssm else 'stripes'}) [{card}]: worst max|diff| "
          f"{ctl:.4g} of the range (must exceed {share})")
    if ctl <= share:
        raise AssertionError(f"{name}: the check cannot see a data place "
                             f"reading another's rows")
    del placed, p
    torch.cuda.empty_cache()
    solo = wave_engine(torch, cfg, params, card)
    run = wave_engine(torch, cfg, sharding.place_serve(cfg, params, mesh),
                      card, mesh)
    same = sum(a == b for a, b in zip(solo[0], run[0])) / len(run[0])
    print(f"engine {cfg.name} wave, {shape} vs none, greedy [{card}]: "
          f"{same:.2f} of requests token for token equal; ms a decode step "
          f"{solo[1]:.2f} / {run[1]:.2f}, prefill tok/s {solo[2]:.1f} / "
          f"{run[2]:.1f}")
    del params
    torch.cuda.empty_cache()
    entries = []
    for (kernel, what), r in res.items():
        if kernel == "flash_decode":
            entries.append(kernel_entry(
                f"flash_decode[{cfg.name}, {shape} place, 2 rows, heads "
                f"{what}]", "src/repro_torch/csrc/dense_decode.cu",
                "src/repro/kernels/flash_decode/flash_decode.py:78",
                run[3]["flash_decode"], r))
        else:
            entries.append(kernel_entry(
                f"ssd_scan[{cfg.name}, {shape} place, 2 x {what} rows, "
                f"{max(WAVE_SSD_LENS)}]", "src/repro_torch/csrc/ssd_scan.cu",
                "src/repro/kernels/ssd_scan/ssd_scan.py:66",
                run[3]["ssd_scan"], r))
    return entries


def run_data_serving(torch, gen, card):
    """Phase 16: serving over (data, model) meshes naming the card d x m
    times — ``run_data_paged``, then ``run_data_waves`` for each of
    DATA_WAVES.  Returns the kernels-line entries."""
    entries = run_data_paged(torch, gen, card)
    for arch, shape in DATA_WAVES:
        entries += run_data_waves(torch, arch, shape, gen, card)
    return entries


# ---------------------------------------------------------------------------
# Phase 17: the moe family served over a (data, model) mesh with data axes
# above 1 — experts cut on E over data, dispatched in the reference's groups
# ---------------------------------------------------------------------------

#: qwen2-moe-a2.7b at full width on 10 of its 24 layers (every width full;
#: the whole script's time: 12 until phase 18 came), its meshes and pools.
MOE_DATA_DEPTH = 10
MOE_DATA_MESHES = ((2, 1), (2, 2))
MOE_DATA_POOLS = ("bf16", "int8")
#: qwen3-moe-235b-a22b at full width on 4 of its 94 layers (about 22 GB:
#: 128 experts of 3 x 4096 x 1536 a layer), its meshes and decode steps.
QWEN3_ARCH, QWEN3_DEPTH = "qwen3-moe-235b-a22b", 4
QWEN3_MESHES = ((4, 1), (2, 2))
QWEN3_DECODES = 8
#: The group control's capacity factor: at 0.5 the capacity's floor of 8
#: slots binds, so that the slot order decides which tokens keep their
#: experts (the config's 1.25 drops few of a 64-token row's).
MOE_CONTROL_FACTOR = 0.5


def hint_of(d):
    """The axis state of d data places: a meshless run's MoE then forms
    the groups a mesh with d data places forms."""
    from repro_torch.parallel import sharding
    return sharding.AxisState((("data", d), ("model", 1)))


def by_places(picks, mesh, n, lanes=None):
    """A meshless run's expert choices (one (n S, k) entry a MoE layer
    call, tokens in batch order) as a run over ``mesh`` routes them: each
    call's entry cut into one entry a place holding rows, in place order,
    that place's rows (``moe._grouped`` routes each place's own rows; a
    data place's model shards alike).  The replay then maps choices by
    token, not by place."""
    from repro_torch.parallel import sharding
    split = sharding.split_rows(mesh, lanes, n)
    di = sharding.axis_index(mesh, sharding.AxisState.from_mesh(mesh).dp)
    out = []
    for e in picks:
        rows = e.reshape(n, -1, e.shape[-1])
        for q in range(mesh.devices.size):
            held = list(range(n)) if split is None else list(split.rows[di[q]])
            if held:
                out.append(rows[held].reshape(-1, e.shape[-1]))
    return out


def experts_placed(torch, cfg, placed, mesh):
    """Each place holds only its E / d experts (E over data, d over
    ``model`` where they divide), every leaf gathering back bit for bit
    is the CPU tests' (``to_whole`` of a 4.8 GB leaf is skipped here):
    returns the bytes of one place's experts a layer."""
    from repro_torch.parallel import sharding
    d, m = mesh.shape["data"], mesh.shape["model"]
    E, D = cfg.moe.num_experts, cfg.d_model
    moe = placed["blocks"]["moe"]
    size = 0
    for name in ("w_gate", "w_up", "w_down"):
        x = moe[name]
        want = [cfg.num_layers, E // d, D // m, cfg.d_ff] \
            if name != "w_down" else [cfg.num_layers, E // d, cfg.d_ff,
                                      D // m]
        if x.rows != (("data",), 1) or \
                any(list(p.shape) != want for p in x.parts) or \
                len(x.distinct_parts()) != d * m:
            raise AssertionError(f"{cfg.name} {name} at {(d, m)}: placed "
                                 f"{x.rows} {x.parts[0].shape}, want "
                                 f"{want} on each of {d * m} places")
        size += x.parts[0][0].numel() * x.parts[0].element_size()
    return size


def moe_group_control(torch, cfg, params, placed, mesh, card):
    """A cohort of lanes 0 and 1 (both on data place 0 at d = 2) prefills
    64 tokens each, every position's logits, at the capacity factor
    MOE_CONTROL_FACTOR: over ``mesh`` within 5% of the meshless run under
    the same data axes, the expert choices replayed by token; with each
    data place's rows taken as one dispatch group (slots by place, not
    the reference's groups: lane 1's tokens compete with lane 0's for one
    capacity) beyond it."""
    from dataclasses import replace
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    dev = "cuda"
    c = replace(cfg, attn_kernel="on", moe=replace(
        cfg.moe, capacity_factor=MOE_CONTROL_FACTOR))
    rng = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(1, cfg.vocab_size, (2, 64), generator=rng,
                         device=dev)
    tbl = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    lens = torch.tensor([64, 64], dtype=torch.int32, device=dev)
    lanes = sharding.Lanes((0, 1), B)

    def chunk(p, mesh_, axes):
        cache = M.init_paged_cache(c, 9, BS, device=dev, mesh=mesh_)
        with sharding.use_axes(axes):
            out = M.prefill_slots(c, p, cache, toks, lens, tbl,
                                  all_logits=True, mesh=mesh_,
                                  lanes=lanes)[0]
        torch.cuda.synchronize()
        return [out.float()]

    d = mesh.shape["data"]
    picks = []
    with routing(torch, picks, replay=False):
        want = chunk(params, None, hint_of(d))
    name = f"{cfg.name} cohort of lanes 0 and 1, {mesh_name(mesh)} vs none"
    with routing(torch, by_places(picks, mesh, 2, lanes), replay=True):
        compare_logits(torch, name, chunk(placed, mesh, mesh), want, 0.05,
                       card, names=("every position",))

    def by_place(rows, d_):
        split = rows.split
        of, pos = [0] * rows.n, [0] * rows.n
        for i, r in enumerate(split.rows):
            for k, j in enumerate(r):
                of[j], pos[j] = i, k
        return sharding.Groups(d_, max(len(r) for r in split.rows),
                               tuple(of), tuple(pos))

    keep = sharding.dispatch_groups
    sharding.dispatch_groups = by_place
    try:
        with routing(torch, by_places(picks, mesh, 2, lanes), replay=True):
            bad = compare_logits(torch, name + " control (slots by data "
                                 "place)", chunk(placed, mesh, mesh), want,
                                 0.05, card, enforce=False,
                                 names=("every position",))
    finally:
        sharding.dispatch_groups = keep
    if bad <= 0.05:
        raise AssertionError(f"{name}: the check cannot see slots formed "
                             f"by data place")


def moe_data_steps(torch, cfg, params, mesh, axes, decodes, log=None):
    """A first chunk (4 lanes of 64, 40, 9 and 1 tokens), a continuation
    (every position's logits) and ``decodes`` decode steps on a bf16
    pool, kernels on, over ``mesh`` (``params`` placed there) or none,
    under ``axes``; launch counts set to 0 before and read after; the
    mesh's bytes read into ``log`` after each call; after the first chunk
    every data replica of the pool bit for bit the others.  Returns
    (logits of each call, ms a decode step, launches, peak GiB)."""
    from dataclasses import replace
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    dev = "cuda"
    rng, N, tbl, lens, toks = first_chunk(torch, cfg, 1)
    nb = len(lens)
    l2 = torch.tensor([16, 3, 16, 1], dtype=torch.int32, device=dev)
    t2 = torch.randint(1, cfg.vocab_size, (nb, 16), generator=rng,
                       device=dev)
    nxt = torch.randint(1, cfg.vocab_size, (nb, decodes), generator=rng,
                        device=dev)
    c = replace(cfg, attn_kernel="on")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0

    def read():
        if mesh is not None and log is not None:
            log.append(dict(mesh.moved_bytes))
        if mesh is not None:
            mesh.moved_bytes.clear()

    torch.cuda.reset_peak_memory_stats()
    out = []
    with sharding.use_axes(axes):
        cache = M.init_paged_cache(c, N, BS, device=dev, mesh=mesh)
        if mesh is not None:
            mesh.moved_bytes.clear()
        a, cache = M.prefill_slots(c, params, cache, toks, lens, tbl,
                                   mesh=mesh)
        read()
        if mesh is not None:
            replicas_equal(torch, cache, mesh, f"{cfg.name} "
                           f"{mesh_name(mesh)}, after a chunk")
        b, cache = M.prefill_slots(c, params, cache, t2, l2, tbl,
                                   start=lens, all_logits=True, mesh=mesh)
        read()
        out += [a.float(), b.float()]
        pos = lens + l2
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for i in range(decodes):
            d_, cache = M.decode_step(c, params, cache, nxt[:, i:i + 1],
                                      pos + i, block_tables=tbl, mesh=mesh)
            read()
            out.append(d_[:, 0].float())
        ev[1].record()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    return out, ev[0].elapsed_time(ev[1]) / decodes, launches, \
        torch.cuda.max_memory_allocated() / 2**30


def run_qwen3_data(torch, gen, card):
    """qwen3-moe-235b-a22b at full width on QWEN3_DEPTH layers over
    QWEN3_MESHES: K1 and K2 at one place's heads (rep 16, D 128: 64 over
    4 at (4, 1), 32 over 2 at (2, 2)) against their plain versions and
    per data place against one launch; the experts placed one E / d
    block a place; ``moe_data_steps`` over each mesh against the
    meshless run under the same data axes within 5% of the range, the
    expert choices replayed by token, K2 launched d x m x layers times a
    chunk and K1 a decode step, the bytes of each call equal to
    ``dryrun.serve_collectives``.  Returns the kernels-line entries."""
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    cfg = replace(get_config(QWEN3_ARCH), num_layers=QWEN3_DEPTH)
    kernels = data_kernels(torch, cfg, gen, card, QWEN3_MESHES)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    print(f"params {cfg.name}, {QWEN3_DEPTH} layers [{card}]: "
          f"{held / 2**30:.2f} GiB, init peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB")
    entries, L = [], cfg.num_layers
    src = {"decode": ("src/repro_torch/csrc/paged_decode.cu",
                      "src/repro/kernels/flash_decode/flash_decode.py:183"),
           "prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                       "src/repro/kernels/flash_prefill/flash_prefill.py"
                       ":231")}
    for d, m in QWEN3_MESHES:
        mesh = card_mesh(m, d=d)
        picks = []
        with routing(torch, picks, replay=False):
            want, ms0, _, _ = moe_data_steps(torch, cfg, params, None,
                                             hint_of(d), QWEN3_DECODES)
        placed = sharding.place_serve(cfg, params, mesh)
        per = experts_placed(torch, cfg, placed, mesh)
        log = []
        with routing(torch, by_places(picks, mesh, 4), replay=True):
            got, ms, launches, peak = moe_data_steps(
                torch, cfg, placed, mesh, mesh, QWEN3_DECODES, log)
        n = mesh.devices.size
        if launches != {"paged_flash_decode": n * L * QWEN3_DECODES,
                        "paged_flash_prefill": 2 * n * L,
                        "flash_decode": 0, "ssd_scan": 0}:
            raise AssertionError(f"{cfg.name} {(d, m)}: launches {launches}")
        kw = dict(table_width=T, act=2, token_bytes=8)
        count = [dryrun.serve_collectives(cfg, mesh, 4, chunk=64,
                                          written=114, **kw),
                 dryrun.serve_collectives(cfg, mesh, 4, chunk=16, written=36,
                                          first=False, all_logits=True,
                                          **kw)]
        count += [dryrun.serve_collectives(cfg, mesh, 4, written=4,
                                           active=False, **kw)] * QWEN3_DECODES
        if log != count:
            raise AssertionError(f"{cfg.name} {(d, m)}: moved {log}, count "
                                 f"{count}")
        worst = compare_logits(
            torch, f"{cfg.name} bf16 pool, {mesh_name(mesh)} vs none "
            f"under the same data axes", got, want, 0.05, card,
            names=("first chunk", "continuation") + tuple(
                f"decode {i}" for i in range(QWEN3_DECODES)))
        print(f"qwen3 over data {cfg.name} {(d, m)} [{card}]: {ms:.2f} ms a "
              f"decode step ({ms0:.2f} meshless), peak {peak:.2f} GiB, one "
              f"place's experts {per / 2**20:.1f} MiB a layer; launches "
              f"{launches} ({n} places x {L} layers a call); bytes of the "
              f"decode step {log[-1]}; worst share {worst:.4g}")
        heads, dec, pre = kernels[d, m]
        tag = f"{cfg.name}, {(d, m)} place, 4 lanes, heads {heads}"
        entries += [kernel_entry(f"paged_flash_decode[{tag}]",
                                 *src["decode"],
                                 launches["paged_flash_decode"], dec),
                    kernel_entry(f"paged_flash_prefill[{tag}]",
                                 *src["prefill"],
                                 launches["paged_flash_prefill"],
                                 pre["continuation"],
                                 err=max(r["err"] for r in pre.values()))]
        del placed
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return entries


def run_moe_data_serving(torch, gen, card):
    """Phase 17: qwen2-moe-a2.7b at full width on MOE_DATA_DEPTH layers
    over MOE_DATA_MESHES — K1 and K2 at one place's shapes against their
    plain versions and per data place against one launch; the experts
    placed one E / d block a place; ``data_logits`` on bf16 and int8
    pools against the meshless run under the same data axes (the
    reference's groups), the expert choices replayed by token; the group
    control at (2, 1); the 12-request trace greedy on both pools at each
    mesh; waves at (2, 2): K3 at one place's rows, ``wave_steps`` against
    meshless within WAVE_SHARE with the choices replayed, K3 launched
    once a place a layer, 4 greedy requests.  Then ``run_qwen3_data``.
    Returns the kernels-line entries."""
    from dataclasses import replace
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    cfg = replace(get_config(MOE_ARCH), num_layers=MOE_DATA_DEPTH)
    kernels = data_kernels(torch, cfg, gen, card, MOE_DATA_MESHES)
    params = M.init_params(cfg, seed=0, device="cuda")
    want = {}
    for kd in MOE_DATA_POOLS:
        picks = []
        with sharding.use_axes(hint_of(2)), \
                routing(torch, picks, replay=False):
            want[kd] = model_logits(torch, cfg, params, kd, "on"), picks
    runs, worst = {}, {}
    for d, m in MOE_DATA_MESHES:
        mesh = card_mesh(m, d=d)
        placed = sharding.place_serve(cfg, params, mesh)
        per = experts_placed(torch, cfg, placed, mesh)
        print(f"experts {cfg.name} at {(d, m)} [{card}]: each place "
              f"{per / 2**20:.1f} MiB a layer (its {cfg.moe.num_experts // d}"
              f" experts' {cfg.d_model // m} columns)")
        for kd in MOE_DATA_POOLS:
            logits, picks = want[kd]
            with sharding.use_axes(mesh), \
                    routing(torch, by_places(picks, mesh, 4), replay=True):
                worst[d, m, kd] = data_logits(torch, cfg, placed, kd, mesh,
                                              logits, card)
        if m == 1:
            moe_group_control(torch, cfg, params, placed, mesh, card)
        for kd in MOE_DATA_POOLS:
            runs[d, m, kd] = run_mesh_trace(torch, cfg, placed, card, mesh,
                                            kv_dtype=kd)
        del placed
        torch.cuda.empty_cache()
    print(f"model check {cfg.name} over data axes [{card}]: worst share of "
          f"the range " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))

    # Waves at (2, 2).
    d, m = 2, 2
    mesh = card_mesh(m, d=d)
    a = sharding.attn_shard_size(mesh, cfg.num_kv_heads)
    wheads = (cfg.num_heads // a, cfg.num_kv_heads // a, cfg.head_dim)
    k3 = check_dense_decode(torch, wheads, gen, lanes=PLACE_WAVE_ROWS)
    picks = []
    with routing(torch, picks, replay=False):
        wwant = wave_steps(torch, cfg, params, None, axes=hint_of(d))[0]
    placed = sharding.place_serve(cfg, params, mesh)
    with routing(torch, by_places(picks, mesh, 4), replay=True):
        got, pre, dec = wave_steps(torch, cfg, placed, mesh)
    n = mesh.devices.size
    name = f"{cfg.name} wave, {(d, m)} vs none under the same data axes"
    zero = {"paged_flash_decode": 0, "paged_flash_prefill": 0,
            "ssd_scan": 0}
    if pre != {**zero, "flash_decode": 0} or \
            dec != {**zero, "flash_decode": 2 * n * cfg.num_layers}:
        raise AssertionError(f"{name}: launches prefill {pre}, decode {dec}")
    compare_logits(torch, name, got, wwant, WAVE_SHARE["moe"], card,
                   names=("prefill", "decode 1", "decode 2"))
    wrun = wave_engine(torch, cfg, placed, card, mesh)
    del placed, params
    torch.cuda.empty_cache()

    entries = []
    src = {"decode": ("src/repro_torch/csrc/paged_decode.cu",
                      "src/repro/kernels/flash_decode/flash_decode.py:183"),
           "prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                       "src/repro/kernels/flash_prefill/flash_prefill.py"
                       ":231")}
    for d, m in MOE_DATA_MESHES:
        heads, dec, pre = kernels[d, m]
        launches = runs[d, m, "bf16"][2]
        tag = f"{cfg.name}, {(d, m)} place, 4 lanes, heads {heads}"
        entries += [kernel_entry(f"paged_flash_decode[{tag}]",
                                 *src["decode"],
                                 launches["paged_flash_decode"], dec),
                    kernel_entry(f"paged_flash_prefill[{tag}]",
                                 *src["prefill"],
                                 launches["paged_flash_prefill"],
                                 pre["continuation"],
                                 err=max(r["err"] for r in pre.values()))]
    entries.append(kernel_entry(
        f"flash_decode[{cfg.name}, (2, 2) place, 2 rows, heads {wheads}]",
        "src/repro_torch/csrc/dense_decode.cu",
        "src/repro/kernels/flash_decode/flash_decode.py:78",
        wrun[3]["flash_decode"], k3))
    return entries + run_qwen3_data(torch, gen, card)


# ---------------------------------------------------------------------------
# Phase 18: training on a batch that does not divide the data axes
# ---------------------------------------------------------------------------

#: The batch (rows x positions) of phase 18's tinyllama-1.1b step: 3 rows
#: divide no data axis above 1, so ``place_batch`` keeps them whole on
#: every data place and each computes every row.  The meshes (data,
#: model), each naming the card d x m times.
UNEVEN_B, UNEVEN_S = 3, 1024
UNEVEN_MESHES = ((2, 1), (2, 2))
#: mamba2-1.3b's batch, fp32 weights (as phase 15), at (2, 2).
UNEVEN_SSM_S = 512
#: qwen2-moe-a2.7b's MoE layer at (2, 2) on 3 rows of each length: T =
#: 3072 takes the manual path on token slices of 1.5 rows; T = 3069 (odd)
#: the grouped path on the experts cut on E over data and d over model.
UNEVEN_MOE_S = (1024, 1023)


@contextlib.contextmanager
def losses_summed_over_data():
    """The control: the R data places' losses summed where the sound step
    takes their mean (each place's loss is the whole batch's, so the
    batch counts R times)."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    mean = M.loss_fn
    M.loss_fn = lambda cfg, p, b, mesh=None: mean(
        cfg, p, b, mesh=mesh) * sharding.data_size(mesh)
    try:
        yield
    finally:
        M.loss_fn = mean


def uneven_steps(torch, cfg, params, batch, meshes, card, control=False):
    """One AdamW step meshless and at each mesh from ``params`` on
    ``batch``, each mesh's against the unsplit meshless step by phase
    13's limits, its bytes equal to ``dryrun.train_collectives``; with
    ``control``, the summed-losses control at (2, 1), which must fail
    them.  -> [(mesh name, ms a step, peak memory)]."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import dryrun
    B, S = batch["tokens"].shape
    old = dict(tree_lib.flatten(params))
    base = mesh_step(torch, cfg, params, batch, None)
    rows = [("meshless", base[3], base[4])]
    for d, m in meshes:
        mesh = card_mesh(m, d=d)
        got = mesh_step(torch, cfg, params, batch, mesh)
        compare_step(torch, f"{cfg.name} {B} x {S} {(d, m)} (the batch "
                     f"whole on each data place) vs meshless", got[:3],
                     base[:3], old, card)
        check_bytes(f"train step {cfg.name} {B} x {S} {(d, m)}", got[5],
                    dryrun.train_collectives(cfg, B, S, mesh, params), card)
        rows.append((str((d, m)), got[3], got[4]))
        del got
        torch.cuda.empty_cache()
    if control:
        with losses_summed_over_data():
            ctrl = mesh_step(torch, cfg, params, batch, card_mesh(1, d=2),
                             timed=False)
        if not compare_step(torch, f"{cfg.name} (2, 1) control (the data "
                            f"places' losses summed) vs meshless", ctrl[:3],
                            base[:3], old, card, enforce=False)[0]:
            raise AssertionError("the summed-losses control passed")
    return rows


def check_moe_uneven(torch, gen, card):
    """qwen2-moe-a2.7b's MoE layer at full width at (2, 2) on 3 rows
    placed whole on every data place: at S = 1024 (T even) the manual
    path on each data place's 1536-token slice against the plain
    ``_routed`` in the same two contiguous token groups, at S = 1023 (T
    odd) the grouped path against the meshless layer in one group; each
    by the reference's criterion (99% of tokens within 2% of the
    output's scale, aux within 0.05) with its bytes equal to
    ``dryrun.moe_layer_collectives``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M, moe
    from repro_torch.parallel import sharding
    cfg = get_config(MOE_ARCH)
    p = moe_layer(torch, cfg, gen)
    mesh = card_mesh(2, d=2)
    experts = ("w_gate", "w_up", "w_down")
    with torch.no_grad():
        placed = M._tree_map(lambda v: v[0], sharding.place_train(
            cfg, {"blocks": {"moe": M._tree_map(lambda v: v[None], p)}},
            mesh)["blocks"]["moe"])
        placed = M.gather_data(placed, keep=lambda path: path[-1] in experts
                               and "shared" not in path)
    for S in UNEVEN_MOE_S:
        x = (torch.randn(UNEVEN_B, S, cfg.d_model, device="cuda",
                         generator=gen) * 0.5).bfloat16()
        manual = S % 2 == 0
        with torch.no_grad():
            if manual:
                out, me, ce = moe._routed(cfg, p, x, G=2)
                ref = out + moe._shared(cfg, p["shared"], x)
                aux_ref = moe._aux(cfg, me, ce)
            else:
                ref, aux_ref = moe.apply_moe(cfg, p, x)
            xs = sharding.place_batch(cfg, {"x": x}, mesh)["x"]
            if moe.expert_parallel(cfg, mesh, xs) != manual:
                raise AssertionError(f"S={S}: manual path {not manual}")
            mesh.moved_bytes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, aux = moe.apply_moe(cfg, placed, xs, mesh=mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        path = "manual, token slices" if manual else "grouped, one group"
        worst = 1.0
        for g in sharding.groups(mesh, "model"):
            tok = ((out.parts[g[0]].float() - ref.float()).abs().amax(-1)
                   / (ref.float().abs().max() + 1e-9))
            worst = min(worst, float((tok < 0.02).float().mean()))
        aux_err = max(abs(float(a) - float(aux_ref)) for a in aux.parts)
        print(f"moe {cfg.name} {UNEVEN_B} x {S} (2, 2) {path} vs "
              f"{'_routed in 2 token groups' if manual else 'meshless'} "
              f"[{card}]: {worst:.4%} of tokens within 2% of scale on the "
              f"worst data place (>= 99%), aux {float(aux.parts[0]):.5f} vs "
              f"{float(aux_ref):.5f} (|d| {aux_err:.2e} < 0.05), {ms:.1f} ms "
              f"host wall")
        if worst < 0.99 or not aux_err < 0.05:
            raise AssertionError(f"moe {S}: {worst}, aux {aux_err}")
        check_bytes(f"moe {cfg.name} {UNEVEN_B} x {S} (2, 2) {path}",
                    dict(mesh.moved_bytes), dryrun.moe_layer_collectives(
                        cfg, UNEVEN_B, S, mesh), card)


def run_uneven_training(torch, gen, card):
    """Phase 18: a batch of UNEVEN_B rows, which divides no data axis,
    whole on every data place.  Full-width tinyllama-1.1b, one AdamW step
    meshless and at each UNEVEN_MESHES mesh against the unsplit meshless
    step (phase 13's limits; bytes equal to the dry run's count; ms a
    step and peak memory), the summed-losses control; mamba2-1.3b on fp32
    weights at (2, 2); no kernel launch; qwen2-moe-a2.7b's MoE layer on
    both branches (``check_moe_uneven``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    zero_launches()
    runs = []
    for arch, S, cast, meshes in (
            (ARCH, UNEVEN_S, False, UNEVEN_MESHES),
            (SSM_ARCH, UNEVEN_SSM_S, True, ((2, 2),))):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        params = M.init_params(cfg, seed=0, device="cuda")
        if cast:
            params = as_fp32(params)
        batch = train_batch(torch, cfg, UNEVEN_B, S)
        rows = uneven_steps(torch, cfg, params, batch, meshes, card,
                            control=not cast)
        runs.append((cfg, S, rows))
        del params, batch
        torch.cuda.empty_cache()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the grad path: "
                             f"{launches}")
    for cfg, S, rows in runs:
        print(f"train step {cfg.name} B={UNEVEN_B} S={S} by mesh, the batch "
              f"whole on each data place [{card}]: " + "; ".join(
                  f"{n} {ms:.1f} ms/step, peak {pk / 2**30:.2f} GiB"
                  for n, ms, pk in rows)
              + " (one card holds every place: no speedup is expected)")
    check_moe_uneven(torch, gen, card)
    print(f"uneven-batch training phase [{card}]: "
          f"{time.perf_counter() - t0:.1f} s")


#: Each phase's seconds, in the order the phases ran.
PHASE_SECONDS = {}
_LAST_MARK = [time.perf_counter()]


def mark(phase):
    """Record and print the seconds since the previous mark as ``phase``'s
    (the first mark counts from the script's start)."""
    now = time.perf_counter()
    PHASE_SECONDS[phase] = now - _LAST_MARK[0]
    _LAST_MARK[0] = now
    print(f"phase {phase}: {PHASE_SECONDS[phase]:.1f} s")


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
    mark("1. device report")

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
    from repro_torch.models import kv_quant
    print(f"f8 cast past 464 (torch {torch.__version__}, cuda / cpu): "
          f"{'+-448' if kv_quant.f8_saturates('cuda') else 'NaN'} / "
          f"{'+-448' if kv_quant.f8_saturates('cpu') else 'NaN'}; the "
          f"prefill kernel's f8 scatter follows the card's")
    mark("2. build")

    # 3. Kernel checks.
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pools = ("bf16", "int8", "fp8", "f8")
    dec = {kd: check_decode(torch, cfg, gen, kd) for kd in pools}
    tiny = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    pre = {kd: check_prefill(torch, tiny, gen, kd) for kd in pools}
    pre6 = {kd: check_prefill(torch, REP6_HEADS, gen, kd,
                              cases=("first", f"first, prefix {VLM_PREFIX}",
                                     "continuation"))
            for kd in pools}
    dense = check_dense_decode(torch, tiny, gen)
    # The new families' heads: qwen2-moe-a2.7b 16 over 16 of 128 (rep 1),
    # internvl2-26b 48 over 8 of 128 (rep 6).
    moe_cfg, vlm_cfg = get_config(MOE_ARCH), get_config(VLM_ARCH)
    moe_heads = (moe_cfg.num_heads, moe_cfg.num_kv_heads, moe_cfg.head_dim)
    dec_moe = check_decode(torch, moe_cfg, gen)
    dec_vlm = check_decode(torch, vlm_cfg, gen)
    pre_moe = check_prefill(torch, moe_heads, gen,
                            cases=("first", "continuation"))
    dense_vlm = check_dense_decode(torch, REP6_HEADS, gen,
                                   S=MAX_LEN + VLM_PREFIX)
    # The f8 pool and stripes beyond tinyllama-1.1b's heads: K1 and K2 at
    # qwen2-moe-a2.7b's (rep 1) and internvl2-26b's (rep 6, above), K3 at
    # head dims 64 (tinyllama-1.1b), 112 (zamba2-7b's shared attention,
    # 32 over 32) and 128 (internvl2-26b).
    dec8 = {"moe": check_decode(torch, moe_cfg, gen, "f8"),
            "vlm": check_decode(torch, vlm_cfg, gen, "f8")}
    pre_moe8 = check_prefill(torch, moe_heads, gen, "f8",
                             cases=("first", "continuation"))
    dense8 = {64: check_dense_decode(torch, tiny, gen, kv_dtype="f8"),
              112: check_dense_decode(torch, ZAMBA_HEADS, gen, kv_dtype="f8"),
              128: check_dense_decode(torch, REP6_HEADS, gen,
                                      S=MAX_LEN + VLM_PREFIX, kv_dtype="f8")}
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
    rows += [(f"paged_flash_decode[f8, heads {moe_heads}]", dec8["moe"]),
             (f"paged_flash_decode[f8, heads {REP6_HEADS}]", dec8["vlm"])]
    rows += [(f"paged_flash_prefill[f8, {k}, heads {moe_heads}]", v)
             for k, v in pre_moe8.items()]
    rows += [(f"flash_decode[f8, D={d}]", r) for d, r in dense8.items()]
    for name, r in rows:
        print(f"kernel {name} [{card}]: max|err| {r['err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}){rates(r) if 'ops' in r else ''}")
    mark("3. kernel checks")

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
    mark("6. the last three kernels")

    # 4. Model checks, full width.
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    print(f"params: {M.param_count(cfg) / 1e9:.3f} B bf16 in "
          f"{time.perf_counter() - t0:.1f} s")
    check_model(torch, cfg, params, card)
    mark("4. model checks")

    # 5. The main path, one run per pool encoding and mode, then the
    # same-bytes trio and a profile of the bf16 engine's decode step.
    launches = {}
    for kv_dtype, mode in (("bf16", "auto"), ("int8", "auto"),
                           ("fp8", "auto"), ("f8", "auto"), ("bf16", "wave"),
                           ("f8", "wave")):
        launches[kv_dtype, mode], eng = run_engine(
            torch, cfg, params, card, kv_dtype=kv_dtype, mode=mode,
            reqs=trace(cfg, WAVE_REQUESTS) if mode == "wave" else None)
        if (kv_dtype, mode) == ("bf16", "auto"):
            bf16_engine = eng
        if (kv_dtype, mode) == ("f8", "auto") and \
                eng.stats.kv_block_bytes != F8_BLOCK_BYTES:
            raise AssertionError(f"f8 pool: {eng.stats.kv_block_bytes} "
                                 f"bytes a block, not {F8_BLOCK_BYTES}")
    run_same_bytes_pair(torch, cfg, params, card)
    profile_prefill(torch, bf16_engine, cfg, card)
    profile_decode(torch, bf16_engine, cfg, card)
    mark("5. engine runs")

    # 7. The last three kernels' entry points.
    slice3 = run_slice3_entry_points(torch, cfg, gen, card)
    mark("7. entry points")

    # 8. Speculative decoding and the async front end: the prefill kernel
    # at the verify pass's shape on every pool, the verify pass against
    # decode steps at the model level, the 12-request trace greedy with
    # speculation off and on (bf16 and int8 pools), then the launcher
    # through the front end and a two-replica router with a crash.
    ver = {kd: check_prefill(torch, tiny, gen, kd, cases=(VERIFY,))[VERIFY]
           for kd in pools}
    ver["bf16, heads REP6"] = check_prefill(torch, REP6_HEADS, gen,
                                            cases=(VERIFY,))[VERIFY]
    for kd, r in ver.items():
        print(f"kernel paged_flash_prefill[{kd}, verify P={SPEC_K + 1}] "
              f"[{card}]: max|err| {r['err']:.3g}; kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}){rates(r)}")
    check_verify_model(torch, cfg, params, card)
    spec = {kd: run_spec(torch, cfg, params, card, kv_dtype=kd,
                         reqs=trace(cfg, SPEC_REQUESTS))
            for kd in ("bf16", "int8", "f8")}
    run_launcher(torch, card)
    mark("8. speculation and the async front end")

    # 9. The other attention families at full width, one at a time.
    del params, bf16_engine, eng
    family = {arch: run_family(torch, arch, card)
              for arch in (MOE_ARCH, VLM_ARCH) + DENSE_ARCHS}
    mark("9. the other attention families")

    # 10. The recurrent families at full width, one at a time.
    recurrent = {arch: run_recurrent(torch, arch, gen, card)
                 for arch in (SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH)}
    mark("10. the recurrent families")

    # 11. Training on one card.
    k5_fwd, k5_fwd_launches, _ = run_training(torch, gen, card)
    mark("11. training")

    # 12. Tensor-parallel serving over a model axis of 2 and 4 shards on
    # the one card.
    sharded = run_sharded(torch, gen, card)
    mark("12. tensor-parallel serving")

    # 13. Training over a (data, model) mesh on the one card.
    run_mesh_training(torch, gen, card)
    mark("13. training over a mesh")

    # 14. Waves over a model axis of 2 and 4 shards on the one card, every
    # family.
    waves = {arch: run_wave_sharded(torch, arch, ways, gen, card)
             for arch, ways in WAVE_SHARDS}
    mark("14. waves over a model axis")

    # 15. The recurrent families' training over a (data, model) mesh on
    # the one card.
    run_recurrent_mesh_training(torch, card)
    mark("15. recurrent training over a mesh")

    # 16. Serving over a (data, model) mesh on the one card.
    data = run_data_serving(torch, gen, card)
    mark("16. serving over a (data, model) mesh")

    # 17. The moe family over a (data, model) mesh on the one card.
    data += run_moe_data_serving(torch, gen, card)
    mark("17. moe over a (data, model) mesh")

    # 18. Training on a batch that does not divide the data axes.
    run_uneven_training(torch, gen, card)
    mark("18. training on an uneven batch")

    # Result lines.  The quantized bodies report their int8 times (fp8
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
        kernel_entry(f"paged_flash_prefill[verify, P={SPEC_K + 1}]",
                     pre_src, f"{pre_tpu}:231",
                     spec["bf16"]["paged_flash_prefill"], ver["bf16"]),
        kernel_entry(f"paged_flash_prefill[int8/fp8 pool, verify, "
                     f"P={SPEC_K + 1}]", pre_src, f"{pre_tpu}:202",
                     spec["int8"]["paged_flash_prefill"], ver["int8"],
                     err=max(ver["int8"]["err"], ver["fp8"]["err"])),
        kernel_entry(f"paged_flash_prefill[verify, heads {REP6_HEADS}]",
                     pre_src, f"{pre_tpu}:231",
                     family[VLM_ARCH]["spec"]["paged_flash_prefill"],
                     ver["bf16, heads REP6"]),
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
    dense_src = "src/repro_torch/csrc/dense_decode.cu"
    # The f8 kinds: the TPU kernels' fp route over an f8 cache (probs @ V
    # in bf16, `_pv_dtype`), the paged entries at tinyllama-1.1b's shapes
    # with the worst error over every f8 head shape checked.
    kernels += [
        kernel_entry("paged_flash_decode[f8]", dec_src, f"{dec_tpu}:183",
                     runs("paged_flash_decode", ("f8", "auto")), dec["f8"],
                     err=max(r["err"] for r in [dec["f8"]]
                             + list(dec8.values()))),
        kernel_entry("paged_flash_prefill[f8]", pre_src, f"{pre_tpu}:231",
                     runs("paged_flash_prefill", ("f8", "auto")),
                     pre["f8"]["continuation"],
                     err=max(r["err"] for res in (pre["f8"], pre6["f8"],
                                                  pre_moe8)
                             for r in res.values())),
        kernel_entry(f"paged_flash_prefill[f8, verify, P={SPEC_K + 1}]",
                     pre_src, f"{pre_tpu}:231",
                     spec["f8"]["paged_flash_prefill"], ver["f8"]),
        kernel_entry("flash_decode[f8, D=64]", dense_src, f"{dec_tpu}:78",
                     runs("flash_decode", ("f8", "wave")), dense8[64]),
        kernel_entry("flash_decode[f8, D=112]", dense_src, f"{dec_tpu}:78",
                     recurrent[HYBRID_ARCH][2]["flash_decode"], dense8[112]),
        kernel_entry("flash_decode[f8, D=128]", dense_src, f"{dec_tpu}:78",
                     family[VLM_ARCH]["wave f8"]["flash_decode"],
                     dense8[128]),
    ]
    ssd_src, ssd_tpu = ("src/repro_torch/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:66")
    for arch in (HYBRID_ARCH, AUDIO_ARCH):
        r, run = recurrent[arch][0]["dense"], recurrent[arch][1]
        c = get_config(arch)
        kernels.append(kernel_entry(
            f"flash_decode[heads {(c.num_heads, c.num_kv_heads, c.head_dim)}]",
            dense_src, f"{dec_tpu}:78", run["flash_decode"], r))
    for arch in (SSM_ARCH, HYBRID_ARCH):
        res, run = recurrent[arch][0]["ssd"], recurrent[arch][1]
        kernels.append(kernel_entry(
            f"ssd_scan[{arch} prefill]", ssd_src, ssd_tpu, run["ssd_scan"],
            res[512], err=max(r["err"] for r in res.values())))
    lines = {("decode", False): (dec_src, f"{dec_tpu}:183"),
             ("decode", True): (dec_src, f"{dec_tpu}:151"),
             ("prefill", False): (pre_src, f"{pre_tpu}:231"),
             ("prefill", True): (pre_src, f"{pre_tpu}:202")}
    for name, kernel, quant, n, r, err in sharded:
        kernels.append(kernel_entry(name, *lines[kernel, quant], n, r, err))
    kernels += wave_entries(waves)
    kernels += data
    kernels.append(kernel_entry(
        f"flash_attention[forward, B={TRAIN_B}]",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:72",
        k5_fwd_launches, k5_fwd))
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launches on the main "
                                 f"path")
        if k["library_ms"] is None and not k["name"].startswith("ssd_scan"):
            raise AssertionError(f"{k['name']}: no library time")
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k['name']}: {key} is {v}")
    print(f"phase seconds [{card}]: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; total {sum(PHASE_SECONDS.values()):.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
