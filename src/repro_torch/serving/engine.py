"""Serving engine: continuous batching over a ref-counted paged KV cache,
and the lockstep wave path.

Port of ``repro.serving.engine``: both modes for the families with
attention KV caches (dense, moe, vlm), the wave path for the recurrent
ones (ssm, hybrid, audio), which have no block-addressable cache.  The
continuous path's host-side scheduler is the reference's, line for
line:

  * one pool of fixed-size KV blocks (``model.init_paged_cache``)
    addressed through per-lane block tables;
  * prefix caching through the content-addressed ``serving.paged
    .BlockStore``: admission matches the longest cached prefix and the
    lane starts with those blocks, so prefill runs only the uncached tail
    (at least one prompt token is always recomputed);
  * retired full blocks linger in an LRU pool until allocation evicts
    them; copy-on-write (``ensure_writable``) before every write;
  * optimistic admission: nothing is reserved, pool pressure preempts a
    request (``preempt_policy``) which re-queues at the head and is
    recomputed, mostly from prefix-cache hits;
  * ``decode_steps=k`` decode iterations per host sync, with one (2, k, B)
    copy to the host per window;
  * the pool is bf16, float8_e4m3fn (``kv_dtype="f8"``: the K/V cast,
    no scales, half the bytes per block) or SCLAD-compressed
    (``kv_dtype="int8"/"fp8"``: payload plus fp32 scales, about half the
    bytes per block), so more blocks and concurrent lanes fit in the same
    memory; ``kv_dtype="f8"`` stores the wave path's stripes as
    float8_e4m3fn too;
  * both paged attention hot paths go through the hand-written kernels
    (``attn_kernel``: "auto" = kernels on the card, plain versions on the
    CPU; "on" = kernels; "off" = plain versions);
  * speculative decoding (``spec_decode="ngram"``, ``_spec_step``): a
    host proposer (``serving.spec``) drafts up to ``spec_k`` tokens per
    lane, one continuation chunk of ``spec_k + 1`` rows per live lane
    scores [anchor | drafts] through the paged prefill path, the lane
    keeps the longest draft prefix plain decode would have sampled, and
    ``BlockStore.truncate`` rolls the rejected tail back;
  * the async front end's surface: the ``on_token(uid, token)`` hook
    (every token as a host sync observes it), ``pool_saturation`` and
    ``live_blocks``.

vlm note: the patch prefix is part of each lane's cache, so its positions
enter the hash chain as sentinel ids and the patch embeddings' digest
seeds the lane's chain root (``_chain_seed``): requests with the same
image (or both with the zero stub, the default) share the prefix; the
same token ids behind different images never do.

``mode="wave"`` (``_run_waves``) is the reference's lockstep baseline:
requests grouped by exact prompt length, each wave prefilled in one pass
into dense caches (``model.prefill``: (L, B, ctx, Hk, D) stripes,
Mamba-2 states, whisper's cross K/V of zero stub frames) and decoded
together — attention through the dense flash-decode kernel — until every
member is done.  ``mode="auto"`` picks continuous for the attention
families and wave for the others, as the reference does; an ssm or
hybrid prompt longer than ``ssm.chunk_size`` must be a multiple of it.

Device state (pool, logits, positions, active mask, budgets, sampling
keys) is updated in place.  Sampling keys are POSITIONAL (see
``serving.sampler``): a request's token at position p depends on (seed,
uid, p) only, so outputs do not depend on co-tenants or preemption.

``mesh=`` (a (data=d, model=m) ``launch.mesh.Mesh``) serves both paths
over the mesh, as the reference's single controller per replica: the
host-side scheduler (queue, BlockStore, tables, admission and
preemption; the waves) runs once on this process and the mesh only
widens the device work.  Over ``model``: the weights cut by
``sharding.place_serve`` (``param_specs(mode="serve")``; the Mamba-2
leaves head-aligned, by component), the pool on its KV heads (payload
and scales together), the wave path's stripes on their KV heads and its
Mamba-2 states and windows on their heads (``model.init_cache(mesh=)``).
Over the data axes: the weights whole on every data place but the
routed experts, cut on E over data where E divides it (expert
parallelism; the MoE dispatches in the reference's groups of each call's
rows, ``moe.apply_moe(rows=)``); the lanes
cut by their slot (lane i to data index i // (max_batch / d): its
prefill chunks, verify passes, decode rows, sampled tokens and
positions, its image), the wave rows alike (row j of a B-row wave to
j // (B / d)) with the stripes and Mamba-2 caches cut on their batch;
every data place keeps a replica of the pool, and the rows each place
writes are gathered to the others (``sharding.gather_writes``), so a
lane may read a prefix block another place wrote.  Where d does not
divide the lanes, every data place runs every lane (no value changes).
The paged attention paths, the dense decode and the SSD scan run once
per (data, model) place with lanes, at the shard's head counts on the
place's rows.  Logits, sampled tokens and every scheduler input live on
place 0's device; ``EngineStats`` do not depend on the mesh.  Each
engine places and runs under its own ``sharding.use_axes``: nothing
leaks into the ambient axis state.
"""
from __future__ import annotations

import hashlib
import math
import time
import warnings
from dataclasses import dataclass, field, replace as dc_replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.flash_decode.ops import ATTN_KERNEL_MODES
from repro_torch.models import model as M
from repro_torch.parallel import sharding
from repro_torch.serving.paged import (BlockStore, OutOfBlocks, TRASH_BLOCK,
                                       chain_hashes, chain_root_for)
from repro_torch.serving.sampler import (SamplerConfig, positional_keys,
                                         request_keys, sample)
from repro_torch.serving.spec import SPEC_DECODE_MODES, make_proposer

#: Victim-selection policies for pool-pressure preemption.
PREEMPT_POLICIES = ("youngest", "largest", "deadline")

#: Families with block-addressable KV caches: the continuous path's.
CONTINUOUS_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32 — the ORIGINAL prompt
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    done: bool = False
    #: Soft completion deadline (only ORDER matters) — consumed by
    #: preempt_policy="deadline".  None = no deadline.
    deadline: Optional[float] = None
    #: vlm only: the request's (num_patches, d_model) fp32 patch
    #: embeddings; None = the zero stub.
    patch_embeds: Optional[np.ndarray] = None
    #: Chain root of the request's prefix-cache digests (``_chain_seed``).
    chain_seed: bytes = b""


@dataclass
class _Prefilling:
    """A request mid-admission: its prompt is entering the cache in chunks.

    ``tokens`` is the EFFECTIVE prompt (original prompt plus any tokens
    generated before a preemption — recompute replays them as prompt).
    ``consumed`` counts effective-prompt tokens already in the cache; it
    starts at the prefix-cache hit length.  ``cached_len`` is the hit
    length — nonzero means the first chunk is a continuation (the cached
    context is read through the table)."""
    req: Request
    lane: int
    budget: int  # decode budget remaining
    tokens: np.ndarray
    consumed: int = 0
    cached_len: int = 0  # cached positions, a vlm patch prefix included
    counted_cached: int = 0  # cached tokens credited to stats at admission


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    cached_prompt_tokens: int = 0  # prompt tokens skipped via prefix cache
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0
    admissions: int = 0
    preemptions: int = 0
    #: Peak simultaneously DECODING lanes.
    peak_decode_lanes: int = 0
    #: Time to first token (submit -> first token seen at a host sync).
    ttft_s_sum: float = 0.0
    ttft_count: int = 0
    #: One submit->first-token sample per request, and inter-token
    #: latency samples at host-sync granularity (a window's gap spread
    #: evenly over the tokens it released).
    ttft_history: List[float] = field(default_factory=list)
    itl_history: List[float] = field(default_factory=list)
    cancellations: int = 0
    #: Peak blocks referenced by >= 1 lane, and device bytes per block
    #: (all layers, K+V).
    peak_live_blocks: int = 0
    kv_block_bytes: int = 0
    #: Occupancy: active lanes summed over decode steps vs. capacity.
    occupied_slot_steps: int = 0
    slot_steps: int = 0
    #: Live LOGICAL tokens summed over decode steps vs. pool tokens.
    used_token_steps: int = 0
    pool_token_steps: int = 0
    #: Speculative decoding: verify passes, drafts proposed and drafts
    #: accepted.
    spec_passes: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.decode_s, 1e-9)

    @property
    def prefill_tokens_per_s(self) -> float:
        """Prompt tokens prefilled per second of prefill wall time."""
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def mean_ttft_s(self) -> float:
        return self.ttft_s_sum / max(self.ttft_count, 1)

    @staticmethod
    def percentile(history: List[float], q: float) -> float:
        """Nearest-rank percentile (q in (0, 100]); 0.0 when empty."""
        if not history:
            return 0.0
        if not 0.0 < q <= 100.0:
            raise ValueError(f"percentile q={q} outside (0, 100]")
        xs = sorted(history)
        return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]

    @property
    def p50_ttft_s(self) -> float:
        return self.percentile(self.ttft_history, 50.0)

    @property
    def p99_ttft_s(self) -> float:
        return self.percentile(self.ttft_history, 99.0)

    @property
    def p50_itl_s(self) -> float:
        return self.percentile(self.itl_history, 50.0)

    @property
    def p99_itl_s(self) -> float:
        return self.percentile(self.itl_history, 99.0)

    @property
    def slot_occupancy(self) -> float:
        return self.occupied_slot_steps / max(self.slot_steps, 1)

    @property
    def mean_active_requests(self) -> float:
        return self.occupied_slot_steps / max(self.decode_steps, 1)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from the prefix cache."""
        seen = self.cached_prompt_tokens + self.prefill_tokens
        return self.cached_prompt_tokens / max(seen, 1)

    @property
    def block_utilization(self) -> float:
        """Live logical tokens vs. pool token capacity (>1.0: sharing
        serves more context than the pool stores)."""
        return self.used_token_steps / max(self.pool_token_steps, 1)

    @property
    def peak_pool_bytes(self) -> int:
        return self.peak_live_blocks * self.kv_block_bytes

    @property
    def spec_acceptance_rate(self) -> float:
        return self.spec_accepted / max(self.spec_proposed, 1)


def _bucket(n: int, cap: int) -> int:
    """Smallest power-of-two >= n (min 8), capped at cap."""
    p = 8
    while p < n:
        p *= 2
    return min(p, cap)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_len: int = 256, eos_id: int = 0,
                 sampler: Optional[SamplerConfig] = None,
                 mode: str = "auto", pad_id: int = 0, seed: int = 0,
                 mesh=None, block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = 32,
                 prefix_cache: bool = True,
                 decode_steps: int = 1,
                 attn_kernel: Optional[str] = None,
                 preempt_policy: str = "youngest",
                 kv_dtype: Optional[str] = None,
                 spec_decode: str = "off", spec_k: int = 4,
                 device: DeviceLike = None,
                 decode_kernel: Optional[str] = None):
        """The reference engine's knobs (see its docstrings), plus
        ``device``: the card by default, ``"cpu"`` on request; ``params``
        must already live there (with a ``mesh``: on its shard 0 device,
        whole or already placed, e.g. ``model.init_params(mesh=)``).
        Every config serves under any (data, model) mesh; what it
        refuses, the reference refuses too: a paged cache for the ssm,
        hybrid and audio families (``mode="continuous"`` raises
        ``ValueError``; they serve in waves).

        ``mesh``: a ``launch.mesh.Mesh`` with ``data`` and ``model`` axes
        (see the module docstring); its place 0 device is the engine's,
        and ``device`` must name it or be None.

        ``spec_decode="ngram"`` / ``spec_k`` (continuous mode only):
        speculative decoding.  Emitted tokens equal ``spec_decode="off"``
        bit for bit on the plain path (greedy and stochastic: each verify
        position samples with the positional key plain decode would use,
        and positions advance only by accepted tokens).  Through the
        kernels, decode positions are scored by the paged prefill kernel
        instead of the paged decode kernel, which sums in another order:
        logits agree to bf16 tolerance and a near-tie greedy argmax can
        flip, as in the reference.  ``decode_steps`` is not used while
        speculating.  ``decode_kernel`` is the deprecated spelling of
        ``attn_kernel``: it warns, and raises on a conflicting
        ``attn_kernel``."""
        if decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if spec_decode not in SPEC_DECODE_MODES:
            raise ValueError(
                f"spec_decode {spec_decode!r} not in {SPEC_DECODE_MODES}")
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"preempt_policy {preempt_policy!r} not in "
                f"{PREEMPT_POLICIES}")
        if mode == "auto":
            mode = "continuous" if cfg.family in CONTINUOUS_FAMILIES \
                else "wave"
        if mode not in ("continuous", "wave"):
            raise ValueError(f"mode {mode!r} not in ('auto', 'continuous', "
                             f"'wave')")
        if mode == "continuous" and cfg.family not in CONTINUOUS_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} has no block-addressable KV cache; "
                f"use mode='wave'")
        if spec_decode != "off" and mode != "continuous":
            raise ValueError(
                "spec_decode requires the continuous (paged) engine: the "
                "verifier is the paged chunked-prefill path and rollback "
                "is a BlockStore operation")
        if decode_kernel is not None:
            warnings.warn(
                "ServingEngine(decode_kernel=...) is deprecated; the knob "
                "now selects the prefill kernel too — use attn_kernel=",
                DeprecationWarning, stacklevel=2)
            if attn_kernel is not None and attn_kernel != decode_kernel:
                raise ValueError(
                    f"conflicting attn_kernel={attn_kernel!r} and "
                    f"decode_kernel={decode_kernel!r}")
            attn_kernel = decode_kernel
        if attn_kernel is not None:
            if attn_kernel not in ATTN_KERNEL_MODES:
                raise ValueError(
                    f"attn_kernel {attn_kernel!r} not in {ATTN_KERNEL_MODES}")
            cfg = dc_replace(cfg, attn_kernel=attn_kernel)
        if kv_dtype is not None:
            cfg = dc_replace(cfg, kv_dtype=kv_dtype)
        if mesh is not None:
            self._check_mesh(cfg, mesh, device)
            device = sharding.model_devices(mesh)[0]
        self.mode = mode
        self.device = resolve_device(device)
        self._mesh = mesh
        self._axes = sharding.AxisState.from_mesh(mesh)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        self._chain_root = chain_root_for(cfg.kv_dtype)
        #: Cache positions ahead of each prompt: the vlm patch prefix.
        self._prefix = cfg.num_patches if cfg.family == "vlm" else 0
        self.preempt_policy = preempt_policy
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.seed = seed
        self.sampler = sampler or SamplerConfig()
        self.stats = EngineStats()
        #: Poisoned-engine flag (see ``step()``).
        self.poisoned = False
        #: Optional per-token hook ``on_token(uid, token)``, called on the
        #: engine's (caller's) thread for every generated token as a host
        #: sync observes it; the async front end streams through it.
        #: Preemption recompute replays tokens as prompt, so no token is
        #: announced twice.
        self.on_token: Optional[Callable[[int, int], None]] = None
        self._queue: List[Request] = []
        self._instant: List[Tuple[int, List[int]]] = []  # zero-budget
        self._submit_t: Dict[int, float] = {}
        self._last_obs_t: Dict[int, float] = {}
        self._digest_cache: Dict[int, Tuple[int, List[bytes]]] = {}
        self._uid = 0
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.decode_steps = decode_steps
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self._proposer = make_proposer(spec_decode)
        self.params = params
        if mesh is not None:
            with sharding.use_axes(self._axes):
                self.params = sharding.place_serve(cfg, params, mesh)
        if mode == "continuous":
            self._init_continuous()

    @staticmethod
    def _check_mesh(cfg: ModelConfig, mesh, device: DeviceLike) -> None:
        """A mesh is served from its shard 0 device."""
        dev0 = sharding.model_devices(mesh)[0]
        if device is not None and resolve_device(device) != dev0:
            raise ValueError(f"device {device} is not the mesh's shard 0 "
                             f"device {dev0}")

    def _call(self, fn, *args, **kwargs):
        """``fn(cfg, params, *args)``, a model call, under this engine's
        axis state, over its mesh when it has one."""
        if self._mesh is not None:
            kwargs["mesh"] = self._mesh
        with sharding.use_axes(self._axes):
            return fn(self.cfg, self.params, *args, **kwargs)

    def _model(self, fn, *args, **kwargs):
        """``_call`` on the continuous path's pool."""
        return self._call(fn, self._cache, *args, **kwargs)

    def _lanes(self, lanes: List[int], all_lanes: bool = False
               ) -> Dict[str, sharding.Lanes]:
        """The ``lanes`` keyword of a model call whose rows serve
        ``lanes`` of the engine's ``max_batch``: the data axes' cut of its
        rows over a mesh, and the batch the reference's MoE groups see
        (``all_lanes``: every lane, the verify pass's)."""
        return {"lanes": sharding.Lanes(tuple(int(i) for i in lanes),
                                        self.max_batch, all_lanes)}

    # -- public API ----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               deadline: Optional[float] = None,
               patch_embeds: Optional[np.ndarray] = None) -> int:
        """Queue a request; ``deadline`` feeds preempt_policy="deadline";
        ``patch_embeds`` (vlm only, (num_patches, d_model)) is the
        request's image, whose digest seeds its prefix-cache chain."""
        if self.poisoned:
            raise RuntimeError(
                "engine is poisoned: an earlier step() failure left the "
                "block store inconsistent; build a fresh engine")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no decode room in a "
                f"{self.max_len}-token cache")
        if patch_embeds is not None:
            if self.cfg.family != "vlm":
                raise ValueError(
                    f"patch_embeds is vlm-only (family is "
                    f"{self.cfg.family!r})")
            patch_embeds = np.asarray(patch_embeds, np.float32)
            want = (self.cfg.num_patches, self.cfg.d_model)
            if patch_embeds.shape != want:
                raise ValueError(
                    f"patch_embeds shape {patch_embeds.shape} != {want}")
        self._uid += 1
        uid = self._uid
        if max_new_tokens < 1:
            self._instant.append((uid, []))
            return uid
        if self.mode == "continuous":
            worst = self._worst_case_tokens(prompt, max_new_tokens)
            need = self._alloc.blocks_for(worst)
            cap = min(self._alloc.num_blocks,
                      self._alloc.max_blocks_per_slot)
            if need > cap:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool/block "
                    f"table caps at {cap}; it can never be admitted "
                    f"(raise num_blocks or shorten the prompt/budget)")
        self._submit_t[uid] = time.perf_counter()
        self._queue.append(Request(
            uid, prompt, max_new_tokens, deadline=deadline,
            patch_embeds=patch_embeds,
            chain_seed=self._chain_seed(patch_embeds)))
        return uid

    def _chain_seed(self, patch_embeds: Optional[np.ndarray]) -> bytes:
        """A request's prefix-cache chain root: the engine's
        kv_dtype-namespaced root, with the vlm image folded in (the zero
        stub has a constant seed of its own, so stub requests share)."""
        if self.cfg.family != "vlm":
            return self._chain_root
        if patch_embeds is None:
            return hashlib.sha256(
                self._chain_root + b"|vlm-zero-stub").digest()
        return hashlib.sha256(
            self._chain_root + patch_embeds.tobytes()).digest()

    def _note_tokens(self, uid: int, m: int, now: float) -> None:
        """Latency samples for ``m`` tokens of ``uid`` observed at ``now``:
        a request's first token is a TTFT sample, later ones ITL samples
        (the host-sync gap spread over the window's tokens)."""
        if m <= 0:
            return
        prev = self._last_obs_t.get(uid)
        if prev is None:
            t0 = self._submit_t.pop(uid, None)
            if t0 is not None:
                self.stats.ttft_s_sum += now - t0
                self.stats.ttft_count += 1
                self.stats.ttft_history.append(now - t0)
        else:
            self.stats.itl_history.extend([(now - prev) / m] * m)
        self._last_obs_t[uid] = now

    def step(self) -> List[Tuple[int, List[int]]]:
        """One scheduler iteration: admit, ONE prefill chunk, then
        ``decode_steps`` masked decode iterations across all lanes.
        Returns the requests finished this iteration as (uid, tokens).

        Poisoned-engine contract: when the body raises, the BlockStore
        invariants are re-checked; if they no longer hold the engine marks
        itself ``poisoned`` and refuses every later step()/submit()."""
        if self.mode != "continuous":
            raise RuntimeError(
                f"step() requires mode='continuous' (engine is in "
                f"{self.mode!r} mode); use run()")
        if self.poisoned:
            raise RuntimeError(
                "engine is poisoned: an earlier step() failure left the "
                "block store inconsistent; build a fresh engine")
        try:
            return self._step()
        except Exception:
            try:
                self._alloc.check_invariants()
            except Exception:
                self.poisoned = True
            raise

    def _step(self) -> List[Tuple[int, List[int]]]:
        finished: List[Tuple[int, List[int]]] = list(self._instant)
        self._instant = []
        self._admit()
        self._prefill_step()
        if not self._host_active.any():
            return finished
        if self._proposer is not None:
            return self._spec_step(finished)

        K = self.decode_steps
        # Hand each about-to-decode lane the blocks its next (up to K)
        # tokens land in; pool pressure preempts (possibly the lane itself).
        for i in np.nonzero(self._host_active)[0]:
            i = int(i)
            if not self._host_active[i]:
                continue  # preempted while an earlier lane grew
            steps_i = min(K, int(self._host_rem[i]))
            lo = self._prefix + int(self._host_pos[i])
            self._grow_for_writes(
                i, lo, lo + steps_i,
                alive=lambda i=i: bool(self._host_active[i]))
        if not self._host_active.any():
            return finished
        self._note_peak()
        tables = torch.from_numpy(self._alloc.block_table()).to(self.device)

        t0 = time.perf_counter()
        host = self._decode_window(tables)  # (2, K, B): one host copy
        tok_h, active_h = host[0], host[1].astype(bool)
        self.stats.decode_s += time.perf_counter() - t0

        was = self._host_active.copy()
        self.stats.peak_decode_lanes = max(self.stats.peak_decode_lanes,
                                           int(was.sum()))
        self.stats.decode_steps += K
        self.stats.slot_steps += self.max_batch * K
        self.stats.used_token_steps += self._alloc.live_tokens * K
        self.stats.pool_token_steps += self._alloc.num_blocks \
            * self._alloc.block_size * K

        bs = self._alloc.block_size
        now = time.perf_counter()
        for i in np.nonzero(was)[0]:
            i = int(i)
            r = self._slot_req[i]
            pos_before = self._prefix + int(self._host_pos[i])
            alive, emitted = True, 0
            for j in range(K):
                if not alive:
                    break
                tok = int(tok_h[j, i])
                r.output.append(tok)
                emitted += 1
                if self.on_token is not None:
                    self.on_token(r.uid, tok)
                self._host_pos[i] += 1
                self._host_rem[i] -= 1
                self.stats.generated_tokens += 1
                self.stats.occupied_slot_steps += 1
                alive = bool(active_h[j, i])
            self._note_tokens(r.uid, emitted, now)
            if self.prefix_cache and \
                    (self._prefix + int(self._host_pos[i])) // bs \
                    != pos_before // bs:
                # Freshly filled full block(s) become matchable.
                self._alloc.commit_full(i, self._content_ids(r))
            if not alive:
                r.done = True
                finished.append((r.uid, r.output))
                self._slot_req[i] = None
                self._host_active[i] = False
                self._last_obs_t.pop(r.uid, None)
                self._alloc.release(i)
        return finished

    def _decode_window(self, tables: torch.Tensor) -> np.ndarray:
        """``decode_steps`` masked decode iterations on the device; returns
        the packed (2, K, B) [tokens, still-active] array in ONE copy."""
        cfg, sampler = self.cfg, self.sampler
        toks, actives = [], []
        for _ in range(self.decode_steps):
            active = self._active
            # Inactive lanes (retired mid-window, mid-prefill, preempted)
            # run as masked rows with their tables pointed at the trash
            # block, so their writes cannot clobber a live block.
            tbl = torch.where(active[:, None], tables,
                              torch.full_like(tables, TRASH_BLOCK))
            keys = positional_keys(self._keys, self._pos)
            tok = sample(sampler, self._logits, keys, active=active,
                         pad_id=self.pad_id)
            self._budget -= active.to(torch.int32)
            retire = active & ((tok == self.eos_id) | (self._budget <= 0))
            logits, self._cache = self._model(
                M.decode_step, tok[:, None], self._pos, active=active,
                block_tables=tbl)
            self._logits = logits[:, 0]
            self._pos += active.to(torch.int32)
            self._active = active & ~retire
            toks.append(tok)
            actives.append(self._active.to(torch.int32))
        return torch.stack([torch.stack(toks), torch.stack(actives)]) \
            .cpu().numpy()

    def _spec_step(self, finished: List[Tuple[int, List[int]]]
                   ) -> List[Tuple[int, List[int]]]:
        """One speculative decode pass across all decoding lanes.

        1. Each lane's ANCHOR: what plain decode would sample next.  In
           steady state the previous verify pass sampled it already
           (``_spec_next``); a lane fresh out of prefill or a recompute
           samples it from its stored logits (``spec_anchor``, no model).
        2. Host: the proposer drafts up to ``spec_k`` continuations from
           the request's history (none past EOS or the budget).
        3. Growth and the copy-on-write barrier over the whole chunk
           (pool pressure preempts, as in decode).
        4. ONE verify pass (``spec_verify``) over the live lanes' [anchor
           | drafts] chunks: a continuation chunk through the paged
           prefill path that writes the drafted K/V into the pool and
           says how many drafts plain decode would have emitted.
        5. Emit the accepted prefix (stopping at EOS or the budget, as
           decode does) and ``BlockStore.truncate`` the rejected tail.

        The verify pass hands back the last accepted position's logits
        and their sample, which is the next pass's anchor, so the engine's
        logits stay exactly plain decode's from pass to pass."""
        t0 = time.perf_counter()
        live = [int(i) for i in np.nonzero(self._host_active)[0]]
        # Popped, not read: a lane that does not survive this pass derives
        # its anchor again from replayed logits.
        cached = {i: self._spec_next.pop(i) for i in list(self._spec_next)}
        fresh = [i for i in live if i not in cached]
        if fresh:
            cached.update(zip(fresh, self.spec_anchor(fresh).tolist()))
        chunks: Dict[int, List[int]] = {}
        for i in live:
            r = self._slot_req[i]
            chunk = [cached[i]]
            rem_after = int(self._host_rem[i]) - 1
            if chunk[0] != self.eos_id and rem_after > 0:
                k = min(self.spec_k, rem_after)
                hist = [int(t) for t in r.prompt] + r.output + chunk
                chunk += [int(d) for d in
                          self._proposer.propose(hist, k)[:k]]
            chunks[i] = chunk
        for i in chunks:
            if not self._host_active[i]:
                continue  # preempted while an earlier lane grew
            lo = self._prefix + int(self._host_pos[i])
            self._grow_for_writes(
                i, lo, lo + len(chunks[i]),
                alive=lambda i=i: bool(self._host_active[i]))
        # A lane preempted during growth drops its anchor; the recompute
        # replays it.
        lanes = [i for i in chunks if self._host_active[i]]
        if not lanes:
            self.stats.decode_s += time.perf_counter() - t0
            return finished
        self._note_peak()
        for i in lanes:
            self.stats.spec_proposed += len(chunks[i]) - 1
        v, anext = self.spec_verify(lanes, [chunks[i] for i in lanes])
        self.stats.decode_s += time.perf_counter() - t0

        self.stats.peak_decode_lanes = max(self.stats.peak_decode_lanes,
                                           len(lanes))
        self.stats.spec_passes += 1
        self.stats.decode_steps += 1
        self.stats.slot_steps += self.max_batch
        self.stats.used_token_steps += self._alloc.live_tokens
        self.stats.pool_token_steps += self._alloc.num_blocks \
            * self._alloc.block_size

        bs = self._alloc.block_size
        now = time.perf_counter()
        for j, i in enumerate(lanes):
            r = self._slot_req[i]
            chunk = chunks[i]
            lo = self._prefix + int(self._host_pos[i])
            emitted, alive = 0, True
            # Accepted tokens are exactly what plain decode would emit, so
            # retirement is decode's: stop at EOS or budget zero.
            for tok in chunk[:int(v[j]) + 1]:
                r.output.append(tok)
                emitted += 1
                if self.on_token is not None:
                    self.on_token(r.uid, tok)
                self._host_pos[i] += 1
                self._host_rem[i] -= 1
                self.stats.generated_tokens += 1
                if tok == self.eos_id or self._host_rem[i] <= 0:
                    alive = False
                    break
            self.stats.spec_accepted += emitted - 1
            self.stats.occupied_slot_steps += 1
            # One host sync released `emitted` tokens: the ITL gap spreads
            # over the ACCEPTED tokens only.
            self._note_tokens(r.uid, emitted, now)
            if emitted < len(chunk):
                # Roll back the optimistic writes past the accepted prefix.
                self._alloc.truncate(i, lo + emitted)
            if self.prefix_cache and (lo + emitted) // bs != lo // bs:
                self._alloc.commit_full(i, self._content_ids(r))
            if not alive:
                r.done = True
                finished.append((r.uid, r.output))
                self._slot_req[i] = None
                self._host_active[i] = False
                self._last_obs_t.pop(r.uid, None)
                self._alloc.release(i)
            else:
                # The lane consumed its whole accepted prefix, so its
                # position is where `anchor_next` was sampled.
                self._spec_next[i] = int(anext[j])
        return finished

    def spec_anchor(self, lanes: List[int]) -> np.ndarray:
        """The next token of each of ``lanes`` from its stored logits:
        decode's sampling rule, with the key of the lane's position."""
        idx = torch.tensor(lanes, device=self.device)
        pos = torch.from_numpy(self._host_pos[lanes].astype(np.int32)) \
            .to(self.device)
        keys = positional_keys(self._keys[idx], pos)
        return sample(self.sampler, self._logits[idx], keys).cpu().numpy()

    def spec_verify(self, lanes: List[int], chunks: List[List[int]]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Score each lane's [anchor | drafts] chunk in ONE continuation
        pass of (len(lanes), spec_k + 1) left-padded rows over the lanes'
        cached context, writing the chunk's K/V into the pool.  Returns
        per lane how many drafts plain decode would have emitted (``v``)
        and the sample after the last accepted token (the next anchor);
        the lanes' stored logits become that token's logits.  Only live
        lanes are scored, so no row has length 0."""
        dev, P, pfx = self.device, self.spec_k + 1, self._prefix
        n = len(lanes)
        tokens = np.full((n, P), self.pad_id, np.int32)
        lengths = np.empty(n, np.int32)
        starts = np.empty(n, np.int32)
        for j, (i, chunk) in enumerate(zip(lanes, chunks)):
            lengths[j] = len(chunk)
            tokens[j, P - len(chunk):] = chunk
            starts[j] = pfx + int(self._host_pos[i])
        idx = torch.tensor(lanes, device=dev)
        tok_d = torch.from_numpy(tokens).to(dev)
        len_d = torch.from_numpy(lengths).to(dev)
        start_d = torch.from_numpy(starts).to(dev)
        tables = torch.from_numpy(self._alloc.block_table()[lanes]).to(dev)
        logits_all, self._cache = self._model(
            M.prefill_slots, tok_d, len_d, tables, start=start_d,
            all_logits=True, **self._lanes(lanes, all_lanes=True))
        pad = P - len_d
        # Column c holds the token at position (start - pfx) + (c - pad);
        # what decode emits after it samples column c's logits with the
        # key of the NEXT position.
        col = torch.arange(P, device=dev)[None]
        nxt = (start_d - pfx)[:, None] \
            + torch.clamp(col - pad[:, None], min=0) + 1
        keys = positional_keys(self._keys[idx].repeat_interleave(P),
                               nxt.reshape(-1))
        expected = sample(self.sampler, logits_all.reshape(n * P, -1),
                          keys).reshape(n, P)
        # Draft at column c + 1 is accepted iff it equals what decode
        # emits after column c; the pad columns lead the run.
        ok = tok_d[:, 1:] == expected[:, :-1]
        lead = torch.where(col[:, :-1] < pad[:, None], True, ok)
        run = torch.cumprod(lead.to(torch.int32), dim=1).sum(1)
        v = torch.minimum(torch.clamp(run - pad, min=0), len_d - 1)
        sel = torch.clamp(pad + v, max=P - 1)
        rows = torch.arange(n, device=dev)
        self._logits[idx] = logits_all[rows, sel]
        host = torch.stack([v.to(torch.int64),
                            expected[rows, sel].to(torch.int64)]).cpu()
        return host[0].numpy(), host[1].numpy()

    def has_pending_work(self) -> bool:
        """True while ``step()`` (or ``run()``) can make progress."""
        if self.mode != "continuous":
            return bool(self._queue or self._instant)
        return bool(self._queue or self._prefilling or self._instant
                    or self._host_active.any())

    @property
    def pool_saturation(self) -> float:
        """Live (ref-counted) blocks over pool capacity, right now: the
        saturation signal the front end's circuit breaker watches."""
        if self.mode != "continuous":
            return 0.0
        return self._alloc.live_blocks / max(self._alloc.num_blocks, 1)

    @property
    def live_blocks(self) -> int:
        """Blocks referenced by some in-flight lane: the load half of the
        replica router's least-loaded fallback."""
        if self.mode != "continuous":
            return 0
        return self._alloc.live_blocks

    def match_cached_blocks(self, prompt, patch_embeds=None) -> int:
        """How many leading blocks of ``prompt`` (behind ``patch_embeds``
        on a vlm engine) the prefix cache could serve RIGHT NOW, without
        touching any state (0 with caching off or in wave mode)."""
        if self.mode != "continuous" or not self.prefix_cache:
            return 0
        content = np.concatenate([np.full(self._prefix, -1, np.int64),
                                  np.asarray(prompt, np.int64)])
        if patch_embeds is not None:
            patch_embeds = np.asarray(patch_embeds, np.float32)
        digests = chain_hashes(content, self._alloc.block_size,
                               seed=self._chain_seed(patch_embeds))
        return self._alloc.match_digests(
            digests, max_cached_tokens=self._prefix + len(prompt) - 1,
            min_cached_tokens=self._prefix)[0]

    def cancel(self, uid: int) -> bool:
        """Abort a request wherever it is — queued, mid-prefill or
        decoding — releasing its blocks like a retirement.  Returns False
        if it already finished (or was never submitted).  Continuous mode
        only."""
        if self.mode != "continuous":
            raise RuntimeError("cancel() requires mode='continuous'")
        self._submit_t.pop(uid, None)
        self._last_obs_t.pop(uid, None)
        for i, (u, _) in enumerate(self._instant):
            if u == uid:
                self._instant.pop(i)
                self.stats.cancellations += 1
                return True
        for i, r in enumerate(self._queue):
            if r.uid == uid:
                self._queue.pop(i)
                self._digest_cache.pop(uid, None)
                self.stats.cancellations += 1
                return True
        for s in self._prefilling:
            if s.req.uid == uid:
                self._prefilling.remove(s)
                self._alloc.release(s.lane)
                self.stats.cached_prompt_tokens -= s.counted_cached
                self.stats.cancellations += 1
                return True
        for i, r in enumerate(self._slot_req):
            if r is not None and r.uid == uid:
                self._slot_req[i] = None
                self._host_active[i] = False
                self._host_rem[i] = 0
                self._active[i] = False
                self._spec_next.pop(i, None)
                self._alloc.release(i)
                self.stats.cancellations += 1
                return True
        return False

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns uid -> generated tokens."""
        if self.mode != "continuous":
            return self._run_waves()
        results: Dict[int, List[int]] = {}
        while self.has_pending_work():
            for uid, toks in self.step():
                results[uid] = toks
        return results

    # -- continuous internals ------------------------------------------------
    def _init_continuous(self) -> None:
        cfg, B, dev = self.cfg, self.max_batch, self.device
        bs = self.block_size
        table_width = -(-(self.max_len + self._prefix) // bs)
        if self.num_blocks is None:
            self.num_blocks = B * table_width
        self._alloc = BlockStore(self.num_blocks, bs, B, table_width,
                                 prefix_cache=self.prefix_cache,
                                 kv_dtype=cfg.kv_dtype)
        # +1 device block: id 0 is the dead-lane trash sink.
        with sharding.use_axes(self._axes):
            self._cache = M.init_paged_cache(cfg, self.num_blocks + 1, bs,
                                             device=dev, mesh=self._mesh)
        # Device bytes per pool block, all layers, K+V, over every leaf
        # (axis 1 is blocks for payload and scale leaves alike) and each
        # distinct piece once: a SCLAD pool's figure is its payload plus
        # its fp32 scales; the data replicas, or a pool whole on every
        # shard, count once (the figure does not depend on the mesh).
        self.kv_block_bytes = sum(
            x[:, 0].numel() * x.element_size()
            for leaf in self._cache.values() for x in sharding.pieces(leaf))
        ldtype = self.params["embed"].dtype
        self._logits = torch.zeros((B, cfg.vocab_size), dtype=ldtype,
                                   device=dev)
        self._pos = torch.zeros(B, dtype=torch.int32, device=dev)
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._budget = torch.zeros(B, dtype=torch.int32, device=dev)
        self._keys = torch.zeros(B, dtype=torch.int64, device=dev)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._prefilling: List[_Prefilling] = []
        self._host_active = np.zeros(B, bool)
        self._host_pos = np.zeros(B, np.int64)
        self._host_rem = np.zeros(B, np.int64)  # decode budget remaining
        #: lane -> anchor token carried from the previous verify pass
        #: (``_spec_step``); dropped whenever a request leaves its lane.
        self._spec_next: Dict[int, int] = {}

    def _clamped_budget(self, prompt, max_new_tokens: int) -> int:
        """Decode budget clamped so the sequence fits ``max_len``."""
        return min(max_new_tokens, self.max_len - len(prompt))

    def _worst_case_tokens(self, prompt, max_new_tokens: int) -> int:
        return self._prefix + len(prompt) \
            + self._clamped_budget(prompt, max_new_tokens)

    def _effective_prompt(self, r: Request) -> np.ndarray:
        """The original prompt plus any tokens generated before a
        preemption (recompute replays them)."""
        if not r.output:
            return r.prompt
        return np.concatenate([r.prompt, np.asarray(r.output, np.int32)])

    def _content_ids(self, r: Request) -> np.ndarray:
        """Token ids at each cache position, for the prefix-cache chain:
        -1 per vlm patch position (the request's ``chain_seed`` commits
        the chain to the image), then prompt, then generated tokens."""
        return np.concatenate([np.full(self._prefix, -1, np.int64),
                               np.asarray(r.prompt, np.int64),
                               np.asarray(r.output, np.int64)])

    def _remaining_budget(self, r: Request) -> int:
        return self._clamped_budget(r.prompt, r.max_new_tokens) \
            - len(r.output)

    def _prompt_digests(self, r: Request) -> List[bytes]:
        """Chain digests of the request's content, cached by length."""
        n = self._prefix + len(r.prompt) + len(r.output)
        hit = self._digest_cache.get(r.uid)
        if hit is not None and hit[0] == n:
            return hit[1]
        digests = chain_hashes(self._content_ids(r), self._alloc.block_size,
                               seed=r.chain_seed)
        self._digest_cache[r.uid] = (n, digests)
        return digests

    # -- preemption ----------------------------------------------------------
    def _victim_key(self, r: Request, lane: int):
        """Sort key for victim selection — the MAX key is preempted."""
        if self.preempt_policy == "largest":
            return (self._alloc.owned_blocks(lane), r.uid)
        if self.preempt_policy == "deadline":
            d = float("inf") if r.deadline is None else float(r.deadline)
            return (d, r.uid)
        return (r.uid,)  # youngest

    def _select_victim(self):
        """("lane", i) or ("prefill", s) to evict, or None."""
        best, best_key = None, None
        for i in np.nonzero(self._host_active)[0]:
            r = self._slot_req[int(i)]
            if r is None:
                continue
            key = self._victim_key(r, int(i))
            if best_key is None or key > best_key:
                best, best_key = ("lane", int(i)), key
        for s in self._prefilling:
            key = self._victim_key(s.req, s.lane)
            if best_key is None or key > best_key:
                best, best_key = ("prefill", s), key
        return best

    def _preempt(self, victim) -> None:
        """Release the victim's blocks and re-queue it at the head."""
        kind, v = victim
        self.stats.preemptions += 1
        if kind == "lane":
            r = self._slot_req[v]
            self._slot_req[v] = None
            self._host_active[v] = False
            self._host_rem[v] = 0
            self._active[v] = False
            # The carried anchor belongs to the evicted request; the
            # recompute replays its logits and derives it again.
            self._spec_next.pop(v, None)
            self._alloc.release(v)
            self._queue.insert(0, r)
        else:
            self._prefilling.remove(v)
            self._alloc.release(v.lane)
            self._queue.insert(0, v.req)
            self.stats.cached_prompt_tokens -= v.counted_cached

    def _under_pressure(self, alive: Callable[[], bool],
                        op: Callable[[], None]) -> bool:
        """Run an allocator op that may raise OutOfBlocks, preempting and
        retrying until it succeeds.  False if the op's own request was
        preempted."""
        while True:
            if not alive():
                return False
            try:
                op()
                return True
            except OutOfBlocks:
                victim = self._select_victim()
                assert victim is not None, "OutOfBlocks with no live request"
                self._preempt(victim)

    def _grow_for_writes(self, lane: int, lo: int, hi: int,
                         alive: Callable[[], bool]) -> bool:
        """Grow ``lane`` to ``hi`` tokens and run the copy-on-write barrier
        over positions [lo, hi).  False if the lane was preempted."""
        if not self._under_pressure(
                alive, lambda: self._alloc.grow(lane, hi)):
            return False
        bs = self._alloc.block_size
        for idx in range(lo // bs, (hi - 1) // bs + 1):
            moved: List[Tuple[int, int]] = []

            def cow(idx=idx, moved=moved):
                mv = self._alloc.ensure_writable(lane, idx * bs)
                if mv is not None:
                    moved.append(mv)

            if not self._under_pressure(alive, cow):
                return False
            for src, dst in moved:
                self._copy_block(src, dst)
        return True

    def _note_peak(self) -> None:
        self.stats.kv_block_bytes = self.kv_block_bytes
        self.stats.peak_live_blocks = max(self.stats.peak_live_blocks,
                                          self._alloc.live_blocks)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write payload copy (all layers of one block)."""
        self._cache = M.copy_cache_block(self._cache, src, dst)

    # -- admission / prefill -------------------------------------------------
    def _admit(self) -> None:
        """Move queued requests onto free lanes when the store can cover
        the uncached prompt tail plus one decode block RIGHT NOW."""
        owned = {s.lane for s in self._prefilling}
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in owned]
        while self._queue and free:
            r = self._queue[0]
            eff_len = len(r.prompt) + len(r.output)
            digests = self._prompt_digests(r) if self.prefix_cache else []
            cached_blocks, pooled = self._alloc.match_digests(
                digests, max_cached_tokens=self._prefix + eff_len - 1,
                min_cached_tokens=self._prefix)
            need_now = self._alloc.blocks_for(
                self._prefix + eff_len + 1) - cached_blocks
            if need_now > self._alloc.available - pooled:
                break  # FIFO: wait for blocks rather than starve the head
            lane = free.pop(0)
            eff = self._effective_prompt(r)
            cached_len = self._alloc.admit(
                lane, digests=digests if self.prefix_cache else None,
                max_cached_tokens=self._prefix + eff_len - 1,
                min_cached_tokens=self._prefix, seed=r.chain_seed)
            self._digest_cache.pop(r.uid, None)
            consumed = max(0, cached_len - self._prefix)
            self.stats.cached_prompt_tokens += consumed
            self._prefilling.append(_Prefilling(
                r, lane, self._remaining_budget(r), eff,
                consumed=consumed, cached_len=cached_len,
                counted_cached=consumed))
            self._queue.pop(0)
            self.stats.admissions += 1

    def _prefill_step(self) -> None:
        """Run ONE prefill chunk for the current admission cohort."""
        if not self._prefilling:
            return

        def _first(s: _Prefilling) -> bool:
            return s.consumed == 0 and s.cached_len == 0

        first = _first(self._prefilling[0])
        cohort = [s for s in self._prefilling if _first(s) == first]
        cap = self.prefill_chunk or self.max_len

        # Grow every member's blocks BEFORE assembling the batch: growth
        # can preempt cohort members, which drops them from this chunk.
        ready: List[Tuple[_Prefilling, int]] = []
        for s in cohort:
            if s not in self._prefilling:
                continue
            take = min(cap, len(s.tokens) - s.consumed)
            lo = self._prefix + s.consumed
            if self._grow_for_writes(
                    s.lane, lo, lo + take,
                    alive=lambda s=s: s in self._prefilling):
                ready.append((s, take))
        ready = [(s, t) for (s, t) in ready if s in self._prefilling]
        self._note_peak()
        if not ready:
            return
        cohort, takes = [s for s, _ in ready], [t for _, t in ready]
        P = _bucket(max(takes), cap)
        n = len(cohort)
        tokens = np.full((n, P), self.pad_id, np.int32)
        lengths = np.empty(n, np.int32)
        starts = np.empty(n, np.int32)
        for j, (s, take) in enumerate(zip(cohort, takes)):
            tokens[j, P - take:] = s.tokens[s.consumed:s.consumed + take]
            lengths[j] = take
            starts[j] = self._prefix + s.consumed
        dev = self.device
        tables = torch.from_numpy(
            self._alloc.block_table()[[s.lane for s in cohort]]).to(dev)

        t0 = time.perf_counter()
        patches = None
        if first and self.cfg.family == "vlm":
            patches = self._patch_batch([s.req for s in cohort])
        logits_new, self._cache = self._model(
            M.prefill_slots, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev), tables,
            start=None if first else torch.from_numpy(starts).to(dev),
            patch_embeds=patches, **self._lanes([s.lane for s in cohort]))

        done_rows, done = [], []
        for j, (s, take) in enumerate(zip(cohort, takes)):
            s.consumed += take
            if self.prefix_cache:
                self._alloc.commit_full(s.lane, self._content_ids(s.req))
            if s.consumed == len(s.tokens):
                done_rows.append(j)
                done.append(s)
                self._slot_req[s.lane] = s.req
                self._prefilling.remove(s)
        if done:
            rows = torch.tensor(done_rows, device=dev)
            lanes = torch.tensor([s.lane for s in done], device=dev)
            self._logits[lanes] = logits_new[rows]
            self._pos[lanes] = torch.tensor(
                [len(s.tokens) for s in done], dtype=torch.int32, device=dev)
            self._active[lanes] = True
            self._budget[lanes] = torch.tensor(
                [s.budget for s in done], dtype=torch.int32, device=dev)
            self._keys[lanes] = request_keys(
                self.seed, torch.tensor([s.req.uid for s in done],
                                        device=dev))
            for s in done:
                self._host_active[s.lane] = True
                self._host_pos[s.lane] = len(s.tokens)
                self._host_rem[s.lane] = s.budget
        synchronize(dev)
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_tokens += int(sum(takes))
        self.stats.prefill_chunks += 1

    def _patch_batch(self, reqs: List[Request]) -> torch.Tensor:
        """The requests' images as one (n, num_patches, d_model) batch on
        the device, zeros for a request without one, cast to bf16 before
        the projection, as in the reference."""
        cfg = self.cfg
        pe = np.zeros((len(reqs), cfg.num_patches, cfg.d_model), np.float32)
        for j, r in enumerate(reqs):
            if r.patch_embeds is not None:
                pe[j] = r.patch_embeds
        return torch.from_numpy(pe).to(self.device, torch.bfloat16)

    # -- wave path -----------------------------------------------------------
    def _run_waves(self) -> Dict[int, List[int]]:
        """Lockstep wave batching, bucketed by exact prompt length (padding
        would let real tokens attend to pads without the masked-prefill
        machinery of the continuous path)."""
        results: Dict[int, List[int]] = {uid: toks
                                         for uid, toks in self._instant}
        self._instant = []
        by_len: Dict[int, List[Request]] = {}
        for r in self._queue:
            by_len.setdefault(len(r.prompt), []).append(r)
        self._queue = []
        for _, reqs in sorted(by_len.items()):
            for i in range(0, len(reqs), self.max_batch):
                wave = reqs[i: i + self.max_batch]
                self._run_wave(wave)
                for r in wave:
                    results[r.uid] = r.output
        return results

    def _run_wave(self, wave: List[Request]) -> None:
        """Prefill one same-length wave into dense caches (placed on the
        mesh when there is one), then decode it in lockstep until every
        member hit its budget or EOS.  The token
        at position p of request uid samples with the positional key of
        (seed, uid, p), as on the continuous path."""
        cfg, dev = self.cfg, self.device
        B = len(wave)
        S = len(wave[0].prompt)  # waves are same-length by construction
        batch = {"tokens": torch.from_numpy(
            np.stack([r.prompt for r in wave]).astype(np.int32)).to(dev)}

        if cfg.family == "vlm":
            batch["patch_embeds"] = self._patch_batch(wave)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (B, cfg.encdec.encoder_seq_len, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        logits, cache = self._call(M.prefill, batch, self.max_len)
        synchronize(dev)
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_tokens += B * S
        self.stats.admissions += B

        max_new = min(max(r.max_new_tokens for r in wave), self.max_len - S)
        keys = request_keys(self.seed, torch.tensor([r.uid for r in wave],
                                                    device=dev))
        done = np.zeros(B, bool)
        t0 = time.perf_counter()
        for step in range(max_new):
            self.stats.decode_steps += 1
            self.stats.occupied_slot_steps += int((~done).sum())
            self.stats.slot_steps += self.max_batch
            pos = torch.full((B,), S + step, dtype=torch.int32, device=dev)
            next_tok = sample(self.sampler, logits.reshape(B, -1),
                              positional_keys(keys, pos))
            nt = next_tok.cpu().numpy()
            now = time.perf_counter()
            for i, r in enumerate(wave):
                if not done[i] and len(r.output) < r.max_new_tokens:
                    r.output.append(int(nt[i]))
                    if self.on_token is not None:
                        self.on_token(r.uid, int(nt[i]))
                    self._note_tokens(r.uid, 1, now)
                    self.stats.generated_tokens += 1
                    if nt[i] == self.eos_id:
                        done[i] = True
                if len(r.output) >= r.max_new_tokens:
                    done[i] = True
            if done.all():
                break
            # One position a wave: the wave's rows share their length.
            logits, cache = self._call(M.decode_step, cache,
                                       next_tok[:, None], pos[0])
            logits = logits[:, 0]
        synchronize(dev)
        self.stats.decode_s += time.perf_counter() - t0
        for r in wave:
            self._last_obs_t.pop(r.uid, None)
