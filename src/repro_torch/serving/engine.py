"""Serving engine: continuous batching over a ref-counted paged KV cache,
and the lockstep wave path.

Port of ``repro.serving.engine`` for the dense family, both modes.  The
continuous path's host-side scheduler is the reference's, line for line:

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
  * the pool is bf16 or SCLAD-compressed (``kv_dtype="int8"/"fp8"``:
    payload plus fp32 scales, about half the bytes per block, so more
    blocks and concurrent lanes in the same memory);
  * both paged attention hot paths go through the hand-written kernels
    (``attn_kernel``: "auto" = kernels on the card, plain versions on the
    CPU; "on" = kernels; "off" = plain versions).

``mode="wave"`` (``_run_waves``) is the reference's lockstep baseline:
requests grouped by exact prompt length, each wave prefilled in one pass
into dense (L, B, max_len, Hk, D) stripes (``model.prefill``) and decoded
together through the dense flash-decode kernel until every member is
done.  ``mode="auto"`` picks continuous for the attention families, as
the reference does.

Device state (pool, logits, positions, active mask, budgets, sampling
keys) is updated in place.  Sampling keys are POSITIONAL (see
``serving.sampler``): a request's token at position p depends on (seed,
uid, p) only, so outputs do not depend on co-tenants or preemption.

Outside the port so far the engine raises ``NotImplementedError``:
speculative decoding, meshes, ``kv_dtype="f8"`` and non-dense families.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.flash_decode.ops import ATTN_KERNEL_MODES
from repro_torch.models import model as M
from repro_torch.serving.paged import (BlockStore, OutOfBlocks, TRASH_BLOCK,
                                       chain_hashes, chain_root_for)
from repro_torch.serving.sampler import (SamplerConfig, positional_keys,
                                         request_keys, sample)

#: Victim-selection policies for pool-pressure preemption.
PREEMPT_POLICIES = ("youngest", "largest", "deadline")


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
    cached_len: int = 0
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
    #: Speculative decoding counters (the port does not speculate yet).
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
                 spec_decode: str = "off", device: DeviceLike = None):
        """The reference engine's knobs (see its docstrings), plus
        ``device``: the card by default, ``"cpu"`` on request; ``params``
        must already live there.  Raises ``NotImplementedError`` for what
        the port does not serve yet."""
        if decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"preempt_policy {preempt_policy!r} not in "
                f"{PREEMPT_POLICIES}")
        if spec_decode != "off":
            raise NotImplementedError("speculative decoding is not ported")
        if mesh is not None:
            raise NotImplementedError("tensor-parallel meshes are not ported")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port serves the dense family")
        if mode == "auto":  # as in the reference, for the attention families
            mode = "continuous"
        if mode not in ("continuous", "wave"):
            raise ValueError(f"mode {mode!r} not in ('auto', 'continuous', "
                             f"'wave')")
        if attn_kernel is not None:
            if attn_kernel not in ATTN_KERNEL_MODES:
                raise ValueError(
                    f"attn_kernel {attn_kernel!r} not in {ATTN_KERNEL_MODES}")
            cfg = dc_replace(cfg, attn_kernel=attn_kernel)
        if kv_dtype is not None:
            cfg = dc_replace(cfg, kv_dtype=kv_dtype)
        M.check_kv_dtype(cfg)
        self.mode = mode
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        self._chain_root = chain_root_for(cfg.kv_dtype)
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
        self.params = params
        if mode == "continuous":
            self._init_continuous()

    # -- public API ----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               deadline: Optional[float] = None) -> int:
        """Queue a request; ``deadline`` feeds preempt_policy="deadline"."""
        if self.poisoned:
            raise RuntimeError(
                "engine is poisoned: an earlier step() failure left the "
                "block store inconsistent; build a fresh engine")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no decode room in a "
                f"{self.max_len}-token cache")
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
        self._queue.append(Request(uid, prompt, max_new_tokens,
                                   deadline=deadline))
        return uid

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

        K = self.decode_steps
        # Hand each about-to-decode lane the blocks its next (up to K)
        # tokens land in; pool pressure preempts (possibly the lane itself).
        for i in np.nonzero(self._host_active)[0]:
            i = int(i)
            if not self._host_active[i]:
                continue  # preempted while an earlier lane grew
            steps_i = min(K, int(self._host_rem[i]))
            lo = int(self._host_pos[i])
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
            pos_before = int(self._host_pos[i])
            alive, emitted = True, 0
            for j in range(K):
                if not alive:
                    break
                tok = int(tok_h[j, i])
                r.output.append(tok)
                emitted += 1
                self._host_pos[i] += 1
                self._host_rem[i] -= 1
                self.stats.generated_tokens += 1
                self.stats.occupied_slot_steps += 1
                alive = bool(active_h[j, i])
            self._note_tokens(r.uid, emitted, now)
            if self.prefix_cache and \
                    int(self._host_pos[i]) // bs != pos_before // bs:
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
            logits, self._cache = M.decode_step(
                cfg, self.params, self._cache, tok[:, None], self._pos,
                active=active, block_tables=tbl)
            self._logits = logits[:, 0]
            self._pos += active.to(torch.int32)
            self._active = active & ~retire
            toks.append(tok)
            actives.append(self._active.to(torch.int32))
        return torch.stack([torch.stack(toks), torch.stack(actives)]) \
            .cpu().numpy()

    def has_pending_work(self) -> bool:
        """True while ``step()`` (or ``run()``) can make progress."""
        if self.mode != "continuous":
            return bool(self._queue or self._instant)
        return bool(self._queue or self._prefilling or self._instant
                    or self._host_active.any())

    def match_cached_blocks(self, prompt) -> int:
        """How many leading blocks of ``prompt`` the prefix cache could
        serve RIGHT NOW, without touching any state (0 with caching off
        or in wave mode)."""
        if self.mode != "continuous" or not self.prefix_cache:
            return 0
        digests = chain_hashes(np.asarray(prompt, np.int64),
                               self._alloc.block_size,
                               seed=self._chain_root)
        return self._alloc.match_digests(
            digests, max_cached_tokens=len(prompt) - 1)[0]

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
        table_width = -(-self.max_len // bs)
        if self.num_blocks is None:
            self.num_blocks = B * table_width
        self._alloc = BlockStore(self.num_blocks, bs, B, table_width,
                                 prefix_cache=self.prefix_cache,
                                 kv_dtype=cfg.kv_dtype)
        # +1 device block: id 0 is the dead-lane trash sink.  Raises for
        # the families and pool encodings the port does not serve yet.
        self._cache = M.init_paged_cache(cfg, self.num_blocks + 1, bs,
                                         device=dev)
        # Device bytes per pool block, all layers, K+V, over every leaf
        # (axis 1 is blocks for payload and scale leaves alike): a SCLAD
        # pool's figure is its payload plus its fp32 scales.
        self.kv_block_bytes = sum(
            x[:, 0].numel() * x.element_size() for x in self._cache.values())
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

    def _clamped_budget(self, prompt, max_new_tokens: int) -> int:
        """Decode budget clamped so the sequence fits ``max_len``."""
        return min(max_new_tokens, self.max_len - len(prompt))

    def _worst_case_tokens(self, prompt, max_new_tokens: int) -> int:
        return len(prompt) + self._clamped_budget(prompt, max_new_tokens)

    def _effective_prompt(self, r: Request) -> np.ndarray:
        """The original prompt plus any tokens generated before a
        preemption (recompute replays them)."""
        if not r.output:
            return r.prompt
        return np.concatenate([r.prompt, np.asarray(r.output, np.int32)])

    def _content_ids(self, r: Request) -> np.ndarray:
        """Token ids at each cache position, for the prefix-cache chain."""
        return np.concatenate([np.asarray(r.prompt, np.int64),
                               np.asarray(r.output, np.int64)])

    def _remaining_budget(self, r: Request) -> int:
        return self._clamped_budget(r.prompt, r.max_new_tokens) \
            - len(r.output)

    def _prompt_digests(self, r: Request) -> List[bytes]:
        """Chain digests of the request's content, cached by length."""
        n = len(r.prompt) + len(r.output)
        hit = self._digest_cache.get(r.uid)
        if hit is not None and hit[0] == n:
            return hit[1]
        digests = chain_hashes(self._content_ids(r), self._alloc.block_size,
                               seed=self._chain_root)
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
                digests, max_cached_tokens=eff_len - 1)
            need_now = self._alloc.blocks_for(eff_len + 1) - cached_blocks
            if need_now > self._alloc.available - pooled:
                break  # FIFO: wait for blocks rather than starve the head
            lane = free.pop(0)
            eff = self._effective_prompt(r)
            cached_len = self._alloc.admit(
                lane, digests=digests if self.prefix_cache else None,
                max_cached_tokens=eff_len - 1, seed=self._chain_root)
            self._digest_cache.pop(r.uid, None)
            self.stats.cached_prompt_tokens += cached_len
            self._prefilling.append(_Prefilling(
                r, lane, self._remaining_budget(r), eff,
                consumed=cached_len, cached_len=cached_len,
                counted_cached=cached_len))
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
            lo = s.consumed
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
            starts[j] = s.consumed
        dev = self.device
        tables = torch.from_numpy(
            self._alloc.block_table()[[s.lane for s in cohort]]).to(dev)

        t0 = time.perf_counter()
        logits_new, self._cache = M.prefill_slots(
            self.cfg, self.params, self._cache,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev), tables,
            start=None if first else torch.from_numpy(starts).to(dev))

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
        """Prefill one same-length wave into dense stripes, then decode it
        in lockstep until every member hit its budget or EOS.  The token
        at position p of request uid samples with the positional key of
        (seed, uid, p), as on the continuous path."""
        cfg, dev = self.cfg, self.device
        B = len(wave)
        S = len(wave[0].prompt)  # waves are same-length by construction
        toks = torch.from_numpy(
            np.stack([r.prompt for r in wave]).astype(np.int32)).to(dev)

        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, self.params, {"tokens": toks},
                                  self.max_len)
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
                    self._note_tokens(r.uid, 1, now)
                    self.stats.generated_tokens += 1
                    if nt[i] == self.eos_id:
                        done[i] = True
                if len(r.output) >= r.max_new_tokens:
                    done[i] = True
            if done.all():
                break
            logits, cache = M.decode_step(cfg, self.params, cache,
                                          next_tok[:, None], pos)
            logits = logits[:, 0]
        synchronize(dev)
        self.stats.decode_s += time.perf_counter() - t0
        for r in wave:
            self._last_obs_t.pop(r.uid, None)
