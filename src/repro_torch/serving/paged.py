"""Paged KV-cache block store (host side): ref-counts, prefix cache, LRU pool.

The port's own copy of ``repro.serving.paged`` (numpy only, unchanged in
behaviour), so the port shares no module with the reference package.

A plain free list with *worst-case reservation* (every request reserving
``ceil((prompt + budget) / block_size)`` blocks at admission) is safe but
doubly conservative for the paper's SRAM-only CC-MEM design (§4.2, Fig
6/8), where on-chip KV capacity is the scarcest resource priced into
TCO/token: requests sharing a prompt prefix each pay for their own copy of
identical KV blocks, and the decode budget is reserved up front even
though most requests stop at EOS long before it.

This module is instead a **ref-counted block store**:

  * every live block carries a reference count — multiple lanes may map the
    same block through their block tables (read-only sharing);
  * full blocks are content-addressed by a **hash chain** over their token
    ids (sha256 of ``parent_digest || token_bytes``, so a block's identity
    commits to its entire prefix, not just its own tokens).  A prefix index
    maps chain digests to live blocks; ``admit`` walks a new request's chain
    and starts the lane with every already-resident prefix block, so prefill
    only runs the uncached tail;
  * blocks whose refcount drops to zero but whose content is registered are
    *retired into an LRU pool* instead of being blanked: a later request with
    the same prefix revives them (an "LRU hit"), and allocation evicts the
    oldest pooled block only when the true free list is empty;
  * a lane that must write into a block another lane can read goes
    **copy-on-write** via ``ensure_writable`` (the store swaps in a fresh
    block; the caller copies the device payload), so sharing is never
    observable through the attention gather;
  * there is **no reservation**: ``grow`` hands out blocks lazily and raises
    ``OutOfBlocks`` when both the free list and the pool are dry.  The
    serving engine reacts by *preempting* the youngest request (release its
    blocks, re-queue it for recompute) — vLLM-style optimistic admission.

Block id 0 (``TRASH_BLOCK``) is never handed out: the device scatter for
retired/padded lanes is redirected there, so a freed block can be re-assigned
to another lane without any risk of a stale lane clobbering it.

Invariants (pinned by ``tests/test_paged_kv.py``): refcounts never go
negative; a block reaches the free list iff its refcount is zero AND it is
not in (or has left) the LRU pool; the prefix index and per-block hash map
stay a bijection; copy-on-write never hands back a block any other lane can
reach.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.layers import TRASH_BLOCK


class OutOfBlocks(RuntimeError):
    """The free list and the LRU pool are both empty.

    Raised by ``grow`` / ``ensure_writable`` under optimistic admission;
    the engine preempts a request and retries.
    """


CHAIN_ROOT = b"kv-chain-root"
_CHAIN_ROOT = CHAIN_ROOT  # back-compat alias


def chain_root_for(kv_dtype: str = "fp") -> bytes:
    """The store's chain-root seed for a given pool representation.

    A block's compressed payload is a pure function of (token ids, chain
    root, kv_dtype) — the SCLAD quantizers are path-independent — so the
    kv_dtype must be part of the content address: two stores serving the
    same tokens under different ``kv_dtype`` hold different pool bytes and
    must never hash-match each other's blocks (e.g. through a snapshot or
    a shared host-side index).  fp-family spellings ("fp"/"bf16"/"f8")
    keep the historic root so existing digests stay valid.
    """
    if kv_dtype in ("int8", "fp8"):
        return hashlib.sha256(
            CHAIN_ROOT + b"|kv:" + kv_dtype.encode()).digest()
    return CHAIN_ROOT


def chain_hashes(content: Sequence[int], block_size: int,
                 prefix: Sequence[bytes] = (),
                 seed: bytes = CHAIN_ROOT) -> List[bytes]:
    """Digest per FULL block of ``content``: sha256(parent || tokens).

    The chain makes a block's identity commit to its whole prefix — two
    requests share block ``i`` only if they agree on every token up to and
    including block ``i``, which is exactly the prefix-cache safety
    condition for causal attention.

    ``prefix``: already-computed digests for the leading blocks — they are
    reused verbatim and only the remaining blocks are hashed (the
    incremental path ``commit_full`` uses so per-token decode cost stays
    O(1) amortized instead of re-hashing the whole sequence).

    ``seed``: the chain root.  Token ids alone don't always determine the
    cached K/V — a vlm request's patch prefix depends on its IMAGE, which
    the engine folds in here as a per-request patch-embedding digest, so
    two requests with identical token ids but different images can never
    share blocks.
    """
    n_full = len(content) // block_size
    out: List[bytes] = list(prefix[:n_full])
    prev = out[-1] if out else seed
    for i in range(len(out), n_full):
        blk = np.asarray(content[i * block_size:(i + 1) * block_size],
                         np.int64)
        prev = hashlib.sha256(prev + blk.tobytes()).digest()
        out.append(prev)
    return out


class BlockStore:
    """Ref-counted store of fixed-size KV token blocks over ``num_slots``
    decode lanes, with content-hash prefix sharing and an LRU retired pool.

    num_blocks:  usable pool size (ids ``1..num_blocks``; id 0 is trash).
    block_size:  tokens per block.
    num_slots:   decode lanes (rows of the block table).
    max_blocks_per_slot: width of the per-lane block table (the per-request
        context cap in blocks).
    prefix_cache: when False, no hashing/registration happens — the store
        degenerates to the plain lazy allocator (every block exclusive,
        released blocks go straight back to the free list).
    kv_dtype: the device pool's representation ("fp" family or the SCLAD
        "int8"/"fp8" compressed layouts).  Only used to derive the store's
        default chain root (``chain_root_for``): quantized pools hold
        different bytes per token than fp pools, so their content hashes
        live in a disjoint namespace and can never cross-match.
    """

    def __init__(self, num_blocks: int, block_size: int, num_slots: int,
                 max_blocks_per_slot: int, prefix_cache: bool = True,
                 kv_dtype: str = "fp"):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_slots = num_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.prefix_cache = prefix_cache
        self.kv_dtype = kv_dtype
        self.chain_root = chain_root_for(kv_dtype)
        # LIFO free list: recently-freed blocks are reused first, which keeps
        # the working set of device pages small.
        self._free: List[int] = list(range(num_blocks, 0, -1))
        #: retired-but-reusable blocks, oldest first: block -> chain digest.
        self._pool: "OrderedDict[int, bytes]" = OrderedDict()
        self._ref: Dict[int, int] = {}  # live block -> number of owning lanes
        self._hash: Dict[int, bytes] = {}  # registered block -> chain digest
        self._index: Dict[bytes, int] = {}  # chain digest -> block
        self._blocks: Dict[int, List[int]] = {}  # slot -> block ids, in order
        self._len: Dict[int, int] = {}  # slot -> grown sequence length
        #: slot -> chain digests computed so far (cache for commit_full:
        #: decode extends the chain incrementally instead of re-hashing
        #: the sequence from position 0 every window).
        self._chain: Dict[int, List[bytes]] = {}
        #: slot -> chain-root seed (per-request for vlm patch digests).
        self._seed: Dict[int, bytes] = {}
        self._table = np.zeros((num_slots, max_blocks_per_slot), np.int32)
        # Counters for EngineStats / benchmarks.
        self.hit_blocks = 0    # blocks reused through the prefix index
        self.lru_hits = 0      # of those, revived from the retired pool
        self.evictions = 0     # pooled blocks blanked to satisfy allocation
        self.cow_copies = 0    # copy-on-write block swaps

    # -- queries -------------------------------------------------------------
    @property
    def num_free(self) -> int:
        """Blocks that are blank (hold no reusable content)."""
        return len(self._free)

    @property
    def available(self) -> int:
        """Blocks obtainable by allocation: blank + evictable (LRU pool)."""
        return len(self._free) + len(self._pool)

    @property
    def live_blocks(self) -> int:
        """Blocks referenced by at least one lane (shared blocks count
        once — this is device-memory occupancy, not logical tokens)."""
        return self.num_blocks - self.available

    @property
    def pooled_blocks(self) -> int:
        return len(self._pool)

    @property
    def live_tokens(self) -> int:
        """LOGICAL tokens cached across lanes (sum of per-lane lengths).
        With prefix sharing this can exceed ``live_blocks * block_size`` —
        the gap is exactly the memory sharing saves."""
        return sum(self._len.values())

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def seq_len(self, slot: int) -> int:
        return self._len.get(slot, 0)

    def owned_blocks(self, slot: int) -> int:
        """Blocks currently referenced by the slot (shared ones included) —
        what a preemption of this slot can drop references to."""
        return len(self._blocks.get(slot, ()))

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def block_table(self) -> np.ndarray:
        """(num_slots, max_blocks_per_slot) int32; unallocated entries are
        TRASH_BLOCK.  Returns the live array — callers must not mutate it."""
        return self._table

    def match_prefix(self, content: Sequence[int],
                     max_cached_tokens: Optional[int] = None,
                     min_cached_tokens: int = 0,
                     seed: Optional[bytes] = None) -> int:
        """Number of leading FULL blocks of ``content`` resident in the
        store (live or pooled), after the caps admission applies:

        max_cached_tokens: never match past this many tokens (the engine
            caps at ``len(content) - 1`` so at least one token is always
            recomputed — decode needs the last-token logits);
        min_cached_tokens: an all-or-nothing floor (the vlm patch prefix
            cannot be *partially* cached — its embedding is only computed
            on a from-scratch first chunk).
        """
        if not self.prefix_cache:
            return 0
        seed = self.chain_root if seed is None else seed
        return self._match(chain_hashes(content, self.block_size, seed=seed),
                           max_cached_tokens, min_cached_tokens)

    def match_digests(self, digests: Sequence[bytes],
                      max_cached_tokens: Optional[int] = None,
                      min_cached_tokens: int = 0) -> Tuple[int, int]:
        """Like ``match_prefix`` but over precomputed chain digests, and
        also reports how many of the matched blocks currently sit in the
        LRU pool.  Admission policy needs that split: pooled blocks count
        toward ``available`` until the match revives them, so a gate that
        credits them as cached must NOT also count them as allocatable."""
        if not self.prefix_cache:
            return 0, 0
        n = self._match(digests, max_cached_tokens, min_cached_tokens)
        pooled = sum(1 for h in digests[:n] if self._index[h] in self._pool)
        return n, pooled

    def _match(self, digests: Sequence[bytes],
               max_cached_tokens: Optional[int],
               min_cached_tokens: int) -> int:
        n = 0
        for h in digests:
            if h not in self._index:
                break
            n += 1
        if max_cached_tokens is not None:
            n = min(n, max_cached_tokens // self.block_size)
        n = min(n, self.max_blocks_per_slot)
        if n * self.block_size < min_cached_tokens:
            n = 0
        return n

    # -- lifecycle -----------------------------------------------------------
    def admit(self, slot: int, content: Optional[Sequence[int]] = None,
              max_cached_tokens: Optional[int] = None,
              min_cached_tokens: int = 0,
              digests: Optional[Sequence[bytes]] = None,
              seed: Optional[bytes] = None) -> int:
        """Open a lane; start it with every cached prefix block of
        ``content`` (token ids, from cache position 0).  Takes a reference
        on each matched block — pooled blocks are revived, live ones are
        shared.  Returns the cached length in tokens (0 when nothing
        matched, caching is off, or no content was given).

        ``digests``: precomputed ``chain_hashes`` of the content — pass it
        when the caller already hashed for its admission policy, so the
        prompt is hashed once per admission, not twice.

        ``seed``: the lane's chain-root seed (see ``chain_hashes``) —
        remembered for the lane's own ``commit_full`` registrations, so a
        request's blocks are only ever matchable by requests with the SAME
        seed (e.g. the same vlm patch-embedding digest).

        There is NO capacity reservation: admission policy (how much room
        must be available before admitting) is the caller's job.
        """
        if slot in self._blocks:
            raise ValueError(f"slot {slot} already admitted")
        seed = self.chain_root if seed is None else seed
        self._blocks[slot] = []
        self._len[slot] = 0
        self._chain[slot] = []
        self._seed[slot] = seed
        if (content is None and digests is None) or not self.prefix_cache:
            return 0
        if digests is None:
            digests = chain_hashes(content, self.block_size, seed=seed)
        else:
            digests = list(digests)
        n = self._match(digests, max_cached_tokens, min_cached_tokens)
        self._chain[slot] = digests[:n]  # seed the incremental chain cache
        owned = self._blocks[slot]
        for h in digests[:n]:
            b = self._index[h]
            if b in self._pool:  # revive: retired donor, same prefix
                del self._pool[b]
                self._ref[b] = 1
                self.lru_hits += 1
            else:
                self._ref[b] += 1
            self._table[slot, len(owned)] = b
            owned.append(b)
            self.hit_blocks += 1
        self._len[slot] = n * self.block_size
        return self._len[slot]

    def _take_block(self) -> int:
        """A writable blank block: free list first, else evict the LRU
        pooled block (its cached content is lost to the prefix index)."""
        if self._free:
            return self._free.pop()
        if self._pool:
            b, h = self._pool.popitem(last=False)  # oldest retiree
            del self._index[h]
            del self._hash[b]
            self.evictions += 1
            return b
        raise OutOfBlocks(
            f"all {self.num_blocks} blocks are referenced by live lanes")

    def grow(self, slot: int, seq_len: int) -> List[int]:
        """Extend ``slot`` to hold ``seq_len`` tokens; returns the newly
        assigned block ids (possibly empty).  With no reservation this MAY
        raise ``OutOfBlocks`` — the engine preempts and retries.  On a
        partial failure the blocks already assigned stay with the lane (and
        ``seq_len`` is rounded down to what they cover), so a retry after
        preemption continues where it left off."""
        if slot not in self._blocks:
            raise ValueError(f"slot {slot} not admitted")
        if seq_len < self._len[slot]:
            raise ValueError(
                f"slot {slot} cannot shrink ({self._len[slot]} -> {seq_len})")
        need = self.blocks_for(seq_len)
        if need > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot} needs {need} blocks; the block table is "
                f"{self.max_blocks_per_slot} wide")
        owned = self._blocks[slot]
        new: List[int] = []
        while len(owned) < need:
            try:
                b = self._take_block()
            except OutOfBlocks:
                self._len[slot] = max(self._len[slot],
                                      min(seq_len,
                                          len(owned) * self.block_size))
                raise
            self._ref[b] = 1
            self._table[slot, len(owned)] = b
            owned.append(b)
            new.append(b)
        self._len[slot] = seq_len
        return new

    def ensure_writable(self, slot: int, pos: int) -> Optional[Tuple[int, int]]:
        """Write barrier for cache position ``pos`` of ``slot``.

        If the covering block is shared (refcount > 1) it is swapped for a
        fresh exclusive block — **copy-on-write**: returns ``(src, dst)``
        and the caller must copy the device payload ``src -> dst`` before
        writing.  May raise ``OutOfBlocks``.  If the block is exclusive,
        returns None; a registered exclusive block is unregistered first
        (its content is about to diverge from its digest)."""
        if slot not in self._blocks:
            raise ValueError(f"slot {slot} not admitted")
        idx = pos // self.block_size
        owned = self._blocks[slot]
        if idx >= len(owned):
            raise ValueError(
                f"slot {slot} position {pos} not grown (has "
                f"{len(owned)} blocks)")
        b = owned[idx]
        # The write may change content at positions >= pos, so any cached
        # chain digests from this block on are no longer trustworthy.
        # (Engine writes are append-only — logical content never changes —
        # but the store stays correct for arbitrary callers.)
        del self._chain[slot][idx:]
        if self._ref[b] > 1:
            nb = self._take_block()
            self._ref[b] -= 1
            self._ref[nb] = 1
            owned[idx] = nb
            self._table[slot, idx] = nb
            self.cow_copies += 1
            return (b, nb)
        self._unregister(b)
        return None

    def _unregister(self, block: int) -> None:
        """Drop ``block`` from the prefix index: its content no longer
        matches its digest (or is about to stop matching)."""
        h = self._hash.pop(block, None)
        if h is not None and self._index.get(h) == block:
            del self._index[h]

    def commit_full(self, slot: int, content: Sequence[int]) -> int:
        """Register the lane's full, written blocks in the prefix index.

        ``content`` are the token ids actually written (cache position
        order).  Only blocks both fully *grown into* and fully *covered by
        content* are eligible (a lane pre-grown for multi-step decode may
        own blocks beyond its written length).  Already-registered blocks
        and duplicate content (another block holds the same chain digest)
        are skipped.  Returns the number of newly registered blocks.
        """
        if not self.prefix_cache:
            return 0
        if slot not in self._blocks:
            raise ValueError(f"slot {slot} not admitted")
        owned = self._blocks[slot]
        n_full = min(self._len[slot], len(content)) // self.block_size
        # Incremental: digests before len(self._chain[slot]) are reused,
        # so a decode loop calling this every window hashes each block
        # once, not the whole sequence every token.
        chain = chain_hashes(content[:n_full * self.block_size],
                             self.block_size, prefix=self._chain[slot],
                             seed=self._seed[slot])
        self._chain[slot] = chain
        added = 0
        for i, h in enumerate(chain):
            b = owned[i]
            if b in self._hash or h in self._index:
                continue
            self._hash[b] = h
            self._index[h] = b
            added += 1
        return added

    def truncate(self, slot: int, new_len: int) -> List[int]:
        """Roll the lane back to ``new_len`` tokens — the speculative-decode
        rejection path: drafted K/V was written through the pool
        optimistically, the verifier rejected a suffix, and the lane's
        logical length rewinds.

        Safety rules (pinned in tests/test_paged_kv.py):

        * blocks past ``blocks_for(new_len)`` lose this lane's reference;
          at refcount zero they are unregistered and go to the FREE list,
          never the LRU pool — their tail bytes are untrusted, so a stale
          digest must not be able to revive them;
        * a now-partial boundary block that this lane owns exclusively is
          unregistered (its tail holds rolled-back bytes that a future
          write will replace, so its digest no longer binds);
        * a SHARED boundary block keeps its registration and is not
          touched: the lane can never have written it (the copy-on-write
          barrier in ``ensure_writable`` forbids it), so its content is
          still exactly its digest and every other owner stays intact;
        * cached chain digests from the first rolled-back block on are
          invalidated, so a later ``commit_full`` re-hashes the suffix the
          lane actually wrote instead of reviving the stale chain.

        Returns the block ids whose refcount reached zero (freed).
        """
        if slot not in self._blocks:
            raise ValueError(f"slot {slot} not admitted")
        if not 0 <= new_len <= self._len[slot]:
            raise ValueError(
                f"slot {slot} cannot truncate to {new_len} "
                f"(grown length {self._len[slot]})")
        keep = self.blocks_for(new_len)
        owned = self._blocks[slot]
        del self._chain[slot][new_len // self.block_size:]
        dropped: List[int] = []
        while len(owned) > keep:
            b = owned.pop()
            self._table[slot, len(owned)] = TRASH_BLOCK
            self._ref[b] -= 1
            assert self._ref[b] >= 0, f"block {b} refcount went negative"
            if self._ref[b] == 0:
                del self._ref[b]
                self._unregister(b)
                self._free.append(b)
                dropped.append(b)
        if new_len % self.block_size and keep:
            b = owned[keep - 1]
            if self._ref[b] == 1:
                self._unregister(b)
        self._len[slot] = new_len
        return dropped

    def release(self, slot: int) -> List[int]:
        """Retire a request: drop one reference from each of its blocks.
        Blocks that hit refcount zero either retire into the LRU pool
        (registered content stays matchable) or return to the free list
        (unregistered / partial blocks).  Shared blocks another lane still
        references stay live and are NOT returned.  Returns the block ids
        whose refcount reached zero."""
        if slot not in self._blocks:
            raise ValueError(f"slot {slot} not admitted")
        dropped: List[int] = []
        for b in self._blocks.pop(slot):
            self._ref[b] -= 1
            assert self._ref[b] >= 0, f"block {b} refcount went negative"
            if self._ref[b] == 0:
                del self._ref[b]
                h = self._hash.get(b)
                if h is not None:
                    self._pool[b] = h  # newest retiree at the MRU end
                else:
                    self._free.append(b)
                dropped.append(b)
        self._table[slot] = TRASH_BLOCK
        del self._len[slot]
        del self._chain[slot]
        del self._seed[slot]
        return dropped

    # -- invariants (exercised by tests/test_paged_kv.py) --------------------
    def check_invariants(self) -> None:
        counts: Dict[int, int] = {}
        for slot, blocks in self._blocks.items():
            assert len(blocks) == len(set(blocks)), \
                f"slot {slot} lists a block twice"
            for b in blocks:
                counts[b] = counts.get(b, 0) + 1
        live, free, pool = set(counts), set(self._free), set(self._pool)
        assert not live & free, "live block on the free list"
        assert not live & pool, "live block in the retired pool"
        assert not free & pool, "block both free and pooled"
        assert TRASH_BLOCK not in live | free | pool
        assert len(live) + len(free) + len(pool) == self.num_blocks, \
            "block leaked"
        assert set(self._ref) == live
        for b, n in counts.items():
            assert self._ref[b] == n, (
                f"block {b} refcount {self._ref[b]} != {n} owning lanes")
            assert n >= 1
        for b in pool:
            assert b in self._hash, "pooled block lost its registration"
            assert self._pool[b] == self._hash[b]
        for h, b in self._index.items():
            assert self._hash.get(b) == h, "index/hash maps diverged"
        for b, h in self._hash.items():
            assert self._index.get(h) == b, "hash map entry not indexed"
            assert b in live or b in pool
        assert set(self._chain) == set(self._blocks), "chain cache leaked"
        assert set(self._seed) == set(self._blocks), "seed map leaked"
        for slot, chain in self._chain.items():
            assert len(chain) <= len(self._blocks[slot])
        expect = sum(self.blocks_for(n) for n in self._len.values())
        total_owned = sum(len(b) for b in self._blocks.values())
        assert total_owned == expect, (
            f"owned blocks {total_owned} != sum(ceil(len/bs)) {expect}")
        for slot, blocks in self._blocks.items():
            row = self._table[slot]
            assert list(row[:len(blocks)]) == blocks
            assert (row[len(blocks):] == TRASH_BLOCK).all()


#: Back-compat alias of ``BlockStore`` (its older name), as the reference
#: keeps it.
BlockAllocator = BlockStore
