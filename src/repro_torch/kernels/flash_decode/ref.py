"""Plain PyTorch versions of paged and dense decode attention.

Twins of ``repro.kernels.flash_decode.ref`` (fp pool branch), with the
same arithmetic: a compute-dtype score einsum, an fp32 masked softmax
with ``-1e30`` at masked positions (an exact 0 after the max
subtraction, so results do not depend on how much dead padding the
cache carries), and a compute-dtype probs @ V.  They are the CPU path,
the ``attn_kernel="off"`` path, and what the CUDA kernel is held against
on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, lengths):
    """q: (B, H, D); caches: (B, S, Hk, D); lengths: int or (B,) valid
    positions per row -> (B, H, D) in q.dtype."""
    B, H, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hk
    lens = torch.as_tensor(lengths, dtype=torch.int32,
                           device=q.device).reshape(-1).expand(B)
    qg = q.reshape(B, 1, Hk, rep, D)
    k = k_cache.to(q.dtype)
    v = v_cache.to(q.dtype)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
    scores = scores / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None] < lens[:, None]  # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(B, H, D)


def paged_decode_ref(q, k_pool, v_pool, lengths, block_tables):
    """Gather version of the paged kernel: resolve each lane's block table
    into a dense per-lane cache copy, then run ``decode_ref``.

    q: (B, H, D); pools: (N, bs, Hk, D); lengths: (B,) int32;
    block_tables: (B, T) int32.  This materializes the (B, T*bs, Hk, D)
    copy the kernel exists to avoid — the correctness reference, not the
    hot path.
    """
    B = q.shape[0]
    Hk, D = k_pool.shape[2], k_pool.shape[3]
    tables = block_tables.long()
    kc = k_pool[tables].reshape(B, -1, Hk, D)
    vc = v_pool[tables].reshape(B, -1, Hk, D)
    return decode_ref(q, kc, vc, lengths)
