"""Plain PyTorch versions of paged and dense decode attention.

Twins of ``repro.kernels.flash_decode.ref``, with the same arithmetic: a
compute-dtype score einsum, an fp32 masked softmax with ``-1e30`` at
masked positions (an exact 0 after the max subtraction, so results do
not depend on how much dead padding the cache carries), and a
compute-dtype probs @ V; a SCLAD pool's payload is dequantized to the
compute dtype first.  They are the CPU path, the ``attn_kernel="off"``
path, and what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import kv_quant

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


def paged_decode_ref(q, k_pool, v_pool, lengths, block_tables,
                     kv_scales=None):
    """Gather version of the paged kernel: resolve each lane's block table
    into a dense per-lane cache copy, then run ``decode_ref``.

    q: (B, H, D); pools: (N, bs, Hk, D); lengths: (B,) int32;
    block_tables: (B, T) int32.  This materializes the (B, T*bs, Hk, D)
    copy the kernel exists to avoid — the correctness reference, not the
    hot path.

    kv_scales: (k_scale, v_scale) (N, bs, Hk) fp32 for a SCLAD pool (int8
    or fp8 payload): the gathered payload is dequantized to q.dtype
    (``kv_quant.dequantize``) before attention.
    """
    B = q.shape[0]
    Hk, D = k_pool.shape[2], k_pool.shape[3]
    tables = block_tables.long()
    kc = kv_quant.raw(k_pool)[tables].view(k_pool.dtype) \
        .reshape(B, -1, Hk, D)
    vc = kv_quant.raw(v_pool)[tables].view(v_pool.dtype) \
        .reshape(B, -1, Hk, D)
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        kc = kv_quant.dequantize(kc, k_scale[tables].reshape(B, -1, Hk),
                                 q.dtype)
        vc = kv_quant.dequantize(vc, v_scale[tables].reshape(B, -1, Hk),
                                 q.dtype)
    return decode_ref(q, kc, vc, lengths)
