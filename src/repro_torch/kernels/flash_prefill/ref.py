"""Plain PyTorch version of paged chunked-prefill attention + K/V scatter.

Twins of ``repro.kernels.flash_prefill.ref``, with the same arithmetic:

  * the cached-context gather ``k_pool[block_tables]`` materializing the
    dense (B, T*bs, Hk, D) per-lane copy the kernel exists to avoid;
  * the dense (B, S, S) causal/left-pad mask and its (B, S, T*bs) context
    extension;
  * a compute-dtype score einsum, an fp32 masked softmax (``-1e30`` at
    masked positions) and a compute-dtype probs @ V;
  * the left-compact roll + block-table scatter of the chunk's new-token
    K/V, with junk-tail entries dropped;
  * on a SCLAD pool (``kv_scales`` + ``kv_dtype``): the context payload
    dequantized on load, the chunk's own K/V fake-quantized before it is
    attended to, and the scatter writing quantized payload and scales;
  * on an f8 pool (float8_e4m3fn, no scales): the context cast to the
    compute dtype (exact), the chunk's own K/V attended to unrounded, and
    the scatter storing the K/V cast to float8_e4m3fn (``kv_quant.put``).

The pools (and scales) are updated IN PLACE and returned (the same
tensors), where the reference package returns new arrays.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import kv_quant

NEG_INF = -1e30


def prefill_attention_ref(q, k_new, v_new, k_pool, v_pool, lengths,
                          block_tables, start: Optional[torch.Tensor] = None,
                          prefix: int = 0, kv_scales=None,
                          kv_dtype: Optional[str] = None):
    """One layer of chunked-prefill attention against a paged KV pool.

    q:             (B, S, H, D) rotated queries of this chunk (S = prefix
                   + P: an optional patch prefix plus P LEFT-padded prompt
                   tokens);
    k_new/v_new:   (B, S, Hk, D) this chunk's rotated K/V (compute dtype);
    k_pool/v_pool: (N, bs, Hk, D) the shared block pool (trash block
                   included), updated in place;
    lengths:       (B,) int32 true token count of the chunk (<= P);
    block_tables:  (B, T) int32 per-lane tables;
    start:         None => first chunk (no cached context); else (B,)
                   int32 cache positions already filled per row — the
                   chunk attends to positions [0, start) through the table;
    prefix:        patch-prefix length (first chunk only);
    kv_scales:     optional (k_scale, v_scale) (N, bs, Hk) fp32 scales of
                   a SCLAD pool, updated in place, with ``kv_dtype``
                   ("int8"/"fp8") naming the payload encoding.

    Returns (attn_out (B, S, H*D) in q.dtype, k_pool, v_pool) with the
    chunk's K/V left-compacted and written at positions ``start + i``;
    quantized calls append (k_scale, v_scale).  Rows ``< pad`` of a
    left-padded chunk attend to nothing real; their output is junk.
    """
    B, S, H, D = q.shape
    Hk = k_new.shape[2]
    rep = H // Hk
    P = S - prefix
    dev = q.device
    lengths = lengths.to(torch.int32)
    pad = P - lengths  # (B,)
    start_v = torch.zeros(B, dtype=torch.int32, device=dev) \
        if start is None else start.to(torch.int32)

    # Key j is visible to query i iff causal AND j is not a pad slot.
    sidx = torch.arange(S, device=dev)
    real_key = (sidx[None] < prefix) | (sidx[None] >= prefix + pad[:, None])
    mask = (sidx[None, None, :] <= sidx[None, :, None]) \
        & real_key[:, None, :]  # (B, S, S)

    quantized = kv_scales is not None
    kk, vv = k_new, v_new
    if quantized:
        # Attend to the chunk's K/V as a pool reader will see it.
        kk = kv_quant.fake_quant(k_new, kv_dtype)
        vv = kv_quant.fake_quant(v_new, kv_dtype)
    if start is not None:
        # Dense per-lane context gather.
        bs = k_pool.shape[1]
        tables = block_tables.long()
        kg = kv_quant.raw(k_pool)[tables].view(k_pool.dtype) \
            .reshape(B, -1, Hk, D)
        vg = kv_quant.raw(v_pool)[tables].view(v_pool.dtype) \
            .reshape(B, -1, Hk, D)
        if quantized:
            k_scale, v_scale = kv_scales
            kg = kv_quant.dequantize(
                kg, k_scale[tables].reshape(B, -1, Hk), q.dtype)
            vg = kv_quant.dequantize(
                vg, v_scale[tables].reshape(B, -1, Hk), q.dtype)
        ctx_len = block_tables.shape[1] * bs
        ctx_mask = torch.arange(ctx_len, device=dev)[None] \
            < start_v[:, None]  # (B, T*bs)
        kk = torch.cat([kg.to(q.dtype), kk], dim=1)
        vv = torch.cat([vg.to(q.dtype), vv], dim=1)
        mask = torch.cat([ctx_mask[:, None, :].expand(B, S, ctx_len),
                          mask.expand(B, S, S)], dim=-1)

    qg = q.reshape(B, S, Hk, rep, D)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, kk).float()
    scores = scores / math.sqrt(D)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, vv).reshape(B, S, H * D)

    written = scatter_new_kv_ref(k_new, v_new, k_pool, v_pool, lengths,
                                 block_tables, start=start, prefix=prefix,
                                 kv_scales=kv_scales, kv_dtype=kv_dtype)
    return (out,) + written


def scatter_new_kv_ref(k_new, v_new, k_pool, v_pool, lengths, block_tables,
                       start: Optional[torch.Tensor] = None, prefix: int = 0,
                       kv_scales=None, kv_dtype: Optional[str] = None):
    """Write the chunk's new-token K/V into the pools, in place.

    Left-compacts each row's token K/V — real tokens to offsets
    0..len-1 after the prefix — then stores it through the block table at
    cache positions ``start + i``.  Junk-tail entries are dropped, so they
    cannot touch another row's blocks.  Returns (k_pool, v_pool).

    With ``kv_scales`` + ``kv_dtype`` (SCLAD pool) the compacted rows are
    quantized (``kv_quant.quantize``, per row, so compaction and
    quantization commute) and payload and scales are stored through the
    same indices; returns (k_pool, v_pool, k_scale, v_scale).
    """
    B, S = k_new.shape[0], k_new.shape[1]
    bs = k_pool.shape[1]
    T = block_tables.shape[1]
    P = S - prefix
    dev = k_new.device
    lengths = lengths.to(torch.int32)
    pad = (P - lengths).long()
    start_v = torch.zeros(B, dtype=torch.long, device=dev) \
        if start is None else start.long()

    roll_idx = (torch.arange(P, device=dev)[None] + pad[:, None]) % P

    def compact(kv):  # (B, S, Hk, D), token part rolled left
        head, tail = kv[:, :prefix], kv[:, prefix:]
        tail = torch.take_along_dim(tail, roll_idx[:, :, None, None], dim=1)
        return torch.cat([head, tail], dim=1) if prefix else tail

    dest = start_v[:, None] + torch.arange(S, device=dev)[None]  # (B, S)
    blk_idx = torch.clamp(dest // bs, max=T - 1)
    blk = torch.take_along_dim(block_tables.long(), blk_idx, dim=1)
    writable = torch.arange(S, device=dev)[None] < prefix + lengths[:, None]
    off = dest % bs
    b_w, o_w = blk[writable], off[writable]
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        kq, ks1 = kv_quant.quantize(compact(k_new)[writable], kv_dtype)
        vq, vs1 = kv_quant.quantize(compact(v_new)[writable], kv_dtype)
        kv_quant.raw(k_pool)[b_w, o_w] = kv_quant.raw(kq)
        kv_quant.raw(v_pool)[b_w, o_w] = kv_quant.raw(vq)
        k_scale[b_w, o_w] = ks1
        v_scale[b_w, o_w] = vs1
        return k_pool, v_pool, k_scale, v_scale
    kv_quant.put(k_pool, (b_w, o_w), compact(k_new)[writable])
    kv_quant.put(v_pool, (b_w, o_w), compact(v_new)[writable])
    return k_pool, v_pool
