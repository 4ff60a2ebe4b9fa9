"""Flash-decode wrappers of the CUDA kernels in ``repro_torch/csrc``.

* ``paged_flash_decode`` (``csrc/paged_decode.cu``) — port of
  ``repro.kernels.flash_decode.flash_decode.paged_flash_decode``, for a
  bf16 or f8 (float8_e4m3fn, no scales) pool and for a SCLAD int8/fp8
  pool with its fp32 scales;
* ``flash_decode`` (``csrc/dense_decode.cu``) — port of
  ``repro.kernels.flash_decode.flash_decode.flash_decode``: decode over
  dense (B, S, Hk, D) bf16 or f8 stripes (the wave path's cache).

An f8 pool or f8 stripes are read as they are, one byte an element, and
each element widened on load (exact: every e4m3 value is a bf16 value),
so the kernels score what the plain versions score after their cast to
the compute dtype.

Both run one body (``csrc/decode_attention.cuh``): the key walk is split
across blocks at a fixed ``SPLIT`` positions (``decode_splits``: from the
table or stripe width alone, never from ``lengths``), each block's
partial goes to an fp32 workspace this wrapper allocates, and a second
kernel merges a row's splits in a fixed order.  bf16 q runs on the
tensor cores, fp32 q in exact fp32.

A CUDA tensor launches the kernels, or the call raises; the plain
PyTorch versions (``ref.paged_decode_ref``, ``ref.decode_ref``) run only
for tensors on the CPU.  ``<wrapper>.launches`` counts wrapper calls that
launched their kernels (two device launches each: split and combine).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import decode_ref, paged_decode_ref

HEAD_DIMS = (64, 128)  # the paged kernel's head dims
#: The dense kernel's: also zamba2-7b's shared attention, 3584 / 32 = 112.
DENSE_HEAD_DIMS = (64, 112, 128)
#: The dense kernel's stripe dtypes (kv_kind 0 and 3).
DENSE_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)
MAX_REP = 32  # query heads per kv head the kernel holds in one block
#: Positions a block of the split pass walks (``kSplit`` in
#: ``csrc/decode_attention.cuh``).
SPLIT = 128


def decode_splits(width: int) -> int:
    """Blocks of the split pass along the key walk of a table (or
    stripe) of ``width`` positions: ``ceil(width / SPLIT)``.  Shapes
    only: the host never reads ``lengths``."""
    return -(-width // SPLIT)


def split_ranges(n: int, width: int):
    """The positions ``[lo, hi)`` each of the ``decode_splits(width)``
    blocks walks for a row of length ``n``; a block whose range starts at
    or past ``min(n, width)`` is empty (it exits at once)."""
    live = max(0, min(n, width))
    return [(min(s * SPLIT, live), min((s + 1) * SPLIT, live))
            for s in range(decode_splits(width))]


def _workspace(q, width):
    """``(n_split, ws)``: the split pass's fp32 scratch, per (row, query
    head, split) a (D,) accumulator, then per (row, head, split) its
    (m, l); sized from shapes only."""
    B, H, D = q.shape
    n_split = decode_splits(width)
    return n_split, torch.empty(B * H * n_split * (D + 2),
                                dtype=torch.float32, device=q.device)


def _check_q(what, q, Hk, D, head_dims=HEAD_DIMS):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: q dtype {q.dtype} not bf16/fp32")
    if q.dim() != 3 or q.shape[2] != D or D not in head_dims:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)}, head dim "
                         f"{D} (D in {head_dims})")
    H = q.shape[1]
    if Hk <= 0 or H % Hk or H // Hk > MAX_REP:
        raise ValueError(f"{what}: H={H} Hk={Hk} unsupported")


def _check_inputs(q, k_pool, v_pool, lengths, block_tables, kv_scales):
    B = q.shape[0]
    dev = q.device
    if any(t.device != dev for t in (k_pool, v_pool, lengths, block_tables)):
        raise ValueError("paged_flash_decode: all inputs must be on one device")
    if v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape \
            or k_pool.dim() != 4:
        raise ValueError("paged_flash_decode: k/v pools must match, "
                         "(N, bs, Hk, D)")
    _check_q("paged_flash_decode", q, k_pool.shape[2], k_pool.shape[3])
    kind = _build.kv_kind("paged_flash_decode", k_pool, kv_scales)
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_flash_decode: lengths/tables must be int32")
    if lengths.shape != (B,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("paged_flash_decode: lengths (B,), tables (B, T)")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, lengths, block_tables)):
        raise ValueError("paged_flash_decode: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_flash_decode: pools must be 16-byte "
                         "aligned")
    return kind


def _check_dense(q, k_cache, v_cache, lengths):
    """Checks the dense call's inputs; returns the stripes' ``kv_kind``
    (0 bf16, 3 float8_e4m3fn)."""
    B = q.shape[0]
    if any(t.device != q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("flash_decode: all inputs must be on one device")
    if k_cache.dtype not in DENSE_DTYPES or v_cache.dtype != k_cache.dtype \
            or v_cache.shape != k_cache.shape or k_cache.dim() != 4 \
            or k_cache.shape[0] != B:
        raise TypeError("flash_decode: k/v caches must be bf16 or "
                        "float8_e4m3fn (B, S, Hk, D)")
    _check_q("flash_decode", q, k_cache.shape[2], k_cache.shape[3],
             DENSE_HEAD_DIMS)
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("flash_decode: lengths must be (B,) int32")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("flash_decode: inputs must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: caches must be 16-byte aligned")
    return _build.kv_kind("flash_decode", k_cache, None)


def paged_flash_decode(q, k_pool, v_pool, lengths, block_tables,
                       kv_scales=None):
    """Decode attention straight out of the paged KV block pool.

    q:            (B, H, D) one new token per row, bf16 or fp32;
    k_pool/v_pool:(N, bs, Hk, D) the shared block pool (trash block
                  included): bf16, float8_e4m3fn without scales (f8), or
                  a SCLAD int8 / float8_e4m3fn payload;
    lengths:      (B,) int32 valid cache positions per row (dead lanes'
                  lengths only cover trash blocks; their output is junk
                  the caller's active mask discards);
    block_tables: (B, T) int32 per-lane tables; unallocated entries point
                  at the trash block;
    kv_scales:    (k_scale, v_scale) (N, bs, Hk) fp32, with a SCLAD pool
                  only: the payload is dequantized on load.

    Returns (B, H, D) in q.dtype; a row with no live position gets zeros.
    KV bytes are read once per token, block by block through the table,
    never gathered into a per-lane copy.
    """
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, lengths, block_tables,
                                kv_scales=kv_scales)
    _build.refuse_grad("paged_flash_decode", q, k_pool, v_pool,
                       *(kv_scales or ()))
    kind = _check_inputs(q, k_pool, v_pool, lengths, block_tables, kv_scales)
    B, H, D = q.shape
    _, bs, Hk, _ = k_pool.shape
    ks, vs = (None, None) if kv_scales is None \
        else (kv_scales[0].data_ptr(), kv_scales[1].data_ptr())
    T = block_tables.shape[1]
    n_split, ws = _workspace(q, T * bs)
    out = torch.empty_like(q)
    _build.launch(
        "paged_decode", "paged_flash_decode", q.device,
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        lengths.data_ptr(), block_tables.data_ptr(), ws.data_ptr(),
        out.data_ptr(), B, H, Hk, D, bs, T, n_split,
        int(q.dtype == torch.bfloat16), kind)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def flash_decode(q, k_cache, v_cache, lengths):
    """Decode attention over dense per-row K/V stripes.

    q:        (B, H, D) one new token per row, bf16 or fp32, D in
              ``DENSE_HEAD_DIMS``;
    k_cache/v_cache: (B, S, Hk, D) bf16 or float8_e4m3fn stripes (row
              b's position j at [b, j]);
    lengths:  (B,) int32 valid positions per row (read up to min(len, S)).

    Returns (B, H, D) in q.dtype; a row with no live position gets zeros.
    """
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, lengths)
    _build.refuse_grad("flash_decode", q, k_cache, v_cache)
    kind = _check_dense(q, k_cache, v_cache, lengths)
    B, S, Hk, D = k_cache.shape
    n_split, ws = _workspace(q, S)
    out = torch.empty_like(q)
    _build.launch(
        "dense_decode", "flash_decode", q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), ws.data_ptr(), out.data_ptr(), B, S,
        q.shape[1], Hk, D, n_split, int(q.dtype == torch.bfloat16), kind)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
