"""Paged flash-prefill with the fused K/V scatter: the wrapper of the CUDA
kernel in ``repro_torch/csrc/paged_prefill.cu``.

Port of ``repro.kernels.flash_prefill.flash_prefill.paged_flash_prefill``,
for a bf16 pool and for a SCLAD int8/fp8 pool with its fp32 scales.  The
pools (and scales) are updated IN PLACE — the reference package aliases
them with ``input_output_aliases`` instead — and returned, so the call
keeps the reference's return signature.  A CUDA tensor launches the
kernel, or the call raises; the plain PyTorch version
(``ref.prefill_attention_ref``) runs only for tensors on the CPU.
``paged_flash_prefill.launches`` counts kernel launches.

A thread block owns the ``rep = H / Hk`` query heads of one kv head for
a run of query positions (the kernel picks them from shapes alone;
``prefill_tiles`` mirrors the plan), any rep from 1 to ``MAX_REP``.
bf16 q runs on the tensor cores, fp32 q in exact fp32; every block
stores the chunk rows of its own positions into the pool.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import prefill_attention_ref

HEAD_DIMS = (64, 128)
MAX_REP = 32  # query heads per kv head
#: Query rows (positions x rep) a thread block holds, by body: one 16-row
#: tensor-core m tile a warp, 8 warps (bf16 q); 64 in the exact-fp32 body
#: (``TcShape::kRows`` / ``kRows`` in ``csrc/paged_prefill.cu``).
TC_ROWS = 128
EXACT_ROWS = 64


def prefill_tiles(S: int, H: int, Hk: int, dtype=torch.bfloat16):
    """``(positions, tiles)``: the query positions one thread block owns,
    ``rows // rep`` for its body's rows, and the blocks along a chunk of
    ``S`` padded positions, ``ceil(S / positions)``; block ``i`` owns
    positions ``[i * positions, min(S, (i + 1) * positions))``.

    The kernel's launch computes the same plan from the same shapes (it
    never reads ``lengths`` or ``start`` on the host); this mirror is for
    the tests, and ``tests/test_torch_cuda.py`` holds it against the
    blocks the kernel runs."""
    rows = TC_ROWS if dtype == torch.bfloat16 else EXACT_ROWS
    positions = rows // (H // Hk)
    return positions, -(-S // positions)


def _check_inputs(q, k_new, v_new, k_pool, v_pool, lengths, block_tables,
                  start, prefix, kv_scales, kv_dtype):
    B, S, H, D = q.shape
    N, bs, Hk, Dk = k_pool.shape
    dev = q.device
    rest = [k_new, v_new, k_pool, v_pool, lengths, block_tables]
    if start is not None:
        rest.append(start)
    if any(t.device != dev for t in rest):
        raise ValueError("paged_flash_prefill: all inputs must be on one "
                         "device")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("paged_flash_prefill: q/k_new/v_new must share a "
                        "bf16 or fp32 dtype")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("paged_flash_prefill: k/v pools must share a dtype")
    kind = _build.kv_kind("paged_flash_prefill", k_pool, kv_scales)
    want = {0: None, 1: "int8", 2: "fp8"}[kind]
    if kv_dtype != want:
        raise TypeError(f"paged_flash_prefill: kv_dtype {kv_dtype!r} does "
                        f"not name a {k_pool.dtype} pool")
    ints = [lengths, block_tables] + ([start] if start is not None else [])
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("paged_flash_prefill: lengths/tables/start must be "
                        "int32")
    if k_new.shape != (B, S, Hk, D) or v_new.shape != k_new.shape \
            or v_pool.shape != k_pool.shape or Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"paged_flash_prefill: bad shapes q {tuple(q.shape)}"
                         f" k_new {tuple(k_new.shape)} pool "
                         f"{tuple(k_pool.shape)} (D in {HEAD_DIMS})")
    if Hk <= 0 or H % Hk or H // Hk > MAX_REP:
        raise ValueError(f"paged_flash_prefill: H={H} Hk={Hk} unsupported")
    if lengths.shape != (B,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B \
            or (start is not None and start.shape != (B,)):
        raise ValueError("paged_flash_prefill: lengths/start (B,), tables "
                         "(B, T)")
    if not 0 <= prefix <= S:
        raise ValueError(f"paged_flash_prefill: prefix {prefix} not in "
                         f"[0, {S}]")
    if not all(t.is_contiguous() for t in [q] + rest):
        raise ValueError("paged_flash_prefill: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_new, v_new, k_pool, v_pool)):
        raise ValueError("paged_flash_prefill: q, k/v_new and the pools "
                         "must be 16-byte aligned")
    return kind


def paged_flash_prefill(q, k_new, v_new, k_pool, v_pool, lengths,
                        block_tables, start=None, prefix: int = 0,
                        kv_scales=None, kv_dtype: Optional[str] = None):
    """Chunked-prefill attention + fused K/V scatter on the paged pool.

    q:             (B, S, H, D) rotated chunk queries (S = prefix + P,
                   prompt tokens LEFT-padded to P), bf16 or fp32;
    k_new/v_new:   (B, S, Hk, D) the chunk's rotated K/V, q's dtype;
    k_pool/v_pool: (N, bs, Hk, D) shared block pool, updated in place: bf16,
                   or a SCLAD int8 / float8_e4m3fn payload;
    lengths:       (B,) int32 true chunk token count per row (<= P);
    block_tables:  (B, T) int32 per-lane tables;
    start:         None for a first chunk (no cached context: the table
                   walk is skipped), else (B,) int32 cached positions;
    prefix:        patch-prefix length (first chunk only);
    kv_scales:     (k_scale, v_scale) (N, bs, Hk) fp32, updated in place,
                   and ``kv_dtype`` ("int8"/"fp8"), with a SCLAD pool only:
                   the context is dequantized on load, the chunk's own K/V
                   fake-quantized before it is attended to, and the
                   scatter stores quantized payload and scales.

    Returns (attn_out (B, S, H*D), k_pool, v_pool), plus (k_scale,
    v_scale) for a SCLAD pool.  Cached KV bytes are read block by block
    through the table, never gathered, and the new K/V lands in the pool
    inside the same launch.
    """
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k_new, v_new, k_pool, v_pool,
                                     lengths, block_tables, start=start,
                                     prefix=prefix, kv_scales=kv_scales,
                                     kv_dtype=kv_dtype)
    kind = _check_inputs(q, k_new, v_new, k_pool, v_pool, lengths,
                         block_tables, start, prefix, kv_scales, kv_dtype)
    B, S, H, D = q.shape
    _, bs, Hk, _ = k_pool.shape
    ks, vs = (None, None) if kv_scales is None \
        else (kv_scales[0].data_ptr(), kv_scales[1].data_ptr())
    out = torch.empty((B, S, H * D), dtype=q.dtype, device=q.device)
    lib = _build.load("paged_prefill")
    code = lib.repro_paged_prefill(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), ks, vs, lengths.data_ptr(),
        None if start is None else start.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(),
        B, S, H, Hk, D, bs, block_tables.shape[1], prefix,
        int(q.dtype == torch.bfloat16), kind,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_flash_prefill")
    paged_flash_prefill.launches += 1
    if kv_scales is not None:
        return (out, k_pool, v_pool) + tuple(kv_scales)
    return out, k_pool, v_pool


paged_flash_prefill.launches = 0
