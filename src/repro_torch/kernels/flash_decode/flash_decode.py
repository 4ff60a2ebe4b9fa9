"""Paged flash-decode: the wrapper of the CUDA kernel in
``repro_torch/csrc/paged_decode.cu``.

Port of ``repro.kernels.flash_decode.flash_decode.paged_flash_decode`` (fp
pool branch).  A CUDA tensor launches the kernel, or the call raises; the
plain PyTorch version (``ref.paged_decode_ref``) runs only for tensors on
the CPU.  ``paged_flash_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import paged_decode_ref

HEAD_DIMS = (64, 128)
MAX_REP = 32  # query heads per kv head the kernel holds in one block


def _check_inputs(q, k_pool, v_pool, lengths, block_tables):
    B, H, D = q.shape
    N, bs, Hk, Dk = k_pool.shape
    dev = q.device
    if any(t.device != dev for t in (k_pool, v_pool, lengths, block_tables)):
        raise ValueError("paged_flash_decode: all inputs must be on one device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_flash_decode: q dtype {q.dtype} not bf16/fp32")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError("paged_flash_decode: the pool must be bf16")
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_flash_decode: lengths/tables must be int32")
    if v_pool.shape != k_pool.shape or Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"paged_flash_decode: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} (D in {HEAD_DIMS})")
    if H % Hk or H // Hk > MAX_REP:
        raise ValueError(f"paged_flash_decode: H={H} Hk={Hk} unsupported")
    if lengths.shape != (B,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("paged_flash_decode: lengths (B,), tables (B, T)")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, lengths, block_tables)):
        raise ValueError("paged_flash_decode: inputs must be contiguous")


def paged_flash_decode(q, k_pool, v_pool, lengths, block_tables):
    """Decode attention straight out of the paged KV block pool.

    q:            (B, H, D) one new token per row, bf16 or fp32;
    k_pool/v_pool:(N, bs, Hk, D) bf16, the shared block pool (trash block
                  included);
    lengths:      (B,) int32 valid cache positions per row (dead lanes'
                  lengths only cover trash blocks; their output is junk
                  the caller's active mask discards);
    block_tables: (B, T) int32 per-lane tables; unallocated entries point
                  at the trash block.

    Returns (B, H, D) in q.dtype.  KV bytes are read once per token, block
    by block through the table, never gathered into a per-lane copy.
    """
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, lengths, block_tables)
    _check_inputs(q, k_pool, v_pool, lengths, block_tables)
    B, H, D = q.shape
    _, bs, Hk, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    code = lib.repro_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        B, H, Hk, D, bs, block_tables.shape[1],
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
