"""Public chunked-prefill attention entry point.

``prefill_attention`` is what ``models.model.prefill_slots`` (and so the
serving engine's prefill chunks) calls once per layer.  The
``attn_kernel`` knob (``kernels.flash_decode.ops.resolve_kernel``) picks
the CUDA kernel or the plain PyTorch version, as on the decode side.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_decode.ops import resolve_kernel
from repro_torch.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill
from repro_torch.kernels.flash_prefill.ref import prefill_attention_ref


def prefill_attention(q, k_new, v_new, k_pool, v_pool, lengths,
                      block_tables, *, start: Optional[torch.Tensor] = None,
                      prefix: int = 0, kernel: str = "auto",
                      kv_scales=None, kv_dtype: Optional[str] = None):
    """One layer of paged chunked-prefill attention + new-token K/V write.

    q: (B, S, H, D) rotated chunk queries (S = prefix + P, prompt tokens
    LEFT-padded to P); k_new/v_new: (B, S, Hk, D); k_pool/v_pool: (N, bs,
    Hk, D) shared block pool, updated in place; lengths: (B,) int32 true
    chunk token counts; block_tables: (B, T) int32; start: None for first
    chunks, else (B,) int32 cached positions per row; kv_scales +
    kv_dtype: (k_scale, v_scale) (N, bs, Hk) fp32, updated in place, and
    the payload encoding ("int8"/"fp8") of a SCLAD pool — both
    implementations dequantize the context on load, fake-quantize the
    chunk's own K/V before attending, and store quantized payload and
    scales.

    Returns (attn_out (B, S, H*D), k_pool, v_pool), with (k_scale,
    v_scale) appended for a SCLAD pool.
    """
    fn = paged_flash_prefill if resolve_kernel(kernel, q.device) \
        else prefill_attention_ref
    return fn(q, k_new, v_new, k_pool, v_pool, lengths, block_tables,
              start=start, prefix=prefix, kv_scales=kv_scales,
              kv_dtype=kv_dtype)
