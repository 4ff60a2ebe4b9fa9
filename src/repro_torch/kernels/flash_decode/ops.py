"""Public decode-attention entry point and the ``attn_kernel`` knob.

``decode_attention`` is what ``models.layers.attention_decode`` (and so
``model.decode_step`` and the serving engine's decode window) calls.  The
cache layout is chosen by ``block_tables``: the paged (N, bs, Hk, D) pool
(bf16 or SCLAD int8/fp8 with ``kv_scales``), or, with ``None``, dense
(B, S, Hk, D) stripes (the wave path).  The implementation is chosen by
``resolve_kernel``:

  * ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors;
  * ``"on"``  — always the kernel; CPU tensors raise (a CUDA kernel has no
    interpret mode);
  * ``"off"`` — always the plain version, on either device.

The same knob selects the prefill-side kernel (``kernels.flash_prefill``)
and, as ``kernel=``, the SCLD matmul of ``SCLDLinear``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.flash_decode import (flash_decode,
                                                           paged_flash_decode)
from repro_torch.kernels.flash_decode.ref import decode_ref, paged_decode_ref

ATTN_KERNEL_MODES = ("auto", "on", "off")


def resolve_kernel(kernel: str, device: torch.device) -> bool:
    """-> True when tensors on ``device`` take the CUDA kernel."""
    if kernel not in ATTN_KERNEL_MODES:
        raise ValueError(
            f"kernel mode {kernel!r} not in {ATTN_KERNEL_MODES}")
    on_cuda = torch.device(device).type == "cuda"
    if kernel == "on" and not on_cuda:
        raise RuntimeError(
            "kernel mode 'on' needs CUDA tensors: the kernels are CUDA code "
            "with no CPU or interpret mode (use 'auto' or 'off' on the CPU)")
    return on_cuda if kernel == "auto" else kernel == "on"


def decode_attention(q, k_cache, v_cache, lengths, block_tables=None, *,
                     kernel: str = "auto", kv_scales=None):
    """One decode-attention step.

    q: (B, H, D) the new token's rotated queries; k_cache/v_cache: the
    shared (N, bs, Hk, D) block pool when ``block_tables`` (B, T) int32 is
    given, else (B, S, Hk, D) dense bf16 stripes; lengths: (B,) int32 (a
    scalar or 0-d tensor broadcasts) valid positions per row; kv_scales:
    (k_scale, v_scale) (N, bs, Hk) fp32 of a SCLAD pool (paged layout
    only).  Returns (B, H, D).  The caller owns the cache write of the new
    K/V; this is the read side only.
    """
    use_kernel = resolve_kernel(kernel, q.device)
    if block_tables is not None:
        if use_kernel:
            return paged_flash_decode(q, k_cache, v_cache, lengths,
                                      block_tables, kv_scales=kv_scales)
        return paged_decode_ref(q, k_cache, v_cache, lengths, block_tables,
                                kv_scales=kv_scales)
    if kv_scales is not None:
        raise ValueError("kv_scales belong to the paged pool layout")
    if not use_kernel:
        return decode_ref(q, k_cache, v_cache, lengths)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=q.device) \
        .reshape(-1).expand(q.shape[0]).contiguous()
    return flash_decode(q, k_cache, v_cache, lens)
