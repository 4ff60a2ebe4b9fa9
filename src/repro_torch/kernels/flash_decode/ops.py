"""Public decode-attention entry point and the ``attn_kernel`` knob.

``decode_attention`` is what ``models.layers.attention_decode`` (and so
``model.decode_step`` and the serving engine's decode window) calls.  The
implementation is chosen by ``resolve_kernel``:

  * ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors;
  * ``"on"``  — always the kernel; CPU tensors raise (a CUDA kernel has no
    interpret mode);
  * ``"off"`` — always the plain version, on either device.

The same knob selects the prefill-side kernel (``kernels.flash_prefill``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.flash_decode import paged_flash_decode
from repro_torch.kernels.flash_decode.ref import paged_decode_ref

ATTN_KERNEL_MODES = ("auto", "on", "off")


def resolve_kernel(kernel: str, device: torch.device) -> bool:
    """-> True when tensors on ``device`` take the CUDA kernel."""
    if kernel not in ATTN_KERNEL_MODES:
        raise ValueError(
            f"attention kernel mode {kernel!r} not in {ATTN_KERNEL_MODES}")
    on_cuda = torch.device(device).type == "cuda"
    if kernel == "on" and not on_cuda:
        raise RuntimeError(
            "attn_kernel='on' needs CUDA tensors: the kernels are CUDA code "
            "with no CPU or interpret mode (use 'auto' or 'off' on the CPU)")
    return on_cuda if kernel == "auto" else kernel == "on"


def decode_attention(q, k_pool, v_pool, lengths, block_tables, *,
                     kernel: str = "auto"):
    """One paged decode-attention step.

    q: (B, H, D) the new token's rotated queries; k_pool/v_pool: (N, bs,
    Hk, D) the shared block pool; lengths: (B,) int32 valid positions per
    row; block_tables: (B, T) int32.  Returns (B, H, D).  The caller owns
    the pool write of the new K/V; this is the read side only.
    """
    if resolve_kernel(kernel, q.device):
        return paged_flash_decode(q, k_pool, v_pool, lengths, block_tables)
    return paged_decode_ref(q, k_pool, v_pool, lengths, block_tables)
