"""Blocked flash attention over the CUDA kernel in
``csrc/flash_attention.cu``: port of
``repro.kernels.flash_attention.flash_attention.flash_attention``.

GQA attention (B, Sq, H, D) x (B, Sk, Hk, D), causal or not, with an
fp32 online softmax over key tiles and the key walk of a causal query
tile ending at the last key its rows can see.  The causal mask is
aligned bottom-right (query i sees keys j <= i + Sk - Sq), as the plain
version ``ref.attention_ref`` has it; causal with Sq > Sk, where that
mask leaves rows with no key, raises.  A CUDA tensor launches the
kernel, or the call raises; the plain version runs only for tensors on
the CPU.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D), H % Hk == 0, Sq % block_q
    == 0, Sk % block_k == 0; all fp32 or all bf16 -> (B, Sq, H, D) in
    q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if block_q <= 0 or block_k <= 0 or Sq % block_q or Sk % block_k:
        raise ValueError(f"flash_attention: Sq={Sq}, Sk={Sk} are not "
                         f"multiples of block_q={block_q}, "
                         f"block_k={block_k}")
    if causal and Sq > Sk:
        raise ValueError(f"flash_attention: causal with Sq={Sq} > Sk={Sk} "
                         f"leaves the first {Sq - Sk} rows with no key")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all inputs must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must all be fp32 or all "
                        "bf16")
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != D or D not in HEAD_DIMS or Hk <= 0 or H % Hk:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} (D in {HEAD_DIMS}, H % Hk "
                         f"== 0)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hk, D, int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
