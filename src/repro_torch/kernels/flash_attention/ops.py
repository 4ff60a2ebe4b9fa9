"""Public wrapper for blocked flash attention."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal: bool = True, block_q: int = 128,
              block_k: int = 128):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) -> (B, Sq, H, D): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)
    return attention_ref(q, k, v, causal=causal)
