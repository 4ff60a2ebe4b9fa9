"""Plain PyTorch version of blocked flash attention.

Twin of ``repro.kernels.flash_attention.ref.attention_ref``: fp32 math,
GQA by head groups, and a causal mask aligned bottom-right (query i sees
keys j <= i + Sk - Sq), as ``jnp.tril(k=Sk - Sq)`` there.  It is the CPU
path of ``ops.attention`` and what the CUDA kernel is held against on
the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) -> (B, Sq, H, D) in q's
    dtype.  With causal and Sq > Sk the first Sq - Sk rows see no key
    and come out NaN, as in the reference."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    qf = q.float().reshape(B, Sq, Hk, rep, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
