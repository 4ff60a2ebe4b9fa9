"""Transformer layers of the attention families: norm, rotary
embeddings, QKV projection, full causal attention (``_sdpa``,
``chunked_attention``, ``attention``), SwiGLU/GeGLU/GELU MLP, and
single-token decode attention over a paged pool (bf16 or SCLAD int8/fp8)
or dense stripes.

Port of the serving-path functions of ``repro.models.layers``, as plain
functions on tensors over explicit parameter dictionaries.  The
arithmetic follows the reference: fp32 norm statistics and rotary
angles, compute-dtype matmuls, a compute-dtype score product with an fp32
masked softmax.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.models import kv_quant

Params = Dict[str, torch.Tensor]


#: Elements drawn per fp32 temporary by the initialisers: 64 Mi, 256 MiB.
INIT_CHUNK = 1 << 26


def _normal(gen: torch.Generator, shape, std: float,
            dtype) -> torch.Tensor:
    """N(0, std^2) in ``dtype``, drawn in fp32 INIT_CHUNK elements at a
    time, so a leaf's draw adds at most 256 MiB to the memory it fills."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=gen.device,
                                    dtype=torch.float32).mul_(std)
    return out


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Scaled normal init (fan-in): N(0, 1/fan_in), the distribution of
    the reference's ``dense_init`` (not its bits)."""
    return _normal(gen, shape, 1.0 / math.sqrt(shape[in_axis]), dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.bfloat16) -> torch.Tensor:
    return _normal(gen, shape, 0.02, dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def rope_frequencies(cfg: ModelConfig) -> Tuple[int, np.ndarray]:
    """Returns (rotary_dim, inv_freq[rotary_dim // 2]) as float32 numpy,
    computed exactly as the reference does."""
    rot = int(cfg.head_dim * cfg.rope_fraction)
    rot -= rot % 2
    if cfg.rope_theta <= 0 or rot == 0:
        return 0, np.zeros((0,), np.float32)
    inv = 1.0 / (cfg.rope_theta
                 ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return rot, inv.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _inv_freq_on(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, copied there once: a copy from
    host memory per layer would stall the host on the device each time."""
    return torch.from_numpy(rope_frequencies(cfg)[1]).to(device)


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    rot = rope_frequencies(cfg)[0]
    if rot == 0:
        return x
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * _inv_freq_on(cfg, x.device)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def _project_qkv(cfg: ModelConfig, p: Params, xq: torch.Tensor,
                 xkv: torch.Tensor):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, Sq, h, hd), k.reshape(B, Skv, hk, hd),
            v.reshape(B, Skv, hk, hd))


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, mask=None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Skv, Hk, D) -> (B, Sq, H*D).  The
    reference's arithmetic: compute-dtype scores, an fp32 softmax with
    ``-1e30`` where ``mask`` (broadcast to (B, Hk, rep, Sq, Skv)) is False,
    compute-dtype probs @ V."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, D)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(B, Sq, H * D)


# Above this sequence length attention runs blockwise (online softmax), so
# peak memory is O(S * chunk) instead of O(S^2).
CHUNKED_ATTN_THRESHOLD = 2048
Q_CHUNK = 512
K_CHUNK = 1024


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_chunk: int = Q_CHUNK,
                      k_chunk: int = K_CHUNK) -> torch.Tensor:
    """Blockwise attention with an online softmax, never materializing the
    (Sq, Skv) scores: the reference's loop over query chunks and key
    chunks, with the same fp32 running max / denominator / accumulator.

    q: (B, Sq, H, D); k, v: (B, Skv, Hk, D) -> (B, Sq, H*D) in q.dtype.
    """
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Skv)
    while Sq % q_chunk:
        q_chunk //= 2
    while Skv % k_chunk:
        k_chunk //= 2
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, Hk, rep, D)
        qp = torch.arange(q0, q0 + q_chunk, device=dev)
        acc = torch.zeros((B, q_chunk, Hk, rep, D), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, q_chunk, Hk, rep), -math.inf, device=dev)
        denom = torch.zeros((B, q_chunk, Hk, rep), device=dev)
        for k0 in range(0, Skv, k_chunk):
            ki, vi = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            s = torch.einsum("bqhrd,bkhd->bqhrk", qi, ki).float() * scale
            if causal:
                kp = torch.arange(k0, k0 + k_chunk, device=dev)
                vis = qp[:, None] >= kp[None, :]  # (qc, kc)
                s = s.masked_fill(~vis[None, :, None, None, :], -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhrk,bkhd->bqhrd", p.to(qi.dtype), vi).float()
            m = m_new
        outs.append((acc / torch.clamp(denom, min=1e-30)[..., None])
                    .to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H * D)


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True,
              use_rope: bool = True) -> torch.Tensor:
    """Full self-attention over x (B, S, d) -> (B, S, d): blockwise at and
    above ``CHUNKED_ATTN_THRESHOLD`` tokens (when S divides into
    ``Q_CHUNK``s), one masked ``_sdpa`` below."""
    q, k, v = _project_qkv(cfg, p, x, x)
    if use_rope:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    S = x.shape[1]
    if S >= CHUNKED_ATTN_THRESHOLD and S % Q_CHUNK == 0:
        out = chunked_attention(q, k, v, causal)
    else:
        mask = None
        if causal:
            mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                         device=x.device))
        out = _sdpa(cfg, q, k, v, mask)
    return out @ p["wo"]


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     position: torch.Tensor, block_tables=None,
                     kv_scales=None):
    """Single-token decode attention, with the cache written in place.

    x: (B, 1, d); position: (B,) int32 per-row index of the new token.
    Two cache layouts:

      * paged (``block_tables`` (B, T) int32): k_cache/v_cache are one
        layer's (N, bs, Hk, D) pool.  The new K/V is stored at
        ``block_tables[b, pos // bs]``, offset ``pos % bs``; dead lanes
        carry all-trash tables, so their writes land in the trash block;
        the table index is clamped to the table, as the reference's gather
        clamps it.  With ``kv_scales`` ((N, bs, Hk) fp32, SCLAD pool) the
        new K/V is quantized (``kv_quant.quantize``) and payload and scales
        are stored — plain PyTorch here, as in the reference, for either
        read path;
      * dense (``block_tables=None``): k_cache/v_cache are (B, S, Hk, D)
        bf16 stripes and the new K/V lands at ``[b, pos]``.

    Writes happen in place, where the reference returns new caches.  The
    read goes through ``decode_ops.decode_attention`` with lengths =
    pos + 1.  Returns (out (B, 1, d), k_cache, v_cache), plus (k_scale,
    v_scale) when ``kv_scales`` is given.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, x)
    pos = position.to(torch.int32)
    q = apply_rope(cfg, q, pos[:, None])
    k = apply_rope(cfg, k, pos[:, None])
    rows = torch.arange(B, device=x.device)
    if block_tables is None:
        if kv_scales is not None:
            raise ValueError("kv_scales belong to the paged pool layout")
        k_cache[rows, pos.long()] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, pos.long()] = v[:, 0].to(v_cache.dtype)
    else:
        bs, T = k_cache.shape[1], block_tables.shape[1]
        blk = block_tables[rows, torch.clamp(pos // bs, max=T - 1).long()] \
            .long()
        off = (pos % bs).long()
        if kv_scales is not None:
            k_scale, v_scale = kv_scales
            kq, ks1 = kv_quant.quantize(k[:, 0], cfg.kv_dtype)
            vq, vs1 = kv_quant.quantize(v[:, 0], cfg.kv_dtype)
            kv_quant.raw(k_cache)[blk, off] = kv_quant.raw(kq)
            kv_quant.raw(v_cache)[blk, off] = kv_quant.raw(vq)
            k_scale[blk, off] = ks1
            v_scale[blk, off] = vs1
        else:
            k_cache[blk, off] = k[:, 0].to(k_cache.dtype)
            v_cache[blk, off] = v[:, 0].to(v_cache.dtype)
    out = decode_ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, pos + 1, block_tables,
        kernel=cfg.attn_kernel, kv_scales=kv_scales)
    out = out.reshape(B, 1, -1).to(x.dtype) @ p["wo"]
    if kv_scales is not None:
        return (out, k_cache, v_cache) + tuple(kv_scales)
    return out, k_cache, v_cache


def mlp_shapes(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, Tuple[int, ...]]:
    """The MLP's leaves (``d_ff`` or the config's), as the reference's
    ``init_mlp`` lays them out: gated activations have ``w_gate``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {"w_up": (d, f), "w_down": (f, d)}


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
