"""Transformer layers: norms (and Mamba-2's gated RMSNorm), rotary and
sinusoidal positions, QKV projection, full causal or bidirectional
attention (``_sdpa``, ``chunked_attention``, ``self_attend``,
``attention``), cross
attention over precomputed K/V, SwiGLU/GeGLU/GELU MLP, and single-token
decode attention over a paged pool (bf16, f8 or SCLAD int8/fp8) or
dense stripes, on one device or per shard of a ``model`` mesh axis.

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
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.models import kv_quant
from repro_torch.parallel import sharding

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


def rmsnorm_gated(scale: torch.Tensor, x: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Mamba-2's gated RMSNorm: norm(x * silu(z)), the gate rounded to
    x's dtype before the product, as in the reference."""
    xf = (x * F.silu(z.float()).to(x.dtype)).float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


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


@functools.lru_cache(maxsize=16)
def sinusoidal_positions(seq_len: int, d: int,
                         device: torch.device) -> torch.Tensor:
    """Whisper's absolute sinusoidal embeddings (seq_len, d) in bf16,
    computed in fp32 numpy as the reference does; on ``device``, copied
    there once per length."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    dim = np.arange(d // 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device,
                                                         torch.bfloat16)


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
              use_rope: bool = True, use_kernel: bool = False
              ) -> torch.Tensor:
    """Full self-attention over x (B, S, d) -> (B, S, d) (``self_attend``
    of its projections, ``use_kernel`` as there)."""
    q, k, v = _project_qkv(cfg, p, x, x)
    if use_rope:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return self_attend(cfg, q, k, v, causal, use_kernel) @ p["wo"]


#: The flash-attention kernel's query and key tile: S must divide into it.
FLASH_TILE = 128


def fits_flash_attention(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether self-attention of these shapes meets the flash-attention
    kernel's rules: S a multiple of its 128-position tiles, a head dim
    in ``HEAD_DIMS`` (64, 128), as many keys as queries.  Whisper-base's
    1500 encoder frames and zamba2-7b's head dim 112 do not."""
    S, D = q.shape[1], q.shape[3]
    return S % FLASH_TILE == 0 and D in HEAD_DIMS and k.shape[1] == S


def self_attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, causal: bool = True,
                use_kernel: bool = False) -> torch.Tensor:
    """q (B, S, H, D) over k/v (B, S, Hk, D) of the same positions ->
    (B, S, H*D).  With ``use_kernel`` (the no-grad full-sequence forward on
    the card) through ``flash_attention.ops.attention`` where
    ``fits_flash_attention``; otherwise the reference's arithmetic:
    blockwise at and above ``CHUNKED_ATTN_THRESHOLD`` tokens (when S
    divides into ``Q_CHUNK``s), one masked ``_sdpa`` below."""
    B, S, H, D = q.shape
    if use_kernel and fits_flash_attention(q, k):
        return attn_ops.attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal) \
            .reshape(B, S, H * D)
    if S >= CHUNKED_ATTN_THRESHOLD and S % Q_CHUNK == 0:
        return chunked_attention(q, k, v, causal)
    mask = None
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
    return _sdpa(cfg, q, k, v, mask)


def cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    ctx_k: torch.Tensor, ctx_v: torch.Tensor) -> torch.Tensor:
    """x (B, Sq, d) attends, unmasked, over precomputed ctx_k / ctx_v
    (B, Skv, Hk, D) -> (B, Sq, d).  Plain PyTorch: the reference has no
    kernel here."""
    B, Sq, _ = x.shape
    q = (x @ p["wq"]).reshape(B, Sq, cfg.num_heads, cfg.head_dim)
    return _sdpa(cfg, q, ctx_k, ctx_v) @ p["wo"]


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     position: torch.Tensor, block_tables=None,
                     kv_scales=None, use_rope: bool = True, mesh=None):
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
        bf16 or f8 stripes and the new K/V lands at ``[b, pos]``.

    An f8 pool or f8 stripes (``kv_dtype="f8"``) store the K/V cast to
    float8_e4m3fn (``kv_quant.put``).  The plain read casts them to the
    compute dtype; the kernels take the f8 tensors as they are and widen
    each element on load (every e4m3 value is exact in bf16 and fp32).

    ``use_rope=False`` (whisper: absolute positions) leaves q and k
    unrotated.  Writes happen in place, where the reference returns new
    caches.  The read goes through ``decode_ops.decode_attention`` with
    lengths = pos + 1.  Returns (out (B, 1, d), k_cache, v_cache), plus
    (k_scale, v_scale) when ``kv_scales`` is given.

    With a ``mesh`` (either layout) every argument but ``cfg`` is a
    ``sharding.Sharded`` (x and the positions and tables equal on every
    shard) and so is the output: each shard projects its own heads
    (column-parallel q/k/v, ``sharding.shard_cfg``), stores its K/V into
    its pool or stripe slice (``kv_quant.put``, f8 as bytes), reads
    through the sharded dispatch (the paged or dense decode kernel once a
    shard) and multiplies by its rows of ``wo``; a ``psum`` sums the
    partials.  Where the heads do not divide the axis the attention
    leaves and the cache are whole on every shard, each shard computes
    every head, and nothing is summed.
    """
    cut = sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1
    lcfg = sharding.shard_cfg(cfg, mesh)
    q, pos = sharding.smap(
        lambda p_, x_, k_, v_, pos_, t_, s_: _decode_store(
            lcfg, p_, x_, k_, v_, pos_, t_, s_, use_rope),
        p, x, k_cache, v_cache, position, block_tables, kv_scales,
        mesh=mesh, dim=(1 if cut else None, None))
    lens = sharding.smap(lambda x_: x_ + 1, pos, mesh=mesh)
    out = decode_ops.decode_attention(
        q, k_cache, v_cache, lens, block_tables, kernel=cfg.attn_kernel,
        kv_scales=kv_scales, mesh=mesh)
    out = sharding.smap(
        lambda o, x_, wo: o.reshape(x_.shape[0], 1, -1).to(x_.dtype) @ wo,
        out, x, p["wo"], mesh=mesh)
    if cut:
        out = sharding.psum(out)
    if kv_scales is not None:
        return (out, k_cache, v_cache) + tuple(kv_scales)
    return out, k_cache, v_cache


#: The pool's trash block: dead lanes write there, no live lane reads it,
#: and the block store (``serving.paged``) never hands it out.
TRASH_BLOCK = 0


def pool_slots(block_tables: torch.Tensor, pos: torch.Tensor, bs: int):
    """(block, offset), int64, of cache positions ``pos`` ((B,) or (B, S),
    row r through row r of ``block_tables``) in a pool of ``bs``-row
    blocks; a position past the table lands in its last entry."""
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device).view(
        -1, *[1] * (pos.dim() - 1))
    blk = block_tables.long()[
        rows, torch.clamp(pos // bs, max=block_tables.shape[1] - 1)]
    return blk, pos % bs


def _decode_store(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  position: torch.Tensor, block_tables, kv_scales,
                  use_rope: bool):
    """``attention_decode``'s projection, rotation and cache store: the
    new token's (B, H, D) queries (contiguous) and the int32 positions."""
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, x)
    pos = position.to(torch.int32)
    if use_rope:
        q = apply_rope(cfg, q, pos[:, None])
        k = apply_rope(cfg, k, pos[:, None])
    rows = torch.arange(B, device=x.device)
    if block_tables is None:
        if kv_scales is not None:
            raise ValueError("kv_scales belong to the paged pool layout")
        kv_quant.put(k_cache, (rows, pos.long()), k[:, 0])
        kv_quant.put(v_cache, (rows, pos.long()), v[:, 0])
    else:
        blk, off = pool_slots(block_tables, pos, k_cache.shape[1])
        if kv_scales is not None:
            k_scale, v_scale = kv_scales
            kq, ks1 = kv_quant.quantize(k[:, 0], cfg.kv_dtype)
            vq, vs1 = kv_quant.quantize(v[:, 0], cfg.kv_dtype)
            kv_quant.raw(k_cache)[blk, off] = kv_quant.raw(kq)
            kv_quant.raw(v_cache)[blk, off] = kv_quant.raw(vq)
            k_scale[blk, off] = ks1
            v_scale[blk, off] = vs1
        else:
            kv_quant.put(k_cache, (blk, off), k[:, 0])
            kv_quant.put(v_cache, (blk, off), v[:, 0])
    return q[:, 0].contiguous(), pos


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
