"""Transformer layers of the dense family: norm, rotary embeddings, QKV
projection, SwiGLU/GeGLU/GELU MLP, and paged single-token attention.

Port of the serving-path functions of ``repro.models.layers``, as plain
functions on tensors over explicit parameter dictionaries.  The
arithmetic follows the reference: fp32 norm statistics and rotary
angles, compute-dtype matmuls.
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

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Scaled normal init (fan-in): N(0, 1/fan_in), the distribution of
    the reference's ``dense_init`` (not its bits)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.bfloat16) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


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


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     position: torch.Tensor, block_tables: torch.Tensor):
    """Single-token decode over a paged pool, with the pool written in
    place.

    x: (B, 1, d); position: (B,) int32 per-row index of the new token;
    k_pool/v_pool: (N, bs, Hk, D) one layer's pool; block_tables: (B, T)
    int32.  The new K/V is stored at ``block_tables[b, pos // bs]``, offset
    ``pos % bs`` — in place, where the reference returns a new pool — then
    the attention read goes through ``decode_ops.decode_attention`` with
    lengths = pos + 1.  Dead lanes carry all-trash tables, so their writes
    land in the trash block; the table index is clamped to the table, as
    the reference's gather clamps it.

    Returns (out (B, 1, d), k_pool, v_pool).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, x)
    pos = position.to(torch.int32)
    q = apply_rope(cfg, q, pos[:, None])
    k = apply_rope(cfg, k, pos[:, None])
    bs, T = k_pool.shape[1], block_tables.shape[1]
    rows = torch.arange(B, device=x.device)
    blk = block_tables[rows, torch.clamp(pos // bs, max=T - 1).long()].long()
    off = (pos % bs).long()
    k_pool[blk, off] = k[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v[:, 0].to(v_pool.dtype)
    out = decode_ops.decode_attention(
        q[:, 0].contiguous(), k_pool, v_pool, pos + 1, block_tables,
        kernel=cfg.attn_kernel)
    return out.reshape(B, 1, -1).to(x.dtype) @ p["wo"], k_pool, v_pool


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
