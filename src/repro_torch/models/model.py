"""Dense-family model over a paged KV pool: init, prefill chunks, decode.

Port of the serving path of ``repro.models.model`` for the dense family.
Parameters are a plain dictionary laid out as the reference's tree —
``embed``, ``final_norm``, ``lm_head``, and ``blocks`` whose leaves stack
the layers on axis 0 — so weights carry across unchanged
(``models.convert``).  Layers run in a Python loop where the reference
scans.  The KV pool is a dict of two (L, N, bs, Hk, D) bf16 tensors,
updated IN PLACE by ``prefill_slots``, ``decode_step`` and
``copy_cache_block``, which return the same dict to keep the reference's
signatures.  Plain large products are ``@``, as the reference leaves them
to XLA; attention goes through the paged kernels' entry points.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.models import layers

Params = Dict[str, Any]

#: Pool representations the port serves (the quantized ones come later).
FP_KV_DTYPES = ("bf16", "fp")


def _check_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: the port serves the dense family, not {cfg.family!r}")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (dense family), as the reference's
    ``init_params`` lays it out."""
    _check_dense(cfg, "param_shapes")
    d, h, hk, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    L = cfg.num_layers

    def norm():
        n = {"scale": (d,)}
        if cfg.norm == "layernorm":
            n["bias"] = (d,)
        return n

    attn = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
            "wo": (h * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(h * hd,), bk=(hk * hd,), bv=(hk * hd,))
    if cfg.activation in ("swiglu", "geglu"):
        mlp = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    else:
        mlp = {"w_up": (d, f), "w_down": (f, d)}
    block = {"ln_attn": norm(), "attn": attn, "ln_mlp": norm(), "mlp": mlp}
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab_size, d),
        "final_norm": norm(),
        "blocks": {g: {k: (L,) + s for k, s in leaves.items()}
                   for g, leaves in block.items()},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def param_count(cfg: ModelConfig) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return math.prod(tree)
    return count(param_shapes(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Seeded random parameters with the reference's distributions (not
    its bits): N(0, 1/fan_in) weights, N(0, 0.02^2) embeddings, unit norm
    scales, zero biases.  Drawn on ``device`` from one explicit
    ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = param_shapes(cfg)

    def make(path, shape):
        name = path[-1]
        if name == "embed":
            return layers.embed_init(gen, shape, dtype)
        if name == "scale":
            return torch.ones(shape, dtype=dtype, device=dev)
        if name in ("bias", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return layers.dense_init(gen, shape, dtype=dtype)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return make(path, tree)

    return walk(shapes, ())


def layer_params(params: Params, layer: int) -> Params:
    """One layer's view of the stacked ``blocks`` leaves."""
    return {g: {k: v[layer] for k, v in leaves.items()}
            for g, leaves in params["blocks"].items()}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None) -> Params:
    """KV cache as a pool of fixed-size token blocks, (L, num_blocks,
    block_size, Hk, hd) bf16 for K and for V.  Block 0 is the trash block
    dead lanes write into; the host-side ``serving.paged.BlockStore``
    hands out the rest.  bf16 whatever the parameter dtype, as in the
    reference."""
    _check_dense(cfg, "init_paged_cache")
    if cfg.kv_dtype not in FP_KV_DTYPES:
        raise NotImplementedError(
            f"kv_dtype {cfg.kv_dtype!r}: the port's pool is bf16 only")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def copy_cache_block(cache: Params, src: int, dst: int) -> Params:
    """Copy one block's payload across all layers (``src -> dst``), in
    place: the copy-on-write half of block sharing.  The reference gets
    the same O(block) cost from a jitted scatter with the pool donated."""
    for x in cache.values():
        x[:, dst] = x[:, src]
    return cache


def _attn_qkv(cfg: ModelConfig, blk: Params, x: torch.Tensor,
              positions: torch.Tensor):
    """Norm, QKV projection and RoPE: (q, k, v) in compute dtype."""
    xn = layers.apply_norm(cfg, blk["ln_attn"], x)
    q, k, v = layers._project_qkv(cfg, blk["attn"], xn, xn)
    return (layers.apply_rope(cfg, q, positions),
            layers.apply_rope(cfg, k, positions), v)


def _attn_post(cfg: ModelConfig, blk: Params, x: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """Residual + output projection, then the MLP half (dense branch)."""
    x = x + a @ blk["attn"]["wo"]
    return x + layers.apply_mlp(cfg, blk["mlp"],
                                layers.apply_norm(cfg, blk["ln_mlp"], x))


def unembed(cfg: ModelConfig, params: Params, h: torch.Tensor):
    h = layers.apply_norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def prefill_slots(cfg: ModelConfig, params: Params, cache: Params,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  block_tables: torch.Tensor,
                  start: Optional[torch.Tensor] = None,
                  all_logits: bool = False) -> Tuple[torch.Tensor, Params]:
    """Prefill one left-padded prompt CHUNK per row into the paged pool.

    tokens: (Bn, P) int, each row's chunk LEFT-padded to P; lengths:
    (Bn,) int32 true token count of the chunk; block_tables: (Bn, T) int32
    rows of the block table, grown by the caller to cover this chunk's
    writes; start: None for a first chunk (rows start at position 0), else
    (Bn,) int32 positions already cached per row — the chunk attends to
    them through the table (prefix-cache hits and long prompts take this
    path).

    Pad positions are masked out of the attention, and pad RoPE positions
    are clipped to each row's first real position.  Per layer the chunk's
    K/V is left-compacted and written at positions ``start + i`` in place;
    the junk tail is dropped.

    Returns (last-real-token logits (Bn, vocab), cache) — or, with
    ``all_logits``, per-position logits (Bn, P, vocab) (rows < pad junk).
    """
    _check_dense(cfg, "prefill_slots")
    Bn, P = tokens.shape
    dev = tokens.device
    first = start is None
    lengths = lengths.to(torch.int32)
    pad = P - lengths  # (Bn,)
    h = params["embed"][tokens.long()]
    start_v = torch.zeros(Bn, dtype=torch.int32, device=dev) if first \
        else start.to(torch.int32)
    positions = start_v[:, None] + torch.clamp(
        torch.arange(P, device=dev)[None] - pad[:, None], min=0)
    for layer in range(cfg.num_layers):
        blk = layer_params(params, layer)
        q, k, v = _attn_qkv(cfg, blk, h, positions)
        a, _, _ = prefill_ops.prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            cache["k"][layer], cache["v"][layer], lengths, block_tables,
            start=None if first else start_v, kernel=cfg.attn_kernel)
        h = _attn_post(cfg, blk, h, a)
    # Left padding aligns every row's last REAL token at index P - 1.
    if all_logits:
        return unembed(cfg, params, h), cache
    return unembed(cfg, params, h[:, -1]), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, position: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step over the paged pool.

    tokens: (B, 1); position: (B,) int32 index of each row's new token;
    block_tables: (B, T) int32 (required: the port's cache is paged).
    ``active`` is accepted for the reference's signature; the dense family
    ignores it (dead lanes are masked by their trash tables).

    Returns (logits (B, 1, vocab), cache) with the pool written in place.
    """
    _check_dense(cfg, "decode_step")
    if block_tables is None:
        raise NotImplementedError(
            "decode_step: the port's KV cache is paged; pass block_tables")
    h = params["embed"][tokens.long()]
    pos = torch.as_tensor(position, dtype=torch.int32, device=h.device) \
        .expand(tokens.shape[0])
    for layer in range(cfg.num_layers):
        blk = layer_params(params, layer)
        a, _, _ = layers.attention_decode(
            cfg, blk["attn"], layers.apply_norm(cfg, blk["ln_attn"], h),
            cache["k"][layer], cache["v"][layer], pos, block_tables)
        h = h + a
        h = h + layers.apply_mlp(cfg, blk["mlp"],
                                 layers.apply_norm(cfg, blk["ln_mlp"], h))
    return unembed(cfg, params, h), cache
