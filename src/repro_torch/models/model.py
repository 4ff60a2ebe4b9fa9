"""Dense-family model: init, paged prefill chunks and decode, and the
wave path's dense-cache prefill and decode.

Port of the serving path of ``repro.models.model`` for the dense family.
Parameters are a plain dictionary laid out as the reference's tree —
``embed``, ``final_norm``, ``lm_head``, and ``blocks`` whose leaves stack
the layers on axis 0 — so weights carry across unchanged
(``models.convert``).  Layers run in a Python loop where the reference
scans.  Two caches:

  * the paged pool (continuous batching): (L, N, bs, Hk, D) ``k``/``v``
    leaves, bf16 or — for a SCLAD ``kv_dtype`` ("int8"/"fp8") — the
    compressed payload plus (L, N, bs, Hk) fp32 ``k_scale``/``v_scale``;
  * dense stripes (the wave path): (L, B, max_len, Hk, D) bf16.

Both are updated IN PLACE by ``prefill_slots``, ``decode_step`` and
``copy_cache_block``, which return the same dict to keep the reference's
signatures.  Plain large products are ``@``, as the reference leaves them
to XLA; decode and chunked-prefill attention go through the kernels'
entry points.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.models import kv_quant, layers

Params = Dict[str, Any]

#: Pool representations the port serves: bf16 and the SCLAD encodings
#: ("f8", float8 stripes and pools without scales, is not ported).
SERVED_KV_DTYPES = ("bf16", "fp", "int8", "fp8")


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


def check_kv_dtype(cfg: ModelConfig) -> None:
    if cfg.kv_dtype not in SERVED_KV_DTYPES:
        raise NotImplementedError(
            f"kv_dtype {cfg.kv_dtype!r} is not ported (the port serves "
            f"{SERVED_KV_DTYPES})")


def kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    """Dense-stripe storage dtype: bf16.  The SCLAD values only change the
    paged pool's layout; the stripes keep bf16 under them, as in the
    reference."""
    check_kv_dtype(cfg)
    return torch.bfloat16


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """Dense KV stripes for the wave path: (L, batch, max_len, Hk, hd)
    ``k`` and ``v`` in ``kv_store_dtype``, zeros."""
    _check_dense(cfg, "init_cache")
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    kvd = kv_store_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=kvd, device=dev),
            "v": torch.zeros(shape, dtype=kvd, device=dev)}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None) -> Params:
    """KV cache as a pool of fixed-size token blocks, (L, num_blocks,
    block_size, Hk, hd) for K and for V.  Block 0 is the trash block
    dead lanes write into; the host-side ``serving.paged.BlockStore``
    hands out the rest.  bf16 whatever the parameter dtype, as in the
    reference; with a SCLAD ``cfg.kv_dtype`` ("int8"/"fp8") the leaves
    hold the compressed payload and two more fp32 leaves ``k_scale`` /
    ``v_scale`` (L, num_blocks, block_size, Hk) hold the per-position,
    per-head scales, initialised to ones (an all-zero payload row's scale
    by the quantizer's convention).  Block identity (sharing,
    copy-on-write, LRU) covers payload and scales as one unit."""
    _check_dense(cfg, "init_paged_cache")
    check_kv_dtype(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    if not kv_quant.is_quantized(cfg.kv_dtype):
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
    kvd = kv_quant.payload_dtype(cfg.kv_dtype)
    return {"k": torch.zeros(shape, dtype=kvd, device=dev),
            "v": torch.zeros(shape, dtype=kvd, device=dev),
            "k_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=dev),
            "v_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=dev)}


def _layer_scales(cache: Params, layer: int):
    """One layer's (k_scale, v_scale) of a SCLAD pool, else None."""
    if "k_scale" not in cache:
        return None
    return cache["k_scale"][layer], cache["v_scale"][layer]


def copy_cache_block(cache: Params, src: int, dst: int) -> Params:
    """Copy one block across all layers and every leaf — payload and, for
    a SCLAD pool, scales — (``src -> dst``), in place: the copy-on-write
    half of block sharing.  The reference gets
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


def _attn_block_body(cfg: ModelConfig, blk: Params, x: torch.Tensor,
                     positions: torch.Tensor):
    """One layer over a plain causal window (the wave path's prefill):
    returns (x_out, k, v) with k/v of this call's tokens in the compute
    dtype.  Blockwise attention at and above
    ``layers.CHUNKED_ATTN_THRESHOLD`` tokens, one masked ``_sdpa``
    below."""
    q, k, v = _attn_qkv(cfg, blk, x, positions)
    S = x.shape[1]
    if S >= layers.CHUNKED_ATTN_THRESHOLD and S % layers.Q_CHUNK == 0:
        a = layers.chunked_attention(q, k, v, causal=True)
    else:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=x.device))
        a = layers._sdpa(cfg, q, k, v, mask)
    return _attn_post(cfg, blk, x, a), k, v


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
    path).  A SCLAD pool (``cfg.kv_dtype`` "int8"/"fp8") is read
    dequantized and written quantized, scales included.

    Pad positions are masked out of the attention, and pad RoPE positions
    are clipped to each row's first real position.  Per layer the chunk's
    K/V is left-compacted and written at positions ``start + i`` in place;
    the junk tail is dropped.

    Returns (last-real-token logits (Bn, vocab), cache) — or, with
    ``all_logits``, per-position logits (Bn, P, vocab) (rows < pad junk).
    """
    _check_dense(cfg, "prefill_slots")
    quantized = kv_quant.is_quantized(cfg.kv_dtype)
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
        a = prefill_ops.prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            cache["k"][layer], cache["v"][layer], lengths, block_tables,
            start=None if first else start_v, kernel=cfg.attn_kernel,
            kv_scales=_layer_scales(cache, layer),
            kv_dtype=cfg.kv_dtype if quantized else None)[0]
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
    """One autoregressive step.

    tokens: (B, 1); position: a scalar or (B,) int32 index of each row's
    new token.  With ``block_tables`` (B, T) int32 the cache is the paged
    pool (bf16 or SCLAD, ``init_paged_cache``); without, it is the wave
    path's dense stripes (``init_cache``), written at ``[rows, pos]``.
    ``active`` is accepted for the reference's signature; the dense family
    ignores it (dead lanes are masked by their trash tables).

    Returns (logits (B, 1, vocab), cache) with the cache written in place.
    """
    _check_dense(cfg, "decode_step")
    h = params["embed"][tokens.long()]
    pos = torch.as_tensor(position, dtype=torch.int32, device=h.device) \
        .expand(tokens.shape[0])
    for layer in range(cfg.num_layers):
        blk = layer_params(params, layer)
        scales = None if block_tables is None \
            else _layer_scales(cache, layer)
        a = layers.attention_decode(
            cfg, blk["attn"], layers.apply_norm(cfg, blk["ln_attn"], h),
            cache["k"][layer], cache["v"][layer], pos, block_tables,
            kv_scales=scales)[0]
        h = h + a
        h = h + layers.apply_mlp(cfg, blk["mlp"],
                                 layers.apply_norm(cfg, blk["ln_mlp"], h))
    return unembed(cfg, params, h), cache


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """The wave path's prompt pass: ``batch["tokens"]`` (B, S) int, all
    rows the same length, through every layer at once; each layer's K/V
    lands in fresh dense stripes (``init_cache``, (L, B, max_len, Hk, hd)
    bf16) at positions [0, S).  Returns (last-position logits (B, vocab),
    cache)."""
    _check_dense(cfg, "prefill")
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    h = params["embed"][tokens.long()]
    positions = torch.arange(S, device=tokens.device)
    for layer in range(cfg.num_layers):
        h, k, v = _attn_block_body(cfg, layer_params(params, layer), h,
                                   positions)
        cache["k"][layer, :, :S] = k.to(cache["k"].dtype)
        cache["v"][layer, :, :S] = v.to(cache["v"].dtype)
    return unembed(cfg, params, h[:, -1]), cache
