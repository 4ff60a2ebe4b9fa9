"""The model of every family: init, the full-sequence forward and the
training loss, paged prefill chunks and decode (the attention families),
and the wave path's dense-cache prefill and decode (all six).

Port of ``repro.models.model``, serving over a (data, model) mesh
included (``prefill_slots`` / ``decode_step`` with ``mesh=`` on the paged
pool; ``prefill`` / ``decode_step`` with ``mesh=`` on the wave path's
dense caches, every family; tensor-parallel over ``model``, each data
place running its own lanes' rows), and the training loss over a placed
(data, model) mesh
(``loss_fn(mesh=)``: FSDP gathers a layer inside its rematerialized body,
TP over ``model`` for every family, the Mamba-2 blocks cut on their
heads):

  * dense — GQA decoder blocks (tinyllama, stablelm, phi3, granite);
  * moe — the same attention with an MoE FFN (``models.moe``; qwen2-moe,
    qwen3-moe), whose routing skips pads and dead lanes;
  * vlm — a dense backbone behind a stub patch-embedding prefix
    (internvl2): ``num_patches`` projected embeddings take the cache
    positions before the prompt's;
  * ssm — a stack of Mamba-2 blocks (``models.ssm``; mamba2);
  * hybrid — Mamba-2 groups of ``hybrid.attn_every`` blocks, each followed
    by one shared attention block (zamba2), then a tail of Mamba-2 blocks;
  * audio — whisper's encoder over stub frame embeddings and a decoder
    with causal self-attention and cross-attention, sinusoidal positions,
    no rope.

Parameters are a plain dictionary laid out as the reference's tree —
``embed``, ``final_norm``, ``lm_head``, ``patch_proj`` (vlm), and stacked
block leaves: ``blocks`` (L, ...) for dense/moe/vlm/ssm, ``groups``
(groups, per, ...), ``tail`` (tail, ...) and an unstacked
``shared_attn`` for hybrid, ``enc_blocks`` / ``enc_norm`` /
``dec_blocks`` for audio — so weights carry across unchanged
(``models.convert``).  Layers run in Python loops where the reference
scans.  Two caches:

  * the paged pool (continuous batching, attention families only): (L,
    N, bs, Hk, D) ``k``/``v`` leaves, bf16, float8_e4m3fn for
    ``kv_dtype="f8"`` (no scales), or — for a SCLAD ``kv_dtype``
    ("int8"/"fp8") — the compressed payload plus (L, N, bs, Hk) fp32
    ``k_scale``/``v_scale``;
  * the wave path's dense caches (``init_cache``): (L, B, ctx, Hk, D)
    stripes in ``kv_store_dtype`` (bf16, float8_e4m3fn for "f8"), ctx =
    max_len plus the vlm patch prefix; stacked
    ``conv``/``state`` Mamba-2 caches for ssm (and hybrid's ``groups`` /
    ``tail``, beside its (groups, B, max_len, Hk, D) ``attn_k``/``attn_v``
    stripes); self-attention stripes plus ``cross_k``/``cross_v`` of the
    encoder's frames for audio.

Caches are updated IN PLACE by ``prefill_slots``, ``decode_step`` and
``copy_cache_block``, which return the same dict to keep the reference's
signatures.  Plain large products are ``@``, as the reference leaves them
to XLA; decode and chunked-prefill attention go through the kernels'
entry points, and so does the ssm and hybrid prefill's SSD scan.

``forward`` (and ``loss_fn`` over it) is differentiated by plain torch
autograd, as the reference differentiates its jnp attention and scan: no
kernel has a backward.  With grad disabled on the card it routes
self-attention through the flash-attention kernel and the Mamba-2 scans
through the SSD kernel (``kernel_route``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import resolve_kernel
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.models import kv_quant, layers, moe as moe_lib, ssm as ssm_lib
from repro_torch.parallel import sharding

Params = Dict[str, Any]

#: Weight of the MoE load-balancing loss in ``loss_fn``.
MOE_AUX_COEF = 0.01

#: The families with attention KV caches: the paged pool's.
ATTENTION_FAMILIES = ("dense", "moe", "vlm")


def check_paged(cfg: ModelConfig, what: str) -> None:
    """The paged pool holds attention K/V: the recurrent families (ssm,
    hybrid, audio) have no block-addressable cache, as in the
    reference."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"{what}: paged KV caches cover the attention families "
            f"{ATTENTION_FAMILIES}, not {cfg.family!r}")


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, Mamba-2 blocks a group, tail blocks) of a hybrid stack:
    zamba2-7b's 81 layers are 13 groups of 6 and a tail of 3."""
    per = cfg.hybrid.attn_every
    groups = cfg.num_layers // per
    return groups, per, cfg.num_layers - groups * per


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes, as the reference's ``init_params``
    lays it out: moe blocks hold ``moe`` (``moe.param_shapes``) where
    dense ones hold ``mlp``; vlm adds the (d, d) ``patch_proj``; ssm
    blocks hold ``ln`` and ``mamba`` (``ssm.param_shapes``), stacked
    (groups, per, ...) and (tail, ...) in a hybrid beside one unstacked
    ``shared_attn`` dense block; audio has ``enc_blocks``, ``enc_norm``
    and ``dec_blocks`` (self- and cross-attention)."""
    d, h, hk, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    L, fam = cfg.num_layers, cfg.family

    def norm():
        n = {"scale": (d,)}
        if cfg.norm == "layernorm":
            n["bias"] = (d,)
        return n

    def attn():
        a = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
             "wo": (h * hd, d)}
        if cfg.qkv_bias:
            a.update(bq=(h * hd,), bk=(hk * hd,), bv=(hk * hd,))
        return a

    def stack(lead, block):
        return _tree_map(lambda s: lead + s, block)

    def dense_block():
        return {"ln_attn": norm(), "attn": attn(), "ln_mlp": norm(),
                "mlp": layers.mlp_shapes(cfg)}

    def ssm_block():
        return {"ln": norm(), "mamba": ssm_lib.param_shapes(cfg)}

    shapes: Dict[str, Any] = {"embed": (cfg.vocab_size, d),
                              "final_norm": norm()}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    if fam == "moe":
        shapes["blocks"] = stack((L,), {
            "ln_attn": norm(), "attn": attn(), "ln_mlp": norm(),
            "moe": moe_lib.param_shapes(cfg)})
    elif fam in ("dense", "vlm"):
        shapes["blocks"] = stack((L,), dense_block())
        if fam == "vlm":
            shapes["patch_proj"] = (d, d)
    elif fam == "ssm":
        shapes["blocks"] = stack((L,), ssm_block())
    elif fam == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        shapes["groups"] = stack((groups, per), ssm_block())
        if tail:
            shapes["tail"] = stack((tail,), ssm_block())
        shapes["shared_attn"] = dense_block()
    elif fam == "audio":
        shapes["enc_blocks"] = stack((cfg.encdec.num_encoder_layers,),
                                     dense_block())
        shapes["enc_norm"] = norm()
        shapes["dec_blocks"] = stack((L,), {
            "ln_self": norm(), "self_attn": attn(), "ln_cross": norm(),
            "cross_attn": attn(), "ln_mlp": norm(),
            "mlp": layers.mlp_shapes(cfg)})
    else:
        raise ValueError(fam)
    return shapes


def param_count(cfg: ModelConfig) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return math.prod(tree)
    return count(param_shapes(cfg))


def param_count_active(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE experts scaled by top-k/E), summed
    in the reference's leaf order."""
    total = 0.0
    for path, shape in tree_lib.flatten(param_shapes(cfg)):
        keys = path.split("/")
        n = float(math.prod(shape))
        if cfg.moe is not None and "moe" in keys and "shared" not in keys \
                and keys[-1] in ("w_gate", "w_up", "w_down"):
            n *= cfg.moe.num_experts_per_tok / cfg.moe.num_experts
        total += n
    return int(total)


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16, mesh=None) -> Params:
    """Seeded random parameters with the reference's distributions (not
    its bits): N(0, 1/fan_in) weights, N(0, 0.02^2) embeddings, unit norm
    scales, zero biases; the MoE router in fp32 whatever ``dtype`` is, as
    in the reference; the Mamba-2 leaves the reference fixes take its
    values (``ssm.fixed_leaf``: ``A_log``, ``D`` and ``dt_bias`` in
    fp32).  Drawn on ``device`` from one explicit
    ``torch.Generator``, in fp32 pieces of at most 256 MiB
    (``layers.INIT_CHUNK``), so init peaks that much above the weights.

    With a ``mesh`` each leaf is cut for serving
    (``sharding.serve_specs``) as soon as it is drawn, so the whole tree
    is never held twice: the same values as without a mesh, placed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = None if mesh is None \
        else sharding.serve_specs(cfg, param_specs(cfg), mesh)

    def make(path, shape):
        name = path[-1]
        if "mamba" in path:
            fixed = ssm_lib.fixed_leaf(name, shape, dtype, dev)
            if fixed is not None:
                return fixed
        if name == "embed":
            return layers.embed_init(gen, shape, dtype)
        if name == "scale":
            return torch.ones(shape, dtype=dtype, device=dev)
        if name in ("bias", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return layers.dense_init(
            gen, shape, dtype=torch.float32 if name == "router" else dtype)

    def walk(tree, path, spec):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,), None if spec is None else spec[k])
                    for k, v in tree.items()}
        x = make(path, tree)
        return x if spec is None else sharding.shard(x, spec, mesh)

    return walk(param_shapes(cfg), (), specs)


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors — shapes and dtypes, no
    storage: the twin of the reference's ``param_specs`` (its
    ``eval_shape`` of ``init_params``: bf16, the router and the fixed
    Mamba-2 leaves fp32)."""
    def make(path, shape):
        name = path[-1]
        fixed = ssm_lib.fixed_leaf(name, shape, torch.bfloat16, "meta") \
            if "mamba" in path else None
        if fixed is not None:
            return fixed
        return torch.empty(shape, device="meta", dtype=torch.float32
                           if name == "router" else torch.bfloat16)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return make(path, tree)

    return walk(param_shapes(cfg), ())


def layer_params(params: Params, layer: int, key: str = "blocks",
                 group: Optional[int] = None) -> Params:
    """One layer's view of the stacked ``key`` leaves (a hybrid's
    ``groups`` take the group index first)."""
    if group is None:
        return _tree_map(lambda v: v[layer], params[key])
    return _tree_map(lambda v: v[group, layer], params[key])


def kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    """Dense-stripe (and fp pool) storage dtype: bf16, float8_e4m3fn for
    ``kv_dtype="f8"`` (half the bytes).  The SCLAD values only change the
    paged pool's layout; the stripes keep bf16 under them, as in the
    reference."""
    return torch.float8_e4m3fn if cfg.kv_dtype == "f8" else torch.bfloat16


def _zeros_like_stacked(one: Params, lead: Tuple[int, ...]) -> Params:
    return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               conv_dtype: torch.dtype = torch.bfloat16, mesh=None) -> Params:
    """The wave path's dense caches, zeros, as the reference lays them
    out: (L, batch, ctx, Hk, hd) ``k`` and ``v`` stripes in
    ``kv_store_dtype`` (ctx = max_len, plus ``num_patches`` for the vlm
    family's patch prefix); ssm: the Mamba-2 cache (``conv``, ``state``)
    stacked (L, ...); hybrid: ``groups`` stacked (groups, per, ...),
    ``tail`` (tail, ...) and the shared block's (groups, batch, max_len,
    Hk, hd) ``attn_k``/``attn_v``; audio: ``k``/``v`` stripes and the
    encoder frames' (L, batch, frames, Hk, hd) ``cross_k``/``cross_v``.
    ``conv_dtype``: the Mamba-2 conv windows' (bf16, the reference's;
    ``prefill`` passes its compute dtype, which the reference's prompt
    pass leaves there).

    With a ``mesh`` (``device`` is then ignored) every leaf is a
    ``sharding.Sharded`` placed by ``sharding.wave_cache_specs``: the
    stripes cut on their KV heads, the Mamba-2 states on their heads and
    the conv windows by components, where the heads divide the axis,
    else whole on every shard; every leaf cut on its batch dim over data
    axes that divide ``batch``.  Each part is made on its device; no
    whole cache is built."""
    if mesh is not None:
        meta = init_cache(cfg, batch, max_len, "meta", conv_dtype)
        specs = sharding.wave_cache_specs(cfg, meta, mesh)
        return tree_lib.map_leaves(lambda x, spec: sharding.place_new(
            x.shape, spec, mesh, lambda sh, d: torch.zeros(
                sh, dtype=x.dtype, device=d)), meta, specs)
    dev = resolve_device(device)
    fam, L = cfg.family, cfg.num_layers

    def stripes(lead, ctx):
        return _stripes(cfg, lead + (batch, ctx), dev)

    if fam in ATTENTION_FAMILIES:
        ctx = max_len + (cfg.num_patches if fam == "vlm" else 0)
        return {"k": stripes((L,), ctx), "v": stripes((L,), ctx)}
    if fam == "audio":
        F_ = cfg.encdec.encoder_seq_len
        return {"k": stripes((L,), max_len), "v": stripes((L,), max_len),
                "cross_k": stripes((L,), F_), "cross_v": stripes((L,), F_)}
    one = ssm_lib.init_mamba_cache(cfg, batch, dev, conv_dtype)
    if fam == "ssm":
        return _zeros_like_stacked(one, (L,))
    groups, per, tail = hybrid_layout(cfg)
    cache = {"groups": _zeros_like_stacked(one, (groups, per)),
             **_hybrid_stripes(cfg, batch, max_len, dev)}
    if tail:
        cache["tail"] = _zeros_like_stacked(one, (tail,))
    return cache


def _stripes(cfg: ModelConfig, lead: Tuple[int, ...], dev) -> torch.Tensor:
    """Zero K (or V) stripes (*lead, Hk, hd) in ``kv_store_dtype``."""
    return torch.zeros(lead + (cfg.num_kv_heads, cfg.head_dim),
                       dtype=kv_store_dtype(cfg), device=dev)


def _hybrid_stripes(cfg: ModelConfig, batch: int, max_len: int, dev):
    """A hybrid's shared-attention stripes, (groups, batch, max_len, Hk,
    hd) for K and for V."""
    lead = (hybrid_layout(cfg)[0], batch, max_len)
    return {"attn_k": _stripes(cfg, lead, dev),
            "attn_v": _stripes(cfg, lead, dev)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    """The wave path's dense caches (``init_cache``) as ``meta`` tensors:
    the twin of the reference's ``cache_specs``."""
    return init_cache(cfg, batch, max_len, device="meta")


def _pool_leaves(cfg: ModelConfig, num_blocks: int, block_size: int):
    """{leaf: (shape, dtype, fill)} of the paged pool."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    if not kv_quant.is_quantized(cfg.kv_dtype):
        kvd = kv_store_dtype(cfg)
        return {"k": (shape, kvd, 0), "v": (shape, kvd, 0)}
    kvd = kv_quant.payload_dtype(cfg.kv_dtype)
    return {"k": (shape, kvd, 0), "v": (shape, kvd, 0),
            "k_scale": (shape[:-1], torch.float32, 1),
            "v_scale": (shape[:-1], torch.float32, 1)}


def _filled(shape, dtype, fill, device) -> torch.Tensor:
    make = torch.ones if fill else torch.zeros
    return make(shape, dtype=dtype, device=device)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None, mesh=None) -> Params:
    """KV cache as a pool of fixed-size token blocks, (L, num_blocks,
    block_size, Hk, hd) for K and for V.  Block 0 is the trash block
    dead lanes write into; the host-side ``serving.paged.BlockStore``
    hands out the rest.  bf16 whatever the parameter dtype, as in the
    reference, or float8_e4m3fn with no scale leaves for ``kv_dtype="f8"``
    (fp-exact: each value is the K/V cast); with a SCLAD ``cfg.kv_dtype``
    ("int8"/"fp8") the leaves
    hold the compressed payload and two more fp32 leaves ``k_scale`` /
    ``v_scale`` (L, num_blocks, block_size, Hk) hold the per-position,
    per-head scales, initialised to ones (an all-zero payload row's scale
    by the quantizer's convention).  Block identity (sharing,
    copy-on-write, LRU) covers payload and scales as one unit.

    With a ``mesh`` (``device`` is then ignored) every leaf is a
    ``sharding.Sharded`` placed per ``sharding.cache_specs(paged=True)``,
    sanitized: payload and scale leaves cut together on the KV-head axis
    over ``model`` (each shard dequantizes its own heads), or whole on
    every shard where Hk does not divide the axis — the same gate as
    ``sharding.attn_shard_size``, so placement and dispatch agree.  Over
    the data axes the pool is whole (any table may point anywhere in it):
    each data index holds its own replica, which its lanes read and
    write, kept equal to the others by ``sharding.gather_writes``.  Each
    part is made on its device; no whole pool is built."""
    check_paged(cfg, "init_paged_cache")
    leaves = _pool_leaves(cfg, num_blocks, block_size)
    if mesh is None:
        dev = resolve_device(device)
        return {k: _filled(shape, dt, fill, dev)
                for k, (shape, dt, fill) in leaves.items()}
    meta = {k: torch.empty(shape, device="meta")
            for k, (shape, _, _) in leaves.items()}
    with sharding.use_axes(mesh):
        specs = sharding.sanitize_specs(
            sharding.cache_specs(cfg, meta, None, 1, paged=True), meta)
    return {k: sharding.place_new(
        shape, specs[k], mesh,
        lambda sh, d, dt=dt, fill=fill: _filled(sh, dt, fill, d),
        data_replicas=True)
        for k, (shape, dt, fill) in leaves.items()}


def _gather_pool_writes(cache: Params, split, fn, *xs) -> None:
    """The pool rows each data place wrote in this call copied to the
    other data replicas (``sharding.gather_writes``): ``fn`` gives one
    data index's (block, offset) of its live writes from its model shard
    0's parts of the call's placed scheduler inputs ``xs``."""
    if split is None:
        return
    firsts = split.firsts()
    written = [fn(*(None if x is None else x.parts[firsts[i]] for x in xs))
               if split.rows[i] else None for i in range(len(split.rows))]
    sharding.gather_writes(list(cache.values()), split, written)


def _live(blk: torch.Tensor, off: torch.Tensor, keep: torch.Tensor):
    """(block, offset) of the kept writes, the trash block's left out."""
    keep = keep & (blk != layers.TRASH_BLOCK)
    return blk[keep], off[keep]


def _chunk_writes(S: int, prefix: int, bs: int):
    """The pool rows a prefill chunk of S = prefix + P columns writes, as
    the K2 scatter computes them (``flash_prefill.ref
    .scatter_new_kv_ref``): row r at positions start + i, i < prefix +
    length, through its table."""
    def fn(tables, start, lengths):
        dev = tables.device
        st = torch.zeros(tables.shape[0], dtype=torch.long, device=dev) \
            if start is None else start.long()
        dest = st[:, None] + torch.arange(S, device=dev)[None]
        keep = torch.arange(S, device=dev)[None] < prefix + lengths[:, None]
        return _live(*layers.pool_slots(tables, dest, bs), keep)
    return fn


def _decode_writes(bs: int):
    """The pool row a decode step writes a row: its position through its
    table (``layers.pool_slots``, as ``layers._decode_store`` stores)."""
    def fn(tables, pos):
        blk, off = layers.pool_slots(tables, pos, bs)
        return _live(blk, off, torch.ones_like(blk, dtype=torch.bool))
    return fn


def _layer_scales(cache: Params, layer: int):
    """One layer's (k_scale, v_scale) of a SCLAD pool, else None."""
    if "k_scale" not in cache:
        return None
    return cache["k_scale"][layer], cache["v_scale"][layer]


def copy_cache_block(cache: Params, src: int, dst: int) -> Params:
    """Copy one block across all layers and every leaf — payload and, for
    a SCLAD pool, scales — (``src -> dst``), in place: the copy-on-write
    half of block sharing.  The reference gets
    the same O(block) cost from a jitted scatter with the pool donated.
    A sharded pool copies within each shard's part: every part keeps its
    device, shape and cut."""
    for x in cache.values():
        for part in (x.distinct_parts() if isinstance(x, sharding.Sharded)
                     else (x,)):
            kv_quant.raw(part)[:, dst] = kv_quant.raw(part)[:, src]
    return cache


def _attn_qkv(cfg: ModelConfig, blk: Params, x: torch.Tensor,
              positions: torch.Tensor):
    """Norm, QKV projection and RoPE: (q, k, v) in compute dtype."""
    xn = layers.apply_norm(cfg, blk["ln_attn"], x)
    q, k, v = layers._project_qkv(cfg, blk["attn"], xn, xn)
    return (layers.apply_rope(cfg, q, positions),
            layers.apply_rope(cfg, k, positions), v)


def _attn_block_body(cfg: ModelConfig, blk: Params, x: torch.Tensor,
                     positions: torch.Tensor, mesh=None, rows=None):
    """One layer over a plain causal window (the wave path's prefill;
    every token routes, as in the reference):
    returns (x_out, k, v) with k/v of this call's tokens in the compute
    dtype (``layers.self_attend``).  Over a ``mesh`` each shard attends
    with its own heads (k/v then cut on their heads) and ``wo`` and the
    FFN run as ``_attn_post(mesh=)``; ``rows`` a serving call's
    ``sharding.CallRows`` (the MoE's groups)."""
    lcfg = sharding.shard_cfg(cfg, mesh)
    q, k, v = sharding.smap(
        lambda b_, x_, pos: _attn_qkv(lcfg, b_, x_, pos), blk, x, positions,
        mesh=mesh, dim=_head_dim(cfg, mesh))
    a = sharding.smap(lambda q_, k_, v_: layers.self_attend(lcfg, q_, k_, v_),
                      q, k, v, mesh=mesh)
    return _attn_post(cfg, blk, x, a, mesh=mesh, rows=rows), k, v


def _head_dim(cfg: ModelConfig, mesh) -> Optional[int]:
    """The dim of a (B, S, heads, D) projection cut over ``mesh``: 2
    where the attention heads are cut, else None (whole on every
    shard)."""
    return 2 if sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1 \
        else None


def _psum_rows(y, w):
    """The shards' partial products with ``w``'s rows summed (``psum``)
    where ``w`` is cut, else y."""
    return y if sharding.cut_dim(w) is None else sharding.psum(y)


def _attn_post(cfg: ModelConfig, blk: Params, x: torch.Tensor,
               a: torch.Tensor,
               moe_valid: Optional[torch.Tensor] = None,
               mesh=None, rows=None) -> torch.Tensor:
    """Residual + output projection, then the FFN half.  Over a ``mesh``
    ``wo`` is row-parallel where the heads are cut: a ``psum`` of the
    shards' partials."""
    return _attn_post_aux(cfg, blk, x, a, moe_valid, mesh, rows)[0]


def _attn_post_aux(cfg: ModelConfig, blk: Params, x, a, moe_valid=None,
                   mesh=None, rows=None):
    """``_attn_post`` and the MoE load-balancing loss (``_ffn_aux``)."""
    y = sharding.smap(lambda a_, wo: a_ @ wo, a, blk["attn"]["wo"],
                      mesh=mesh)
    if sharding.cut_dim(blk["attn"]["wo"]) is not None:
        y = sharding.psum(y)
    return _ffn_aux(cfg, blk, sharding.smap(torch.add, x, y, mesh=mesh),
                    moe_valid, mesh, rows)


def _ffn(cfg: ModelConfig, blk: Params, x: torch.Tensor,
         moe_valid: Optional[torch.Tensor] = None,
         mesh=None, rows=None) -> torch.Tensor:
    """x plus the MLP — or, in a moe block, the MoE FFN, with
    ``moe_valid`` (x's leading dims, bool) keeping pads and dead lanes
    out of the expert capacity — of the normed x."""
    return _ffn_aux(cfg, blk, x, moe_valid, mesh, rows)[0]


def _ffn_aux(cfg: ModelConfig, blk: Params, x: torch.Tensor,
             moe_valid: Optional[torch.Tensor] = None, mesh=None,
             rows=None):
    """``_ffn`` and the MoE load-balancing loss: (x_out, aux), aux None
    for an MLP block.  Over a ``mesh`` the MLP is column- then
    row-parallel (a ``psum`` of the down projection's partials) and the
    MoE as ``moe.apply_moe(mesh=)``.  ``rows``: a serving call's
    ``sharding.CallRows``, from which the MoE forms the reference's
    dispatch groups (None: training)."""
    xn = _norm(cfg, blk["ln_mlp"], x, mesh)
    if "moe" in blk:
        y, aux = moe_lib.apply_moe(cfg, blk["moe"], xn, valid=moe_valid,
                                   mesh=mesh, rows=rows)
    else:
        y, aux = sharding.smap(lambda p_, x_: layers.apply_mlp(cfg, p_, x_),
                               blk["mlp"], xn, mesh=mesh), None
        if sharding.cut_dim(blk["mlp"]["w_down"]) is not None:
            y = sharding.psum(y)
    return sharding.smap(torch.add, x, y, mesh=mesh), aux


def _norm(cfg: ModelConfig, p: Params, x, mesh=None):
    """``layers.apply_norm`` of x by the norm leaves p, on each shard."""
    return sharding.smap(lambda n, x_: layers.apply_norm(cfg, n, x_), p, x,
                         mesh=mesh)


def _prepend_patches(w, patch_embeds, h, mesh=None):
    """The vlm stub frontend: patch embeddings (B, num_patches, d) times
    ``patch_proj`` ``w`` in their promoted dtype (bf16 embeddings meet
    fp32 params in fp32, as jnp promotes them), cast to h's dtype and
    put ahead of h's positions.  Over a ``mesh`` a ``w`` cut on its
    columns projects each shard's columns, then all_gathers them."""
    def project(pe, w_, x):
        ct = torch.promote_types(pe.dtype, w_.dtype)
        return (pe.to(ct) @ w_.to(ct)).to(x.dtype)

    patches = sharding.all_gather(sharding.smap(
        project, patch_embeds, w, h, mesh=mesh,
        dim=None if sharding.cut_dim(w) is None else 2))
    return sharding.smap(lambda a_, b_: torch.cat([a_, b_], dim=1),
                         patches, h, mesh=mesh)


def _embed(embed, tokens: torch.Tensor, mesh=None):
    """Token embeddings of ``tokens``.  Over a ``mesh`` (the tokens on
    every shard) a table cut on the vocab is a masked lookup per shard,
    then a ``psum``; one cut on d_model (a vocab that does not divide the
    axis) is an ``all_gather`` of the shards' columns."""
    if sharding.cut_dim(embed) == 0:
        V = embed.parts[0].shape[0]
        mi = sharding.axis_index(mesh, sharding.TP_AXIS)
        parts = []
        for i, e, t in zip(mi, embed.parts, tokens.parts):
            if t is None:  # a place without lanes
                parts.append(None)
                continue
            t = t.long() - i * V
            ok = (t >= 0) & (t < V)
            parts.append(e[t.clamp(0, V - 1)].masked_fill(~ok[..., None], 0))
        return sharding.psum(sharding.Sharded(tuple(parts), None, mesh))
    return sharding.all_gather(sharding.smap(
        lambda e, t: e[t.long()], embed, tokens, mesh=mesh,
        dim=None if sharding.cut_dim(embed) is None else len(tokens.shape)))


def unembed(cfg: ModelConfig, params: Params, h: torch.Tensor, mesh=None,
            split=None):
    """Final norm and the vocab projection.  Over a ``mesh`` (h equal on
    every model shard of a data index) a column-parallel ``lm_head`` (or
    tied table cut on the vocab) gathers the logits; one cut on d_model
    sums the shards' partial products (``psum``).  The logits come back
    on place 0's device, in batch order: the rows of each data index
    gathered there where ``split`` (``sharding.split_rows``) cuts them."""
    out = _unembed_placed(cfg, params, h, mesh)
    return out if mesh is None else sharding.gather_rows(out, split)


def _unembed_placed(cfg: ModelConfig, params: Params, h, mesh=None):
    """``unembed`` over a ``mesh`` as a ``Sharded``: every place's logits
    (its data shard's rows), whole over ``model``."""
    hn = _norm(cfg, params["final_norm"], h, mesh)
    tied = cfg.tie_embeddings
    w = params["embed"] if tied else params["lm_head"]
    cut = sharding.cut_dim(w)

    def product(x, w_):
        return x @ w_.T if tied else x @ w_

    if cut is not None and cut == (1 if tied else 0):
        n = w.parts[0].shape[1 if tied else 0]
        mi = sharding.axis_index(mesh, sharding.TP_AXIS)
        return sharding.psum(sharding.Sharded(tuple(
            None if x is None else product(x[..., i * n:(i + 1) * n], w_)
            for i, x, w_ in zip(mi, hn.parts, w.parts)), None, mesh))
    return sharding.all_gather(sharding.smap(
        product, hn, w, mesh=mesh,
        dim=None if cut is None else len(h.shape) - 1))


def prefill_slots(cfg: ModelConfig, params: Params, cache: Params,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  block_tables: torch.Tensor,
                  start: Optional[torch.Tensor] = None,
                  patch_embeds: Optional[torch.Tensor] = None,
                  all_logits: bool = False,
                  mesh=None, lanes=None) -> Tuple[torch.Tensor, Params]:
    """Prefill one left-padded prompt CHUNK per row into the paged pool.

    tokens: (Bn, P) int, each row's chunk LEFT-padded to P; lengths:
    (Bn,) int32 true token count of the chunk; block_tables: (Bn, T) int32
    rows of the block table, grown by the caller to cover this chunk's
    writes; start: None for a first chunk (rows start at position 0), else
    (Bn,) int32 positions already cached per row, INCLUDING a vlm patch
    prefix — the chunk attends to them through the table (prefix-cache
    hits and long prompts take this path); patch_embeds: the vlm family's
    (Bn, num_patches, d) first-chunk images (zeros when None; continuations
    ignore it).  A SCLAD pool (``cfg.kv_dtype`` "int8"/"fp8") is read
    dequantized and written quantized, scales included.

    A vlm first chunk puts the projected patches ahead of the tokens: the
    ``num_patches`` prefix takes positions 0.. and the tokens follow it.
    Pad positions are masked out of the attention, and pad RoPE positions
    are clipped to each row's first real position; MoE routing skips the
    pads (they consume no expert capacity).  Per layer the row's K/V is
    left-compacted ([patches | chunk | junk]) and written at positions
    ``start + i`` in place; the junk tail is dropped.

    Returns (last-real-token logits (Bn, vocab), cache) — or, with
    ``all_logits``, per-position logits (Bn, P, vocab) over the chunk's
    token columns (rows < pad junk; the patch prefix excluded).

    With a ``mesh`` the parameters and the pool are ``sharding.Sharded``
    (``sharding.place_serve``, ``init_paged_cache(mesh=)``) and the same
    layer loop runs tensor-parallel: one controller drives every shard,
    each shard runs the single-device arithmetic on its own parts, and
    the shards meet only in ``sharding.psum`` / ``all_gather``.  The
    layout is ``sharding.serve_specs``': the embedding cut on the vocab
    (``_embed``) or, where the vocab does not divide the axis
    (granite-3-8b's 49155, internvl2-26b's 92553 at 2 ways), on d_model;
    q/k/v and their biases column-parallel, each shard attending with
    its own heads; ``wo`` row-parallel, then psum; the MLP column- then
    row-parallel, then psum (the MoE as ``moe.apply_moe(mesh=)``);
    ``lm_head`` as ``unembed`` says.  Where Hk does not divide the axis
    (phi3-medium-14b's 10 kv heads at 4 ways, the reduced tinyllama's 2)
    attention and the pool stay whole on every shard and only the FFN is
    cut: explicit per-shard heads cannot split mid-head as GSPMD may.
    Every other argument and the logits live on place 0's device.

    Over data axes above 1 each data place takes the rows of its lanes
    (``sharding.split_rows``: ``lanes`` a ``sharding.Lanes`` naming each
    row's lane, by default row j is lane j of Bn; every place takes every
    row where the lanes' width does not divide the data axes) and runs
    them on its replica of the pool, K2 once a (data, model) place with
    rows; a place without rows runs nothing.  The rows each place wrote
    then reach the other replicas (``sharding.gather_writes``), and the
    logits come back in row order.  The MoE dispatches in the reference's
    groups of the call's rows (``sharding.call_rows``: the rows in order,
    or, with ``lanes.all_lanes``, every lane of the width — a verify
    pass), whichever data place holds them, on experts cut over data.
    """
    check_paged(cfg, "prefill_slots")
    Bn, P = tokens.shape
    dev = tokens.device
    first = start is None
    lengths = lengths.to(torch.int32)
    prefix = cfg.num_patches if cfg.family == "vlm" and first else 0
    if prefix and patch_embeds is None:
        patch_embeds = torch.zeros((Bn, cfg.num_patches, cfg.d_model),
                                   dtype=torch.bfloat16, device=dev)
    start_v = torch.zeros(Bn, dtype=torch.int32, device=dev) if first \
        else start.to(torch.int32)
    pad = P - lengths  # (Bn,)
    positions = start_v[:, None] + prefix + torch.clamp(
        torch.arange(P, device=dev)[None] - pad[:, None], min=0)
    if prefix:
        positions = torch.cat([torch.arange(prefix, device=dev)[None]
                               .expand(Bn, prefix), positions], dim=1)
    # Real keys (the patch prefix and the chunk's tokens): the MoE
    # routing's validity mask.
    sidx = torch.arange(prefix + P, device=dev)[None]
    real_key = (sidx < prefix) | (sidx >= prefix + pad[:, None])
    attn = dict(start=None if first else start_v, prefix=prefix,
                kernel=cfg.attn_kernel,
                kv_dtype=cfg.kv_dtype
                if kv_quant.is_quantized(cfg.kv_dtype) else None)
    split = sharding.split_rows(mesh, lanes, Bn)
    rows = sharding.call_rows(lanes, Bn, split)
    bc = functools.partial(sharding.scatter, mesh=mesh, split=split)
    h = _embed(params["embed"], bc(tokens), mesh)
    if prefix:
        h = _prepend_patches(params["patch_proj"], bc(patch_embeds), h,
                             mesh)
    positions, real_key = bc(positions), bc(real_key)
    lengths, tables = bc(lengths), bc(block_tables)
    attn["start"] = bc(attn["start"])
    lcfg = sharding.shard_cfg(cfg, mesh)
    for layer in range(cfg.num_layers):
        blk = layer_params(params, layer)
        q, k, v = sharding.smap(
            lambda b_, x, pos: tuple(t.contiguous()
                                     for t in _attn_qkv(lcfg, b_, x, pos)),
            blk, h, positions, mesh=mesh, dim=_head_dim(cfg, mesh))
        a = prefill_ops.prefill_attention(
            q, k, v, cache["k"][layer], cache["v"][layer], lengths, tables,
            kv_scales=_layer_scales(cache, layer), mesh=mesh, **attn)[0]
        h = _attn_post(cfg, blk, h, a, moe_valid=real_key, mesh=mesh,
                       rows=rows)
    _gather_pool_writes(cache, split,
                        _chunk_writes(prefix + P, prefix,
                                      cache["k"].shape[2]),
                        tables, attn["start"], lengths)
    # Left padding aligns every row's last REAL token at index S - 1.
    h = sharding.smap(lambda x: x[:, prefix:] if all_logits else x[:, -1],
                      h, mesh=mesh)
    return unembed(cfg, params, h, mesh, split), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, position: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                mesh=None) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step.

    tokens: (B, 1); position: a scalar or (B,) int32 index of each row's
    new token among the prompt and generated tokens (a vlm row's cache
    position adds ``num_patches``; audio takes one scalar, as the
    reference does).  With ``block_tables`` (B, T) int32 the cache is the
    paged pool (bf16 or SCLAD, ``init_paged_cache``; attention families
    only); without, it is the wave path's dense cache (``init_cache``):
    stripes written at ``[rows, pos]``, Mamba-2 windows and states
    replaced.  ``active`` (B,) bool marks live lanes: the moe family
    routes only those (dead lanes consume no expert capacity); attention
    ignores it (dead lanes are masked by their trash tables).

    Returns (logits (B, 1, vocab), cache) with the cache written in place.

    With a ``mesh`` the layer loop runs tensor-parallel, as
    ``prefill_slots`` says, on the paged pool (``init_paged_cache(mesh=)``)
    or on the dense caches (``init_cache(mesh=)``, every family): each
    shard writes and reads its own stripe heads (the dense decode kernel
    once a shard), and updates its own Mamba-2 heads' states and windows
    (``ssm.apply_mamba_decode(mesh=)``); whisper's cross-attention reads
    each shard's cross K/V heads, its ``wo`` partials summed.  Over data
    axes above 1 each data place steps its own lanes' rows (row j is
    lane j of B, ``prefill_slots`` says which data place runs it): on its
    pool replica, K1 once a (data, model) place, its live writes then
    gathered to the other replicas; or on its rows of the dense caches
    (``init_cache(mesh=)`` cuts them on the batch alike), K3 once a
    place and each place's Mamba-2 states and windows.
    """
    fam = cfg.family
    if block_tables is not None:
        check_paged(cfg, "decode_step")
    prefix = cfg.num_patches if fam == "vlm" else 0
    pos = (torch.as_tensor(position, dtype=torch.int32, device=tokens.device)
           + prefix).expand(tokens.shape[0])
    split = sharding.split_rows(mesh, None, tokens.shape[0])
    rows = sharding.call_rows(None, tokens.shape[0], split)
    bc = functools.partial(sharding.scatter, mesh=mesh, split=split)
    h = _embed(params["embed"], bc(tokens), mesh)
    pos, tables = bc(pos.contiguous()), bc(block_tables)
    valid = bc(None if active is None else active[:, None])
    if fam in ATTENTION_FAMILIES:
        for layer in range(cfg.num_layers):
            blk = layer_params(params, layer)
            scales = None if block_tables is None \
                else _layer_scales(cache, layer)
            h = _attn_decode(cfg, blk, h, cache["k"][layer],
                             cache["v"][layer], pos, tables, scales, valid,
                             mesh, rows)
        if block_tables is not None:
            _gather_pool_writes(cache, split,
                                _decode_writes(cache["k"].shape[2]), tables,
                                pos)
    elif fam == "ssm":
        for layer in range(cfg.num_layers):
            h = _mamba_decode(cfg, layer_params(params, layer), cache,
                              (layer,), h, mesh)
    elif fam == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        for g in range(groups):
            for i in range(per):
                h = _mamba_decode(cfg, layer_params(params, i, "groups", g),
                                  cache["groups"], (g, i), h, mesh)
            h = _attn_decode(cfg, params["shared_attn"], h,
                             cache["attn_k"][g], cache["attn_v"][g], pos,
                             mesh=mesh)
        for i in range(tail):
            h = _mamba_decode(cfg, layer_params(params, i, "tail"),
                              cache["tail"], (i,), h, mesh)
    elif fam == "audio":
        if torch.as_tensor(position).dim() != 0:
            raise ValueError("audio decode takes one scalar position")
        ctx = cache["k"].shape[2]
        h = sharding.smap(lambda x, p_: x + layers.sinusoidal_positions(
            ctx, cfg.d_model, x.device)[p_[0].long()], h, pos, mesh=mesh)
        for layer in range(cfg.num_layers):
            blk = layer_params(params, layer, "dec_blocks")
            xn = _norm(cfg, blk["ln_self"], h, mesh)
            a = layers.attention_decode(
                cfg, blk["self_attn"], xn, cache["k"][layer],
                cache["v"][layer], pos, use_rope=False, mesh=mesh)[0]
            h = sharding.smap(torch.add, h, a, mesh=mesh)
            h = _cross_attend(cfg, blk, h, cache["cross_k"][layer],
                              cache["cross_v"][layer], mesh)
            h = _ffn(cfg, blk, h, mesh=mesh)
    else:
        raise ValueError(fam)
    return unembed(cfg, params, h, mesh, split), cache


def _attn_decode(cfg: ModelConfig, blk: Params, h, k_cache, v_cache, pos,
                 tables=None, scales=None, valid=None, mesh=None, rows=None):
    """One attention layer's decode step (norm, ``layers.attention_decode``
    with its cache store, residual, FFN); returns h after the layer."""
    xn = _norm(cfg, blk["ln_attn"], h, mesh)
    a = layers.attention_decode(cfg, blk["attn"], xn, k_cache, v_cache, pos,
                                tables, kv_scales=scales, mesh=mesh)[0]
    return _ffn(cfg, blk, sharding.smap(torch.add, h, a, mesh=mesh), valid,
                mesh, rows)


def _cross_attend(cfg: ModelConfig, blk: Params, h, ck, cv, mesh=None):
    """h plus whisper's cross-attention of the normed h over the cached
    frames' K/V (stored in the stripes' dtype, read in h's), each shard
    over its own heads, ``wo``'s partials summed."""
    lcfg = sharding.shard_cfg(cfg, mesh)
    c = sharding.smap(
        lambda n, p_, x, k_, v_: layers.cross_attention(
            lcfg, p_, layers.apply_norm(cfg, n, x), k_.to(x.dtype),
            v_.to(x.dtype)),
        blk["ln_cross"], blk["cross_attn"], h, ck, cv, mesh=mesh)
    return sharding.smap(torch.add, h,
                         _psum_rows(c, blk["cross_attn"]["wo"]), mesh=mesh)


def _mamba_decode(cfg: ModelConfig, blk: Params, caches: Params, idx,
                  h: torch.Tensor, mesh=None) -> torch.Tensor:
    """One Mamba-2 block's decode step, its window and state at ``idx``
    of the stacked ``caches`` replaced in place; returns h plus the
    block's output."""
    xn = _norm(cfg, blk["ln"], h, mesh)
    y, new = ssm_lib.apply_mamba_decode(
        cfg, blk["mamba"], {k: v[idx] for k, v in caches.items()}, xn,
        mesh=mesh)
    for k, v in new.items():
        kv_quant.put(caches[k], idx, v)
    return sharding.smap(torch.add, h, y, mesh=mesh)


def _mamba_prefill(cfg: ModelConfig, blk: Params, caches: Params, idx,
                   h: torch.Tensor, use_kernel: bool,
                   mesh=None) -> torch.Tensor:
    """One Mamba-2 block over the prompt (the SSD kernel's route with
    ``use_kernel``), its final state and conv window written at ``idx``
    of the stacked ``caches``; returns h plus the block's output."""
    xn = _norm(cfg, blk["ln"], h, mesh)
    y, st = ssm_lib.apply_mamba_block(cfg, blk["mamba"], xn,
                                      use_kernel=use_kernel, mesh=mesh)
    for k, v in st.items():
        kv_quant.put(caches[k], idx, v)
    return sharding.smap(torch.add, h, y, mesh=mesh)


def encode_audio(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                 remat: bool = False, use_kernel: bool = False, mesh=None
                 ) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, F, d) -> (B, F,
    d): sinusoidal positions, bidirectional rope-free attention, the
    ``enc_norm``.  The frames are taken in the parameters' dtype: the
    reference's layer scan needs them there (bf16 frames with fp32
    parameters change its carry's type and do not trace).  ``remat`` and
    ``use_kernel`` as in ``backbone``.  ``mesh``: frames and parameters
    placed — for serving (``place_serve``), or for training
    (``place_train``: each block's leaves gathered as ``_gather_layer``
    says inside its rematerialized body, which is recomputed whole) —
    each shard attending with its own heads, the ``wo`` and MLP partials
    summed; the output equal on every shard of a data shard."""
    dt = params["embed"].dtype
    h = sharding.smap(lambda f: f.to(dt) + layers.sinusoidal_positions(
        f.shape[1], cfg.d_model, f.device)[None], frames, mesh=mesh)
    lcfg = sharding.shard_cfg(cfg, mesh)
    heads_cut = sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1

    def body(x, blk):
        blk = _gather_layer(cfg, blk, mesh, heads_cut)
        a = sharding.smap(
            lambda n, p_, x_: layers.attention(
                lcfg, p_, layers.apply_norm(cfg, n, x_), None, causal=False,
                use_rope=False, use_kernel=use_kernel),
            blk["ln_attn"], blk["attn"], x, mesh=mesh)
        x = sharding.smap(torch.add, x, _psum_rows(a, blk["attn"]["wo"]),
                          mesh=mesh)
        return _ffn(cfg, blk, x, mesh=mesh)

    h = _run_blocks(body, h, params["enc_blocks"], remat, mesh is None)
    return _norm(cfg, params["enc_norm"], h, mesh)


# ---------------------------------------------------------------------------
# The full-sequence forward (training, evaluation) and the loss
# ---------------------------------------------------------------------------

def kernel_route(cfg: ModelConfig, device: torch.device) -> bool:
    """Whether the full-sequence forward takes the kernels: only with
    grad disabled (no kernel has a backward, so a kernel would hand
    autograd a detached result), then as ``cfg.attn_kernel`` resolves on
    ``device``.  ``attn_kernel="on"`` with grad enabled raises."""
    if torch.is_grad_enabled():
        if cfg.attn_kernel == "on":
            raise ValueError(
                "attn_kernel='on' with grad enabled: the kernels have no "
                "backward; run the forward under torch.no_grad() or use "
                "'auto'/'off'")
        return False
    return resolve_kernel(cfg.attn_kernel, device)


def _unstack(tree) -> List[Params]:
    """The per-layer views of stacked leaves (leading axis), one
    ``unbind`` per leaf: autograd stacks their gradients back in one
    pass, where indexing layer by layer would build a full-size gradient
    for every layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, sharding.Sharded):
        return tree.unbind()
    return list(torch.unbind(tree, 0))


def _maybe_remat(fn, remat: bool, early_stop: bool = True):
    """``fn`` under activation checkpointing when ``remat`` and grad is
    enabled: its activations are recomputed in the backward pass (the
    reference's ``jax.checkpoint``).  ``early_stop=False`` recomputes
    the whole of ``fn``, not only up to its last saved activation (the
    sharded step: its collectives then run twice, countably)."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False,
                                 early_stop=early_stop)


def _run_blocks(body, h: torch.Tensor, stacked: Params, remat: bool,
                early_stop: bool = True) -> torch.Tensor:
    """h through ``body(h, block)`` for each block of the ``stacked``
    leaves, each block rematerialized when ``remat`` (``early_stop`` as
    in ``_maybe_remat``)."""
    step = _maybe_remat(body, remat, early_stop)
    for blk in _unstack(stacked):
        h = step(h, blk)
    return h


def _pad_to_multiple(h: torch.Tensor, mult: int):
    """h (B, S, d) zero-padded at the end to a multiple of ``mult``
    positions; returns (h, S)."""
    S = h.shape[1]
    return F.pad(h, (0, 0, 0, (-S) % mult)), S


def backbone(cfg: ModelConfig, params: Params, h: torch.Tensor,
             positions: torch.Tensor, remat: bool = False,
             encoder_out: Optional[torch.Tensor] = None,
             use_kernel: bool = False, mesh=None, rows=None):
    """The layer stack on embedded input h (B, S, d), causal over all S
    positions.  ``remat``: each block (and each hybrid group) under
    activation checkpointing.  ``use_kernel`` (``kernel_route``): self-
    attention through the flash-attention kernel where its shape rules
    hold (``layers.fits_flash_attention``), the Mamba-2 scans through the
    SSD kernel.  Returns (h, aux), aux the MoE load-balancing loss summed
    over layers (0 for the other families), a 0-d fp32 tensor.

    mesh: every family over a placed mesh (``sharding.place_train``), one
    loop with the meshless stack (h, positions, ``encoder_out`` and the
    result ``Sharded``): each block's leaves gathered as
    ``_gather_layer`` says inside its body; attention with each shard's
    own heads, ``wo`` and the FFN as ``_attn_post_aux(mesh=)``; a
    Mamba-2 block on each shard's heads (``ssm.apply_mamba_block(mesh=)``:
    the gated norm's sum of squares and ``out_proj``'s partials summed
    over ``model``); zamba2's shared attention block gathered and run in
    every group, so its gradient adds over the groups; whisper's decoder
    attending over its own and the encoder's K/V with each shard's
    heads.  A rematerialized block is recomputed whole
    (``early_stop=False``), its collectives with it.  ``rows``: the
    batch's placement over the data axes (``sharding.train_rows`` of the
    placed tokens), which the MoE reads (its groups, its path): h's parts
    are ``smap``'s, whose shape is a place's, so a cut batch and a whole
    one look alike here.  The routed experts stay cut where they lie on
    d_model over ``model`` (``moe.expert_cuts``: the manual path's
    layout)."""
    fam = cfg.family
    heads_cut = sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1
    lcfg = sharding.shard_cfg(cfg, mesh)
    early = mesh is None

    def attn_layer(x, blk, experts_kept=False):
        blk = _gather_layer(cfg, blk, mesh, heads_cut, experts_kept)
        q, k, v = sharding.smap(
            lambda b_, x_, pos: _attn_qkv(lcfg, b_, x_, pos),
            blk, x, positions, mesh=mesh)
        a = sharding.smap(lambda q_, k_, v_: layers.self_attend(
            lcfg, q_, k_, v_, use_kernel=use_kernel), q, k, v, mesh=mesh)
        return _attn_post_aux(cfg, blk, x, a, mesh=mesh, rows=rows)

    def mamba(x, blk):
        blk = _gather_layer(cfg, blk, mesh, heads_cut)
        y = ssm_lib.apply_mamba_block(
            cfg, blk["mamba"], _norm(cfg, blk["ln"], x, mesh),
            use_kernel=use_kernel, mesh=mesh)[0]
        return sharding.smap(torch.add, x, y, mesh=mesh)

    def run(body, x, stacked):
        return _run_blocks(body, x, stacked, remat, early)

    aux = sharding.smap(lambda x: torch.zeros(
        (), dtype=torch.float32, device=x.device), h, mesh=mesh)
    if fam in ATTENTION_FAMILIES:
        step = _maybe_remat(functools.partial(
            attn_layer, experts_kept=cfg.moe is not None and moe_lib.
            expert_cuts(params["blocks"]["moe"]["w_gate"])[0]),
            remat, early)
        for blk in _unstack(params["blocks"]):
            h, a = step(h, blk)
            if a is not None:
                aux = sharding.smap(torch.add, aux, a, mesh=mesh)
    elif fam == "ssm":
        h = run(mamba, h, params["blocks"])
    elif fam == "hybrid":
        def group(x, grp):
            return attn_layer(run(mamba, x, grp), params["shared_attn"])[0]
        h = run(group, h, params["groups"])
        if "tail" in params:
            h = run(mamba, h, params["tail"])
    elif fam == "audio":
        if encoder_out is None:
            raise ValueError("the audio backbone needs encoder_out")
        hd = cfg.head_dim

        def qkv(n, p_, x_):
            xn = layers.apply_norm(cfg, n, x_)
            return layers._project_qkv(lcfg, p_, xn, xn)

        def cross_kv(e, p_):
            return tuple((e @ p_[w]).reshape(*e.shape[:2],
                                             lcfg.num_kv_heads, hd)
                         for w in ("wk", "wv"))

        def body(x, blk):
            blk = _gather_layer(cfg, blk, mesh, heads_cut)
            q, k, v = sharding.smap(qkv, blk["ln_self"], blk["self_attn"], x,
                                    mesh=mesh)
            a = sharding.smap(lambda q_, k_, v_, wo: layers.self_attend(
                lcfg, q_, k_, v_, True, use_kernel) @ wo, q, k, v,
                blk["self_attn"]["wo"], mesh=mesh)
            x = sharding.smap(torch.add, x,
                              _psum_rows(a, blk["self_attn"]["wo"]),
                              mesh=mesh)
            ck, cv = sharding.smap(cross_kv, encoder_out, blk["cross_attn"],
                                   mesh=mesh)
            return _ffn(cfg, blk, _cross_attend(cfg, blk, x, ck, cv, mesh),
                        mesh=mesh)
        h = run(body, h, params["dec_blocks"])
    else:
        raise ValueError(fam)
    return h, aux


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            remat: bool = False, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  batch: ``tokens`` (B, S) int, plus
    ``patch_embeds`` (B, num_patches, d) for vlm (a prefix whose
    positions are cut from the logits) or ``frames`` (B, F, d) for audio.
    At S >= ``CHUNKED_ATTN_THRESHOLD`` the sequence is zero-padded to a
    multiple of ``Q_CHUNK`` (causal: the pads change no real position).
    Kernels as ``kernel_route`` decides, once.  Returns (logits (B, S,
    vocab) in the parameters' dtype, aux loss).

    mesh: ``params`` and ``batch`` placed on it (every family;
    ``sharding.place_train`` / ``place_batch``), tensor-parallel over
    ``model`` as the paged layer loop is: the embedding cut on the vocab
    (a masked lookup a shard, then ``psum``) or, where the vocab does not
    divide the axis, on d_model over the data axes only (gathered whole
    first), q/k/v column-parallel with each shard's own heads where
    ``attn_shard_size`` allows, ``wo`` and ``w_down`` row-parallel, each
    followed by a ``psum``; the Mamba-2 blocks on each shard's heads
    (``backbone``); whisper's encoder as ``encode_audio(mesh=)``;
    ``lm_head`` column-parallel, its logits all-gathered.  Leaves cut
    over the data axes are all-gathered before use, a layer's inside its
    rematerialized body, so the gathers run again in the backward and
    their transposes are the gradients' reduce-scatters; the attention
    and the scan are the plain ones (no kernel).  Logits and aux are
    then ``Sharded``, each data shard's rows, or every row on every data
    place where the batch does not divide the data axes
    (``sharding.place_batch`` keeps it whole)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    use_kernel = mesh is None and kernel_route(cfg, tokens.device)
    embed = gather_data(params["embed"])
    h = _embed(embed, tokens, mesh)
    encoder_out = None
    prefix = 0
    if cfg.family == "vlm":
        h = _prepend_patches(gather_data(params["patch_proj"]),
                             batch["patch_embeds"], h, mesh)
        prefix = batch["patch_embeds"].shape[1]
    elif cfg.family == "audio":
        encoder_out = encode_audio(cfg, params, batch["frames"], remat,
                                   use_kernel, mesh)
        h = sharding.smap(lambda x: x + layers.sinusoidal_positions(
            S, cfg.d_model, x.device)[None], h, mesh=mesh)
    mult = layers.Q_CHUNK if prefix + S >= layers.CHUNKED_ATTN_THRESHOLD \
        else 1
    h = sharding.smap(lambda x: _pad_to_multiple(x, mult)[0], h, mesh=mesh)
    positions = sharding.smap(
        lambda x: torch.arange(x.shape[1], device=x.device), h, mesh=mesh)
    rows = None if mesh is None else sharding.train_rows(mesh,
                                                          tokens.shape[0])
    h, aux = backbone(cfg, params, h, positions, remat, encoder_out,
                      use_kernel, mesh, rows)
    h = sharding.smap(lambda x: x[:, prefix:prefix + S], h, mesh=mesh)
    head = {"final_norm": params["final_norm"],
            "embed" if cfg.tie_embeddings else "lm_head":
            embed if cfg.tie_embeddings else params["lm_head"]}
    return _unembed_placed(cfg, gather_data(head), h, mesh), aux


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, Any], mesh=None) -> torch.Tensor:
    """Next-token cross-entropy against ``batch["labels"]`` (B, S), fp32
    logits, averaged over B * S, plus ``MOE_AUX_COEF`` times the MoE aux
    loss; the forward runs with ``remat``.

    mesh: ``params`` and ``batch`` placed on it (``sharding.place_train``:
    FSDP over the data axes x TP over ``model``; ``place_batch``: the
    batch cut over the data axes, or whole on every data place where it
    does not divide them) — ``forward(mesh=)``, every family; each of
    the R data places computes its rows' mean loss (on its model shard
    0) and the loss is the mean of those R losses, a 0-d tensor on place
    0's device.  Where the batch is cut that is the mean over all rows
    (the places' rows are equal in number).  Where it is whole, every
    place's loss is the whole batch's, so their mean is that loss once —
    not R times (a sum would be R-fold) — and each place's gradient is
    1/R of the whole: the FSDP gathers' transposes (reduce-scatters) and
    ``sum_replicas`` add the R places' shares back to the whole gradient
    — not 1/R of it.  A place's slice of such a replicated activation
    (the manual MoE's token slices) transposes to a local pad with
    zeros, never to a ``psum`` over data, which would count that
    gradient R times."""
    if mesh is None:
        logits, aux = forward(cfg, params, batch, remat=True)
        return _xent(logits, batch["labels"]) + MOE_AUX_COEF * aux
    firsts = [g[0] for g in sharding.groups(mesh, sharding.TP_AXIS)]
    logits, aux = forward(cfg, params, batch, remat=True, mesh=mesh)
    per = [_xent(logits.parts[k], batch["labels"].parts[k])
           + MOE_AUX_COEF * aux.parts[k] for k in firsts]
    dev0 = per[0].device
    return sum(x.to(dev0) for x in per) / len(per)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# FSDP gathers of the full-sequence forward over a placed mesh
# ---------------------------------------------------------------------------

def gather_data(tree, keep: Callable[[Tuple[str, ...]], bool] = None):
    """Every ``Sharded`` leaf cut over data axes all-gathered over them
    (the FSDP gather), except leaves whose key path ``keep`` accepts."""
    def walk(x, path):
        if isinstance(x, dict):
            return {k: walk(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, sharding.Sharded) and x.rows is not None \
                and not (keep and keep(path)):
            return sharding.all_gather(x, axis=x.rows[0])
        return x
    return walk(tree, ())


#: A block's attention leaves (whisper's decoder has two sets).
ATTN_KEYS = ("attn", "self_attn", "cross_attn")


def _gather_layer(cfg: ModelConfig, blk: Params, mesh, heads_cut: bool,
                  experts_kept: bool = False) -> Params:
    """One layer's leaves ready for use: all-gathered over the data axes
    (FSDP; not the experts on the manual MoE path; a Mamba-2 leaf's
    component cut stays), and the attention leaves all-gathered over
    ``model`` where the heads are not cut (the rule may cut their columns
    mid-head; every shard then computes every head)."""
    def keep(path):
        return experts_kept and "moe" in path and "shared" not in path \
            and path[-1] in ("w_gate", "w_up", "w_down")
    blk = gather_data(blk, keep)
    if heads_cut or sharding.axes_size(mesh, sharding.TP_AXIS) == 1:
        return blk
    return dict(blk, **{a: {k: sharding.all_gather(v)
                            for k, v in blk[a].items()}
                        for a in ATTN_KEYS if a in blk})


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            max_len: int, mesh=None) -> Tuple[torch.Tensor, Params]:
    """The wave path's prompt pass: ``batch["tokens"]`` (B, S) int, all
    rows the same length, through every layer at once — behind the
    projected ``batch["patch_embeds"]`` (B, num_patches, d) for the vlm
    family, over the encoded ``batch["frames"]`` (B, F, d) for audio —
    into fresh dense caches (``init_cache``): each attention layer's K/V
    lands in its stripes at positions [0, prefix + S); audio also stores
    each decoder layer's cross K/V of the frames; each Mamba-2 block
    leaves its final state and conv window.  An ssm or hybrid prompt
    longer than ``ssm.chunk_size`` must be a multiple of it
    (``ssm.ssd_chunked``).  Returns (last-position logits (B, vocab),
    cache).

    With a ``mesh`` (``params`` placed by ``sharding.place_serve``) the
    same layer loop runs tensor-parallel into ``init_cache(mesh=)``'s
    placed caches: the embedding as ``_embed`` says; q/k/v
    column-parallel with each shard's own heads, ``wo`` and the MLP
    row-parallel, then ``psum`` (the MoE as ``moe.apply_moe(mesh=)``,
    every row routing); each Mamba-2 block on the shard's heads
    (``ssm.apply_mamba_block(mesh=)``, the SSD kernel once a shard);
    whisper's encoder likewise, its cross K/V cut on their heads.  Over
    data axes above 1 that divide B each data place runs its rows (row j
    of B to data index j // (B / d): the tokens, patch embeddings and
    frames cut alike) into its rows of the caches (``init_cache(mesh=)``
    cuts them on the batch), K4 once a (data, model) place on its b / d x
    H / m folded rows; else every data place runs every row.  The batch
    and the logits live on place 0's device."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    fam = cfg.family
    dev = tokens.device
    split = sharding.split_rows(mesh, None, B)
    rows = sharding.call_rows(None, B, split)
    bc = functools.partial(sharding.scatter, mesh=mesh, split=split)
    h = _embed(params["embed"], bc(tokens), mesh)
    if fam == "vlm":
        h = _prepend_patches(params["patch_proj"],
                             bc(batch["patch_embeds"]), h, mesh)
    positions = sharding.broadcast(torch.arange(h.shape[1], device=dev),
                                   mesh)
    cache = init_cache(cfg, B, max_len, device=dev, conv_dtype=h.dtype,
                       mesh=mesh)
    ssd_kernel = resolve_kernel(cfg.attn_kernel, dev) \
        if fam in ("ssm", "hybrid") else False

    def store(name, index, x):
        kv_quant.put(cache[name], index, x)

    if fam == "ssm":
        for layer in range(cfg.num_layers):
            h = _mamba_prefill(cfg, layer_params(params, layer), cache,
                               (layer,), h, ssd_kernel, mesh)
    elif fam == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        for g in range(groups):
            for i in range(per):
                h = _mamba_prefill(cfg, layer_params(params, i, "groups", g),
                                   cache["groups"], (g, i), h, ssd_kernel,
                                   mesh)
            h, k, v = _attn_block_body(cfg, params["shared_attn"], h,
                                       positions, mesh)
            store("attn_k", (g, slice(None), slice(S)), k)
            store("attn_v", (g, slice(None), slice(S)), v)
        for i in range(tail):
            h = _mamba_prefill(cfg, layer_params(params, i, "tail"),
                               cache["tail"], (i,), h, ssd_kernel, mesh)
    elif fam == "audio":
        enc = encode_audio(cfg, params, bc(batch["frames"]), mesh=mesh)
        h = sharding.smap(lambda x: x + layers.sinusoidal_positions(
            S, cfg.d_model, x.device)[None], h, mesh=mesh)
        lcfg = sharding.shard_cfg(cfg, mesh)
        heads = _head_dim(cfg, mesh)

        def qkv(n, p_, x):
            xn = layers.apply_norm(cfg, n, x)
            return layers._project_qkv(lcfg, p_, xn, xn)

        for layer in range(cfg.num_layers):
            blk = layer_params(params, layer, "dec_blocks")
            q, k, v = sharding.smap(qkv, blk["ln_self"], blk["self_attn"], h,
                                    mesh=mesh, dim=heads)
            a = sharding.smap(
                lambda q_, k_, v_, wo: layers.self_attend(lcfg, q_, k_, v_)
                @ wo, q, k, v, blk["self_attn"]["wo"], mesh=mesh)
            h = sharding.smap(torch.add, h,
                              _psum_rows(a, blk["self_attn"]["wo"]),
                              mesh=mesh)
            ck, cv = sharding.smap(
                lambda e, p_: tuple((e @ p_[w]).reshape(
                    e.shape[0], -1, lcfg.num_kv_heads, cfg.head_dim)
                    for w in ("wk", "wv")),
                enc, blk["cross_attn"], mesh=mesh, dim=heads)
            h = _ffn(cfg, blk, _cross_attend(cfg, blk, h, ck, cv, mesh),
                     mesh=mesh)
            store("k", (layer, slice(None), slice(S)), k)
            store("v", (layer, slice(None), slice(S)), v)
            store("cross_k", layer, ck)
            store("cross_v", layer, cv)
    else:
        S = h.shape[1]
        for layer in range(cfg.num_layers):
            h, k, v = _attn_block_body(cfg, layer_params(params, layer), h,
                                       positions, mesh, rows)
            store("k", (layer, slice(None), slice(S)), k)
            store("v", (layer, slice(None), slice(S)), v)
    return unembed(cfg, params, sharding.smap(lambda x: x[:, -1], h,
                                              mesh=mesh), mesh, split), cache
