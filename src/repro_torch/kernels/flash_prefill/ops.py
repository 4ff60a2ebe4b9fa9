"""Public chunked-prefill attention entry point.

``prefill_attention`` is what ``models.model.prefill_slots`` (and so the
serving engine's prefill chunks) calls once per layer.  The
``attn_kernel`` knob (``kernels.flash_decode.ops.resolve_kernel``) picks
the CUDA kernel or the plain PyTorch version, as on the decode side.
Pools placed over a mesh (``parallel.sharding.Sharded``) run the call
once per place (``_sharded_paged_prefill``), each on its own contiguous
head slice of its pool replica, which it writes in place, and on its
lanes' rows (over data axes above 1; a place without lanes launches
nothing).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_decode.ops import check_placed, \
    resolve_kernel
from repro_torch.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill
from repro_torch.kernels.flash_prefill.ref import prefill_attention_ref
from repro_torch.parallel import sharding


def prefill_attention(q, k_new, v_new, k_pool, v_pool, lengths,
                      block_tables, *, start: Optional[torch.Tensor] = None,
                      prefix: int = 0, kernel: str = "auto",
                      kv_scales=None, kv_dtype: Optional[str] = None,
                      mesh=None):
    """One layer of paged chunked-prefill attention + new-token K/V write.

    q: (B, S, H, D) rotated chunk queries (S = prefix + P, prompt tokens
    LEFT-padded to P); k_new/v_new: (B, S, Hk, D); k_pool/v_pool: (N, bs,
    Hk, D) shared block pool, updated in place; lengths: (B,) int32 true
    chunk token counts; block_tables: (B, T) int32; start: None for first
    chunks, else (B,) int32 cached positions per row; kv_scales +
    kv_dtype: (k_scale, v_scale) (N, bs, Hk) fp32, updated in place, and
    the payload encoding ("int8"/"fp8") of a SCLAD pool — both
    implementations dequantize the context on load, fake-quantize the
    chunk's own K/V before attending, and store quantized payload and
    scales.

    Returns (attn_out (B, S, H*D), k_pool, v_pool), with (k_scale,
    v_scale) appended for a SCLAD pool.

    Pools that are ``sharding.Sharded`` (placed once, cut on their KV
    heads where the ``model`` axis divides Hk, else whole on every
    shard) run per shard (``_sharded_paged_prefill``).  mesh: the gate
    for plain pools, as ``decode_attention``'s: one the mesh would cut
    raises ``TypeError``; otherwise the single-device call.
    """
    if isinstance(k_pool, sharding.Sharded):
        return _sharded_paged_prefill(q, k_new, v_new, k_pool, v_pool,
                                      lengths, block_tables, start, prefix,
                                      kernel, kv_scales, kv_dtype)
    check_placed(mesh, k_pool, block_tables)
    fn = paged_flash_prefill if resolve_kernel(kernel, q.device) \
        else prefill_attention_ref
    return fn(q, k_new, v_new, k_pool, v_pool, lengths, block_tables,
              start=start, prefix=prefix, kv_scales=kv_scales,
              kv_dtype=kv_dtype)


def _sharded_paged_prefill(q, k_new, v_new, k_pool, v_pool, lengths,
                           block_tables, start, prefix, kernel, kv_scales,
                           kv_dtype):
    """Chunked prefill once per model shard.

    The pools are inputs and outputs (the scatter is fused in): each
    shard writes the chunk's K/V of its own Hk/m heads into its own pool
    slice, in place, so the shards' pools together are the single-device
    write and no pool byte moves here (over data axes above 1 each data
    place writes its lanes' rows into its replica; the model then copies
    them to the others, ``sharding.gather_writes``).  The output is (B,
    S, H*D) head-major, so the shards' outputs concatenate on the last
    axis in head order.  Tables, lengths and start are placed as q is.
    Plain q / k_new / v_new are placed by ``paged_attn_specs`` and the
    output gathered; a
    ``Sharded`` q (the model's path) gets the per-shard outputs.
    """
    mesh, cut = k_pool.mesh, k_pool.dim is not None
    sp = sharding.paged_attn_specs()

    def place(x, spec):
        return sharding.shard(x, spec if cut else sharding.P(), mesh)

    scales = tuple(kv_scales or ())
    host = [sharding.broadcast(x, mesh) for x in (lengths, block_tables,
                                                   start)]
    out = sharding.smap(
        lambda q_, k_, v_, kp, vp, l_, t_, st, sc: prefill_attention(
            q_, k_, v_, kp, vp, l_, t_, start=st, prefix=prefix,
            kernel=kernel, kv_scales=sc or None, kv_dtype=kv_dtype)[0],
        place(q, sp["q_chunk"]), place(k_new, sp["new_kv"]),
        place(v_new, sp["new_kv"]), k_pool, v_pool, *host, scales,
        mesh=mesh, dim=2 if cut else None)
    if not isinstance(q, sharding.Sharded):
        out = sharding.gather(out)
    return (out, k_pool, v_pool) + scales
