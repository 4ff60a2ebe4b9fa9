"""Public decode-attention entry point and the ``attn_kernel`` knob.

``decode_attention`` is what ``models.layers.attention_decode`` (and so
``model.decode_step`` and the serving engine's decode window) calls.  The
cache layout is chosen by ``block_tables``: the paged (N, bs, Hk, D) pool
(bf16, f8, or SCLAD int8/fp8 with ``kv_scales``), or, with ``None``,
dense (B, S, Hk, D) bf16 or f8 stripes (the wave path).  The
implementation is chosen by ``resolve_kernel``:

  * ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors;
  * ``"on"``  — always the kernel; CPU tensors raise (a CUDA kernel has no
    interpret mode);
  * ``"off"`` — always the plain version, on either device.

The same knob selects the prefill-side kernel (``kernels.flash_prefill``)
and, as ``kernel=``, the SCLD matmul of ``SCLDLinear``.

A paged pool or dense stripes placed over a mesh (a
``parallel.sharding.Sharded``: ``model.init_paged_cache(mesh=)``,
``model.init_cache(mesh=)`` or ``sharding.shard``) are read once per
place (``_sharded_decode``): each place calls this same single-device
entry on its contiguous Hk/m slice and H/m query heads — and, over data
axes above 1, on its own lanes' rows (its pool replica, or its rows of
the stripes) — so on the card each place with lanes launches the kernel
at its own head and row counts; a place without lanes launches
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.flash_decode import (flash_decode,
                                                           paged_flash_decode)
from repro_torch.kernels.flash_decode.ref import decode_ref, paged_decode_ref
from repro_torch.parallel import sharding

ATTN_KERNEL_MODES = ("auto", "on", "off")


def resolve_kernel(kernel: str, device: torch.device) -> bool:
    """-> True when tensors on ``device`` take the CUDA kernel."""
    if kernel not in ATTN_KERNEL_MODES:
        raise ValueError(
            f"kernel mode {kernel!r} not in {ATTN_KERNEL_MODES}")
    on_cuda = torch.device(device).type == "cuda"
    if kernel == "on" and not on_cuda:
        raise RuntimeError(
            "kernel mode 'on' needs CUDA tensors: the kernels are CUDA code "
            "with no CPU or interpret mode (use 'auto' or 'off' on the CPU)")
    return on_cuda if kernel == "auto" else kernel == "on"


def decode_attention(q, k_cache, v_cache, lengths, block_tables=None, *,
                     kernel: str = "auto", kv_scales=None, mesh=None):
    """One decode-attention step.

    q: (B, H, D) the new token's rotated queries; k_cache/v_cache: the
    shared (N, bs, Hk, D) block pool when ``block_tables`` (B, T) int32 is
    given, else (B, S, Hk, D) dense bf16 or f8 stripes; lengths: (B,)
    int32 (a scalar or 0-d tensor broadcasts) valid positions per row;
    kv_scales: (k_scale, v_scale) (N, bs, Hk) fp32 of a SCLAD pool (paged
    layout only).  Returns (B, H, D).  The caller owns the cache write of
    the new K/V; this is the read side only.

    A pool or stripes that are a ``sharding.Sharded`` (placed once, cut
    on their KV heads where the ``model`` axis divides Hk, else whole on
    every shard) are read per shard (``_sharded_decode``).  mesh: the
    gate for plain caches — one whose KV heads the mesh's ``model`` axis
    divides (``sharding.attn_shard_size``) must be placed first, and
    raises ``TypeError``; otherwise the single-device call.
    """
    if isinstance(k_cache, sharding.Sharded):
        return _sharded_decode(q, k_cache, v_cache, lengths, block_tables,
                               kernel, kv_scales)
    check_placed(mesh, k_cache, block_tables)
    use_kernel = resolve_kernel(kernel, q.device)
    if block_tables is not None:
        if use_kernel:
            return paged_flash_decode(q, k_cache, v_cache, lengths,
                                      block_tables, kv_scales=kv_scales)
        return paged_decode_ref(q, k_cache, v_cache, lengths, block_tables,
                                kv_scales=kv_scales)
    if kv_scales is not None:
        raise ValueError("kv_scales belong to the paged pool layout")
    if not use_kernel:
        return decode_ref(q, k_cache, v_cache, lengths)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=q.device) \
        .reshape(-1).expand(q.shape[0]).contiguous()
    return flash_decode(q, k_cache, v_cache, lens)


def check_placed(mesh, cache, block_tables) -> None:
    """A plain paged pool (N, bs, Hk, D) or plain dense stripes (B, S, Hk,
    D) under a mesh that would cut their KV heads: place them once
    (``sharding.shard``, ``model.init_paged_cache(mesh=)``,
    ``model.init_cache(mesh=)``) rather than copy them to the shards and
    back on every call."""
    if sharding.attn_shard_size(mesh, cache.shape[2]) > 1:
        what = "paged pool" if block_tables is not None else "dense stripe"
        raise TypeError(
            f"a {what} read over a mesh that cuts its KV heads must be "
            f"placed first (sharding.shard, init_paged_cache(mesh=) or "
            f"init_cache(mesh=))")


def _sharded_decode(q, k_cache, v_cache, lengths, block_tables, kernel,
                    kv_scales):
    """The decode read once per model shard, on a paged pool or (without
    ``block_tables``) dense stripes: the paged or the dense decode
    kernel once a shard.

    Attention is independent per KV head, so cutting the cache's Hk axis
    changes no arithmetic: shard i reads its contiguous Hk/m slice with
    the matching contiguous H/m query heads (head h attends kv head
    h // rep, and contiguous cuts keep rep per shard).  Tables and
    lengths are placed as q is: every model shard of a data index walks
    its lanes' tables or positions; no cache byte moves.  A cache whole
    on every shard gives each shard every head.  A plain q is placed by
    ``paged_attn_specs`` and the output gathered back on the head axis; a
    ``Sharded`` q (the model's path) gets the per-shard outputs.  f8
    stripes go to each shard's launch as they are (kind 3).
    """
    mesh, cut = k_cache.mesh, k_cache.dim is not None
    qs = sharding.shard(q, sharding.paged_attn_specs()["q_decode"] if cut
                        else sharding.P(), mesh)
    lens = lengths if isinstance(lengths, sharding.Sharded) \
        else sharding.broadcast(torch.as_tensor(
            lengths, dtype=torch.int32, device=qs.device).reshape(-1)
            .expand(qs.shape[0]).contiguous(), mesh)
    out = sharding.smap(
        lambda q_, k_, v_, l_, t_, s_: decode_attention(
            q_, k_, v_, l_, t_, kernel=kernel, kv_scales=s_),
        qs, k_cache, v_cache, lens, sharding.broadcast(block_tables, mesh),
        kv_scales, mesh=mesh, dim=1 if cut else None)
    return out if isinstance(q, sharding.Sharded) else sharding.gather(out)
