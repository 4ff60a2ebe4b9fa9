"""SCLAD KV quantization: Store-as-Compressed, Load-as-Dense block payloads.

Port of ``repro.models.kv_quant``.  The paged serving pool
(``model.init_paged_cache``) may store an int8 or fp8 (e4m3fn) payload
plus one fp32 scale per (token position, kv head); every reader
dequantizes on load.  One definition serves every writer: the decode
step's single-token write (``layers.attention_decode``), the plain chunk
scatter (``kernels.flash_prefill.ref.scatter_new_kv_ref``) and the CUDA
prefill kernel's fused scatter (``csrc/paged_prefill.cu``), which repeats
it operation for operation.

The arithmetic is path-independent: a token's payload and scale are a
pure function of its own dense K/V row (the fp32 view of the
compute-dtype value, amax over the head dim, symmetric round to
nearest), so the bytes a token leaves in the pool are the same whether it
arrived by a first chunk, a continuation, a decode step or a preemption
recompute.  That is what makes the block store's hash chain a sound
content address for the compressed payload, and what lets the tests
compare pools bit for bit, against the reference package too.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import Sharded

#: Every accepted ``ModelConfig.kv_dtype`` spelling:
#:   "fp"/"bf16" — bf16 pool (the port's fp pool);
#:   "f8"        — float8_e4m3fn dense stripes and paged pool, no scales:
#:                 the K/V value cast (``to(float8_e4m3fn)``: round to
#:                 nearest even; past 464 see ``f8_saturates``);
#:   "int8"      — SCLAD paged pool: int8 payload + fp32 scales;
#:   "fp8"       — SCLAD paged pool: float8_e4m3fn payload + fp32 scales.
KV_DTYPES = ("fp", "bf16", "f8", "int8", "fp8")

#: The subset that stores the paged pool as compressed payload + scales.
QUANTIZED_KV_DTYPES = ("int8", "fp8")


def is_quantized(kv_dtype: str) -> bool:
    """True iff the paged pool stores compressed payload + scale leaves."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    return kv_dtype in QUANTIZED_KV_DTYPES


def payload_dtype(kv_dtype: str) -> torch.dtype:
    """On-device dtype of the compressed pool payload."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"{kv_dtype!r} is not a quantized kv_dtype")


def qmax(kv_dtype: str) -> float:
    """Largest payload magnitude the scale normalizes to."""
    if kv_dtype == "int8":
        return 127.0
    if kv_dtype == "fp8":
        return 448.0  # float8_e4m3fn max normal
    raise ValueError(f"{kv_dtype!r} is not a quantized kv_dtype")


def raw(t):
    """``t`` itself, or its bytes (uint8 view) when it holds fp8: advanced
    indexing of payloads and f8 stripes (the pool gathers and writes, the
    stripe stores), and their ``torch.cat``, go through this, since not
    every PyTorch build indexes or concatenates float8 tensors on every
    device.  The bits are unchanged.  A placed pool or stripe
    (``sharding.Sharded``) gives the same placement of its parts' bytes,
    places that share a part sharing its view."""
    if isinstance(t, Sharded):
        views: dict = {}
        return t.with_parts([views.setdefault(id(p), raw(p))
                             for p in t.parts])
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


_F8_SATURATES: dict = {}


def f8_saturates(device) -> bool:
    """Whether this PyTorch build's cast to float8_e4m3fn on ``device``
    saturates finite values past 464 to +-448 (True: torch 2.13) or makes
    them NaN, as JAX does (False: torch 2.11).  Below that the builds
    agree.  Asked once per device type with one small cast; the CUDA
    prefill kernel's f8 scatter takes the answer, so that it stores what
    ``.to(float8_e4m3fn)`` stores."""
    kind = torch.device(device).type
    if kind not in _F8_SATURATES:
        x = torch.tensor([470.0], device=device).to(torch.float8_e4m3fn)
        _F8_SATURATES[kind] = bool(x.float().isfinite().item())
    return _F8_SATURATES[kind]


def put(dst, index, x) -> None:
    """``dst[index] = x`` cast to ``dst``'s dtype, through ``raw``: the
    cache stores of K/V rows into bf16 or f8 stripes and pools (and of
    the Mamba-2 states and windows).  An f8 store is
    ``x.to(float8_e4m3fn)``, one rounding from x's value.  A placed
    ``dst`` takes a placed ``x`` part by part, each place writing its
    own slice: no byte moves between shards."""
    if isinstance(dst, Sharded):
        for d, x_ in zip(dst.parts, x.parts):
            put(d, index, x_)
        return
    raw(dst)[index] = raw(x.to(dst.dtype))


def quantize(x: torch.Tensor, kv_dtype: str):
    """Compress ``x`` (..., D) -> (payload (..., D), scales (...,) fp32).

    ``scale = amax * float32(1 / qmax)`` (a multiply by a constant, not a
    division: bitwise what the reference computes), 1.0 for all-zero rows
    so dequantization is exact; payload ``round(x / scale)`` (half to
    even) for int8 — never above 127 in magnitude, so no clip — or the
    fp8 cast.  Every step runs in fp32 from the compute-dtype value.
    """
    inv = torch.tensor(1.0 / qmax(kv_dtype), dtype=torch.float32,
                       device=x.device)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    q = xf / scale[..., None]
    if kv_dtype == "int8":
        payload = torch.round(q).to(torch.int8)
    else:
        payload = q.to(torch.float8_e4m3fn)
    return payload, scale


def dequantize(payload: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Expand payload (..., D) with scales (...,) to dense ``dtype``:
    ``payload * scale`` in fp32, then one cast — the cast chain the
    kernels use on load."""
    out = payload.to(torch.float32) * scale[..., None].to(torch.float32)
    return out.to(dtype)


def fake_quant(x: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """``dequantize(quantize(x))`` in x's dtype: what a pool reader will
    observe once ``x`` is stored.  The prefill paths attend to the
    chunk's own K/V through it, so a key scores the same in-chunk and
    from the pool."""
    payload, scale = quantize(x, kv_dtype)
    return dequantize(payload, scale, x.dtype)
