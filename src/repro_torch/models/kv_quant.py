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

#: Every accepted ``ModelConfig.kv_dtype`` spelling:
#:   "fp"/"bf16" — bf16 pool (the port's fp pool);
#:   "f8"        — float8 dense stripes / fp-exact f8 pool (not ported);
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


def raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or its bytes (uint8 view) when it holds fp8: advanced
    indexing of payloads (the pool gathers and writes) goes through this,
    since not every PyTorch build indexes float8 tensors on every device.
    The bits are unchanged."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


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
