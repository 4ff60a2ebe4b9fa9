"""Mamba-2 SSD chunk scan (arXiv:2405.21060) over the CUDA kernel in
``csrc/ssd_scan.cu``: port of ``repro.kernels.ssd_scan.ssd_scan``.

Per chunk of ``chunk`` positions the kernel computes the quadratic dual
form and carries the (P, N) fp32 state to the next chunk inside one
thread block:

    y     = ((C B^T) . L) xdt + exp(cum) . (C state^T),  L_ij = exp(cum_i - cum_j), i >= j
    state = exp(cum_last) state + (xdt . exp(cum_last - cum))^T B

Inputs are pre-scaled by the caller (xdt = x * dt, a = A * dt).  A CUDA
tensor launches the kernel, or the call raises; the plain PyTorch version
(``ref.ssd_scan_ref``) runs only for tensors on the CPU.
``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

MAX_P, MAX_N = 128, 128  # head dim and state size the kernel holds
MAX_CHUNK = 256
WIDTH_STEP = 16  # P and N are multiples of it


def ssd_scan(xdt, a, b, c, *, chunk: int = 128):
    """xdt: (BH, S, P) pre-scaled inputs; a: (BH, S) = A*dt; b, c:
    (BH, S, N); all fp32 or all bf16, S % chunk == 0 (on the card also
    P and N multiples of 16 up to 128, chunk <= 256).  Returns (y (BH, S,
    P) in xdt's dtype, final_state (BH, P, N) fp32)."""
    BH, S, P = xdt.shape
    N = b.shape[2]
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of chunk "
                         f"{chunk}")
    if xdt.device.type == "cpu":
        return ssd_scan_ref(xdt, a, b, c)
    if any(t.device != xdt.device for t in (a, b, c)):
        raise ValueError("ssd_scan: all inputs must be on one device")
    if xdt.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != xdt.dtype for t in (a, b, c)):
        raise TypeError("ssd_scan: inputs must all be fp32 or all bf16")
    if a.shape != (BH, S) or b.shape != (BH, S, N) or c.shape != b.shape:
        raise ValueError(f"ssd_scan: bad shapes xdt {tuple(xdt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    if not (0 < P <= MAX_P and 0 < N <= MAX_N and chunk <= MAX_CHUNK) \
            or P % WIDTH_STEP or N % WIDTH_STEP:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk}: the kernel "
                         f"takes P and N multiples of {WIDTH_STEP} up to "
                         f"{MAX_P}, chunk up to {MAX_CHUNK}")
    if not all(t.is_contiguous() for t in (xdt, a, b, c)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    y = torch.empty_like(xdt)
    state = torch.empty(BH, P, N, dtype=torch.float32, device=xdt.device)
    lib = _build.load("ssd_scan")
    code = lib.repro_ssd_scan(
        xdt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), state.data_ptr(), BH, S, P, N, chunk,
        int(xdt.dtype == torch.bfloat16),
        torch.cuda.current_stream(xdt.device).cuda_stream)
    _build.check(lib, code, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
