"""Mamba-2 SSD chunk scan (arXiv:2405.21060) over the CUDA kernel in
``csrc/ssd_scan.cu``: port of ``repro.kernels.ssd_scan.ssd_scan``.

Per chunk of ``chunk`` positions, with cum the inclusive cumsum of a over
the chunk:

    y     = ((C B^T) . L) xdt + exp(cum) . (C h_in^T),  L_ij = exp(cum_i - cum_j), i >= j
    h_out = exp(cum_last) h_in + (xdt . exp(cum_last - cum))^T B

The kernel splits the sequence over blocks in three passes (the SSD
paper's chunked algorithm): every chunk's own state contribution in
parallel, a short serial scan over chunks that gives each chunk the state
entering it, then every chunk's outputs in parallel, one block per
64-row query tile.  ``ssd_plan`` is the launch plan, from shapes only;
the wrapper allocates the kernel's fp32 workspace from it.

Inputs are pre-scaled by the caller (xdt = x * dt, a = A * dt).  A CUDA
tensor launches the kernel, or the call raises; the plain PyTorch version
(``ref.ssd_scan_ref``) runs only for tensors on the CPU.
``ssd_scan.launches`` counts wrapper calls that launched the kernel: one
call is one count and three device launches (the passes).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

MAX_P, MAX_N = 128, 128  # head dim and state size the kernel holds
MAX_CHUNK = 256
WIDTH_STEP = 16  # P and N are multiples of it
TILE = 64  # query rows of an output block (pass 3)
STATE_THREADS = 256  # threads of a state-pass block, 4 state entries each


class SsdPlan(NamedTuple):
    """The kernel's launches for one call.

    ``grids``: blocks of pass 1 (one per (bh, chunk)), pass 2 (per bh,
    enough blocks of ``STATE_THREADS`` for P * N / 4 threads) and pass 3
    (one per (bh, chunk, query tile)).  ``states``: the shape of the fp32
    chunk states, which for fp32 inputs become h_in in place.
    ``workspace``: fp32 elements of the workspace: the chunk states, then
    cum (BH * S rounded up to a multiple of 4), then for bf16 inputs h_in
    in bf16 (half as many fp32 elements as the chunk states)."""
    chunks: int
    query_tiles: int
    grids: Tuple[int, int, int]
    states: Tuple[int, int, int, int]
    workspace: int


def ssd_plan(BH: int, S: int, P: int, N: int, chunk: int,
             bf16: bool = True) -> SsdPlan:
    """The launch plan of ``ssd_scan`` on (BH, S, P) / (BH, S, N) inputs
    at ``chunk`` positions a chunk (S % chunk == 0)."""
    nc = S // chunk
    nqt = -(-chunk // TILE)
    n_states = BH * nc * P * N
    n_cum = -(-BH * S // 4) * 4
    grids = (BH * nc, BH * -(-(P * N // 4) // STATE_THREADS), BH * nc * nqt)
    return SsdPlan(nc, nqt, grids, (BH, nc, P, N),
                   n_states + n_cum + (n_states // 2 if bf16 else 0))


def ssd_scan(xdt, a, b, c, *, chunk: int = 128):
    """xdt: (BH, S, P) pre-scaled inputs; a: (BH, S) = A*dt; b, c:
    (BH, S, N); all fp32 or all bf16, S % chunk == 0 (on the card also
    P and N multiples of 16 up to 128, chunk <= 256, and for bf16 xdt, b
    and c 16-byte aligned: the bf16 passes copy their rows with 16-byte
    ``cp.async``, the fp32 ones read element by element).  Returns (y (BH, S, P) in xdt's dtype, final_state
    (BH, P, N) fp32)."""
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
    bf16 = xdt.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (xdt, b, c)):
        raise ValueError("ssd_scan: bf16 xdt, b and c must be 16-byte "
                         "aligned")
    plan = ssd_plan(BH, S, P, N, chunk, bf16)
    y = torch.empty_like(xdt)
    state = torch.empty(BH, P, N, dtype=torch.float32, device=xdt.device)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=xdt.device)
    lib = _build.load("ssd_scan")
    code = lib.repro_ssd_scan(
        xdt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), state.data_ptr(), ws.data_ptr(), BH, S, P, N, chunk,
        int(bf16), torch.cuda.current_stream(xdt.device).cuda_stream)
    _build.check(lib, code, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
