"""SCLD matmul: Store-as-Compressed, Load-as-Dense weights (paper §3.2).

The weight W (K, N) is stored in *block* SCLD form: each (128, 128) tile
keeps only its C largest (8, 128) row-units, as ``vals`` (K/128, N/128,
C, 8, 128) plus the units' row indices ``rows`` (K/128, N/128, C) int32,
so the stored bytes are C/16 of dense.  ``block_compress`` and
``decompress`` are the numpy encoder and decoder, copied from the JAX
package unchanged (the same argsort tie-breaking, so ``vals`` and
``rows`` come out bitwise equal to its).

``sclad_matmul`` (``csrc/sclad_matmul.cu``) computes ``y = x @
decode(vals, rows)``: port of ``repro.kernels.sclad_matmul.sclad_matmul``.
The kernel decodes each stored tile into a dense tile in shared memory
and multiplies densely (load-as-dense: compute is sparsity-agnostic).  A
CUDA tensor launches the kernel, or the call raises; the plain PyTorch
version (``ref.sclad_matmul_ref``) runs only for tensors on the CPU.
``sclad_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sclad_matmul.ref import sclad_matmul_ref

UNIT_R = 8  # row-unit height
TILE = 128  # tile edge
UNITS_PER_TILE = TILE // UNIT_R  # 16
DTYPES = (torch.float32, torch.bfloat16)


def sclad_matmul(x, vals, rows, *, block_m: int = 128):
    """y = x @ decode(vals, rows).

    x:    (M, K) fp32 or bf16, M % block_m == 0;
    vals: (K//128, N//128, C, 8, 128) fp32 or bf16 — the stored row-units;
    rows: (K//128, N//128, C) int32 — each unit's row index in its tile
          (distinct within a tile, in [0, 16)).
    Returns (M, N) in x's dtype.  Each decoded weight is rounded to x's
    dtype before its product, and products accumulate in fp32.
    """
    M, K = x.shape
    nk, nn, C = vals.shape[:3]
    if K != nk * TILE or M % block_m:
        raise ValueError(f"sclad_matmul: x {tuple(x.shape)} needs K == "
                         f"{nk} * {TILE} and M % block_m ({block_m}) == 0")
    if x.device.type == "cpu":
        return sclad_matmul_ref(x, vals, rows)
    if vals.device != x.device or rows.device != x.device:
        raise ValueError("sclad_matmul: all inputs must be on one device")
    if x.dtype not in DTYPES or vals.dtype not in DTYPES:
        raise TypeError(f"sclad_matmul: x {x.dtype} / vals {vals.dtype} "
                        f"not fp32/bf16")
    if vals.dim() != 5 or vals.shape[3:] != (UNIT_R, TILE) \
            or not 1 <= C <= UNITS_PER_TILE:
        raise ValueError(f"sclad_matmul: vals {tuple(vals.shape)} not "
                         f"(K/128, N/128, C, {UNIT_R}, {TILE}), C in 1..16")
    if rows.dtype != torch.int32 or rows.shape != (nk, nn, C):
        raise TypeError(f"sclad_matmul: rows must be int32 {(nk, nn, C)}")
    if not all(t.is_contiguous() for t in (x, vals, rows)):
        raise ValueError("sclad_matmul: inputs must be contiguous")
    y = torch.empty(M, nn * TILE, dtype=x.dtype, device=x.device)
    lib = _build.load("sclad_matmul")
    code = lib.repro_sclad_matmul(
        x.data_ptr(), vals.data_ptr(), rows.data_ptr(), y.data_ptr(),
        M, nk, nn, C, int(x.dtype == torch.bfloat16),
        int(vals.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "sclad_matmul")
    sclad_matmul.launches += 1
    return y


sclad_matmul.launches = 0


# ---------------------------------------------------------------------------
# Block compression (encode side of SCLD)
# ---------------------------------------------------------------------------

def block_compress(w: np.ndarray, units_kept: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform N:M block pruning + compression.

    Keeps the `units_kept` largest-magnitude (8, 128) row-units per (128,128)
    tile.  Returns (vals (nk, nn, C, 8, 128), rows (nk, nn, C) int32).
    """
    K, N = w.shape
    assert K % TILE == 0 and N % TILE == 0
    nk, nn = K // TILE, N // TILE
    C = units_kept
    tiles = w.reshape(nk, TILE, nn, TILE).transpose(0, 2, 1, 3)
    units = tiles.reshape(nk, nn, UNITS_PER_TILE, UNIT_R, TILE)
    mag = np.abs(units).sum(axis=(-1, -2))  # (nk, nn, 16)
    order = np.argsort(-mag, axis=-1)[..., :C]  # top-C units
    rows = np.sort(order, axis=-1).astype(np.int32)
    vals = np.take_along_axis(units, rows[..., None, None], axis=2)
    return vals.astype(w.dtype), rows


def decompress(vals: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Inverse of block_compress (zero-filled)."""
    nk, nn, C = vals.shape[:3]
    units = np.zeros((nk, nn, UNITS_PER_TILE, UNIT_R, TILE), vals.dtype)
    np.put_along_axis(units, rows[..., None, None], vals, axis=2)
    tiles = units.reshape(nk, nn, TILE, TILE).transpose(0, 2, 1, 3)
    return tiles.reshape(nk * TILE, nn * TILE)
