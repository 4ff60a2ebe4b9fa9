"""Store-as-Compressed, Load-as-Dense (SCLD) — paper §3.2, Fig 4 & Fig 13.

Weights are stored in a tile-based compressed sparse row format (tiles of
32x8; each non-zero value is a 24-bit word: 16b value + 5b row + 3b col) and
decoded to dense tiles at load time, so compute units stay sparsity-agnostic.

This module provides:
  * the storage/bandwidth cost model used by the co-design engine,
  * a functional numpy codec for the tile-CSR format — the oracle for the
    block-SCLD matmul kernel in ``repro_torch/kernels/sclad_matmul``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

TILE_R, TILE_C = 32, 8
BITS_VALUE = 16
BITS_ROW = 5  # log2(TILE_R)
BITS_COL = 3  # log2(TILE_C)
BITS_SPARSE_WORD = BITS_VALUE + BITS_ROW + BITS_COL  # 24
BITS_TILE_INDEX = 40  # start+end pointers per tile in the index memory


def storage_factor(sparsity: float) -> float:
    """Stored bytes / dense bytes for a given weight sparsity.

    Each layer chooses the smaller encoding (dense vs tile-CSR), exactly the
    store-side flexibility the CC-MEM decoder CSRs allow, so the factor never
    exceeds 1 (plus the tiny tile-index overhead).
    """
    dense_bits = BITS_VALUE
    sparse_bits = (1.0 - sparsity) * BITS_SPARSE_WORD \
        + BITS_TILE_INDEX / (TILE_R * TILE_C)
    return min(1.0, sparse_bits / dense_bits)


def max_model_scale(sparsity: float) -> float:
    """How much larger a model fits at this sparsity (paper Fig 13 bottom)."""
    return 1.0 / storage_factor(sparsity)


# Perplexity of OPT-175B under SparseGPT unstructured sparsity (paper Fig 13
# top, values approximated from SparseGPT [15]).
OPT175B_PERPLEXITY: Dict[float, float] = {
    0.0: 8.34, 0.1: 8.34, 0.2: 8.34, 0.3: 8.35, 0.4: 8.37, 0.5: 8.40,
    0.6: 8.60, 0.7: 9.67, 0.8: 18.3,
}


# ---------------------------------------------------------------------------
# Functional tile-CSR codec (numpy oracle)
# ---------------------------------------------------------------------------

@dataclass
class TileCSR:
    """Tile-compressed weight matrix (row-major tiles of TILE_R x TILE_C)."""

    shape: Tuple[int, int]
    values: np.ndarray  # (nnz,) float16/float32 non-zero values
    rows: np.ndarray  # (nnz,) uint8 row index within tile
    cols: np.ndarray  # (nnz,) uint8 col index within tile
    tile_ptr: np.ndarray  # (ntiles+1,) int32 — CSR-style offsets per tile

    @property
    def ntiles(self) -> int:
        return len(self.tile_ptr) - 1

    def stored_bits(self) -> int:
        return len(self.values) * BITS_SPARSE_WORD \
            + self.ntiles * BITS_TILE_INDEX


def encode(w: np.ndarray) -> TileCSR:
    """Dense (M, N) -> tile-CSR. M % 32 == 0, N % 8 == 0."""
    M, N = w.shape
    assert M % TILE_R == 0 and N % TILE_C == 0, (M, N)
    tiles = w.reshape(M // TILE_R, TILE_R, N // TILE_C, TILE_C)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(-1, TILE_R, TILE_C)
    vals, rows, cols, ptr = [], [], [], [0]
    for t in tiles:
        r, c = np.nonzero(t)
        vals.append(t[r, c])
        rows.append(r.astype(np.uint8))
        cols.append(c.astype(np.uint8))
        ptr.append(ptr[-1] + len(r))
    return TileCSR(
        shape=(M, N),
        values=np.concatenate(vals) if vals else np.zeros(0, w.dtype),
        rows=np.concatenate(rows) if rows else np.zeros(0, np.uint8),
        cols=np.concatenate(cols) if cols else np.zeros(0, np.uint8),
        tile_ptr=np.asarray(ptr, np.int32),
    )


def decode(t: TileCSR, dtype=np.float32) -> np.ndarray:
    """Load-as-dense: reconstruct the dense matrix."""
    M, N = t.shape
    tr, tc = M // TILE_R, N // TILE_C
    out = np.zeros((tr * tc, TILE_R, TILE_C), dtype)
    for i in range(tr * tc):
        s, e = t.tile_ptr[i], t.tile_ptr[i + 1]
        out[i, t.rows[s:e], t.cols[s:e]] = t.values[s:e]
    out = out.reshape(tr, tc, TILE_R, TILE_C).transpose(0, 2, 1, 3)
    return out.reshape(M, N)


def sparsify(w: np.ndarray, sparsity: float, seed: int = 0) -> np.ndarray:
    """Magnitude-prune to the target unstructured sparsity."""
    flat = np.abs(w).ravel()
    k = int(len(flat) * sparsity)
    if k == 0:
        return w
    thresh = np.partition(flat, k)[k]
    return np.where(np.abs(w) < thresh, 0.0, w).astype(w.dtype)
