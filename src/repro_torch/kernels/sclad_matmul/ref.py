"""Plain PyTorch version of the SCLD matmul.

Twin of ``repro.kernels.sclad_matmul.ref``: decode the stored units into
the dense weight, then an fp32 matmul, then a cast to x's dtype.  The
decode here is ``decompress_torch``, the torch twin of the numpy
``decompress`` (the same scatter of units into zero-filled tiles), so it
runs on whichever device the tensors are on.  It is the CPU path, the
``kernel="off"`` path, and what the CUDA kernel is held against on the
card.
"""
from __future__ import annotations

import torch

UNIT_R, TILE = 8, 128
UNITS_PER_TILE = TILE // UNIT_R


def decompress_torch(vals, rows):
    """(nk, nn, C, 8, 128) units + (nk, nn, C) rows -> dense (K, N) in
    vals' dtype, zero where no unit is stored."""
    nk, nn, C = vals.shape[:3]
    units = torch.zeros(nk, nn, UNITS_PER_TILE, UNIT_R, TILE,
                        dtype=vals.dtype, device=vals.device)
    idx = rows.long()[..., None, None].expand(nk, nn, C, UNIT_R, TILE)
    units.scatter_(2, idx, vals)
    tiles = units.reshape(nk, nn, TILE, TILE).permute(0, 2, 1, 3)
    return tiles.reshape(nk * TILE, nn * TILE)


def sclad_matmul_ref(x, vals, rows):
    """y = x @ decode(vals, rows) — decode, matmul in fp32, cast to x's
    dtype.  x: (M, K); vals: (K/128, N/128, C, 8, 128); rows:
    (K/128, N/128, C) integer."""
    w = decompress_torch(torch.as_tensor(vals), torch.as_tensor(rows))
    return (x.float() @ w.to(device=x.device, dtype=torch.float32)) \
        .to(x.dtype)
