"""Public wrapper: the SCLD linear layer.

``SCLDLinear`` carries block-compressed weights (the store side) and
applies them with the CUDA kernel (the load side): the weight bytes read
per call are ``units_kept/16`` of dense, the paper's memory-capacity and
bandwidth lever.  ``kernel`` follows the port's convention
(``kernels.flash_decode.ops.resolve_kernel``): ``"auto"`` — the kernel
for CUDA tensors, the plain version for CPU tensors; ``"on"`` — always
the kernel (CPU tensors raise); ``"off"`` — always the plain version.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import resolve_kernel
from repro_torch.kernels.sclad_matmul.ref import sclad_matmul_ref
from repro_torch.kernels.sclad_matmul.sclad_matmul import (UNITS_PER_TILE,
                                                           block_compress,
                                                           sclad_matmul)


class SCLDLinear(nn.Module):
    """y = x @ W with W held as block-SCLD ``vals`` (K/128, N/128, C, 8,
    128) and ``rows`` (K/128, N/128, C) int32 buffers."""

    def __init__(self, vals: torch.Tensor, rows: torch.Tensor, *,
                 kernel: str = "auto"):
        super().__init__()
        self.register_buffer("vals", vals)
        self.register_buffer("rows", rows)
        self.kernel = kernel

    @classmethod
    def from_dense(cls, w, units_kept: int,
                   device: DeviceLike = None) -> "SCLDLinear":
        """Compress a dense (K, N) numpy weight, keeping the
        ``units_kept`` largest (8, 128) row-units of every (128, 128)
        tile, onto ``device`` (the card unless the caller asks for the
        CPU)."""
        dev = resolve_device(device)
        vals, rows = block_compress(np.asarray(w), units_kept)
        return cls(torch.from_numpy(vals).to(dev),
                   torch.from_numpy(rows).to(dev))

    @property
    def sparsity(self) -> float:
        return 1.0 - self.vals.shape[2] / float(UNITS_PER_TILE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if resolve_kernel(self.kernel, x.device):
            return sclad_matmul(x, self.vals, self.rows)
        return sclad_matmul_ref(x, self.vals, self.rows)
