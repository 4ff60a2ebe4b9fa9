"""Device resolution: the CUDA card by default, the CPU only on request.

Nothing in the port silently drops to the CPU.  ``resolve_device()``
returns ``cuda`` and raises when no CUDA device is present; a caller that
wants the CPU (the parity tests) says ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device (raises without
    one); ``"cpu"`` -> the CPU; ``"cuda:N"`` -> that card; ``"meta"`` ->
    shapes without storage (the spec functions')."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued device work (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
