"""Carry the reference package's parameters into the port.

``params_from_numpy`` takes the reference's parameter tree as numpy
arrays (nested dicts, stacked ``(L, ...)`` block leaves) and returns the
port's parameter dictionary.  bf16 arrays cross as their raw 16-bit
patterns (``arr.view(np.uint16)`` -> ``torch.uint16`` bits ->
``torch.bfloat16``), so the port needs neither ``ml_dtypes`` nor ``jax``
and the bits are kept exactly.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Params, param_shapes


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with the array's values; bf16 moves bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(cfg: ModelConfig, tree: Any,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The reference tree (numpy leaves) -> the port's parameters on
    ``device``, each leaf in its own dtype (bf16 weights, the fp32 MoE
    router), or every leaf cast to ``dtype`` when given (e.g.
    ``torch.float32`` for the fp32 parity recipe).  Raises if the tree's
    keys or shapes differ from the port's layout for ``cfg``
    (``model.param_shapes``: per family, e.g. ``moe`` blocks, vlm's
    ``patch_proj``)."""
    dev = resolve_device(device)

    def walk(shapes, sub, path):
        if isinstance(shapes, dict):
            if not isinstance(sub, dict) or set(sub) != set(shapes):
                got = sorted(sub) if isinstance(sub, dict) else type(sub)
                raise ValueError(f"params{path}: keys {got} != "
                                 f"{sorted(shapes)}")
            return {k: walk(shapes[k], sub[k], f"{path}[{k!r}]")
                    for k in shapes}
        t = tensor_from_numpy(np.asarray(sub))
        if tuple(t.shape) != tuple(shapes):
            raise ValueError(f"params{path}: shape {tuple(t.shape)} != "
                             f"{tuple(shapes)}")
        t = t.to(dev)
        return t if dtype is None else t.to(dtype)

    return walk(param_shapes(cfg), tree, "")
