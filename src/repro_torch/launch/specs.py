"""Abstract input stand-ins for every (arch x shape) cell: ``meta``
tensors (shape and dtype, no storage).

Port of ``repro.launch.specs``, with ``meta`` tensors where the reference
has ``jax.ShapeDtypeStruct``s: nothing is allocated, so the dry run can
count a 235B-parameter training step on a CPU host.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec
from repro_torch.models import model as M


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs_for(cfg: ModelConfig, shape: ShapeSpec,
                    with_labels: bool) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    S_tok = 1 if shape.is_decode else S
    batch: Dict[str, Any] = {"tokens": sds((B, S_tok), torch.int32)}
    if with_labels:
        batch["labels"] = sds((B, S_tok), torch.int32)
    if cfg.family == "vlm" and not shape.is_decode:
        batch["patch_embeds"] = sds((B, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
    if cfg.family == "audio" and not shape.is_decode:
        batch["frames"] = sds((B, cfg.encdec.encoder_seq_len, cfg.d_model),
                              torch.bfloat16)
    return batch


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """All abstract inputs for the step this shape runs.

    train_*   -> {params, opt_state, batch{tokens,labels}}
    prefill_* -> {params, batch{tokens,...}}
    decode_*  -> {params, cache, tokens, position}
    """
    shape = SHAPES[shape_name]
    params = M.param_specs(cfg)
    out: Dict[str, Any] = {"params": params}
    if shape.kind == "train":
        from repro_torch.training import optimizer as opt
        out["opt_state"] = opt.init(params)
        out["batch"] = batch_specs_for(cfg, shape, with_labels=True)
    elif shape.kind == "prefill":
        out["batch"] = batch_specs_for(cfg, shape, with_labels=False)
    else:  # decode
        out["cache"] = M.cache_specs(cfg, shape.global_batch, shape.seq_len)
        out["tokens"] = sds((shape.global_batch, 1), torch.int32)
        out["position"] = sds((), torch.int32)
    return out
