"""AdamW with global-norm clipping and a warmup-cosine schedule, as pure
functions over parameter trees.

Port of ``repro.training.optimizer``.  Moments are fp32 whatever the
parameters' dtype, and are placed as the parameters are (``state_specs``:
FSDP over ``data`` x TP over ``model``, ZeRO-3-style fully sharded);
each parameter is updated in fp32 and cast back to its own dtype.
Decoupled weight decay applies to leaves with ``ndim >= 2`` *as stored*:
the stacked (L, d) norm scales are decayed, as in the reference.  The
step is a 0-d int32 tensor and the schedule computes in fp32.  ``update``
returns new tensors and leaves its arguments as they were.

On placed trees (``parallel.sharding.Sharded`` leaves, the sharded train
step's) the update is elementwise, so it runs piece by piece: once for
each distinct piece (``sharding.map_pieces``), its result on every place
that holds the piece.  The global norm sums each element's square once
— a cut leaf's pieces each once, a replicated leaf once, not once a
place, and a Mamba-2 leaf's B and C columns, which every model shard
holds whole, once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any  # fp32 tree like params
    v: Any  # fp32 tree like params


def init(params) -> AdamWState:
    def zeros(p):
        if isinstance(p, sharding.Sharded):
            return sharding.map_pieces(zeros, p)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_lib.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_lib.map_leaves(zeros, params),
                      v=tree_lib.map_leaves(zeros, params))


def state_specs(param_spec_tree) -> AdamWState:
    """Optimizer state specs mirroring the parameter specs (the step
    replicated)."""
    return AdamWState(step=sharding.P(), m=param_spec_tree,
                      v=param_spec_tree)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio *
    lr`` at ``total_steps``; fp32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32; on a placed
    tree each element once (``sharding.elements``: each distinct piece,
    the components a Mamba-2 leaf holds whole on every model shard from
    one shard), summed on the first leaf's device."""
    dev = tree_lib.leaves(tree)[0].device
    return torch.sqrt(sum(p.float().square().sum().to(dev)
                          for g in tree_lib.leaves(tree)
                          for p in sharding.elements(g)))


def update(cfg: AdamWConfig, grads, state: AdamWState, params
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics): ``grad_norm`` (before
    clipping) and ``lr``, 0-d fp32 tensors."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, step)
    b1c = 1 - cfg.beta1 ** step.float()
    b2c = 1 - cfg.beta2 ** step.float()

    def upd(p, g, m, v):
        dev = p.device
        g = g.float() * scale.to(dev)
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * g.square()
        delta = (m / b1c.to(dev)) / (torch.sqrt(v / b2c.to(dev)) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr.to(dev) * delta).to(p.dtype), m, v

    flat_p = tree_lib.leaves(params)
    out = [sharding.map_pieces(upd, p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_lib.leaves(grads), tree_lib.leaves(state.m),
        tree_lib.leaves(state.v))]
    new_p = tree_lib.unflatten(params, [o[0] for o in out])
    new_m = tree_lib.unflatten(params, [o[1] for o in out])
    new_v = tree_lib.unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v), \
        {"grad_norm": gnorm, "lr": lr}
