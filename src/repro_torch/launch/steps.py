"""Step functions: train_step / prefill_step / serve_step.

Port of ``repro.launch.steps`` (its sharding assembly waits for the
tensor-parallel slice).  The train step differentiates
``model.loss_fn`` with plain torch autograd (``torch.autograd.grad``
over the parameter leaves: the plain attention and scan, no kernel) and
applies ``optimizer.update``; it returns new parameters and leaves the
given ones as they were.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt_lib


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[opt_lib.AdamWConfig] = None):
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()

    def train_step(params, opt_state, batch):
        """-> (params, opt_state, metrics: ``loss``, ``grad_norm``,
        ``lr``, 0-d tensors)."""
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_lib.leaves(params)]
            loss = M.loss_fn(cfg, tree_lib.unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss does not reach gets a zero gradient, as in JAX.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state, metrics = opt_lib.update(
            opt_cfg, tree_lib.unflatten(params, grads), opt_state, params)
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, position):
        return M.decode_step(cfg, params, cache, tokens, position)

    return serve_step
