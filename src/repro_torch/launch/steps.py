"""Step functions: train_step / prefill_step / serve_step, and the
shardings of every (arch x shape) cell.

Port of ``repro.launch.steps``.  The train step differentiates
``model.loss_fn`` with plain torch autograd (``torch.autograd.grad``
over the parameter leaves: the plain attention and scan, no kernel) and
applies ``optimizer.update``; it returns new parameters and leaves the
given ones as they were.

``shardings_for`` assembles a cell's (in, out) shardings as the
reference does, a ``NamedSharding`` (mesh, spec) pair a leaf.
``make_train_step(mesh=)`` runs the step on trees placed by those specs
(``sharding.place_train`` / ``place_batch``), one controller driving
every place: FSDP over the data axes x TP over ``model``
(``model.loss_fn(mesh=)``), each place's parameter parts its own autograd
leaves, the gradients of pieces several places hold summed explicitly
(``sharding.sum_replicas``), AdamW piece by piece.  A meshless call does
not touch the mesh code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.training import optimizer as opt_lib


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the stand-in for jax's ``NamedSharding``."""
    mesh: Any
    spec: P


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
                    mesh=None):
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    if mesh is not None:
        return _make_placed_train_step(cfg, opt_cfg, mesh)

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


def _make_placed_train_step(cfg: ModelConfig, opt_cfg, mesh):
    def train_step(params, opt_state, batch):
        """The step over ``mesh``: ``params`` and the optimizer moments
        placed by ``sharding.place_train`` (``optimizer.init`` of the
        placed tree), ``batch`` by ``sharding.place_batch`` (cut over
        the data axes, or whole on every data place where it does not
        divide them).  The loss is ``model.loss_fn(mesh=)``'s: the
        batch's mean loss, counted once either way."""
        for what, tree in (("parameters", params), ("batch", batch)):
            if not all(isinstance(x, sharding.Sharded) and x.mesh is mesh
                       for x in tree_lib.leaves(tree)):
                raise TypeError(
                    f"the placed train step takes {what} placed on its mesh "
                    f"(sharding.place_train / place_batch)")
        with torch.enable_grad():
            mine = sharding.member_leaves(params)
            loss = M.loss_fn(cfg, mine, batch, mesh=mesh)
            leaves = tree_lib.leaves(mine)
            grads = iter(torch.autograd.grad(
                loss, [p for x in leaves for p in x.parts],
                allow_unused=True))
        summed = []
        for x in leaves:
            parts = [next(grads) for _ in x.parts]
            summed.append(sharding.sum_replicas(x.with_parts(
                torch.zeros_like(p) if g is None else g
                for p, g in zip(x.parts, parts))))
        params, opt_state, metrics = opt_lib.update(
            opt_cfg, tree_lib.unflatten(params, summed), opt_state, params)
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


# ---------------------------------------------------------------------------
# Sharding assembly
# ---------------------------------------------------------------------------

def shardings_for(cfg: ModelConfig, shape_name: str, mesh):
    """(in_shardings, out_shardings) trees of ``NamedSharding`` for the
    step of this shape, the reference's specs leaf for leaf.  The axis
    state is scoped to this call (``sharding.use_axes``)."""
    from repro_torch.launch import specs as specs_lib

    with sharding.use_axes(mesh):
        return _shardings_for(cfg, shape_name, mesh, specs_lib)


def _named(mesh, tree):
    if isinstance(tree, P):
        return NamedSharding(mesh, tree)
    if isinstance(tree, dict):
        return {k: _named(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_named(mesh, v) for v in tree))
    raise TypeError(type(tree))


def _shardings_for(cfg: ModelConfig, shape_name: str, mesh, specs_lib):
    shape = SHAPES[shape_name]
    dp = mesh_lib.data_axes(mesh)
    ins = specs_lib.input_specs(cfg, shape_name)

    mode = "train" if shape.kind == "train" else "serve"
    pspec = sharding.param_specs(cfg, ins["params"], mode=mode)
    pspec = sharding.sanitize_specs(pspec, ins["params"])
    san = sharding.sanitize_specs
    ns = lambda tree: _named(mesh, tree)  # noqa: E731

    if shape.kind == "train":
        ospec = opt_lib.AdamWState(
            step=P(), m=san(pspec, ins["opt_state"].m),
            v=san(pspec, ins["opt_state"].v))
        bspec = san(sharding.batch_specs(cfg, ins["batch"], dp,
                                         shape.global_batch), ins["batch"])
        metrics_spec = {"grad_norm": P(), "lr": P(), "loss": P()}
        in_sh = (ns(pspec), ns(ospec), ns(bspec))
        out_sh = (ns(pspec), ns(ospec), ns(metrics_spec))
        return in_sh, out_sh
    if shape.kind == "prefill":
        bspec = san(sharding.batch_specs(cfg, ins["batch"], dp,
                                         shape.global_batch), ins["batch"])
        cshape = M.cache_specs(cfg, shape.global_batch, shape.seq_len)
        cspec = san(sharding.cache_specs(cfg, cshape, dp, shape.global_batch),
                    cshape)
        dpa = dp if shape.global_batch % sharding._axes_size_hint(dp) == 0 \
            else None
        lshape = torch.empty((shape.global_batch, cfg.vocab_size),
                             dtype=torch.bfloat16, device="meta")
        logits_spec = san(P(dpa, "model"), lshape)
        in_sh = (ns(pspec), ns(bspec))
        out_sh = (ns(logits_spec), ns(cspec))
        return in_sh, out_sh
    # decode
    cspec = san(sharding.cache_specs(cfg, ins["cache"], dp,
                                     shape.global_batch), ins["cache"])
    dpa = dp if shape.global_batch % sharding._axes_size_hint(dp) == 0 \
        else None
    tok_spec = san(P(dpa, None), ins["tokens"])
    lshape = torch.empty((shape.global_batch, 1, cfg.vocab_size),
                         dtype=torch.bfloat16, device="meta")
    logits_spec = san(P(dpa, None, "model"), lshape)
    in_sh = (ns(pspec), ns(cspec), ns(tok_spec), NamedSharding(mesh, P()))
    out_sh = (ns(logits_spec), ns(cspec))
    return in_sh, out_sh


def step_and_args(cfg: ModelConfig, shape_name: str):
    """(step_fn, abstract args tuple) of this cell, on ``meta`` tensors."""
    from repro_torch.launch import specs as specs_lib

    shape = SHAPES[shape_name]
    ins = specs_lib.input_specs(cfg, shape_name)
    if shape.kind == "train":
        return make_train_step(cfg), (ins["params"], ins["opt_state"],
                                      ins["batch"])
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape.seq_len), (ins["params"],
                                                       ins["batch"])
    return make_serve_step(cfg), (ins["params"], ins["cache"], ins["tokens"],
                                  ins["position"])
