"""GPipe-style pipeline parallelism with micro-batching (paper §4.2, Fig 6).

Port of ``repro.parallel.pipeline``.  The paper's inference schedule
overlaps ``n`` micro-batches over ``p`` pipeline stages so per-token
latency is max(l_mb, n * l_s).  One controller drives the stages of a
``stage`` mesh axis (``parallel.sharding``): every tick each stage runs
``stage_fn`` on what it holds, and ``sharding.ppermute`` moves the
activations stage -> stage, as the reference's shard_map does with
``lax.ppermute``.

The layer stack is stacked as (n_stages, layers_per_stage, ...) and each
stage owns one slice — the weight-stationary placement the analytic
engine assumes.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run microbatches (n_mb, mb, ...) through p pipeline stages.

    stage_fn(params_for_stage, x) -> x, applied by every stage.
    stage_params: a tree of leaves with leading dim n_stages, cut over
    ``axis`` (placed here when plain).  Returns the outputs, the shape of
    ``microbatches``, on place 0's device (equal on every stage).

    The reference's tick schedule: n_mb + p - 1 ticks; at tick t stage 0
    injects microbatch t (the last one again once they run out), the
    other stages take what arrived from the previous stage, the last
    stage commits its result for microbatch t - p + 1, and a cyclic
    ``ppermute`` shifts every stage's output to the next.  A ``psum``
    over ``axis`` at the end hands the committed outputs (zeros on every
    stage but the last) to every stage.
    """
    n_stages = sharding.axes_size(mesh, axis)
    n_mb = microbatches.shape[0]
    params = _place(stage_params, mesh, axis)
    stage = sharding.axis_index(mesh, axis)
    n = mesh.devices.size
    devs = sharding.grid_devices(mesh)
    mbs = [microbatches.to(d) for d in devs]
    local = [_slice(sharding.local(params, k)) for k in range(n)]
    carry = [torch.zeros_like(m[0]) for m in mbs]
    out = [torch.zeros_like(m) for m in mbs]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(n_mb + n_stages - 1):
        inject = min(t, n_mb - 1)
        ys = [stage_fn(local[k], mbs[k][inject] if stage[k] == 0
                       else carry[k]) for k in range(n)]
        commit = t - (n_stages - 1)
        if 0 <= commit < n_mb:
            out = [torch.cat([o[:commit], y[None], o[commit + 1:]])
                   if stage[k] == n_stages - 1 else o
                   for k, (o, y) in enumerate(zip(out, ys))]
        carry = list(sharding.ppermute(
            sharding.Sharded(tuple(ys), None, mesh), axis, perm).parts)
    return sharding.psum(sharding.Sharded(tuple(out), None, mesh),
                         axis).parts[0]


def _place(tree, mesh, axis):
    if isinstance(tree, dict):
        return {k: _place(v, mesh, axis) for k, v in tree.items()}
    return sharding.shard(tree, P(axis), mesh)


def _slice(tree):
    """A stage's (1, ...) parts without their leading dim."""
    if isinstance(tree, dict):
        return {k: _slice(v) for k, v in tree.items()}
    return tree[0]


def split_microbatches(batch: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B/n, ...)."""
    B = batch.shape[0]
    assert B % n == 0
    return batch.reshape((n, B // n) + tuple(batch.shape[1:]))
