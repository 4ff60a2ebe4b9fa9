"""Checkpointing: atomic, async, keep-last-k.

Port of ``repro.training.checkpoint``, with its on-disk layout:
<dir>/step_<n>/ containing

  * meta.json   — step, the leaves' keys, time (and any extra metadata);
  * arrays.npz  — the leaves keyed by their ``/``-joined tree path
    (``repro_torch.tree``: the JAX package's keys), bf16 saved as fp32.

Writes go to a temporary directory that is then renamed, so a job killed
mid-checkpoint never corrupts the latest restore point; the oldest
checkpoints beyond ``keep`` are removed.  Because keys and layout are the
reference's, a ``{"params": ...}`` tree saved by either package restores
in the other.  ``AsyncCheckpointer`` copies device tensors to host
before its thread starts, so training may go on updating them.

Placed trees (``parallel.sharding.Sharded`` leaves) are saved whole, as
the reference saves unsharded arrays, so ``restore`` can load them into
any mesh: into a ``like`` tree of placed leaves each restored array is
cut as its ``like`` leaf is placed — the elastic rescale is a restore
onto another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding


def _host(x, snapshot: bool = False) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as fp32 (npz has no bf16).
    ``snapshot``: a copy that later in-place updates of the tensor cannot
    reach (a CPU tensor's numpy view shares its memory)."""
    if isinstance(x, sharding.Sharded):
        return _host(sharding.to_whole(x), snapshot)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.float().cpu().numpy()  # a new array
        if snapshot and x.device.type == "cpu":
            return x.numpy().copy()
        return x.cpu().numpy()
    return np.array(x) if snapshot else np.asarray(x)


def _flatten(tree) -> List[Tuple[str, np.ndarray]]:
    return [(k, _host(v)) for k, v in tree_lib.flatten(tree)]


def save(ckpt_dir: str, step: int, tree, keep: int = 3,
         extra_meta: Optional[Dict[str, Any]] = None) -> str:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = _flatten(tree)
    np.savez(tmp / "arrays.npz", **{k: v for k, v in leaves})
    meta = {"step": step, "keys": [k for k, _ in leaves],
            "time": time.time(), **(extra_meta or {})}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish

    # Retention: keep the most recent `keep` checkpoints.
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return str(final)


class AsyncCheckpointer:
    """Serializes on a background thread; at most one outstanding save."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, ckpt_dir: str, step: int, tree, keep: int = 3) -> None:
        self.wait()
        # Device->host copy happens here (blocking, consistent snapshot);
        # file IO happens on the thread.
        host_tree = tree_lib.map_leaves(
            lambda x: _host(x, snapshot=True), tree)

        def work():
            self.last_path = save(ckpt_dir, step, host_tree, keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor of the
    ``like`` leaf's dtype on its device, or — a ``Sharded`` ``like``
    leaf — cut and placed as it is (``sharding.place_like``)."""
    path = Path(ckpt_dir) / f"step_{step}" / "arrays.npz"

    def load(arr, leaf):
        x = torch.from_numpy(np.asarray(arr))
        if isinstance(leaf, sharding.Sharded):
            return sharding.place_like(x.to(leaf.dtype), leaf)
        return x.to(device=leaf.device, dtype=leaf.dtype)

    with np.load(path) as data:
        new = [load(data[key], leaf) for key, leaf in tree_lib.flatten(like)]
    return tree_lib.unflatten(like, new)
