"""Device meshes: a named array of torch devices.

Port of ``repro.launch.mesh``.  A ``Mesh`` holds an object array of
``torch.device`` and its axis names (``("data", "model")``, with
``"pod"`` ahead of them multi-pod).  Defined by functions, never module
constants, so importing this module touches no device.

Unlike a jax mesh, a port mesh may name one device several times: m
shards placed on one device (the CPU, or one card) stand in for m
devices.  Each shard still holds its own contiguous slice of every cut
tensor, runs its own kernel launches at its own head counts, and reaches
the others only through ``parallel.sharding``'s collectives, whose byte
counters read what an m-device mesh would move.  It checks the sharded
arithmetic; it is no faster than one shard, and a little slower (m
launches where one would do).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` whose shape is the
    mesh's, one axis per name in ``axis_names``.  ``moved_bytes``: the
    bytes ``parallel.sharding``'s collectives moved between this mesh's
    shards, by kind, since it was last cleared."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    moved_bytes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str = "model") -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        model shards' devices, shard 0 first."""
        if axis not in self.axis_names:
            return [self.devices.flat[0]]
        at = [slice(None) if a == axis else 0 for a in self.axis_names]
        return list(self.devices[tuple(at)])

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, [{devs}])"


Devices = Union[DeviceLike, Sequence[DeviceLike]]


def _device_list(devices: Devices, n: int) -> List[torch.device]:
    """``n`` devices: the CUDA cards (None), one device named n times (a
    string or ``torch.device``), or a sequence repeated to length n."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = [d if isinstance(d, torch.device) and d.type == "meta"
            else resolve_device(d) for d in devices]
    return [devs[i % len(devs)] for i in range(n)]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Devices = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``: over the CUDA cards by default,
    else over ``devices`` — one device (``"cpu"``, ``"cuda:0"``) or a
    list, repeated in order when the mesh has more places than it has
    entries."""
    n = math.prod(shape)
    arr = np.empty(n, dtype=object)
    arr[:] = _device_list(devices, n)
    return Mesh(arr.reshape(shape), tuple(axes))


def make_host_mesh(model_parallel: Optional[int] = None,
                   device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over the devices there are — the CUDA cards,
    or the CPU with ``device="cpu"`` — with ``model_parallel`` (default
    1) shards on the model axis: (n // mp, mp) when n divides by mp, and
    (1, mp) over the n devices repeated when mp exceeds n (one card
    holding several shards)."""
    mp = model_parallel or 1
    if device is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(device)]
    n = len(devs)
    if mp > n:
        return make_mesh((1, mp), ("data", "model"), devs)
    if n % mp:
        raise ValueError(f"{n} devices do not divide into {mp} shards")
    return make_mesh((n // mp, mp), ("data", "model"), devs)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's axes, 16 x 16 a pod (x 2 pods multi-pod), on
    ``meta`` devices: for the sharding rules and the dry run
    (``launch.dryrun``), which read axis names and sizes and place
    ``meta`` tensors — shapes without storage — on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, torch.device("meta"))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of ``mesh`` ("pod" included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
