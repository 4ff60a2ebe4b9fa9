"""Elastic scaling + straggler mitigation policies.

A copy of ``repro.training.elastic`` (stdlib only).

On a 1000+ node deployment the failure domains are: chip, host, pod,
interconnect.  The framework's contract (implemented across
training/checkpoint.py, training/data.py and launch/mesh.py):

  * **Node failure** -> job restarts from the last atomic checkpoint; the
    data stream is index-pure so no samples are skipped or repeated.
  * **Elastic rescale** -> ``checkpoint.restore`` device_puts full arrays
    against the *new* mesh's NamedShardings; optimizer state re-shards with
    its parameters (same specs), so going 2 pods -> 1 pod is a restore.
  * **Straggler mitigation** -> the StragglerMonitor below tracks per-step
    wall times and flags slow outliers; the launcher's policy is to drop the
    afflicted pod from the ``pod`` axis (data-parallel replicas are
    independent) and continue at reduced world size until the replacement
    arrives, then rescale back.

This module provides the measurement + decision logic; the mechanism (mesh
rebuild + restore) already exists in the launcher.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StragglerMonitor:
    """Flags steps (or peers) whose duration is a robust outlier."""

    window: int = 50
    threshold: float = 2.0  # x median
    durations: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self) -> Optional[str]:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        if len(self.durations) >= 10:
            med = statistics.median(self.durations)
            if dt > self.threshold * med:
                return (f"straggler: step took {dt:.3f}s vs median "
                        f"{med:.3f}s (> {self.threshold}x)")
        return None


@dataclass
class ElasticPlan:
    """Decides the mesh for a given healthy-pod count."""

    pods_total: int
    data: int = 16
    model: int = 16

    def mesh_shape(self, healthy_pods: int):
        if healthy_pods >= 2:
            return (healthy_pods, self.data, self.model), ("pod", "data",
                                                           "model")
        return (self.data, self.model), ("data", "model")

    def global_batch_scale(self, healthy_pods: int) -> float:
        """Keep per-pod batch constant: global batch scales with pods."""
        return healthy_pods / self.pods_total
