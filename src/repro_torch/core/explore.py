"""Two-phase design-space exploration (paper §4, Fig 5).

Phase 1 (hardware): bottom-up, LLM-agnostic sweep of chip (die size, CC-MEM
split, bank ratio) and server (chips/lane) design points under floorplan,
power and thermal constraints -> thousands of feasible servers.

Phase 2 (software): for each feasible server and a given LLM workload,
search the software mapping (tp, pp, batch, micro-batch) with the analytic
inference simulator and the TCO model; emit TCO/token-optimal design points.

Port of ``repro.core.explore``: a copy with its imports pointed at
``repro_torch.core``.  Host-side analytics: it launches nothing on a
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core import hardware, perf, tco
from repro_torch.core.workloads import LLMWorkload, PAPER_MODELS


@dataclass
class ExplorationResult:
    workload: LLMWorkload
    ctx: int
    best: perf.DesignPoint
    # All evaluated optima per server (for Fig 7-style scatter plots).
    frontier: List[perf.DesignPoint]


def phase1_servers(**kw) -> List[hardware.ServerConfig]:
    return hardware.sweep_servers(hardware.sweep_chips(**kw))


def phase2(servers: Sequence[hardware.ServerConfig], wl: LLMWorkload,
           ctx: int = 2048,
           batches: Iterable[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                     1024),
           keep_all: bool = True) -> ExplorationResult:
    best: Optional[perf.DesignPoint] = None
    frontier: List[perf.DesignPoint] = []
    for s in servers:
        dp = perf.best_mapping(s, wl, ctx, batches)
        if dp is None:
            continue
        if keep_all:
            frontier.append(dp)
        if best is None or dp.tco_per_mtoken < best.tco_per_mtoken:
            best = dp
    if best is None:
        raise RuntimeError(f"no feasible design for {wl.name} ctx={ctx}")
    return ExplorationResult(workload=wl, ctx=ctx, best=best,
                             frontier=frontier)


def explore(wl: LLMWorkload, ctx: int = 2048,
            servers: Optional[Sequence[hardware.ServerConfig]] = None,
            **kw) -> ExplorationResult:
    servers = servers if servers is not None else phase1_servers()
    return phase2(servers, wl, ctx, **kw)


def explore_all_paper_models(ctx: int = 2048) -> Dict[str, ExplorationResult]:
    servers = phase1_servers()
    return {name: phase2(servers, wl, ctx, keep_all=False)
            for name, wl in PAPER_MODELS.items()}


def multi_model_optimum(workloads: Sequence[LLMWorkload], ctx: int = 2048,
                        servers: Optional[Sequence[hardware.ServerConfig]]
                        = None):
    """Fig 14: one chip for all models — minimize geomean TCO/token."""
    servers = servers if servers is not None else phase1_servers()
    best_server, best_geo, best_points = None, float("inf"), None
    for s in servers:
        pts = []
        for wl in workloads:
            dp = perf.best_mapping(s, wl, ctx)
            if dp is None:
                break
            pts.append(dp)
        if len(pts) != len(workloads):
            continue
        geo = math.exp(sum(math.log(p.tco_per_mtoken) for p in pts)
                       / len(pts))
        if geo < best_geo:
            best_server, best_geo, best_points = s, geo, pts
    return best_server, best_geo, best_points
