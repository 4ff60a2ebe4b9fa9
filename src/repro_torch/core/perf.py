"""Analytic inference simulation + software-mapping search (paper §4.2).

Given a server design and an LLM workload, searches tensor-parallel size,
pipeline stages, batch and micro-batch count for the TCO/token-optimal
mapping, using the paper's pipelined-generation model:

    l_token = max(l_mb, n * l_s)          (Fig 6)
    throughput = N / l_token

Per-layer decode latency is the max of a compute term, a CC-MEM bandwidth
term (weights + KV streamed from SRAM) and the tensor-parallel all-reduce
(ring, slowest-link bound, with the 2D weight-stationary O(1/sqrt(n))
variant of Pope et al. [37]).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.hardware import CHIP_IO_GBS, ServerConfig
from repro_torch.core.tco import server_tco
from repro_torch.core.workloads import LLMWorkload

BYTES_PER_PARAM = 2.0  # fp16/bf16 weights
BYTES_PER_KV = 2.0
ETHERNET_GBS = 12.5e9  # 100GbE between servers
ALLREDUCE_INIT_S = 1e-6
SRAM_USABLE_FRACTION = 0.9
# Compute-array efficiency on SRAM-streamed GEMV/GEMM. With the CC-MEM's
# banked bandwidth the SIMD arrays stay fed even at micro-batch 1 (Brainwave
# style), so efficiency is a constant, not a function of batch; end-to-end
# utilization losses come from the pipeline-bubble model.
COMPUTE_EFFICIENCY = 0.8


@dataclass(frozen=True)
class Mapping:
    tp: int
    pp: int
    batch: int
    microbatches: int

    @property
    def microbatch(self) -> int:
        return self.batch // self.microbatches

    @property
    def chips(self) -> int:
        return self.tp * self.pp


@dataclass(frozen=True)
class PerfResult:
    mapping: Mapping
    tokens_per_s: float
    latency_per_token: float
    util: float
    mem_per_chip_mb: float
    bound: str  # compute | memory | interconnect

    @property
    def tokens_per_s_per_chip(self) -> float:
        return self.tokens_per_s / self.mapping.chips


def _divisors(n: int, cap: int = 10 ** 9) -> List[int]:
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def evaluate(server: ServerConfig, wl: LLMWorkload, ctx: int,
             mapping: Mapping, use_2d_weight_stationary: bool = True
             ) -> Optional[PerfResult]:
    """Latency/throughput for one mapping; None if infeasible."""
    arr = evaluate_grid(server, wl, ctx, [mapping],
                        use_2d_weight_stationary)
    return arr[0] if arr else None


def evaluate_grid(server: ServerConfig, wl: LLMWorkload, ctx: int,
                  mappings: Iterable[Mapping],
                  use_2d_weight_stationary: bool = True
                  ) -> List[Optional[PerfResult]]:
    """Vectorized evaluation of many mappings on one server design."""
    maps = list(mappings)
    if not maps:
        return []
    tp = np.array([m.tp for m in maps], float)
    pp = np.array([m.pp for m in maps], float)
    N = np.array([m.batch for m in maps], float)
    n = np.array([m.microbatches for m in maps], float)
    m_tok = N / n  # microbatch tokens

    chip = server.chip
    L = wl.num_layers
    chips = tp * pp

    # --- capacity check (the CC-MEM constraint: everything resident) -------
    # SCLD: weights are stored compressed (storage factor <= 1) and decoded
    # to dense at load time by the CC-MEM decoder (paper §3.2).
    w_bytes = wl.params * BYTES_PER_PARAM * wl.weight_storage_factor
    kv_bytes = N * ctx * wl.kv_bytes_per_token(BYTES_PER_KV)
    act_bytes = 4.0 * N * wl.d_model * BYTES_PER_KV  # small
    mem_per_chip = (w_bytes + kv_bytes) / chips + act_bytes / tp
    mem_ok = mem_per_chip <= chip.sram_mb * 1e6 * SRAM_USABLE_FRACTION

    # --- per-layer decode latency ------------------------------------------
    # FC path (everything except attention reads): active params stream once
    # per microbatch from CC-MEM.
    fc_params_layer = (wl.active - wl.vocab * wl.d_model) / L
    fc_flops = 2.0 * m_tok * fc_params_layer
    util = np.full_like(m_tok, COMPUTE_EFFICIENCY)
    t_fc_compute = fc_flops / (tp * chip.tflops * 1e12 * util)
    t_fc_mem = (fc_params_layer * BYTES_PER_PARAM
                * wl.weight_storage_factor / tp) / chip.mem_bw

    # Attention: read this layer's KV for every row of the microbatch.
    kv_layer_row = ctx * wl.kv_bytes_per_token(BYTES_PER_KV) / L
    t_attn_mem = (m_tok * kv_layer_row / tp) / chip.mem_bw
    # A decode step attends over the FULL KV prefix (ctx keys); the causal
    # ctx/2 average only applies to prefill, which this generate-stage model
    # does not price.  2 MACs x (QK^T + PV) = 4 flops per key per d_model.
    attn_flops = 4.0 * m_tok * ctx * wl.d_model
    t_attn_compute = attn_flops / (tp * chip.tflops * 1e12 * util)

    # Tensor-parallel all-reduce (2 per layer). Link bw: slowest in group.
    link = np.where(tp <= server.num_chips, CHIP_IO_GBS, ETHERNET_GBS)
    ar_bytes = m_tok * wl.d_model * BYTES_PER_KV
    if use_2d_weight_stationary:
        eff = 2.0 * (np.sqrt(tp) - 1.0) / np.sqrt(tp)
    else:
        eff = 2.0 * (tp - 1.0) / tp
    t_ar = 2.0 * (ar_bytes * eff / link + ALLREDUCE_INIT_S)
    t_ar = np.where(tp > 1, t_ar, 0.0)

    t_layer = (np.maximum.reduce([t_fc_compute, t_fc_mem])
               + np.maximum.reduce([t_attn_compute, t_attn_mem]) + t_ar)

    # Pipeline schedule (paper Fig 6).
    t_send = np.where(pp > 1, m_tok * wl.d_model * BYTES_PER_KV / link
                      + ALLREDUCE_INIT_S, 0.0)
    l_s = (L / pp) * t_layer + t_send
    l_mb = pp * l_s
    l_token = np.maximum(l_mb, n * l_s)
    tokens_per_s = N / l_token

    # Bound classification for reporting.
    comp = t_fc_compute + t_attn_compute
    memb = t_fc_mem + t_attn_mem
    bounds = np.where(t_ar > np.maximum(comp, memb), 2,
                      np.where(memb > comp, 1, 0))

    ok = mem_ok & (pp <= L) & (n <= N) & (m_tok >= 1)
    out: List[Optional[PerfResult]] = []
    names = ("compute", "memory", "interconnect")
    for i, mp in enumerate(maps):
        if not ok[i]:
            out.append(None)
            continue
        out.append(PerfResult(
            mapping=mp,
            tokens_per_s=float(tokens_per_s[i]),
            latency_per_token=float(l_token[i]),
            util=float(util[i]),
            mem_per_chip_mb=float(mem_per_chip[i] / 1e6),
            bound=names[int(bounds[i])],
        ))
    return out


def mapping_grid(server: ServerConfig, wl: LLMWorkload,
                 batches: Iterable[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256,
                                           512, 1024),
                 tp_choices: Optional[Iterable[int]] = None) -> List[Mapping]:
    """The paper's search space: tp x pp x batch x microbatches."""
    nc = server.num_chips
    if tp_choices is None:
        tp_choices = sorted({nc, nc // 2, nc // 4, max(nc // 8, 1)})
    pps = _divisors(wl.num_layers)
    out = []
    for tp in tp_choices:
        if tp < 1 or nc % tp:
            continue
        for pp in pps:
            for N in batches:
                for n in _divisors(int(N), cap=64):
                    out.append(Mapping(tp=tp, pp=pp, batch=int(N),
                                       microbatches=n))
    return out


@dataclass(frozen=True)
class DesignPoint:
    server: ServerConfig
    perf: PerfResult
    tco_per_mtoken: float
    servers: int

    def table_row(self) -> dict:
        c = self.server.chip
        m = self.perf.mapping
        return {
            "die_mm2": c.die_mm2,
            "mb_per_chip": round(c.sram_mb, 1),
            "tflops_per_chip": round(c.tflops, 2),
            "bw_tb_s": round(c.mem_bw / 1e12, 2),
            "chips_per_server": self.server.num_chips,
            "num_servers": self.servers,
            "tp": m.tp,
            "pp": m.pp,
            "batch": m.batch,
            "microbatch": m.microbatch,
            "tokens_s_chip": round(self.perf.tokens_per_s_per_chip, 2),
            "tco_per_mtoken": self.tco_per_mtoken,
            "bound": self.perf.bound,
        }


def best_mapping(server: ServerConfig, wl: LLMWorkload, ctx: int,
                 batches=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
                 ) -> Optional[DesignPoint]:
    """TCO/token-optimal mapping for one server design."""
    from repro_torch.core import tco as tco_lib

    grid = mapping_grid(server, wl, batches)
    results = evaluate_grid(server, wl, ctx, grid)
    best: Optional[DesignPoint] = None
    rate = server_tco(server).rate
    for r in results:
        if r is None:
            continue
        servers = math.ceil(r.mapping.chips / server.num_chips)
        cost = rate * servers / max(r.tokens_per_s, 1e-30) * 1e6
        if best is None or cost < best.tco_per_mtoken:
            best = DesignPoint(server=server, perf=r, tco_per_mtoken=cost,
                               servers=servers)
    return best
