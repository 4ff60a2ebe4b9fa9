"""CC-MEM behavioral model (paper §3.1, Fig 3a).

A cycle-approximate simulator of the Chiplet Cloud memory system: SRAM bank
groups behind a pipelined crossbar, with burst-mode sequential access and
the SCLD compression decoder per bank group.  This is the component-level
model that justifies the bandwidth numbers the co-design engine assumes —
the engine's ``ChipConfig.mem_bw`` is the peak; this module predicts the
*achieved* fraction under bank conflicts and burst lengths.

Modeling choices (all from the paper's description):
  * each bank group is a virtual single-port memory: one word/cycle;
  * the crossbar sustains 100 % throughput absent bank conflicts
    (low-latency, conflict = stall for the losing requester);
  * burst mode amortizes the request path: a burst of B sequential words
    issues 1 request and streams B cycles from one group — GEMM weight
    streams are bursts, attention gathers are not;
  * the SCLD decoder emits up to 8 dense words/cycle from compressed tiles,
    so compressed streams deliver dense-equivalent words at
    min(8, 1/(1-s)) x the raw port rate... capped by the dense port width.

Port of ``repro.core.ccmem``: a copy with its import pointed at
``repro_torch.core.sparsity``.  Host-side numpy analytics: it launches
nothing on a device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class CCMEMConfig:
    num_bank_groups: int = 64
    words_per_cycle_per_group: int = 8  # dense words (port width)
    crossbar_latency_cycles: int = 4  # pipeline depth
    burst_overhead_cycles: int = 2  # CSR setup per burst
    decoder_words_per_cycle: int = 8  # SCLD dense-output rate

    @property
    def peak_words_per_cycle(self) -> int:
        return self.num_bank_groups * self.words_per_cycle_per_group


@dataclass(frozen=True)
class AccessStream:
    """A stream of accesses from one compute port.

    kind: "burst" (sequential weight stream), "strided" (activation rows)
    or "random" (gather).  `words` is the dense word count; `sparsity` > 0
    means the stream reads SCLD-compressed data.
    """

    words: int
    kind: str = "burst"
    burst_len: int = 512
    sparsity: float = 0.0


def _effective_burst(stream: AccessStream) -> int:
    return stream.burst_len if stream.kind != "random" \
        else min(stream.burst_len, 32)


def _group_sequence(stream: AccessStream, cfg: CCMEMConfig,
                    rng: np.random.Generator) -> np.ndarray:
    """Bank-group id per burst for this stream."""
    n_bursts = max(1, stream.words // max(_effective_burst(stream), 1))
    if stream.kind == "burst":
        # Sequential interleave across groups.
        start = int(rng.integers(cfg.num_bank_groups))
        return (start + np.arange(n_bursts)) % cfg.num_bank_groups
    if stream.kind == "strided":
        stride = int(rng.choice([2, 4, 8, 16]))
        start = int(rng.integers(cfg.num_bank_groups))
        return (start + stride * np.arange(n_bursts)) % cfg.num_bank_groups
    return rng.integers(0, cfg.num_bank_groups, size=n_bursts)


def simulate(streams: Sequence[AccessStream], cfg: CCMEMConfig = CCMEMConfig(),
             seed: int = 0) -> dict:
    """Estimate cycles to drain all streams and the achieved bandwidth.

    Conflict model: per round, every stream proposes its next burst's bank
    group; groups serve one burst per round (virtual single-port), losers
    retry next round.  A round costs the burst duration of the longest
    admitted burst (groups are pipelined, so admitted bursts overlap).
    """
    rng = np.random.default_rng(seed)
    seqs: List[np.ndarray] = [_group_sequence(s, cfg, rng) for s in streams]
    ptrs = [0] * len(streams)
    cycles = cfg.crossbar_latency_cycles
    served_words = 0.0
    remaining = [float(s.words) for s in streams]
    total_words = float(sum(s.words for s in streams))

    def burst_cycles(s: AccessStream) -> float:
        # Dense-equivalent words per cycle out of one group.  SCLD streams
        # read (1-s)*24/16 bits per dense word (paper §3.2: same banks, same
        # peak bit rate, extra index bits per word), decoded at up to the
        # 8-wide decoder output.  Sparse reads are therefore never *faster*
        # than dense — the win is capacity — and are slower below ~33%.
        rate = float(cfg.words_per_cycle_per_group)
        if s.sparsity > 0:
            from repro_torch.core.sparsity import storage_factor
            rate = min(float(cfg.decoder_words_per_cycle),
                       rate / max(storage_factor(s.sparsity), 1e-6))
        burst = _effective_burst(s)
        return cfg.burst_overhead_cycles + burst / rate, burst

    active = [i for i in range(len(streams)) if len(seqs[i])]
    while active:
        claims = {}
        for i in active:
            g = int(seqs[i][ptrs[i]])
            claims.setdefault(g, []).append(i)
        winners = [min(v) for v in claims.values()]  # deterministic arb
        round_cost = 0.0
        for i in winners:
            c, burst = burst_cycles(streams[i])
            round_cost = max(round_cost, c)
            # The final burst of a stream is short: credit only the words
            # actually remaining, so served_words can never exceed
            # total_words.
            served = min(float(burst), remaining[i])
            served_words += served
            remaining[i] -= served
            ptrs[i] += 1
        cycles += round_cost
        active = [i for i in active if ptrs[i] < len(seqs[i])]

    peak_cycles = total_words / cfg.peak_words_per_cycle
    return {
        "cycles": cycles,
        "peak_cycles": peak_cycles,
        "achieved_fraction": min(1.0, peak_cycles / max(cycles, 1e-9)),
        "served_words": served_words,
    }


def gemm_streams(m: int, k: int, n: int, tile: int = 128,
                 sparsity: float = 0.0) -> List[AccessStream]:
    """The access pattern of a weight-stationary GEMM on CC-MEM: one long
    weight burst stream + strided activation reads."""
    return [
        AccessStream(words=k * n, kind="burst", burst_len=tile * 4,
                     sparsity=sparsity),
        AccessStream(words=m * k, kind="strided", burst_len=tile),
        AccessStream(words=m * n, kind="strided", burst_len=tile),
    ]


def attention_decode_streams(ctx: int, d: int, kv_heads: int,
                             head_dim: int) -> List[AccessStream]:
    """Decode attention: long sequential KV reads (burst-friendly)."""
    return [
        AccessStream(words=2 * ctx * kv_heads * head_dim, kind="burst",
                     burst_len=head_dim * 8),
        AccessStream(words=4 * d, kind="random", burst_len=32),
    ]
