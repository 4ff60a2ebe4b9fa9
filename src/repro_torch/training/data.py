"""Deterministic synthetic data pipeline.

A copy of ``repro.training.data`` (numpy only).

A seeded, restartable token stream: batch `i` is a pure function of
(seed, i), so a job restarted from a checkpoint at step k reproduces the
exact remaining stream — the property the fault-tolerance story needs.
The generator mimics Zipfian token statistics so losses are non-degenerate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Stateless-per-index batch source (restartable at any step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipfian unigram distribution over the vocab.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = (p / p.sum()).astype(np.float64)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ index)
        toks = rng.choice(cfg.vocab_size, size=(cfg.global_batch,
                                                cfg.seq_len + 1), p=self._p)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def shard_for_host(batch: Dict[str, np.ndarray], host_index: int,
                   host_count: int) -> Dict[str, np.ndarray]:
    """Per-host slice of the global batch (multi-host data loading)."""
    def slc(x):
        n = x.shape[0]
        per = n // host_count
        return x[host_index * per: (host_index + 1) * per]

    return {k: slc(v) for k, v in batch.items()}
