"""Closed-loop warmup for the serving engine's prefill shapes.

Port of ``repro.serving.warmup``.  Prefill runs per (admission group
size, chunk bucket) shape: the closed-loop runs hit each shape naturally
before measuring, but an OPEN-LOOP arrival process admits in groups of
any size from 1 up to ``max_batch`` depending on timing.  The port traces
nothing, so there is no jit cache to fill; what a first use of a shape
pays for on the card is the kernels' build and load (``kernels._build``),
cuBLAS's handles and workspaces, and the caching allocator's first
blocks of each size.  Paid mid-run, that stalls a scheduler tick and
skews both the client latency distribution and the circuit breaker's
tick clock.

``warmup_prefill`` drains one tiny closed-loop batch per (group size,
prompt-length bucket) combination, so every shape the trace can admit has
run once when the clock starts.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np


def trace_prompt_lens(trace: Sequence, engine,
                      extra: Iterable[int] = ()) -> Tuple[int, ...]:
    """Representative prompt lengths covering every prefill shape an
    open-loop ``trace`` can make ``engine`` run.

    Candidates are each item's prompt length AND its preemption-recompute
    worst case (a preempted request replays prompt + generated-so-far as
    one longer prompt, clamped to the cache), plus any ``extra`` lengths
    the caller knows about (e.g. the shared system-prefix length).  Two
    candidates that decompose into the same chunk shapes — same
    has-continuation-chunks bit, same power-of-two bucket of the tail
    chunk — run the same shapes, so one representative (the longest,
    which also walks the most continuation chunks) is kept per shape.
    This is THE coverage rule: ``launch.serve`` derives its warmup from
    it.
    """
    from repro_torch.serving.engine import _bucket

    cap = engine.prefill_chunk or engine.max_len
    cand = {int(n) for n in extra}
    for it in trace:
        p = len(it.prompt)
        cand.add(p)
        cand.add(min(p + int(it.max_new_tokens), engine.max_len - 1))
    reps = {}
    for n in sorted(cand):
        if not 0 < n < engine.max_len:
            continue
        tail = n % cap or cap
        key = (n > cap, _bucket(tail, cap))
        reps[key] = n  # sorted iteration: keeps the longest per shape
    return tuple(sorted(reps.values()))


def warmup_prefill(engine, vocab_size: int,
                   prompt_lens: Iterable[int] = (12,),
                   max_new_tokens: int = 2, seed: int = 99,
                   reset_stats: bool = True) -> None:
    """Warm ``engine`` for every admission group size.

    For each prompt length in ``prompt_lens`` (deduplicated; pick one
    representative per chunk bucket the real trace can hit, including any
    shared-prefix length) and each group size ``1..engine.max_batch``,
    submit that many uniform random prompts and drain them closed-loop.
    Also runs the decode window (and the speculative verify pass when
    ``spec_decode`` is on).

    ``reset_stats``: start the engine's ``EngineStats`` fresh afterwards
    so warmup traffic never pollutes measured numbers.
    """
    from repro_torch.serving.engine import EngineStats

    rng = np.random.default_rng(seed)
    for n in sorted({int(n) for n in prompt_lens}):
        if not 0 < n < engine.max_len:
            continue
        for g in range(1, engine.max_batch + 1):
            for _ in range(g):
                engine.submit(rng.integers(1, vocab_size, size=n),
                              max_new_tokens=max_new_tokens)
            engine.run()
    if reset_stats:
        engine.stats = EngineStats()
