"""Open-loop arrival driver + latency-distribution report for the frontend.

Port of ``repro.serving.openloop``, the same code over the port's engine.

Closed-loop benchmarking (submit everything, run to drain) measures the
engine at its own pace and therefore HIDES queueing delay — the metric
regime the serving-systems literature cares about is open-loop: requests
arrive on a Poisson clock that does not wait for the scheduler, and the
system is judged on tail latency (p99 TTFT, p99 inter-token latency) and
*goodput under an SLO* — completed requests that met their latency target
per second, not raw throughput.  This module provides that posture for
``AsyncFrontend``:

  * ``poisson_trace(...)`` — a reproducible open-loop trace: exponential
    interarrivals at ``rate_req_s`` with per-request prompts/budgets
    drawn from a seeded ``numpy`` Generator.
  * ``drive(frontend, trace)`` — one asyncio client per trace item that
    sleeps until its arrival time, submits, and consumes its stream,
    timestamping every token on the *client* side (so TTFT includes
    admission queueing, which engine-side stats cannot see).
  * ``run_open_loop(engine, trace, ...)`` — sync wrapper: builds the
    frontend, drives the trace, drains, and returns an
    ``OpenLoopReport`` whose ``summary(slo_ttft_s)`` emits the JSON
    block ``serving_bench`` writes into ``BENCH_serving.json``.

Rejected ("backpressure") and shed ("breaker") arrivals are recorded,
not retried: an open-loop client models the load balancer's view, and
retry policy belongs to the caller.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import EngineStats, ServingEngine
from repro_torch.serving.frontend import AsyncFrontend, CircuitBreaker, \
    RejectedError


@dataclass
class TraceItem:
    """One scheduled arrival in an open-loop trace."""
    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[float] = None
    priority: int = 0


@dataclass
class RequestRecord:
    """Client-side outcome of one trace item."""
    arrival_s: float          # scheduled offset from trace start
    #: completed | rejected | shed | timeout | error — "timeout" is a
    #: mid-stream RejectedError(kind="timeout") (per-request wall-clock
    #: budget or failover retry budget exhausted).
    status: str = "pending"
    submit_t: float = 0.0     # wall perf_counter at submit
    token_t: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if not self.token_t:
            return None
        return self.token_t[0] - self.submit_t

    @property
    def itl_s(self) -> List[float]:
        return [b - a for a, b in zip(self.token_t, self.token_t[1:])]


def poisson_trace(rng: np.random.Generator, n: int, rate_req_s: float,
                  vocab: int, prompt_len: tuple = (8, 24),
                  budget: tuple = (8, 24),
                  shared_prefix: Optional[np.ndarray] = None,
                  prefix_fraction: float = 0.0) -> List[TraceItem]:
    """Build ``n`` Poisson arrivals at ``rate_req_s`` requests/second.

    Interarrivals are exponential draws; prompt lengths and decode
    budgets are uniform over the given inclusive ranges.  With
    ``prefix_fraction > 0`` that fraction of requests (Bernoulli) start
    with ``shared_prefix`` — the open-loop analogue of the closed-loop
    shared-prefix bench section.
    """
    if rate_req_s <= 0.0:
        raise ValueError(f"rate_req_s must be > 0, got {rate_req_s}")
    arrivals = np.cumsum(rng.exponential(1.0 / rate_req_s, size=n))
    items: List[TraceItem] = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        toks = rng.integers(0, vocab, size=plen).astype(np.int32)
        if shared_prefix is not None and prefix_fraction > 0.0 \
                and rng.random() < prefix_fraction:
            toks = np.concatenate(
                [np.asarray(shared_prefix, np.int32), toks])
        items.append(TraceItem(
            arrival_s=float(arrivals[i]), prompt=toks,
            max_new_tokens=int(rng.integers(budget[0], budget[1] + 1))))
    return items


async def drive(frontend: AsyncFrontend,
                trace: Sequence[TraceItem]) -> List[RequestRecord]:
    """Run the trace open-loop against a started frontend.

    Every item gets its own client coroutine: sleep until the scheduled
    arrival, submit (a rejection is final — no retry), then consume the
    stream timestamping each token.  Returns records in trace order.
    """
    t0 = time.perf_counter()

    async def one(item: TraceItem) -> RequestRecord:
        rec = RequestRecord(arrival_s=item.arrival_s)
        delay = (t0 + item.arrival_s) - time.perf_counter()
        if delay > 0.0:
            await asyncio.sleep(delay)
        rec.submit_t = time.perf_counter()
        try:
            stream = await frontend.submit(
                item.prompt, max_new_tokens=item.max_new_tokens,
                deadline=item.deadline, priority=item.priority)
        except RejectedError as e:
            rec.status = "shed" if e.kind == "breaker" else "rejected"
            rec.error = str(e)
            return rec
        try:
            async for tok in stream:
                rec.token_t.append(time.perf_counter())
                rec.tokens.append(tok)
            rec.status = "completed"
        except RejectedError as e:
            # Mid-stream rejection: the request was admitted but ended by
            # its wall-clock timeout or the failover retry budget.
            rec.status = "timeout" if e.kind == "timeout" else "shed" \
                if e.kind == "breaker" else "rejected"
            rec.error = str(e)
        except Exception as e:
            rec.status = "error"
            rec.error = f"{type(e).__name__}: {e}"
        return rec

    return list(await asyncio.gather(*(one(it) for it in trace)))


@dataclass
class OpenLoopReport:
    """Everything one open-loop run produced, plus the JSON summary."""
    records: List[RequestRecord]
    wall_s: float
    frontend: AsyncFrontend

    def completed(self) -> List[RequestRecord]:
        return [r for r in self.records if r.status == "completed"]

    def count(self, status: str) -> int:
        return sum(1 for r in self.records if r.status == status)

    @property
    def availability(self) -> float:
        """Completed requests over all arrivals — the fleet-level uptime
        number chaos runs gate on (a dead replica must not cost the
        trace's completions; failover keeps availability at 1.0)."""
        return self.count("completed") / max(len(self.records), 1)

    def goodput_under_slo(self, slo_ttft_s: float) -> Dict[str, float]:
        """Requests that completed AND met the client-side TTFT SLO,
        normalized per wall-clock second (requests and tokens)."""
        good = [r for r in self.completed()
                if r.ttft_s is not None and r.ttft_s <= slo_ttft_s]
        wall = max(self.wall_s, 1e-9)
        return {
            "slo_ttft_s": slo_ttft_s,
            "good_requests": len(good),
            "goodput_req_s": len(good) / wall,
            "goodput_tok_s": sum(len(r.tokens) for r in good) / wall,
        }

    def summary(self, slo_ttft_s: float) -> Dict[str, object]:
        """The JSON block serving_bench embeds in BENCH_serving.json."""
        pct = EngineStats.percentile
        ttfts = [r.ttft_s for r in self.completed()
                 if r.ttft_s is not None]
        itls = [g for r in self.completed() for g in r.itl_s]
        br = self.frontend.breaker
        out = {
            "requests": len(self.records),
            "completed": self.count("completed"),
            "rejected_backpressure": self.count("rejected"),
            "shed_breaker": self.count("shed"),
            "timeouts": self.count("timeout"),
            "errors": self.count("error"),
            "availability": self.availability,
            "wall_s": self.wall_s,
            "client_p50_ttft_s": pct(ttfts, 50.0),
            "client_p99_ttft_s": pct(ttfts, 99.0),
            "client_p50_itl_s": pct(itls, 50.0),
            "client_p99_itl_s": pct(itls, 99.0),
            "goodput": self.goodput_under_slo(slo_ttft_s),
            "breaker": {
                "opens": br.opens,
                "shed": br.shed,
                "final_state": br.state,
                "transitions": [list(t) for t in br.transitions],
            },
        }
        # Fleet frontends (ReplicaRouter) carry fault-tolerance counters
        # — failovers, replica deaths, watchdog trips, retries, drains —
        # threaded into the summary when present.
        ft = getattr(self.frontend, "fault_report", None)
        if callable(ft):
            out["fault_tolerance"] = ft()
        return out


def run_open_loop(engine: ServingEngine, trace: Sequence[TraceItem], *,
                  max_queue_depth: int = 64,
                  breaker: Optional[CircuitBreaker] = None,
                  idle_sleep_s: float = 0.001) -> OpenLoopReport:
    """Drive ``trace`` through a fresh ``AsyncFrontend`` on ``engine``
    and return the report (frontend is started, drained, stopped)."""
    fe = AsyncFrontend(engine, max_queue_depth=max_queue_depth,
                       breaker=breaker, idle_sleep_s=idle_sleep_s)

    async def main() -> List[RequestRecord]:
        await fe.start()
        try:
            return await drive(fe, trace)
        finally:
            await fe.stop(drain=True)

    t0 = time.perf_counter()
    records = asyncio.run(main())
    return OpenLoopReport(records=records,
                          wall_s=time.perf_counter() - t0, frontend=fe)
