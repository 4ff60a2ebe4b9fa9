"""Prefix-affinity replica router: N serving engines, one admission surface.

Port of ``repro.serving.router``, the same code over the port's engine.

Rung 2 of the scale ladder (the paper's §4 cloud posture): tensor
parallelism widens ONE engine over a mesh (``ServingEngine(mesh=...)``);
past that, throughput comes from REPLICAS — independent engines, each its
own single controller (own scheduler, own ``BlockStore``, own KV pool,
own breaker), coordinated only at admission time.  ``ReplicaRouter``
fronts N ``AsyncFrontend``-wrapped engines with exactly the client API of
one frontend (``submit`` -> ``TokenStream``), so the open-loop driver and
any other client code run against a fleet unchanged.

Placement is the router's whole job, and prefix caching makes it
non-trivial: a replica that already holds a request's leading blocks
serves it with most of its prefill skipped, but ONLY that replica —
block pools do not gossip.  Policies:

  * ``"affinity"`` (default) — probe every replica's prefix cache with
    ``engine.match_cached_blocks`` (the SAME hash chain admission uses:
    vlm patch sentinels, per-request chain seed, kv_dtype-namespaced
    root, so a hit here is a hit at admission) and route to the deepest
    match; ties — including the no-match common case — fall back to
    least-loaded by ``live blocks + frontend queue depth``.  Result:
    shared-system-prompt traffic converges onto warm replicas (aggregate
    prefix hit-rate approaches the single-engine rate) while cold
    traffic spreads by load.
  * ``"round_robin"`` — rotate submissions; the affinity-blind baseline
    the bench compares against (shared prefixes get re-prefetched on
    every replica they land on).

Admission folds per-replica backpressure/breaker state into ONE
client-facing surface: a submit tries replicas in preference order and
only raises ``RejectedError`` when EVERY replica rejected — with
``kind="breaker"`` only when all of them were shedding (the fleet is
saturated), else ``kind="backpressure"`` (retry with backoff; some queue
was merely full).  A single overloaded replica therefore sheds onto its
peers before the client ever sees a 503.

Correctness contract: the router never touches tokens — per-request
streams are bit-identical to the same prompt on a solo engine (greedy
sampling; stochastic streams are keyed by per-engine uids and so depend
on placement by construction).  Pinned in tests/test_router.py.

Fault tolerance: at fleet scale module failure is steady-state,
so the router also owns the per-replica HEALTH state machine and request
FAILOVER:

  * **health** — each replica walks healthy -> suspect -> dead
    (``ReplicaHealth``), driven by the frontend's per-tick observer: a
    step whose virtual cost exceeds the watchdog deadline marks the
    replica suspect (hung device); ``crash_threshold`` CONSECUTIVE step
    exceptions mark it dead (a transient error alone never kills — the
    next clean step resets the count).  Suspect replicas take only
    ``probes`` probe placements (the breaker's half-open pattern): a
    probe completing cleanly revives them to healthy.  Dead replicas and
    replicas under administrative ``drain(i)`` are excluded from
    placement; draining lets in-flight lanes finish.
  * **failover** — when a replica dies, its pump is halted, its
    in-flight tickets are detached (streams stay open) and each request
    is resubmitted to a healthy replica as prompt + already-emitted
    tokens: exactly the engine's preemption-recompute path (per-position
    PRNG keys make the replay sampling-invariant; with prefix caching
    the recompute is mostly cache hits).  The new ticket's queue is
    ALIASED to the client's queue and the emitted prefix is never
    regenerated, so the client's ``TokenStream`` continues seamlessly
    and the completed output is BIT-IDENTICAL to a failure-free run
    (greedy; the headline test).  A per-request ``retry_budget`` bounds
    re-homing; exhaustion surfaces ``RejectedError(kind="timeout")``
    from the stream.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import EngineStats, ServingEngine
from repro_torch.serving.frontend import (_DONE, AsyncFrontend, CircuitBreaker,
                                    RejectedError, TokenStream)

ROUTER_POLICIES = ("affinity", "round_robin")

#: Replica health states, in degradation order.
HEALTH_STATES = ("healthy", "suspect", "dead")


class ReplicaHealth:
    """Per-replica healthy/suspect/dead state machine (router-owned).

    Inputs are the frontend's per-tick reports (``record_step``): an
    ERROR tick bumps the consecutive-failure count — ``crash_threshold``
    in a row is a crash and the replica is DEAD; fewer mark it SUSPECT
    until a clean probe revives it.  A clean tick whose virtual cost
    exceeds ``deadline_ticks`` is a WATCHDOG trip (hung/stalled device)
    and also marks suspect.  Suspect replicas accept at most ``probes``
    concurrent probe placements (mirroring the circuit breaker's
    half-open state); a probe that completes cleanly returns the replica
    to healthy, a failed probe leaves it suspect (only consecutive step
    errors kill).  Dead is terminal — fleet recovery is failover plus a
    replacement replica, not resurrection.  ``draining`` is orthogonal
    administrative state: no new placements, in-flight lanes finish.

    All counting is in ticks reported by the pump — no wall clock — so
    fault-injection tests replay deterministically."""

    def __init__(self, *, deadline_ticks: int = 16,
                 crash_threshold: int = 3, probes: int = 1):
        if deadline_ticks < 1 or crash_threshold < 1 or probes < 1:
            raise ValueError("health knobs must all be >= 1")
        self.deadline_ticks = deadline_ticks
        self.crash_threshold = crash_threshold
        self.probes = probes
        self.state = "healthy"
        self.draining = False
        self.watchdog_trips = 0
        self.step_errors = 0
        self.consecutive_errors = 0
        #: Every state change, in order, as (from, to).
        self.transitions: List[Tuple[str, str]] = []
        self._probe_live = 0

    def record_step(self, *, error: Optional[BaseException] = None,
                    cost_ticks: int = 1) -> Optional[str]:
        """Fold one tick's outcome in; returns the notable event —
        "watchdog" (deadline trip), "died" (crash threshold reached),
        "error" (a non-fatal step error) or None."""
        if self.state == "dead":
            return None
        if error is not None:
            self.step_errors += 1
            self.consecutive_errors += 1
            if self.consecutive_errors >= self.crash_threshold:
                self._to("dead")
                return "died"
            if self.state == "healthy":
                self._to("suspect")
            return "error"
        self.consecutive_errors = 0
        if cost_ticks > self.deadline_ticks:
            self.watchdog_trips += 1
            if self.state == "healthy":
                self._to("suspect")
            return "watchdog"
        return None

    def can_place(self) -> bool:
        """May this replica take a NEW request right now?"""
        if self.draining or self.state == "dead":
            return False
        if self.state == "suspect":
            return self._probe_live < self.probes
        return True

    def note_placed(self) -> bool:
        """Record one accepted placement; True if it is a health probe
        (the replica is suspect and this request's completion will judge
        it)."""
        if self.state == "suspect":
            self._probe_live += 1
            return True
        return False

    def record_probe_end(self, ok: Optional[bool]) -> None:
        """A probe placement ended: True = completed cleanly (revive),
        False = errored, None = cancelled (no judgement)."""
        self._probe_live = max(0, self._probe_live - 1)
        if ok and self.state == "suspect":
            self._to("healthy")
            self.consecutive_errors = 0

    def mark_dead(self) -> None:
        if self.state != "dead":
            self._to("dead")

    def _to(self, state: str) -> None:
        self.transitions.append((self.state, state))
        self.state = state
        if state == "suspect":
            self._probe_live = 0


@dataclass
class RouterStats:
    """Admission-time routing outcomes (token accounting lives in each
    engine's own ``EngineStats``)."""
    submitted: int = 0
    rejected: int = 0
    #: Submits whose chosen replica already held >= 1 block of the prompt
    #: (over submits where ANY replica did — the router's hit-RATE is
    #: affinity_hits / affinity_eligible).
    affinity_hits: int = 0
    affinity_eligible: int = 0
    #: Submits that overflowed their preferred replica onto a later one.
    spillovers: int = 0
    per_replica: List[int] = field(default_factory=list)
    #: Requests re-homed off a dead replica and ACCEPTED elsewhere.
    failovers: int = 0
    #: Replicas whose health reached "dead".
    replica_deaths: int = 0
    #: Watchdog deadline trips across the fleet (hung/stalled steps).
    watchdog_trips: int = 0
    #: Failover resubmission attempts (accepted or not; >= failovers).
    retries: int = 0
    #: Replicas currently under administrative drain.
    drained_replicas: int = 0


class _FleetBreaker:
    """Read-only aggregate of the replicas' breakers, shaped like one
    ``CircuitBreaker`` for ``OpenLoopReport.summary`` (opens / shed /
    state / transitions).  State is the most-degraded replica's."""

    def __init__(self, breakers: Sequence[CircuitBreaker]):
        self._breakers = list(breakers)

    @property
    def opens(self) -> int:
        return sum(b.opens for b in self._breakers)

    @property
    def shed(self) -> int:
        return sum(b.shed for b in self._breakers)

    @property
    def state(self) -> str:
        states = {b.state for b in self._breakers}
        for worst in ("open", "half_open"):
            if worst in states:
                return worst
        return "closed"

    @property
    def transitions(self) -> List[tuple]:
        return [t for b in self._breakers for t in b.transitions]


class ReplicaRouter:
    """N independent ``ServingEngine`` replicas behind one ``submit``.

    Single-controller-per-replica: each engine keeps its own scheduler
    loop, block store, and pump thread (via its ``AsyncFrontend``);
    NOTHING is shared between replicas — no pool, no stats, no PRNG
    stream — so a replica is exactly a solo engine and the fleet scales
    by copying it.  The router holds only admission-time state (the
    routing counters and round-robin cursor) on the event loop, so
    ``submit`` is safe to call from many client coroutines.

    ``engines`` may be heterogeneous (different meshes, kernels, pool
    sizes); affinity and load probes read each engine's public surface
    (``match_cached_blocks``, ``live_blocks``) without assumptions.
    ``breaker_factory`` builds one breaker PER replica (None = each
    frontend's default); sharing one breaker object across replicas
    would serialize their pump threads on it and is not supported.
    """

    def __init__(self, engines: Sequence[ServingEngine], *,
                 policy: str = "affinity", max_queue_depth: int = 64,
                 breaker_factory: Optional[Callable[[], CircuitBreaker]]
                 = None,
                 idle_sleep_s: float = 0.001,
                 health_factory: Optional[Callable[[], ReplicaHealth]]
                 = None,
                 retry_budget: int = 3):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"policy {policy!r} not in {ROUTER_POLICIES}")
        if retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        self.policy = policy
        self.retry_budget = retry_budget
        self.frontends = [
            AsyncFrontend(e, max_queue_depth=max_queue_depth,
                          breaker=breaker_factory() if breaker_factory
                          else None,
                          idle_sleep_s=idle_sleep_s)
            for e in engines]
        #: Per-replica health state machines, fed by each frontend's
        #: tick observer (``health_factory`` builds one per replica;
        #: None = defaults).
        self.health = [health_factory() if health_factory
                       else ReplicaHealth() for _ in engines]
        for i, fe in enumerate(self.frontends):
            fe.tick_observer = (
                lambda info, i=i: self._observe_tick(i, info))
        self.stats = RouterStats(per_replica=[0] * len(engines))
        self._rr = 0
        #: Replicas declared dead whose failover has not run yet (a live
        #: event loop drains this via a task; manually-stepped tests call
        #: ``fail_over_dead()`` themselves).
        self._dead_pending: List[int] = []
        self._failover_tasks: List[asyncio.Task] = []
        #: Wall seconds from death detection to the failed-over
        #: request's first replacement token (the failover TTFT the
        #: bench's p99 delta prices).
        self.failover_ttft_s: List[float] = []

    @property
    def engines(self) -> List[ServingEngine]:
        return [fe.engine for fe in self.frontends]

    @property
    def breaker(self) -> _FleetBreaker:
        """Aggregate breaker view (``OpenLoopReport.summary`` reads it)."""
        return _FleetBreaker([fe.breaker for fe in self.frontends])

    @property
    def queue_depth(self) -> int:
        return sum(fe.queue_depth for fe in self.frontends)

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "ReplicaRouter":
        for fe in self.frontends:
            await fe.start()
        return self

    async def stop(self, drain: bool = True) -> None:
        for fe in self.frontends:
            await fe.stop(drain=drain)

    async def __aenter__(self) -> "ReplicaRouter":
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.stop(drain=exc_type is None)

    async def aclose(self) -> None:
        """Leak-proof teardown: finish pending failovers, cancel every
        in-flight stream on EVERY replica (each cancel releases its KV
        blocks), stop all pumps, and assert the fleet holds zero live
        blocks.  Use instead of ``stop()`` when streams may still be
        open — the solo-frontend cancel path only covers one engine;
        this is the fleet-wide version (and the teardown the chaos tests
        drive)."""
        for task in list(self._failover_tasks):
            if not task.done():
                await task
        if self._dead_pending:  # manually-stepped sessions
            await self.fail_over_dead()
        for fe in self.frontends:
            for t in list(fe._inflight.values()):
                fe._cancel_ticket(t)
            if fe._pump_task is None and not fe._stopped:
                # Never-started frontend (manually-stepped tests): no
                # pump will apply the cancels — flush them inline.
                for _ in range(200):
                    if not fe._has_engine_work():
                        break
                    fe._dispatch(fe._tick())
        await self.stop(drain=True)
        leaked = {
            i: fe.engine.live_blocks
            for i, fe in enumerate(self.frontends)
            if not getattr(fe.engine, "poisoned", False)
            and fe.engine.live_blocks > 0}
        assert not leaked, (
            f"router teardown leaked live KV blocks: {leaked}")

    # -- placement -----------------------------------------------------------
    def _load(self, i: int) -> int:
        """Least-loaded fallback signal: device blocks the replica's
        in-flight requests hold plus requests it has accepted but not
        finished (covers queued work not yet admitted to a lane)."""
        return self.frontends[i].engine.live_blocks \
            + self.frontends[i].queue_depth

    def _order(self, prompt, patch_embeds) -> List[int]:
        """Placeable replica indices in preference order for one submit
        (dead/draining replicas excluded; suspect ones only while they
        have a free probe slot — may be empty if the whole fleet is
        down)."""
        n = len(self.frontends)
        if self.policy == "round_robin":
            order = [(self._rr + k) % n for k in range(n)]
            self._rr = (self._rr + 1) % n
            return [i for i in order if self.health[i].can_place()]
        cand = [i for i in range(n) if self.health[i].can_place()]
        if not cand:
            return []
        matches = {i: self.frontends[i].engine.match_cached_blocks(
            prompt, patch_embeds=patch_embeds) for i in cand}
        if any(matches.values()):
            self.stats.affinity_eligible += 1
        order = sorted(cand,
                       key=lambda i: (-matches[i], self._load(i), i))
        if matches[order[0]] > 0:
            self.stats.affinity_hits += 1
        return order

    # -- submission ----------------------------------------------------------
    async def submit(self, prompt, max_new_tokens: int = 32, *,
                     deadline: Optional[float] = None, priority: int = 0,
                     patch_embeds: Optional[np.ndarray] = None,
                     timeout_s: Optional[float] = None) -> TokenStream:
        """Route one request to a replica; returns its ``TokenStream``.

        Tries PLACEABLE replicas (healthy, plus suspect ones with a free
        probe slot; never dead or draining) in preference order; raises
        ``RejectedError`` only when every one rejected (``kind="breaker"``
        iff ALL were breaker sheds — the whole fleet is saturated) or no
        replica accepts placements at all."""
        order = self._order(prompt, patch_embeds)
        if not order:
            self.stats.rejected += 1
            raise RejectedError(
                f"no replica accepts placements (health: "
                f"{[h.state + ('/draining' if h.draining else '') for h in self.health]})",
                kind="breaker")
        kinds = []
        for k, i in enumerate(order):
            try:
                stream = await self.frontends[i].submit(
                    prompt, max_new_tokens=max_new_tokens,
                    deadline=deadline, priority=priority,
                    patch_embeds=patch_embeds, timeout_s=timeout_s)
            except RejectedError as e:
                kinds.append(e.kind)
                continue
            if self.health[i].note_placed():
                # A suspect replica's placement doubles as its revival
                # probe: completion judges the replica, not just the
                # request.
                stream._ticket.on_done = self.health[i].record_probe_end
            self.stats.submitted += 1
            self.stats.per_replica[i] += 1
            if k > 0:
                self.stats.spillovers += 1
            return stream
        self.stats.rejected += 1
        kind = "breaker" if kinds and all(k == "breaker" for k in kinds) \
            else "backpressure"
        raise RejectedError(
            f"all {len(order)} placeable replicas rejected "
            f"({', '.join(kinds)})",
            kind=kind)

    # -- health + failover ---------------------------------------------------
    def _observe_tick(self, i: int, info: dict) -> None:
        """Per-tick health tap (installed as each frontend's
        ``tick_observer``; runs on the event loop, or inline under
        manually-stepped tests)."""
        event = self.health[i].record_step(
            error=info.get("error"),
            cost_ticks=info.get("cost_ticks", 1))
        if event == "watchdog":
            self.stats.watchdog_trips += 1
        elif event == "died":
            self.stats.replica_deaths += 1
            self._dead_pending.append(i)
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # manual stepping: caller runs fail_over_dead()
            self._failover_tasks.append(
                loop.create_task(self.fail_over_dead()))

    def drain(self, i: int) -> None:
        """Administrative drain: replica ``i`` takes no NEW placements;
        its in-flight lanes run to completion.  Idempotent."""
        h = self.health[i]
        if not h.draining:
            h.draining = True
            self.stats.drained_replicas += 1

    def undrain(self, i: int) -> None:
        """Reopen a drained replica for placements."""
        h = self.health[i]
        if h.draining:
            h.draining = False
            self.stats.drained_replicas -= 1

    async def fail_over_dead(self) -> int:
        """Fail over every replica currently pending death handling;
        returns the number of requests re-homed.  Idempotent — safe to
        call when nothing is pending (manually-stepped tests call it
        after ticking; live pumps schedule it automatically)."""
        moved = 0
        while self._dead_pending:
            moved += await self._fail_over(self._dead_pending.pop(0))
        return moved

    async def _fail_over(self, i: int) -> int:
        """Re-home every in-flight request of dead replica ``i``.

        Order matters: detach the tickets FIRST (streams stay open),
        halt the pump, release the dead engine's blocks (its scheduler
        state is intact unless poisoned — injected crashes fire at the
        step boundary), then resubmit each request as prompt + emitted
        tokens.  The resubmission is the engine's preemption-recompute
        contract: positional PRNG keys replay identically, the clamped
        budget arithmetic matches ``_remaining_budget``, and the emitted
        prefix is never re-streamed — so a completed request's output is
        bit-identical to a failure-free run."""
        fe = self.frontends[i]
        victims = fe.take_inflight()
        await fe.halt()
        eng = fe.engine
        for t in victims:
            if t.uid is not None:
                try:
                    eng.cancel(t.uid)
                except Exception:
                    pass  # poisoned store: blocks are unrecoverable
        t0 = time.perf_counter()
        moved = 0
        for t in victims:
            moved += await self._resubmit(fe, t, t0)
        return moved

    async def _resubmit(self, fe: AsyncFrontend, t, t0: float) -> int:
        """Resubmit one detached ticket elsewhere; returns 1 if it was
        accepted by a healthy replica."""
        emitted = list(t.emitted)
        clamp = min(t.max_new_tokens,
                    fe.engine.max_len - len(t.prompt))
        rem = clamp - len(emitted)
        eos = fe.engine.eos_id
        if rem <= 0 or (emitted and emitted[-1] == eos):
            # Already at budget (or past EOS): only the finish event died
            # with the replica — the stream is complete as emitted.
            t.done, t.result = True, emitted
            t.queue.put_nowait(_DONE)
            return 0
        if t.retries >= self.retry_budget:
            t.done = True
            t.queue.put_nowait(RejectedError(
                f"failover retry budget ({self.retry_budget}) exhausted",
                kind="timeout"))
            return 0
        self.stats.retries += 1
        prompt2 = np.concatenate(
            [np.asarray(t.prompt, np.int32),
             np.asarray(emitted, np.int32)]) if emitted else t.prompt
        try:
            stream2 = await self.submit(
                prompt2, max_new_tokens=rem, deadline=t.deadline,
                patch_embeds=t.patch_embeds)
        except RejectedError as e:
            t.done = True
            t.queue.put_nowait(e)
            return 0
        t2 = stream2._ticket
        # Seamless continuation: the replacement's tokens land straight
        # in the client's queue; cancel/uid/done resolve through the
        # successor chain (TokenStream._live).  No awaits separate the
        # submit from the alias, so no token can slip into t2's original
        # queue first.
        t2.queue = t.queue
        t2.retries = t.retries + 1
        t2.timeout_s, t2.expires_at = t.timeout_s, t.expires_at
        t2.on_first_token = (
            lambda: self.failover_ttft_s.append(time.perf_counter() - t0))
        t.successor = (stream2._fe, t2)
        self.stats.failovers += 1
        return 1

    # -- reporting -----------------------------------------------------------
    def routing_report(self) -> Dict[str, object]:
        """Routing + aggregate engine-side outcomes for the bench."""
        s = self.stats
        engines = self.engines
        cached = sum(e.stats.cached_prompt_tokens for e in engines)
        prefill = sum(e.stats.prefill_tokens for e in engines)
        return {
            "policy": self.policy,
            "replicas": len(engines),
            "submitted": s.submitted,
            "rejected": s.rejected,
            "spillovers": s.spillovers,
            "per_replica_requests": list(s.per_replica),
            "affinity_hit_rate": (s.affinity_hits
                                  / max(s.affinity_eligible, 1)),
            "prefix_hit_rate": cached / max(cached + prefill, 1),
            "generated_tokens": sum(e.stats.generated_tokens
                                    for e in engines),
            "health": [h.state for h in self.health],
        }

    def fault_report(self) -> Dict[str, object]:
        """Fleet fault-tolerance outcomes — ``OpenLoopReport.summary``
        embeds this as its ``fault_tolerance`` block (and the bench's
        section 9 commits it behind the schema gate)."""
        s = self.stats
        pct = EngineStats.percentile
        return {
            "replica_deaths": s.replica_deaths,
            "failovers": s.failovers,
            "retries": s.retries,
            "watchdog_trips": s.watchdog_trips,
            "drained_replicas": s.drained_replicas,
            "health": [h.state for h in self.health],
            "failover_p50_ttft_s": pct(self.failover_ttft_s, 50.0),
            "failover_p99_ttft_s": pct(self.failover_ttft_s, 99.0),
        }


def run_open_loop_router(engines: Sequence[ServingEngine],
                         trace, *, policy: str = "affinity",
                         max_queue_depth: int = 64,
                         breaker_factory: Optional[
                             Callable[[], CircuitBreaker]] = None,
                         idle_sleep_s: float = 0.001,
                         health_factory: Optional[
                             Callable[[], ReplicaHealth]] = None,
                         retry_budget: int = 3,
                         drain: Sequence[int] = ()):
    """Drive an open-loop trace through a fresh router over ``engines``;
    returns ``(OpenLoopReport, ReplicaRouter)``.  The report's
    ``summary()`` works as-is (the router quacks enough like a frontend —
    it has a ``breaker`` and a ``fault_report``); routing detail comes
    from ``router.routing_report()``.  ``engines`` may be
    ``FaultyEngine``-wrapped (``serving.faults``) for chaos runs —
    failover then keeps completed streams bit-identical to a clean
    run.  Replica indices in ``drain`` start administratively drained
    (no placements; the launcher's ``--drain-replica``)."""
    from repro_torch.serving.openloop import OpenLoopReport, drive

    router = ReplicaRouter(engines, policy=policy,
                           max_queue_depth=max_queue_depth,
                           breaker_factory=breaker_factory,
                           idle_sleep_s=idle_sleep_s,
                           health_factory=health_factory,
                           retry_budget=retry_budget)
    for i in drain:
        router.drain(i)

    async def main():
        await router.start()
        try:
            return await drive(router, trace)
        finally:
            await router.aclose()

    t0 = time.perf_counter()
    records = asyncio.run(main())
    report = OpenLoopReport(records=records,
                            wall_s=time.perf_counter() - t0,
                            frontend=router)
    return report, router
