"""Deterministic fault injection for replica engines.

Port of ``repro.serving.faults``, the same code over the port's engine.

The paper's fleet posture (thousands of replicated accelerator modules
serving one workload, §4) makes individual module failure a steady-state
condition — so the serving stack's failure handling must be TESTABLE the
same way its scheduling is: replayable, seeded, and free of wall-clock
races.  This module provides exactly that:

  * ``FaultPlan`` — an immutable schedule of fault events keyed by
    *engine-step index* (the number of ``step()`` calls the replica has
    executed, NOT wall time or pump iterations: idle pump ticks never
    advance it, so a plan replays identically under a live pump or a
    manually-stepped test).  Plans are built explicitly
    (``FaultPlan.crash_at(12)``) or drawn from a seed
    (``FaultPlan.seeded(7)``) via a private ``numpy`` Generator — no
    global RNG, no ``time``.
  * ``FaultyEngine`` — a transparent proxy around a ``ServingEngine``
    that injects the plan at the engine-step boundary and delegates
    everything else untouched (``submit``/``cancel``/stats/probes all
    reach the real engine, so scheduler state stays exactly what the
    health layer must recover).

Fault kinds (``FAULT_KINDS``):

  * ``"crash"`` — from its tick on, every ``step()`` raises
    ``ReplicaCrashed`` forever (a dead module does not come back; the
    router's health tracker must detect it and fail its requests over).
  * ``"hang"`` — the step at its tick does nothing and reports a virtual
    cost of ``duration`` ticks via ``last_step_cost`` (one stalled
    device interaction); a cost above the health watchdog's deadline is
    what marks a replica suspect.
  * ``"raise"`` — the step at its tick raises ``InjectedFault`` once and
    the replica then recovers: the transient-device-error case that must
    NOT kill a replica (only *consecutive* failures may).
  * ``"slow"`` — for ``duration`` steps from its tick, only every
    ``factor``-th step makes progress (the others are skipped beats): a
    straggler replica whose throughput drops by ``factor`` without ever
    tripping the watchdog.

Injection happens BEFORE the wrapped ``step()`` runs, so an injected
fault never leaves a half-applied scheduler iteration — the engine's own
poisoned-step contract (``ServingEngine.step``) covers genuine mid-step
failures.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("crash", "hang", "raise", "slow")


class ReplicaCrashed(RuntimeError):
    """The replica is gone: every ``step()`` raises this, forever."""


class InjectedFault(RuntimeError):
    """A transient injected step failure (the replica recovers)."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``tick`` is the engine-step index it fires
    at; ``duration`` is the hang's virtual step cost (in watchdog ticks)
    or the slow window's length (in steps); ``factor`` is the slow
    window's progress divisor (1 real step per ``factor`` calls)."""
    kind: str
    tick: int
    duration: int = 1
    factor: int = 2

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind {self.kind!r} not in {FAULT_KINDS}")
        if self.tick < 0:
            raise ValueError(f"tick must be >= 0, got {self.tick}")
        if self.duration < 1 or self.factor < 1:
            raise ValueError("duration and factor must be >= 1")


class FaultPlan:
    """An immutable, replayable schedule of ``FaultEvent``s.

    Plans compose with ``+`` (union of events); ``seeded`` draws a
    random schedule reproducibly from an integer seed.  All queries are
    by engine-step index and read-only, so one plan object can replay
    any number of runs."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(sorted(
            events, key=lambda e: (e.tick, FAULT_KINDS.index(e.kind))))

    # -- constructors --------------------------------------------------------
    @classmethod
    def crash_at(cls, tick: int) -> "FaultPlan":
        return cls([FaultEvent("crash", tick)])

    @classmethod
    def hang_at(cls, tick: int, duration: int) -> "FaultPlan":
        return cls([FaultEvent("hang", tick, duration=duration)])

    @classmethod
    def raise_at(cls, tick: int) -> "FaultPlan":
        return cls([FaultEvent("raise", tick)])

    @classmethod
    def slow_from(cls, tick: int, factor: int,
                  duration: int) -> "FaultPlan":
        return cls([FaultEvent("slow", tick, duration=duration,
                               factor=factor)])

    @classmethod
    def seeded(cls, seed: int, *, horizon: int = 64,
               crash_p: float = 0.0, hang_p: float = 0.05,
               raise_p: float = 0.05, slow_p: float = 0.05,
               max_hang: int = 64, max_factor: int = 4,
               max_slow: int = 8) -> "FaultPlan":
        """Draw a random plan from ``seed`` — the chaos-test entry point.

        Each step index in ``[0, horizon)`` independently hosts a hang /
        raise / slow event with the given probabilities; at most ONE
        crash is placed (uniformly over the horizon, with probability
        ``crash_p``), since nothing after a crash can fire.  Same seed
        and knobs -> the identical plan, always."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        if crash_p > 0.0 and rng.random() < crash_p:
            events.append(FaultEvent(
                "crash", int(rng.integers(0, horizon))))
        for t in range(horizon):
            if rng.random() < hang_p:
                events.append(FaultEvent(
                    "hang", t, duration=int(rng.integers(2, max_hang + 1))))
            if rng.random() < raise_p:
                events.append(FaultEvent("raise", t))
            if rng.random() < slow_p:
                events.append(FaultEvent(
                    "slow", t, duration=int(rng.integers(1, max_slow + 1)),
                    factor=int(rng.integers(2, max_factor + 1))))
        return cls(events)

    # -- queries -------------------------------------------------------------
    def crash_tick(self) -> Optional[int]:
        ticks = [e.tick for e in self.events if e.kind == "crash"]
        return min(ticks) if ticks else None

    def hang_at_tick(self, tick: int) -> Optional[FaultEvent]:
        for e in self.events:
            if e.kind == "hang" and e.tick == tick:
                return e
        return None

    def raises_at(self, tick: int) -> bool:
        return any(e.kind == "raise" and e.tick == tick
                   for e in self.events)

    def slow_at(self, tick: int) -> Optional[FaultEvent]:
        for e in self.events:
            if e.kind == "slow" and e.tick <= tick < e.tick + e.duration:
                return e
        return None

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(self.events + other.events)

    def __len__(self) -> int:
        return len(self.events)

    def describe(self) -> str:
        """One line per event, for logs and bench provenance."""
        if not self.events:
            return "no faults"
        return "; ".join(
            f"{e.kind}@{e.tick}"
            + (f" x{e.duration}" if e.kind in ("hang", "slow") else "")
            + (f" /{e.factor}" if e.kind == "slow" else "")
            for e in self.events)


class FaultyEngine:
    """A ``ServingEngine`` proxy that injects a ``FaultPlan`` at the
    engine-step boundary.

    Everything except ``step()`` delegates to the wrapped engine — the
    frontend/router surface (``submit``, ``cancel``,
    ``has_pending_work``, ``match_cached_blocks``, ``live_blocks``,
    ``pool_saturation``, ``stats``, ``on_token``, ...) behaves exactly
    like the real replica, which is the point: the health layer must
    recover REAL scheduler state, not a mock's.

    ``last_step_cost`` is the virtual duration (in watchdog ticks) of the
    most recent ``step()`` call: 1 normally, the hang's ``duration`` for
    a stalled step.  The frontend forwards it to the router's per-replica
    watchdog, so hang detection is deterministic — no wall clock.
    """

    def __init__(self, engine, plan: FaultPlan):
        self._engine = engine
        self.plan = plan
        #: Engine-step index: increments once per step() CALL (injected
        #: or delegated), never on idle pump ticks.
        self.ticks = 0
        self.crashed = False
        #: Faults actually fired (a plan event past the run's end never
        #: fires; the chaos tests account against this, not the plan).
        self.injected = 0
        self.last_step_cost = 1

    def __getattr__(self, name):
        return getattr(self._engine, name)

    @property
    def engine(self):
        """The wrapped engine (for tests and reports)."""
        return self._engine

    @property
    def on_token(self):
        return self._engine.on_token

    @on_token.setter
    def on_token(self, fn):
        self._engine.on_token = fn

    def step(self):
        if self.crashed:
            raise ReplicaCrashed(
                f"replica crashed at engine step "
                f"{self.plan.crash_tick()} and will not recover")
        t = self.ticks
        self.ticks += 1
        self.last_step_cost = 1
        crash = self.plan.crash_tick()
        if crash is not None and t >= crash:
            self.crashed = True
            self.injected += 1
            raise ReplicaCrashed(f"injected crash at engine step {t}")
        hang = self.plan.hang_at_tick(t)
        if hang is not None:
            self.injected += 1
            self.last_step_cost = hang.duration
            return []
        if self.plan.raises_at(t):
            self.injected += 1
            raise InjectedFault(f"injected step error at engine step {t}")
        slow = self.plan.slow_at(t)
        if slow is not None and (t - slow.tick) % slow.factor != 0:
            self.injected += 1
            return []  # skipped beat: a straggler's lost step
        return self._engine.step()
