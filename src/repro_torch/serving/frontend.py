"""Async streaming frontend with admission control over ``ServingEngine``.

Port of ``repro.serving.frontend``, the same code over the port's engine.

The engine is a fast in-process loop (``submit``/``step``); a cloud-scale
service (the paper's premise: thousands of replicated modules absorbing
live traffic under a TCO/token objective) additionally needs the network-
facing layer — streaming responses, an arrival process that does not wait
for the scheduler, and an OVERLOAD story.  ``AsyncFrontend`` is that
layer:

  * **streaming**: ``await frontend.submit(prompt, ...)`` returns a
    ``TokenStream`` — an async iterator yielding the request's tokens as
    the engine emits them (the engine's ``on_token`` hook feeds a
    per-request ``asyncio.Queue``).  Closing the stream mid-flight
    (``aclose``) cancels the request and releases its KV blocks.
  * **one pump, off the event loop**: a single background task drives
    ``engine.step()`` through a one-worker ``run_in_executor`` — the
    event loop never blocks on an engine step, and because the pump awaits
    each tick before the next, ALL engine access is serialized on that
    worker thread (the engine itself is not thread-safe).
  * **deadlines / priorities**: ``submit(deadline=, priority=)`` maps
    onto the engine's ``preempt_policy="deadline"`` total order — an
    explicit deadline is passed through; a bare ``priority > 0`` becomes
    the synthetic deadline ``-priority`` (earlier than any real,
    non-negative deadline, so prioritized traffic is preempted last);
    neither means ``deadline=None`` (best-effort: first evicted).  Only
    ORDER matters, and only when the engine runs the "deadline" policy.
  * **backpressure**: at most ``max_queue_depth`` requests may be in
    flight (accepted but not finished); ``submit`` beyond it raises
    ``RejectedError(kind="backpressure")`` — the 503 the caller retries
    with backoff instead of queueing unboundedly.
  * **timeouts + fault surface**: ``submit(timeout_s=...)`` bounds a
    request's wall-clock life — expiry cancels it (blocks released) and
    its stream raises ``RejectedError(kind="timeout")``.  A raising
    ``engine.step()`` no longer kills the pump: the error is counted
    (``stats.step_errors``), reported to ``tick_observer`` (the replica
    router's per-replica health tap — see ``serving.router``), and after
    ``max_step_errors`` CONSECUTIVE failures a solo frontend declares
    the engine dead and fails its in-flight streams; under a router the
    health tracker reacts first and fails the requests over instead.
  * **load shedding**: a closed/open/half-open ``CircuitBreaker`` watches
    every scheduler tick's preemption delta and pool saturation.  Too
    much pressure inside a sliding window trips it OPEN — submits raise
    ``RejectedError(kind="breaker")`` (cheap, instant) while in-flight
    work drains.  After a cooldown (measured in scheduler ticks, so a
    draining engine runs its own clock) it goes HALF-OPEN and admits up
    to ``probes`` probe requests: a probe finishing cleanly closes the
    breaker, pressure while probing reopens it.  This is what turns
    saturation into bounded tail latency instead of collapse.

Correctness contract (tests/test_frontend.py): streamed tokens are
bit-identical to the same trace through the in-process ``engine.run()``
path — the frontend adds admission control, never arithmetic.

Typical use::

    engine = ServingEngine(cfg, params, preempt_policy="deadline")
    async with AsyncFrontend(engine, max_queue_depth=32) as fe:
        stream = await fe.submit(prompt, max_new_tokens=64, priority=1)
        async for tok in stream:
            ...  # deliver incrementally
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import ServingEngine

#: Circuit-breaker states (classic closed/open/half-open admission).
BREAKER_STATES = ("closed", "open", "half_open")

#: Stream terminator sentinel (private to this module).
_DONE = object()


class RejectedError(RuntimeError):
    """503-style admission rejection.

    ``kind`` is "backpressure" (queue depth at ``max_queue_depth`` —
    retry with backoff), "breaker" (circuit breaker shedding load —
    back off harder; the service is saturated) or "timeout" (the request
    exceeded its per-request wall-clock budget, or its failover retry
    budget after replica deaths — raised from the STREAM, not from
    ``submit``, since the request was admitted before it expired)."""

    def __init__(self, reason: str, kind: str):
        super().__init__(reason)
        self.kind = kind


class CircuitBreaker:
    """Closed/open/half-open admission gate driven by scheduler ticks.

    The pump reports every tick via ``record_tick(preemptions,
    saturation)``; a tick is a PRESSURE tick when it preempted at least
    one request or the pool's live-block saturation reached
    ``sat_threshold``.  ``trip_pressure`` pressure ticks inside the last
    ``window`` ticks trip the breaker open; ``cooldown_ticks`` ticks
    later it half-opens and admits up to ``probes`` probe requests —
    ``probes`` clean completions close it, any pressure (or a failed
    probe) reopens it.  All counting is in ticks, not wall time, so
    tests can script the walk deterministically and a draining engine
    advances its own cooldown."""

    def __init__(self, window: int = 16, trip_pressure: int = 4,
                 sat_threshold: float = 1.0, cooldown_ticks: int = 8,
                 probes: int = 1):
        if window < 1 or trip_pressure < 1 or cooldown_ticks < 1 \
                or probes < 1:
            raise ValueError("breaker knobs must all be >= 1")
        if trip_pressure > window:
            raise ValueError(
                f"trip_pressure {trip_pressure} can never fire inside a "
                f"{window}-tick window")
        self.window = window
        self.trip_pressure = trip_pressure
        self.sat_threshold = sat_threshold
        self.cooldown_ticks = cooldown_ticks
        self.probes = probes
        self.state = "closed"
        self._pressure: deque = deque(maxlen=window)
        self._cooldown = 0
        self._probe_live = 0
        self._probe_ok = 0
        #: Every state change, in order, as (from, to) — the scripted
        #: overload test asserts the full closed->open->half_open->closed
        #: walk on this.
        self.transitions: List[Tuple[str, str]] = []
        self.opens = 0
        self.shed = 0

    def allow(self) -> Tuple[bool, bool]:
        """Admission decision for one submit: (admit, is_probe)."""
        if self.state == "closed":
            return True, False
        if self.state == "half_open" and self._probe_live < self.probes:
            self._probe_live += 1
            return True, True
        self.shed += 1
        return False, False

    def record_tick(self, preemptions: int, saturation: float) -> None:
        """One scheduler tick's pressure signal (pump-thread only)."""
        pressure = preemptions > 0 or saturation >= self.sat_threshold
        if self.state == "closed":
            self._pressure.append(pressure)
            if sum(self._pressure) >= self.trip_pressure:
                self._to("open")
        elif self.state == "open":
            self._cooldown -= 1
            if self._cooldown <= 0:
                self._to("half_open")
        else:  # half_open: any pressure while probing reopens
            if pressure:
                self._to("open")

    def record_probe_end(self, ok: bool) -> None:
        """A probe request finished (cleanly or not)."""
        if self.state != "half_open":
            return  # breaker moved on while the probe was in flight
        self._probe_live = max(0, self._probe_live - 1)
        if not ok:
            self._to("open")
            return
        self._probe_ok += 1
        if self._probe_ok >= self.probes:
            self._to("closed")

    def abandon_probe(self) -> None:
        """A probe was cancelled before finishing: free its slot without
        judging the service healthy or sick."""
        if self.state == "half_open":
            self._probe_live = max(0, self._probe_live - 1)

    def _to(self, state: str) -> None:
        self.transitions.append((self.state, state))
        self.state = state
        if state == "open":
            self.opens += 1
            self._cooldown = self.cooldown_ticks
            self._probe_live = self._probe_ok = 0
        elif state == "half_open":
            self._probe_live = self._probe_ok = 0
        else:  # closed: forget the bad window
            self._pressure.clear()


@dataclass
class FrontendStats:
    accepted: int = 0
    completed: int = 0
    cancelled: int = 0
    errors: int = 0  # engine-side submit validation failures
    rejected_backpressure: int = 0
    shed_breaker: int = 0
    #: Requests ended by their per-request wall-clock timeout (their
    #: streams raised RejectedError(kind="timeout")).
    timeouts: int = 0
    #: Scheduler ticks whose engine.step() raised (the crash-detection
    #: signal the replica router's health tracker consumes).
    step_errors: int = 0


@dataclass
class _Ticket:
    """One accepted request's frontend-side state."""
    id: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[float]
    patch_embeds: Optional[np.ndarray]
    queue: asyncio.Queue
    probe: bool = False
    uid: Optional[int] = None  # engine uid, assigned by the pump
    cancelled: bool = False
    done: bool = False
    #: The engine's final token list (completed requests only) — must
    #: equal exactly what was streamed; the no-token-loss property tests
    #: pin on it.
    result: Optional[List[int]] = None
    #: Tokens DELIVERED to the stream's queue so far (consumed by the
    #: client or not).  Failover resubmits prompt + emitted, so exactly
    #: these tokens are never generated — or streamed — twice.
    emitted: List[int] = field(default_factory=list)
    #: Wall-clock budget: the request times out ``timeout_s`` seconds
    #: after submit (checked each dispatch against ``expires_at``).
    timeout_s: Optional[float] = None
    expires_at: Optional[float] = None  # time.monotonic() deadline
    #: Failover retry count (router-owned): how many times this request
    #: has been re-homed after a replica death.
    retries: int = 0
    #: Set when the request was failed over: (frontend, ticket) of the
    #: live incarnation.  Its queue is ALIASED to this ticket's queue, so
    #: the client's stream continues seamlessly; cancel/done resolve
    #: through the chain (``TokenStream._live``).
    successor: Optional[tuple] = None
    #: Completion tap (router health probes, failover latency): called
    #: with True (completed), False (errored) or None (cancelled/timed
    #: out) exactly once, on the event loop.
    on_done: Optional[Callable[[Optional[bool]], None]] = None
    #: One-shot tap fired when the ticket's FIRST token is dispatched
    #: (failover latency measurement).
    on_first_token: Optional[Callable[[], None]] = None


class TokenStream:
    """Async iterator over one request's generated tokens.

    ``aclose()`` cancels the request if it is still in flight (its KV
    blocks are released at the next scheduler tick); ``collect()`` drains
    to completion and returns the full token list.  ``tokens`` holds
    everything yielded so far."""

    def __init__(self, frontend: "AsyncFrontend", ticket: _Ticket):
        self._fe = frontend
        self._ticket = ticket
        self._exhausted = False
        self.tokens: List[int] = []

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self._exhausted:
            raise StopAsyncIteration
        item = await self._ticket.queue.get()
        if item is _DONE:
            self._exhausted = True
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        self.tokens.append(item)
        return item

    async def collect(self) -> List[int]:
        async for _ in self:
            pass
        return self.tokens

    def _live(self) -> Tuple["AsyncFrontend", _Ticket]:
        """The request's live incarnation: failover re-homes a request
        onto another frontend's ticket (queue aliased back to ours), so
        cancel/uid/done must resolve through the successor chain."""
        fe, t = self._fe, self._ticket
        while t.successor is not None:
            fe, t = t.successor
        return fe, t

    async def aclose(self) -> None:
        fe, t = self._live()
        fe._cancel_ticket(t)

    @property
    def uid(self) -> Optional[int]:
        """Engine uid of the LIVE incarnation (None until its pump has
        submitted the request; changes if the request is failed over)."""
        return self._live()[1].uid

    @property
    def done(self) -> bool:
        return self._live()[1].done


class AsyncFrontend:
    """Asyncio serving layer over a continuous-batching ``ServingEngine``
    (module docstring has the full story).

    The frontend may be constructed and submitted to before ``start()``;
    streams only make progress once the pump runs.  Use as an async
    context manager, or pair ``start()`` with ``stop()``.
    """

    def __init__(self, engine: ServingEngine, max_queue_depth: int = 64,
                 breaker: Optional[CircuitBreaker] = None,
                 idle_sleep_s: float = 0.001,
                 max_step_errors: int = 8):
        if engine.mode != "continuous":
            raise ValueError(
                f"AsyncFrontend requires a continuous-mode engine (got "
                f"mode={engine.mode!r}); wave batching has no step() to "
                f"pump")
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if max_step_errors < 1:
            raise ValueError("max_step_errors must be >= 1")
        self.engine = engine
        self.max_queue_depth = max_queue_depth
        self.breaker = breaker or CircuitBreaker()
        self.idle_sleep_s = idle_sleep_s
        #: Consecutive erroring ticks after which a SOLO frontend gives
        #: the engine up for dead and fails its in-flight streams (a
        #: router-managed frontend never reaches this: the router's
        #: health tracker declares death first and takes the tickets for
        #: failover).
        self.max_step_errors = max_step_errors
        self.stats = FrontendStats()
        #: Per-tick observer (the replica router's health tap): called
        #: once per pump tick, on the event loop, with
        #: ``{"error": exc-or-None, "cost_ticks": int}`` — the step's
        #: outcome and its virtual duration (``engine.last_step_cost``
        #: when present, e.g. under fault injection; else 1).
        self.tick_observer: Optional[Callable[[dict], None]] = None
        self._last_tick_info: Optional[dict] = None
        self.last_step_error: Optional[BaseException] = None
        self._consec_step_errors = 0
        self._engine_dead = False
        self._halt = False
        self._tickets = 0
        #: ticket id -> ticket, accepted and not yet finished/cancelled —
        #: len() of this is the backpressure queue depth.
        self._inflight: Dict[int, _Ticket] = {}
        self._by_uid: Dict[int, _Ticket] = {}
        self._pending: List[_Ticket] = []   # accepted, not yet in engine
        self._cancels: List[_Ticket] = []   # cancel commands for the pump
        #: ("tok", uid, token) / ("err", ticket, exc) events produced on
        #: the pump thread, dispatched to queues on the event loop.
        self._events: List[tuple] = []
        self._wake = asyncio.Event()
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-pump")
        self._pump_task: Optional[asyncio.Task] = None
        self._running = True
        self._stopped = False

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "AsyncFrontend":
        if self._pump_task is not None:
            raise RuntimeError("frontend already started")
        if self._stopped:
            raise RuntimeError("frontend already stopped")
        self.engine.on_token = self._on_token
        self._pump_task = asyncio.create_task(self._pump())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Shut the pump down.  ``drain=True`` finishes all in-flight
        requests first; ``drain=False`` cancels them (their streams end
        where they are, their blocks are released)."""
        if self._stopped:
            return
        if not drain:
            for t in list(self._inflight.values()):
                self._cancel_ticket(t)
        self._running = False
        self._wake.set()
        if self._pump_task is not None:
            await self._pump_task
        self._executor.shutdown(wait=True)
        self.engine.on_token = None
        self._stopped = True

    async def __aenter__(self) -> "AsyncFrontend":
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.stop(drain=exc_type is None)

    # -- submission ----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests accepted and not yet finished or cancelled."""
        return len(self._inflight)

    async def submit(self, prompt, max_new_tokens: int = 32, *,
                     deadline: Optional[float] = None, priority: int = 0,
                     patch_embeds: Optional[np.ndarray] = None,
                     timeout_s: Optional[float] = None) -> TokenStream:
        """Admit one request and return its token stream.

        Raises ``RejectedError`` when the in-flight window is full
        (``kind="backpressure"``) or the circuit breaker is shedding
        (``kind="breaker"``).  Engine-side validation failures (prompt
        too long for the cache, bad patch shape, ...) surface as the
        original ``ValueError`` out of the stream's first ``__anext__``.

        ``timeout_s`` is a per-request WALL-CLOCK budget: if the request
        has not completed ``timeout_s`` seconds after this call, it is
        cancelled (blocks released) and its stream raises
        ``RejectedError(kind="timeout")``.
        """
        if self._stopped or not self._running:
            raise RuntimeError("frontend is stopped")
        if timeout_s is not None and timeout_s <= 0.0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        depth = len(self._inflight)
        if depth >= self.max_queue_depth:
            self.stats.rejected_backpressure += 1
            raise RejectedError(
                f"queue depth {depth} at max_queue_depth="
                f"{self.max_queue_depth}; retry with backoff",
                kind="backpressure")
        admit, probe = self.breaker.allow()
        if not admit:
            self.stats.shed_breaker += 1
            raise RejectedError(
                f"circuit breaker {self.breaker.state}: shedding load",
                kind="breaker")
        self._tickets += 1
        t = _Ticket(self._tickets, np.asarray(prompt, np.int32),
                    max_new_tokens,
                    self._effective_deadline(deadline, priority),
                    patch_embeds, asyncio.Queue(), probe=probe)
        if timeout_s is not None:
            t.timeout_s = timeout_s
            t.expires_at = time.monotonic() + timeout_s
        self._inflight[t.id] = t
        self._pending.append(t)
        self.stats.accepted += 1
        self._wake.set()
        return TokenStream(self, t)

    @staticmethod
    def _effective_deadline(deadline: Optional[float],
                            priority: int) -> Optional[float]:
        """Fold (deadline, priority) into the engine's single deadline
        order (module docstring): explicit deadline wins; a bare positive
        priority becomes ``-priority`` (ahead of any non-negative real
        deadline); neither stays None (best-effort, first evicted)."""
        if deadline is not None:
            return float(deadline)
        if priority > 0:
            return -float(priority)
        return None

    # -- cancellation --------------------------------------------------------
    def _cancel_ticket(self, t: _Ticket) -> None:
        if t.done or t.cancelled:
            return
        t.cancelled = True
        self._inflight.pop(t.id, None)
        self.stats.cancelled += 1
        if t.probe:
            self.breaker.abandon_probe()
        if t.on_done is not None:
            t.on_done(None)
        self._cancels.append(t)
        t.queue.put_nowait(_DONE)  # unblock a waiting consumer now
        self._wake.set()

    def _timeout_ticket(self, t: _Ticket) -> None:
        """The request outlived its wall-clock budget: cancel the engine
        side, end the stream with ``RejectedError(kind="timeout")``."""
        if t.done or t.cancelled:
            return
        t.cancelled = True
        self._inflight.pop(t.id, None)
        self.stats.timeouts += 1
        if t.probe:
            self.breaker.abandon_probe()
        if t.on_done is not None:
            t.on_done(None)
        self._cancels.append(t)
        t.queue.put_nowait(RejectedError(
            f"request exceeded its {t.timeout_s}s wall-clock timeout",
            kind="timeout"))
        self._wake.set()

    # -- failover hand-off (router-owned) ------------------------------------
    def take_inflight(self) -> List[_Ticket]:
        """Detach every in-flight ticket WITHOUT ending its stream.

        The router's failover path: the returned tickets will be
        resubmitted on a healthy replica with their queues kept open, so
        nothing here may push ``_DONE`` or an error.  Engine-side state
        (lanes, blocks) is NOT touched — the caller owns that cleanup
        (``engine.cancel`` per ticket uid)."""
        out = [t for t in self._inflight.values()
               if not t.done and not t.cancelled]
        self._inflight.clear()
        self._pending.clear()
        self._by_uid.clear()
        return out

    async def halt(self) -> None:
        """Hard-stop the pump without draining or cancelling tickets —
        a dead replica cannot drain (its ``step()`` raises forever).
        Idempotent; used by the router after ``take_inflight()``."""
        if self._stopped:
            return
        self._halt = True
        self._running = False
        self._wake.set()
        if self._pump_task is not None:
            await self._pump_task
        self._executor.shutdown(wait=True)
        self.engine.on_token = None
        self._stopped = True

    # -- pump ----------------------------------------------------------------
    def _on_token(self, uid: int, token: int) -> None:
        """Engine ``on_token`` hook — runs on the pump thread inside
        ``step()``; events are routed to queues on the event loop."""
        self._events.append(("tok", uid, token))

    def _tick(self) -> List[Tuple[int, List[int]]]:
        """ONE serialized engine interaction (pump thread): apply
        cancels, submit pending requests in arrival order, step the
        scheduler, feed the breaker."""
        eng = self.engine
        cancels, self._cancels = self._cancels, []
        for t in cancels:
            if t.uid is not None:
                eng.cancel(t.uid)
                self._by_uid.pop(t.uid, None)
        pending, self._pending = self._pending, []
        for t in pending:
            if t.cancelled:
                continue
            try:
                t.uid = eng.submit(
                    t.prompt, max_new_tokens=t.max_new_tokens,
                    deadline=t.deadline, patch_embeds=t.patch_embeds)
            except Exception as e:  # validation error -> the stream
                self._events.append(("err", t, e))
                continue
            self._by_uid[t.uid] = t
        p0 = eng.stats.preemptions
        err: Optional[BaseException] = None
        try:
            finished = eng.step() if eng.has_pending_work() else []
        except Exception as e:
            # A raising step must not kill the pump: the engine's
            # poisoned contract keeps the BlockStore consistent (or the
            # engine refuses further steps), and the health layer — not
            # an exception unwind — decides the replica's fate.
            err, finished = e, []
            self.stats.step_errors += 1
            self.last_step_error = e
            self._consec_step_errors += 1
            if self._consec_step_errors >= self.max_step_errors:
                self._engine_dead = True
        else:
            self._consec_step_errors = 0
        self.breaker.record_tick(eng.stats.preemptions - p0,
                                 eng.pool_saturation)
        self._last_tick_info = {
            "error": err,
            "cost_ticks": int(getattr(eng, "last_step_cost", 1)),
        }
        return finished

    def _dispatch(self, finished: List[Tuple[int, List[int]]]) -> None:
        """Route the tick's events to per-request queues (event loop)."""
        events, self._events = self._events, []
        for kind, a, b in events:
            if kind == "tok":
                t = self._by_uid.get(a)
                if t is not None and not t.cancelled:
                    t.emitted.append(b)
                    t.queue.put_nowait(b)
                    if t.on_first_token is not None:
                        cb, t.on_first_token = t.on_first_token, None
                        cb()
            else:  # "err"
                t = a
                if t.cancelled:
                    continue
                t.done = True
                self._inflight.pop(t.id, None)
                self.stats.errors += 1
                if t.probe:
                    self.breaker.abandon_probe()
                if t.on_done is not None:
                    t.on_done(False)
                t.queue.put_nowait(b)
        for uid, toks in finished:
            t = self._by_uid.pop(uid, None)
            if t is None or t.cancelled:
                continue
            t.done, t.result = True, list(toks)
            self._inflight.pop(t.id, None)
            self.stats.completed += 1
            if t.probe:
                self.breaker.record_probe_end(ok=True)
            if t.on_done is not None:
                t.on_done(True)
            t.queue.put_nowait(_DONE)
        if any(t.expires_at is not None for t in self._inflight.values()):
            now = time.monotonic()
            for t in [t for t in self._inflight.values()
                      if t.expires_at is not None and now >= t.expires_at]:
                self._timeout_ticket(t)
        if self._engine_dead and self.tick_observer is None \
                and self._inflight:
            # Solo frontend on a dead engine: nobody will fail these
            # requests over, so surface the failure instead of hanging.
            self._fail_all(RuntimeError(
                f"engine unresponsive: {self.max_step_errors} consecutive "
                f"step failures (last: {self.last_step_error!r})"))
        info, self._last_tick_info = self._last_tick_info, None
        if info is not None and self.tick_observer is not None:
            self.tick_observer(info)

    def _has_engine_work(self) -> bool:
        if self._engine_dead:
            # Stop ticking a dead engine (its step raises forever); the
            # pump idles so stop()/halt() can complete.
            return False
        return bool(self._pending or self._cancels
                    or self.engine.has_pending_work())

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                if self._halt:
                    break
                if not self._has_engine_work() \
                        and self.breaker.state == "closed":
                    if not self._running:
                        break
                    self._wake.clear()
                    if not self._has_engine_work():
                        await self._wake.wait()
                    continue
                if not self._running and not self._has_engine_work():
                    # Stopped while the breaker is open/half-open:
                    # nothing left to drain, the cooldown clock dies
                    # with the service.
                    break
                finished = await loop.run_in_executor(
                    self._executor, self._tick)
                self._dispatch(finished)
                if self._has_engine_work():
                    await asyncio.sleep(0)  # let submitters interleave
                else:
                    # Idle ticks only advance the breaker's cooldown;
                    # don't spin the loop hot while we wait it out.
                    await asyncio.sleep(self.idle_sleep_s)
        except BaseException as e:
            self._fail_all(e)
            raise

    def _fail_all(self, exc: BaseException) -> None:
        """Pump died: no consumer may be left awaiting a queue forever."""
        for t in list(self._inflight.values()):
            if not t.done:
                t.done = True
                t.queue.put_nowait(
                    RuntimeError(f"frontend pump failed: {exc!r}"))
        self._inflight.clear()
