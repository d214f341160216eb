"""Pluggable time source: real wall clock vs event-driven virtual time.

Everything in the platform that *waits* — hedge deadlines, coalescing flush
windows, autoscaler ticks, Timeline stamps — asks a :class:`Clock` instead of
``time`` directly. In production that clock is :data:`REAL` (perf_counter +
sleep). Under the scale/chaos harness it is a :class:`VirtualClock`: a
discrete-event scheduler whose ``now()`` only moves when the next scheduled
event fires, so a run of 10^5-10^6 simulated requests over hundreds of hosts
completes in wall-clock seconds while every latency, deadline, and race
ordering stays faithful to the event timeline.

The virtual clock is single-driver: one thread (the harness) calls
``run_until_idle``/``run_for`` and every event callback executes inline on
that thread, in strict (deadline, seq) order. Scheduling and cancelling from
inside a callback is allowed and ordinary — that is how chained arrivals,
retries, and hedges are expressed.

Invariants: virtual ``now()`` is monotonically non-decreasing and equals the
deadline of the event currently firing; a cancelled event never fires; events
with equal deadlines fire in scheduling order; ``sleep`` on a virtual clock is
a programming error (callbacks must schedule continuations, never block) and
raises rather than deadlocking the simulation.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple


class Clock:
    """Time-source interface. ``virtual`` tells consumers whether waiting is
    a real blocking operation (thread + condvar) or an event to schedule."""

    virtual: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    """Production clock: monotonic perf_counter + real sleeping."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


#: The default clock every consumer falls back to when none is injected.
REAL = RealClock()


class SimEvent:
    """One scheduled callback on a :class:`VirtualClock`; cancellable."""

    __slots__ = ("deadline", "seq", "fn", "cancelled")

    def __init__(self, deadline: float, seq: int, fn: Callable[[], None]) -> None:
        self.deadline = deadline
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class VirtualClock(Clock):
    """Event-driven virtual time: ``now()`` jumps between event deadlines.

    ``schedule(delay, fn)`` registers a callback; ``run_until_idle()`` (or
    ``run_for``/``run_until``) pops events in (deadline, seq) order, advances
    ``now()`` to each deadline, and runs the callback inline. Nothing here
    spawns threads — determinism is the whole point.
    """

    virtual = True

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)
        self._heap: List[Tuple[float, int, SimEvent]] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()     # cheap safety for stray thread use
        self.events_fired = 0

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        raise RuntimeError(
            "VirtualClock.sleep: blocking inside the event loop would "
            "deadlock the simulation — schedule a continuation instead")

    # ------------------------------------------------------------- schedule
    def schedule(self, delay_s: float, fn: Callable[[], None]) -> SimEvent:
        """Run ``fn`` at ``now() + delay_s`` (>= now: negative delays clamp)."""
        with self._lock:
            deadline = self._now + max(0.0, float(delay_s))
            ev = SimEvent(deadline, next(self._seq), fn)
            heapq.heappush(self._heap, (ev.deadline, ev.seq, ev))
        return ev

    def schedule_at(self, deadline: float, fn: Callable[[], None]) -> SimEvent:
        with self._lock:
            ev = SimEvent(max(deadline, self._now), next(self._seq), fn)
            heapq.heappush(self._heap, (ev.deadline, ev.seq, ev))
        return ev

    def pending(self) -> int:
        with self._lock:
            return sum(1 for _, _, e in self._heap if not e.cancelled)

    # ------------------------------------------------------------------ run
    def _pop_due(self, horizon: Optional[float]) -> Optional[SimEvent]:
        with self._lock:
            while self._heap:
                deadline, _, ev = self._heap[0]
                if horizon is not None and deadline > horizon:
                    return None
                heapq.heappop(self._heap)
                if ev.cancelled:
                    continue
                self._now = max(self._now, deadline)
                return ev
            return None

    def run_until_idle(self, max_events: Optional[int] = None) -> int:
        """Fire events in order until none remain (or ``max_events`` fired).
        Returns the number of callbacks executed."""
        fired = 0
        while max_events is None or fired < max_events:
            ev = self._pop_due(horizon=None)
            if ev is None:
                break
            fired += 1
            self.events_fired += 1
            ev.fn()
        return fired

    def run_until(self, deadline: float) -> int:
        """Fire every event due at or before ``deadline``, then advance
        ``now()`` to ``deadline`` (even if no event was due)."""
        fired = 0
        while True:
            ev = self._pop_due(horizon=deadline)
            if ev is None:
                break
            fired += 1
            self.events_fired += 1
            ev.fn()
        with self._lock:
            self._now = max(self._now, deadline)
        return fired

    def run_for(self, duration_s: float) -> int:
        return self.run_until(self.now() + duration_s)
