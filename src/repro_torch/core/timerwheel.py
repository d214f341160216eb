"""One shared deadline thread replacing thread-per-deadline watchers.

Both the dispatcher's hedge deadlines and the coalescer's flush windows need
"run this callback at time T unless cancelled first". The naive spelling —
one parked thread per deadline — means 10k in-flight requests hold 10k
threads doing nothing but waiting. ``DeadlineTimer`` keeps a single daemon
thread over a heap of deadlines instead: schedule/cancel are O(log n) under
one lock, and cancelled entries are simply skipped when they surface.

The timer is clock-pluggable (:mod:`repro_torch.core.simclock`): with the default
real clock it runs the worker thread described above; with a
:class:`~repro_torch.core.simclock.VirtualClock` there is no thread at all — each
entry becomes an event on the virtual clock's heap and fires inline on the
simulation driver thread, which is what lets the scale harness push 10^5+
hedge/flush deadlines through in wall-clock seconds.

Invariants: a cancelled entry never fires; an uncancelled entry fires exactly
once, never before its deadline; callbacks run ON the timer thread (or the
virtual clock's driver thread), so they must hand real work elsewhere rather
than block (a slow callback delays every later deadline); after ``close()``
returns, no entry fires — close joins the worker thread (bounded wait), so a
callback popped concurrently with close cannot run after close returns.
"""
from __future__ import annotations

import heapq
import itertools
import logging
import threading
from typing import Callable, List, Optional, Tuple

from repro_torch.core import metrics
from repro_torch.core.simclock import Clock

log = logging.getLogger(__name__)


class TimerEntry:
    """A scheduled callback; ``cancel()`` makes the timer skip it."""

    __slots__ = ("deadline", "seq", "fn", "cancelled", "_event")

    def __init__(self, deadline: float, seq: int, fn: Callable[[], None]) -> None:
        self.deadline = deadline
        self.seq = seq
        self.fn = fn
        self.cancelled = False
        self._event = None            # VirtualClock SimEvent, in virtual mode

    def cancel(self) -> None:
        # flag only: the entry stays in the heap until its deadline surfaces,
        # which is fine — deadlines are short and the tuple is tiny
        self.cancelled = True
        if self._event is not None:
            self._event.cancel()


class DeadlineTimer:
    def __init__(self, name: str = "deadline-timer",
                 clock: Optional[Clock] = None) -> None:
        self.name = name
        self._clock = clock if clock is not None else metrics.get_clock()
        self._heap: List[Tuple[float, int, TimerEntry]] = []
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._virtual_live: set = set()      # uncancelled unfired entries

    def schedule(self, delay_s: float, fn: Callable[[], None]) -> TimerEntry:
        """Run ``fn`` on the timer thread after ``delay_s`` unless cancelled.

        Callbacks must be quick (enqueue work elsewhere) — they share the one
        thread with every other deadline. After ``close()`` the returned entry
        is already cancelled and will never fire.
        """
        entry = TimerEntry(self._clock.now() + delay_s, next(self._seq), fn)
        if self._clock.virtual:
            return self._schedule_virtual(entry, delay_s)
        with self._cond:
            if self._closed:
                entry.cancelled = True
                return entry
            heapq.heappush(self._heap, (entry.deadline, entry.seq, entry))
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name=self.name)
                self._thread.start()
            self._cond.notify()
        return entry

    def close(self) -> None:
        """Stop the timer; pending entries are dropped (shutdown path).

        Joins the worker thread (bounded) so no callback runs after close
        returns — a callback already popped when close is called finishes
        first. A callback closing its own timer skips the self-join.
        """
        with self._cond:
            self._closed = True
            for _, _, entry in self._heap:
                entry.cancelled = True
            self._heap.clear()
            for entry in list(self._virtual_live):
                entry.cancel()
            self._virtual_live.clear()
            self._cond.notify()
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def pending(self) -> int:
        with self._cond:
            live = sum(1 for _, _, e in self._heap if not e.cancelled)
            live += sum(1 for e in self._virtual_live if not e.cancelled)
            return live

    # ------------------------------------------------------------- internal
    def _schedule_virtual(self, entry: TimerEntry, delay_s: float) -> TimerEntry:
        with self._cond:
            if self._closed:
                entry.cancelled = True
                return entry
            self._virtual_live.add(entry)

        def fire() -> None:
            with self._cond:
                self._virtual_live.discard(entry)
                if self._closed or entry.cancelled:
                    return
            try:
                entry.fn()
            except Exception:    # a bad callback must not kill the event loop
                log.exception("timer %s: callback %r raised; continuing",
                              self.name, entry.fn)

        entry._event = self._clock.schedule(delay_s, fire)
        return entry

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._closed:
                        return
                    if not self._heap:
                        self._cond.wait()
                        continue
                    delay = self._heap[0][0] - self._clock.now()
                    if delay <= 0:
                        _, _, entry = heapq.heappop(self._heap)
                        break
                    self._cond.wait(delay)
            if entry.cancelled:
                continue
            try:
                entry.fn()
            except Exception:   # a bad callback must not kill the shared thread
                log.exception("timer %s: callback %r raised; continuing",
                              self.name, entry.fn)
