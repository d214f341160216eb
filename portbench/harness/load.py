"""Offer a traffic schedule to the system and stamp each request on the
host's clock: when it was due, when it was sent, when its answer came."""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np

GRACE_S = 60.0          # how long past the window's close an answer is waited for


@dataclasses.dataclass
class Request:
    i: int                          # index: its prompt is drawn from (seed, i)
    due: float                      # perf_counter seconds
    sent: float = 0.0
    done: Optional[float] = None    # answered (tokens or an error)
    tokens: Optional[np.ndarray] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.tokens is not None

    def latency(self, give_up: float) -> float:
        """Seconds from due to answer; a request that failed or never came
        is held to have taken until ``give_up``."""
        return (self.done if self.ok else give_up) - self.due


def _watch(req: Request, fut: Future, event: Optional[threading.Event] = None) -> None:
    def settle(f: Future) -> None:
        t = time.perf_counter()
        try:
            req.tokens = np.asarray(f.result())
        except BaseException as e:  # noqa: BLE001 - a failed request is a result
            req.error = f"{type(e).__name__}: {e}"
        req.done = t
        if event is not None:
            event.set()
    fut.add_done_callback(settle)


def open_loop(submit: Callable[[int], Future], offsets: List[float], t0: float) -> List[Request]:
    """Send request ``i`` at ``t0 + offsets[i]``, whether or not earlier ones
    have been answered. Returns with every request sent."""
    reqs = []
    for i, off in enumerate(offsets):
        req = Request(i, t0 + off)
        while True:
            wait = req.due - time.perf_counter()
            if wait <= 0:
                break
            time.sleep(min(wait, 0.05) if wait > 0.002 else 0)
        req.sent = time.perf_counter()
        _watch(req, submit(i))
        reqs.append(req)
    return reqs


def closed_loop(submit: Callable[[int], Future], callers: int, t0: float,
                seconds: float) -> List[Request]:
    """``callers`` threads, each sending its next request as soon as its last
    one is answered, until the window closes. Returns at the close, with
    every caller stopped; answers still due are waited for by ``drain``."""
    reqs: List[Request] = []
    lock = threading.Lock()
    end = t0 + seconds

    def caller() -> None:
        while time.perf_counter() < end:
            with lock:
                req = Request(len(reqs), time.perf_counter())
                reqs.append(req)
            req.sent = req.due
            answered = threading.Event()
            _watch(req, submit(req.i), answered)
            answered.wait(max(0.0, end - time.perf_counter()))

    while time.perf_counter() < t0:
        time.sleep(0.001)
    threads = [threading.Thread(target=caller, name=f"caller{k}") for k in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return reqs


def drain(reqs: List[Request], deadline: float) -> None:
    """Wait until every request is answered or ``deadline`` passes."""
    while time.perf_counter() < deadline and any(r.done is None for r in reqs):
        time.sleep(0.005)


def run(schedule: dict, submit: Callable[[int], Future], t0: float,
        seconds: float) -> List[Request]:
    if "open" in schedule:
        return open_loop(submit, schedule["open"], t0)
    return closed_loop(submit, schedule["closed"], t0, seconds)


def percentile_ms(values_s: List[float], q: float) -> Optional[float]:
    if not values_s:
        return None
    return float(np.percentile(np.asarray(values_s, dtype=np.float64), q) * 1e3)

