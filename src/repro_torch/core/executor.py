"""Executor: one function-execution environment (port of ``repro.core.executor``).

Life cycle, as in the JAX package:

    BUILDING -> READY -> RUNNING -> (READY | EXITED)

A cold-only platform drives every executor straight to EXITED after one
request. The streamed-restore states and helpers (``PARTIAL``,
``ReadinessGates``, ``SplitServe``) come with the streaming slice.

Invariants: ``exit`` is idempotent and drops the program and parameter
references (the device memory goes back to PyTorch's allocator);
``nbytes`` and the residency timers are stable after exit; ``run`` treats
the parameters as read-only. Donor-shared weights come with the fork and
process drivers.
"""
from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch import pytree
from repro_torch.core.metrics import now


class ExecutorState(enum.Enum):
    BUILDING = "building"
    PARTIAL = "partial"
    READY = "ready"
    RUNNING = "running"
    PAUSED = "paused"
    EXITED = "exited"


# Every executor of one image carries an identical parameter tree, and a
# cold-only platform creates an Executor per request: memoize its size.
_NBYTES_CACHE: dict = {}
_NBYTES_LOCK = threading.Lock()


def tree_nbytes(tree, cache_key: Optional[str] = None) -> int:
    if cache_key is not None:
        with _NBYTES_LOCK:
            cached = _NBYTES_CACHE.get(cache_key)
        if cached is not None:
            return cached
    total = int(sum(t.numel() * t.element_size() for t in pytree.leaves(tree)))
    if cache_key is not None:
        with _NBYTES_LOCK:
            _NBYTES_CACHE[cache_key] = total
    return total


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """A program + materialized weights, runnable for exactly one request shape."""

    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(self, image_key: str, driver: str, program: Callable, params: Any,
                 device) -> None:
        with Executor._counter_lock:
            Executor._counter += 1
            self.eid = Executor._counter
        self.image_key = image_key
        self.driver = driver
        self.program = program
        self.params = params
        self.device = torch.device(device)
        self.nbytes = tree_nbytes(params, cache_key=image_key)
        self.state = ExecutorState.READY
        self.t_created = now()
        self.t_exited: Optional[float] = None
        self.busy_seconds = 0.0
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- running
    def run(self, *args, timeline=None) -> Any:
        """Run the program on this executor's weights and wait for the device."""
        with self._lock:
            if self.state not in (ExecutorState.READY, ExecutorState.RUNNING):
                raise RuntimeError(f"executor {self.eid} not runnable: {self.state}")
            self.state = ExecutorState.RUNNING
            program = self.program
        t0 = now()
        try:
            with torch.inference_mode():
                out = program(self.params, *args)
            synchronize(self.device)
            if timeline is not None and not timeline.t_ttfr:
                timeline.t_ttfr = now()
        finally:
            with self._lock:
                self.busy_seconds += now() - t0
                if self.state is ExecutorState.RUNNING:
                    self.state = ExecutorState.READY
        return out

    def run_decode(self, fn: Callable, *args, timeline=None) -> Any:
        """Run a decode-bundle program (admit or step) on this executor's
        weights and wait for the device.

        The continuous-batching loop owns a long-lived executor and alternates
        between the two programs of its DecodeBundle, so the program is an
        argument here instead of the executor's own serve program. Same state
        machine and busy accounting as :meth:`run`.
        """
        with self._lock:
            if self.state not in (ExecutorState.READY, ExecutorState.RUNNING):
                raise RuntimeError(f"executor {self.eid} not runnable: {self.state}")
            self.state = ExecutorState.RUNNING
        t0 = now()
        try:
            with torch.inference_mode():
                out = fn(self.params, *args)
            synchronize(self.device)
            if timeline is not None and not timeline.t_ttfr:
                timeline.t_ttfr = now()
        finally:
            with self._lock:
                self.busy_seconds += now() - t0
                if self.state is ExecutorState.RUNNING:
                    self.state = ExecutorState.READY
        return out

    # -------------------------------------------------------------- lifecycle
    def exit(self) -> None:
        """Drop all references — the unikernel's immediate exit."""
        with self._lock:
            self.params = None
            self.program = None
            self.state = ExecutorState.EXITED
            self.t_exited = now()

    # ---------------------------------------------------------------- queries
    @property
    def resident_seconds(self) -> float:
        end = self.t_exited if self.t_exited is not None else now()
        return end - self.t_created
