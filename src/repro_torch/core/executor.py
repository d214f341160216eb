"""Executor: one function-execution environment (port of ``repro.core.executor``).

Life cycle, as in the JAX package:

    BUILDING -> (PARTIAL ->) READY -> RUNNING -> (READY | PARTIAL | PAUSED | EXITED)

A cold-only platform drives every executor straight to EXITED after one
request; a warm-pool platform parks it READY (holding device memory) or
PAUSED (host memory only).

``PARTIAL`` is the streamed-restore state: the executor is dispatchable while
its image is still arriving in the background. ``ReadinessGates`` carries one
event per parameter leaf (by snapshot path) plus a completion event; a leaf's
event is set only once its device copy has completed (the restore stream
waits on a CUDA event first), so a reader never sees a copy still in flight.
``run`` blocks only until the leaves the program is about to touch are
resident — a gate-aware program (``SplitServe``) waits on its head leaves and
runs the head, any other program waits for full completion. A streaming
failure trips every gate and surfaces as a transient RuntimeError, so the
dispatcher's retry path re-dispatches and the request settles exactly once.

Invariants: ``exit`` is idempotent and drops the program and parameter
references (the device memory goes back to PyTorch's allocator) — a fork
clone's weights belong to its donor (``shared_weights``) and count no bytes;
``nbytes`` and the residency timers are stable after exit; ``run`` treats the
parameters as read-only, which is what makes donor aliasing and the
assembled-tree memo safe; a PARTIAL executor never exposes a half-assembled
tree — ``run`` re-reads ``program``/``params`` under the lock after its gate
wait.
"""
from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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


class ReadinessGates:
    """Per-leaf readiness events for a streamed restore, plus completion.

    One ``threading.Event`` per leaf path: the restore stream sets a leaf's
    event once its tensor is device-resident, ``mark_complete`` fires once the
    whole tree (and any background program work) has landed, and ``fail``
    trips every event with a stored error so no waiter parks forever. Waiting
    on a path the gates have never heard of waits for full completion — an
    unknown leaf must block, never read garbage.

    The gates also patch boot accounting after the fact: timelines bound via
    ``bind_timeline`` receive the background stages
    (``restore_stream_tail_bg``, ``deserialize_program_bg``) when
    ``finish_timelines`` runs, whether they bound before or after it.
    """

    _WAIT_S = 600.0          # backstop so a lost stream can't park a request

    def __init__(self, paths: Iterable[str], head_paths: Sequence[str] = ()) -> None:
        self._events: Dict[str, threading.Event] = {p: threading.Event() for p in paths}
        self.head_paths: Tuple[str, ...] = tuple(head_paths)
        self._tail_program: Optional[Callable] = None
        self._tail_event = threading.Event()
        self._complete = threading.Event()
        self._failure: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._timelines: List[Any] = []
        self._finish: Optional[tuple] = None

    # -------------------------------------------------------------- producers
    def mark_ready(self, path: str) -> None:
        ev = self._events.get(path)
        if ev is not None:
            ev.set()

    def set_tail_program(self, program: Callable) -> None:
        self._tail_program = program
        self._tail_event.set()

    def mark_complete(self) -> None:
        self._complete.set()

    def fail(self, err: BaseException) -> None:
        """Trip every gate with a stored error — waiters raise, none park."""
        with self._lock:
            if self._failure is None:
                self._failure = err
        for ev in self._events.values():
            ev.set()
        self._tail_event.set()
        self._complete.set()

    # -------------------------------------------------------------- consumers
    def is_complete(self) -> bool:
        return self._complete.is_set() and self._failure is None

    def wait_complete(self, timeout: float = _WAIT_S) -> None:
        if not self._complete.wait(timeout):
            raise RuntimeError("streamed restore completion timed out")
        self._raise_if_failed()

    def wait_leaves(self, paths: Iterable[str], timeout: float = _WAIT_S) -> None:
        for p in paths:
            ev = self._events.get(p)
            if ev is None:
                # unknown leaf: only full completion proves it is on the device
                self.wait_complete(timeout)
                continue
            if not ev.wait(timeout):
                raise RuntimeError(f"streamed restore gate timed out: {p}")
        self._raise_if_failed()

    def wait_tail_program(self, timeout: float = _WAIT_S) -> Callable:
        if not self._tail_event.wait(timeout):
            raise RuntimeError("streamed restore tail program timed out")
        self._raise_if_failed()
        return self._tail_program

    def _raise_if_failed(self) -> None:
        if self._failure is not None:
            # phrased so the dispatcher's _is_transient classifies it
            # retryable: the re-dispatch boots fresh (store fallback) and the
            # request still settles exactly once
            raise RuntimeError("streamed restore failed: required chunks not found "
                               f"({self._failure!r})")

    # ------------------------------------------------------- boot accounting
    def bind_timeline(self, tl) -> None:
        """Attach a request timeline; it receives the background-stage patch
        at once if the tail already finished, or when it does."""
        with self._lock:
            fin = self._finish
            if fin is None:
                self._timelines.append(tl)
                return
        stage_s, wall_extra, bf, bd, cr, cf = fin
        tl.record_boot(stage_s, wall_extra, bytes_fetched=bf, bytes_deduped=bd,
                       chunks_rehashed=cr, chunks_refetched=cf)

    def finish_timelines(self, stage_s: Dict[str, float], wall_extra: float,
                         bytes_fetched: int = 0, bytes_deduped: int = 0,
                         chunks_rehashed: int = 0, chunks_refetched: int = 0) -> None:
        with self._lock:
            self._finish = (dict(stage_s), float(wall_extra), int(bytes_fetched),
                            int(bytes_deduped), int(chunks_rehashed), int(chunks_refetched))
            tls = list(self._timelines)
            self._timelines.clear()
        for tl in tls:
            tl.record_boot(stage_s, wall_extra, bytes_fetched=bytes_fetched,
                           bytes_deduped=bytes_deduped, chunks_rehashed=chunks_rehashed,
                           chunks_refetched=chunks_refetched)


class SplitServe:
    """Gate-aware program: the head sub-program now, the tail when it lands.

    ``head(params, tokens) -> (tok0, logits, cache)`` is prefill + the first
    response token — the moment its output is on the host side of a device
    synchronisation the response has begun (``t_ttfr``). The tail (the decode
    steps, re-deriving token 0 from the prefill logits so the output is
    bit-identical to the fused program) waits on the background program
    track. ``gate_aware`` tells ``Executor.run`` to pass the timeline through
    instead of parking on full completion.
    """

    gate_aware = True

    def __init__(self, head: Callable, gates: ReadinessGates) -> None:
        self.head = head
        self.gates = gates

    def __call__(self, params, tokens, timeline=None):
        self.gates.wait_leaves(self.gates.head_paths)
        _tok0, logits, cache = self.head(params, tokens)
        synchronize(logits.device)
        if timeline is not None and not timeline.t_ttfr:
            timeline.t_ttfr = now()
        tail = self.gates.wait_tail_program()
        return tail(params, logits, cache)


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
                 device, shared_weights: bool = False,
                 gates: Optional[ReadinessGates] = None) -> None:
        with Executor._counter_lock:
            Executor._counter += 1
            self.eid = Executor._counter
        self.image_key = image_key
        self.driver = driver
        self.program = program
        self.params = params
        self.device = torch.device(device)
        self.shared_weights = shared_weights     # fork: weights aliased from a donor
        self.gates = gates
        # params may still be streaming in (None until completion): never
        # memoize a size for a tree not held yet, or the 0 would poison the
        # per-image cache for every later executor of this image
        if shared_weights or params is None:
            self.nbytes = 0
        else:
            self.nbytes = tree_nbytes(params, cache_key=image_key)
        if gates is not None and not gates.is_complete():
            self.state = ExecutorState.PARTIAL
        else:
            self.state = ExecutorState.READY
        self.t_created = now()
        self.t_exited: Optional[float] = None
        self.busy_seconds = 0.0
        self._lock = threading.Lock()

    def _complete_restore(self, params: Any = None,
                          program: Optional[Callable] = None) -> None:
        """Background-completion handoff: swap in the fully restored tree
        and/or the fused program, then promote PARTIAL -> READY."""
        with self._lock:
            if self.state is ExecutorState.EXITED:
                return
            if params is not None:
                self.params = params
                if not self.shared_weights:
                    self.nbytes = tree_nbytes(params, cache_key=self.image_key)
            if program is not None:
                self.program = program
            if self.state is ExecutorState.PARTIAL:
                self.state = ExecutorState.READY

    _RUNNABLE = (ExecutorState.READY, ExecutorState.RUNNING, ExecutorState.PARTIAL)

    def _begin(self) -> bool:
        """Enter RUNNING; returns whether the executor was PARTIAL."""
        with self._lock:
            if self.state not in self._RUNNABLE:
                raise RuntimeError(f"executor {self.eid} not runnable: {self.state}")
            was_partial = self.state is ExecutorState.PARTIAL
            self.state = ExecutorState.RUNNING
        return was_partial

    def _wait_complete(self) -> None:
        """Park until the streamed restore completed (raising the gates'
        stored error if the stream died, back in PARTIAL)."""
        try:
            self.gates.wait_complete()
        except BaseException:
            with self._lock:
                if self.state is ExecutorState.RUNNING:
                    self.state = ExecutorState.PARTIAL
            raise

    def _end(self, t0: float) -> None:
        with self._lock:
            self.busy_seconds += now() - t0
            if self.state is ExecutorState.RUNNING:
                done = self.gates is None or self.gates.is_complete()
                self.state = ExecutorState.READY if done else ExecutorState.PARTIAL

    # ---------------------------------------------------------------- running
    def run(self, *args, timeline=None) -> Any:
        """Run the program on this executor's weights and wait for the device."""
        was_partial = self._begin()
        with self._lock:
            program = self.program
        if was_partial and self.gates is not None \
                and not getattr(program, "gate_aware", False):
            # plain program on a streaming executor: the full tree is the
            # read set, so the request parks until the restore completes
            self._wait_complete()
            with self._lock:
                program = self.program
        t0 = now()
        try:
            with torch.inference_mode():
                if getattr(program, "gate_aware", False):
                    out = program(self.params, *args, timeline=timeline)
                else:
                    out = program(self.params, *args)
            synchronize(self.device)
            if timeline is not None and not timeline.t_ttfr:
                timeline.t_ttfr = now()
        finally:
            self._end(t0)
        return out

    def run_batch(self, tokens: torch.Tensor, valid_rows: Optional[int] = None,
                  timeline=None) -> torch.Tensor:
        """Run a padded coalesced batch and drop the padding rows.

        The executor's program was exported at the batch's bucket shape; the
        caller stacked ``valid_rows`` real request rows and padded the rest.
        The padding mask is the row slice ``[:valid_rows]`` — batch rows are
        independent (attention is within-sequence), so padding rows cannot
        contaminate real ones and are simply discarded here.
        """
        out = self.run(tokens, timeline=timeline)
        if valid_rows is not None:
            out = out[:valid_rows]
        return out

    def run_decode(self, fn: Callable, *args, timeline=None) -> Any:
        """Run a decode-bundle program (admit or step) on this executor's
        weights and wait for the device.

        The continuous-batching loop owns a long-lived executor and alternates
        between the two programs of its DecodeBundle, so the program is an
        argument here instead of the executor's own serve program. Same state
        machine and busy accounting as :meth:`run`; a PARTIAL executor parks
        until the full tree landed, since both programs read every weight.
        """
        if self._begin() and self.gates is not None:
            self._wait_complete()
        t0 = now()
        try:
            with torch.inference_mode():
                out = fn(self.params, *args)
            synchronize(self.device)
            if timeline is not None and not timeline.t_ttfr:
                timeline.t_ttfr = now()
        finally:
            self._end(t0)
        return out

    # -------------------------------------------------------------- lifecycle
    def pause(self) -> Any:
        """Evict the weights to host memory; returns the host copy (the
        caller keeps it) and leaves the executor PAUSED."""
        with self._lock:
            host = pytree.tree_map(lambda t: t.to("cpu", copy=True), self.params)
            self.params = None
            self.state = ExecutorState.PAUSED
        return host

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
