"""Staged boot pipeline (port of ``repro.core.boot``): declarative,
individually timed, overlapped cold starts.

    BootPlan   = ordered list of declarative stages, each tagged with a track
    BootEngine = executes a plan; the PROGRAM track (fetch + deserialize) and
                 the WEIGHTS track (host restore + chunked device copy) run
                 CONCURRENTLY; JOIN stages (Finalize) run after both finish
    BootHandle = a cancellable in-flight boot (speculative pre-boot)

Every stage's duration lands in ``Timeline.stage_s[stage.name]`` and the
combined wall time in ``Timeline.t_boot_wall``, so wall < sum of stages is
the overlap win.

The stages ported so far are the unikernel driver's: ``FetchProgram`` (no
host program tier yet), ``DeserializeProgram``, ``RestoreWeightsHost``
(v1 snapshots), ``DevicePut`` and ``Finalize``.

``DevicePut`` is the port's counterpart of ``jax.device_put`` streaming: a
read-ahead thread copies ~32 MB chunks of the (mmap'd) host leaves into
reused pinned buffers, and the stage's thread issues ``copy_(non_blocking=
True)`` from each buffer on a side CUDA stream, so disk page-in, the pinned
copy and the DMA overlap. It waits on that stream before returning, so the
weights are resident when ``Finalize`` hands them to the executor.

Invariants: a weights-track stage never reads context fields a program-track
stage writes (and vice versa); cancellation lands at stage boundaries and
per chunk inside ``streamed_device_put`` (on both its producer and its
consumer side); a cancelled or failed boot disposes everything it
materialized.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import pytree
from repro_torch.core.executor import Executor
from repro_torch.core.metrics import Timeline, now


def spawn_future(fn: Callable[[], Any], name: str) -> Future:
    """Run ``fn`` on a daemon thread, relaying result/exception via a Future."""
    fut: Future = Future()

    def work() -> None:
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - relayed via Future
            fut.set_exception(e)

    threading.Thread(target=work, daemon=True, name=name).start()
    return fut


# Track tags: stages on different tracks may run concurrently; stages within a
# track run in declaration order; JOIN stages run after all tracks complete.
TRACK_PROGRAM = "program"
TRACK_WEIGHTS = "weights"
TRACK_JOIN = "join"


class BootCancelled(RuntimeError):
    """Raised inside a boot whose handle was cancelled before completion."""


class BootContext:
    """Mutable scratch space a plan's stages fill in as the boot progresses."""

    def __init__(self, dep, driver_name: str) -> None:
        self.dep = dep
        self.driver_name = driver_name
        self.program_payload: Optional[bytes] = None
        self.program: Optional[Callable] = None
        self.host_params: Any = None
        self.params: Any = None
        self.executor: Optional[Executor] = None
        self.cancel: Optional[threading.Event] = None   # the handle's cancel
        # request deadline (duck-typed: ``expired()`` / ``check(what)``);
        # stages and chunk loops treat expiry like a cancel
        self.deadline = None


class Stage:
    """One named, timed unit of boot work. Subclasses set ``name``/``track``."""

    name: str = "stage"
    track: str = TRACK_JOIN

    def run(self, ctx: BootContext) -> None:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} name={self.name} track={self.track}>"


# --------------------------------------------------------------------- stages


class FetchProgram(Stage):
    """Acquire the serialized program payload from the image registry."""

    name = "fetch_program"
    track = TRACK_PROGRAM

    def run(self, ctx: BootContext) -> None:
        ctx.program_payload = ctx.dep.fetch_program_payload()


class DeserializeProgram(Stage):
    """Payload bytes -> runnable program (the unikernel 'boot' proper)."""

    name = "deserialize_program"
    track = TRACK_PROGRAM

    def run(self, ctx: BootContext) -> None:
        ctx.program = ctx.dep.cache.deserialize_program(ctx.program_payload)
        ctx.program_payload = None


class RestoreWeightsHost(Stage):
    """Materialize host-side weights from the deployment's v1 snapshot (mmap)."""

    name = "restore_weights_host"
    track = TRACK_WEIGHTS

    def __init__(self, source: str = "snapshot") -> None:
        if source != "snapshot":
            raise NotImplementedError(
                f"weights source {source!r} not yet ported (generic checkpoints "
                "come with the cold_jit drivers)")

    def run(self, ctx: BootContext) -> None:
        ctx.host_params = ctx.dep.snapshots.load_host(ctx.dep.image.key)


class DevicePut(Stage):
    """Stream host leaves to the deployment's device in ~32 MB chunks."""

    name = "device_put"
    track = TRACK_WEIGHTS

    def run(self, ctx: BootContext) -> None:
        ctx.params = streamed_device_put(ctx.host_params, ctx.dep.device, cancel=ctx.cancel,
                                         deadline=ctx.deadline)
        ctx.host_params = None


class Finalize(Stage):
    """Join point: assemble the Executor from the tracks' outputs."""

    name = "finalize"
    track = TRACK_JOIN

    def run(self, ctx: BootContext) -> None:
        if ctx.executor is not None:
            return
        ctx.executor = Executor(ctx.dep.image.key, ctx.driver_name, ctx.program,
                                ctx.params, ctx.dep.device)


# ----------------------------------------------------------- streamed put


def _plan_chunks(sizes: List[int], chunk_bytes: int) -> List[List[Tuple[int, int, int]]]:
    """Cut the leaves' bytes into chunks of at most ``chunk_bytes``: each chunk
    is a list of (leaf, start, end) byte ranges. A leaf larger than a chunk
    spans several (the embedding and the stacked layer leaves do)."""
    chunks: List[List[Tuple[int, int, int]]] = [[]]
    room = chunk_bytes
    for i, n in enumerate(sizes):
        off = 0
        while off < n:
            if room == 0:
                chunks.append([])
                room = chunk_bytes
            take = min(room, n - off)
            chunks[-1].append((i, off, off + take))
            off += take
            room -= take
    return [c for c in chunks if c]


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


STAGING_BUFFERS = 2                 # pinned chunk buffers in flight


def streamed_device_put(host_tree: Any, device, chunk_bytes: int = 32 << 20,
                        cancel: Optional[threading.Event] = None, deadline=None) -> Any:
    """Chunked host -> device copy of a tree of CPU tensors.

    On a CUDA device a producer thread copies each chunk of host bytes (paging
    in mmap'd snapshot files) into one of ``STAGING_BUFFERS`` reused pinned buffers,
    ahead of the consumer, which issues ``copy_(non_blocking=True)`` from the
    buffer on a side stream and records an event the producer waits on before
    it reuses that buffer. The consumer waits for the side stream at the end.
    On the CPU it is a plain chunked copy.

    ``cancel`` and ``deadline`` are consulted per chunk on both sides: the
    producer stops paging bytes in, the consumer stops issuing copies and
    raises :class:`BootCancelled` (or the deadline's own error).
    """
    device = torch.device(device)
    leaves = pytree.leaves(host_tree)
    struct = pytree.structure(host_tree)
    out = [torch.empty(leaf.shape, dtype=leaf.dtype, device=device) for leaf in leaves]
    src = [_byte_view(leaf.contiguous()) for leaf in leaves]
    dst = [_byte_view(t) for t in out]
    chunks = _plan_chunks([s.numel() for s in src], chunk_bytes)

    def check_consumer() -> None:
        if cancel is not None and cancel.is_set():
            raise BootCancelled("cancelled mid device stream")
        if deadline is not None:
            deadline.check("device stream")

    if device.type != "cuda":
        for chunk in chunks:
            check_consumer()
            for i, a, b in chunk:
                dst[i][a:b].copy_(src[i][a:b])
        return pytree.unflatten(struct, out)

    size = max((sum(b - a for _, a, b in c) for c in chunks), default=0)
    bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
            for _ in range(STAGING_BUFFERS)]
    free: "queue.Queue" = queue.Queue()             # (buffer, event of its last copy)
    for k in range(STAGING_BUFFERS):
        free.put((k, None))
    full: "queue.Queue" = queue.Queue()             # (chunk, buffer) | None at the end
    stop = threading.Event()                        # consumer died: unwedge producer
    error: List[BaseException] = []

    def producer() -> None:
        try:
            for chunk in chunks:
                if (cancel is not None and cancel.is_set()) or \
                        (deadline is not None and deadline.expired()):
                    return                          # stop paging in
                while True:
                    try:
                        k, ev = free.get(timeout=0.1)
                        break
                    except queue.Empty:
                        if stop.is_set():
                            return
                if ev is not None:
                    ev.synchronize()                # its previous DMA is done
                o = 0
                for i, a, b in chunk:
                    bufs[k][o:o + b - a].copy_(src[i][a:b])
                    o += b - a
                full.put((chunk, k))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            error.append(e)
        finally:
            full.put(None)

    side = torch.cuda.Stream(device)
    threading.Thread(target=producer, daemon=True, name="bootengine-readahead").start()
    try:
        with torch.cuda.stream(side):
            while True:
                item = full.get()
                if item is None:
                    break
                check_consumer()
                chunk, k = item
                o = 0
                for i, a, b in chunk:
                    dst[i][a:b].copy_(bufs[k][o:o + b - a], non_blocking=True)
                    o += b - a
                ev = torch.cuda.Event()
                ev.record(side)
                free.put((k, ev))
    finally:
        stop.set()
        side.synchronize()
    if error:
        raise error[0]
    check_consumer()                                # producer may have stopped early
    return pytree.unflatten(struct, out)


# --------------------------------------------------------------------- plans


class BootPlan:
    """An ordered, declarative list of stages (the driver's whole start logic).

    Stages on the program and weights tracks run concurrently, so a weights
    stage must never read context fields a program stage writes (and vice
    versa); cross-track products meet only at the JOIN stages.
    """

    def __init__(self, stages: Sequence[Stage]) -> None:
        self.stages: Tuple[Stage, ...] = tuple(stages)
        names = [s.name for s in self.stages]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate stage names: {names}")

    def by_track(self, track: str) -> List[Stage]:
        return [s for s in self.stages if s.track == track]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "BootPlan[" + " -> ".join(s.name for s in self.stages) + "]"


class BootResult:
    def __init__(self, executor: Executor, stage_s: Dict[str, float],
                 wall_s: float, t_first_ready: float = 0.0) -> None:
        self.executor = executor
        self.stage_s = stage_s
        self.wall_s = wall_s
        self.t_first_ready = t_first_ready


class BootHandle:
    """A cancellable in-flight boot (speculative pre-boot).

    ``claim()`` blocks for the result and marks it consumed; ``cancel()`` makes
    an unclaimed boot abort at the next stage boundary or chunk and exit any
    executor it already built.
    """

    def __init__(self, dep, driver_name: str) -> None:
        self.dep = dep
        self.driver_name = driver_name
        self._cancel = threading.Event()
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._claimed = False
        self._result: Optional[BootResult] = None
        self._error: Optional[BaseException] = None
        self.last_stage: Optional[str] = None

    def _note_stage(self, name: str) -> None:
        self.last_stage = name

    def _finish(self, result: Optional[BootResult],
                error: Optional[BaseException]) -> None:
        with self._lock:
            self._result, self._error = result, error
            self._done.set()
            if result is not None and self._cancel.is_set() and not self._claimed:
                result.executor.exit()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def claim(self, timeout: float = 600.0) -> BootResult:
        """Take ownership of the boot's executor (exactly once)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"boot of {self.driver_name} did not complete within "
                f"{timeout:.1f}s (last completed stage: {self.last_stage or 'none'})")
        with self._lock:
            if self._cancel.is_set():
                raise BootCancelled("boot was cancelled before claim")
            self._claimed = True
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> None:
        """Abort an unclaimed boot; exits its executor if one was built."""
        with self._lock:
            if self._claimed:
                return
            self._cancel.set()
            result = self._result if self._done.is_set() else None
        if result is not None:
            result.executor.exit()


# -------------------------------------------------------------------- engine


class BootEngine:
    """Executes BootPlans: concurrent tracks, per-stage timing, cancellation."""

    def execute(self, plan: BootPlan, dep, tl: Timeline, driver_name: str) -> Executor:
        """Synchronous boot: run the plan, stamp ``tl``, return the executor."""
        result = self._run(plan, dep, driver_name, cancel=None,
                           deadline=getattr(tl, "deadline", None))
        tl.record_boot(result.stage_s, result.wall_s, t_first_ready=result.t_first_ready)
        return result.executor

    def launch(self, plan: BootPlan, dep, driver_name: str) -> BootHandle:
        """Speculative pre-boot: run the plan on a background thread."""
        handle = BootHandle(dep, driver_name)

        def run() -> None:
            try:
                result = self._run(plan, dep, driver_name, cancel=handle._cancel,
                                   on_stage=handle._note_stage)
            except BaseException as e:  # noqa: BLE001 - relayed via claim()
                handle._finish(None, e)
            else:
                handle._finish(result, None)

        threading.Thread(target=run, daemon=True, name="bootengine-preboot").start()
        return handle

    # ------------------------------------------------------------- internal
    def _run(self, plan: BootPlan, dep, driver_name: str,
             cancel: Optional[threading.Event], deadline=None,
             on_stage=None) -> BootResult:
        ctx = BootContext(dep, driver_name)
        ctx.cancel = cancel
        ctx.deadline = deadline
        stage_s: Dict[str, float] = {}
        timing_lock = threading.Lock()
        errors: List[BaseException] = []
        t_begin = now()

        def run_track(stages: List[Stage]) -> None:
            try:
                for stage in stages:
                    if cancel is not None and cancel.is_set():
                        raise BootCancelled(f"cancelled before {stage.name}")
                    if deadline is not None:
                        deadline.check(f"boot stage {stage.name}")
                    t0 = now()
                    stage.run(ctx)
                    with timing_lock:
                        stage_s[stage.name] = now() - t0
                    if on_stage is not None:
                        on_stage(stage.name)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        program_track = plan.by_track(TRACK_PROGRAM)
        weights_track = plan.by_track(TRACK_WEIGHTS)
        if program_track and weights_track:
            # the tentpole overlap: program deserialize || weight restore
            t = threading.Thread(target=run_track, args=(weights_track,),
                                 daemon=True, name="bootengine-weights")
            t.start()
            run_track(program_track)
            t.join()
        else:
            run_track(program_track or weights_track)

        if not errors:
            run_track(plan.by_track(TRACK_JOIN))
        if errors:
            self._dispose(ctx)
            raise errors[0]
        if ctx.executor is None:
            raise RuntimeError(f"plan built no executor: {plan}")
        return BootResult(ctx.executor, stage_s, now() - t_begin, t_first_ready=now())

    @staticmethod
    def _dispose(ctx: BootContext) -> None:
        """Drop everything a failed/cancelled boot materialized."""
        if ctx.executor is not None:
            ctx.executor.exit()
        ctx.program = ctx.params = ctx.host_params = ctx.program_payload = None


ENGINE = BootEngine()
