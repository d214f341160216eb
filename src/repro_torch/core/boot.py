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

The stages are the JAX package's, under its names, so timelines compare:
``FetchProgram`` and ``DeserializeProgram`` through the host's program tier,
``RestoreWeightsHost`` (a delta restore through the host's chunk tier for v2
snapshots, mmap for v1, the generic checkpoint's parse + cast for the
cold_jit drivers), ``DevicePut`` and ``Finalize``; ``TraceCompile`` (a fresh
``torch.export`` trace, compiled with AOTInductor); the pool and donor stages ``AliasDonor``,
``ReuseDonor``, ``PoolCheckout``, ``FetchParked``. A stage that took a tier
path records under the name of the path (``fetch_program_cached``,
``fetch_peer``, ``restore_weights_cached``, ``restore_delta`` with
``fetch_chunks_peer`` / ``fetch_chunks_store`` carved out of it).

Streamed boots (``FetchProgramHead``, ``StreamRestore`` /
``FinalizeStream``, the ``unikernel_stream`` driver) relax the all-at-once
join: the weights track opens per-leaf readiness gates as leaves land on the
device (in the manifest's first-use order), and the JOIN stage may finalize a
PARTIAL executor whose tail — remaining leaves, the tail and fused programs
— completes on a background thread, patching the bound timelines
(``restore_stream_tail_bg``, ``deserialize_program_bg``) when it settles.

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
from repro_torch.core import blobstore
from repro_torch.core.executor import Executor, ReadinessGates, SplitServe
from repro_torch.core.metrics import Timeline, now
from repro_torch.core.scheduler import ProgramArtifact
from repro_torch.core.snapshot import _rebuild_structure, load_generic_host


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

    def __init__(self, dep, driver_name: str, bucket_rows: Optional[int] = None,
                 host=None) -> None:
        self.dep = dep
        self.driver_name = driver_name
        # token rows of a coalesced batch's bucket program (None: the deploy
        # shape); the program stages fetch, load or trace at this shape
        self.bucket_rows = bucket_rows
        # the Host this boot runs on (None for host-less boots); fetch stages
        # consult host.cache — the tiered RAM cache of
        # repro_torch.core.scheduler — before the global stores
        self.host = host
        self.program_payload: Optional[bytes] = None
        self.program: Optional[Callable] = None
        # the host program-tier entry serving this boot, if any: after
        # DeserializeProgram runs, the loaded program is parked back on it so
        # the next boot of this image on this host skips the deserialize
        self.program_entry: Any = None
        self.host_params: Any = None
        self.params: Any = None
        self.shared_weights: bool = False       # fork: weights aliased from a donor
        self.executor: Optional[Executor] = None
        # delta-restore accounting: bytes that moved for this boot vs bytes
        # already resident in the host chunk tier, and the integrity trail
        # (chunks re-hashed on read / re-fetched after a peer mismatch).
        # Written only by the weights track; read after the tracks join.
        self.bytes_fetched: int = 0
        self.bytes_deduped: int = 0
        self.chunks_rehashed: int = 0
        self.chunks_refetched: int = 0
        self.cancel: Optional[threading.Event] = None   # the handle's cancel
        # request deadline (duck-typed: ``expired()`` / ``check(what)``);
        # stages and chunk loops treat expiry like a cancel
        self.deadline = None
        # streamed-boot plumbing (set by StreamRestore / FetchProgramHead)
        self.gates: Optional[ReadinessGates] = None
        self.stream: Any = None                         # _StreamState
        self.split_program: bool = False                # head sub-program booted


class Stage:
    """One named, timed unit of boot work. Subclasses set ``name``/``track``.

    Stage instances are built fresh for every plan, so a stage whose work
    depends on the path it took (host-tier hit, peer transfer, global store)
    may rebind ``self.name`` inside ``run``; the engine records its time under
    that name. A stage may also set ``self.extra_s`` (sub-stage name ->
    seconds): the engine records those beside the stage and carves them out
    of the stage's own time, so ``stage_s`` stays a partition of real work.
    """

    name: str = "stage"
    track: str = TRACK_JOIN

    def run(self, ctx: BootContext) -> None:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} name={self.name} track={self.track}>"


# --------------------------------------------------------------------- stages


class FetchProgram(Stage):
    """Acquire the serialized program payload, cheapest source first.

    With a host tier the order is: host RAM (records as
    ``fetch_program_cached``), then a live peer's tier (``fetch_peer``), then
    the global image registry (``fetch_program``). Each miss inserts the
    payload into the host tier, so the next boot routed here hits RAM.
    """

    name = "fetch_program"
    track = TRACK_PROGRAM

    # which artifact to fetch — FetchProgramHead points these at the head
    def _key(self, ctx: BootContext) -> str:
        return ctx.dep.program_key(ctx.bucket_rows)

    def _payload(self, ctx: BootContext) -> bytes:
        return ctx.dep.fetch_program_payload(ctx.bucket_rows)

    def run(self, ctx: BootContext) -> None:
        cache = getattr(ctx.host, "cache", None)
        if cache is None:
            ctx.program_payload = self._payload(ctx)
            return
        key = self._key(ctx)
        entry = cache.get("program", key)
        if entry is not None:
            self.name = "fetch_program_cached"
        else:
            entry = cache.fetch_from_peer("program", key)
            if entry is not None:
                self.name = "fetch_peer"
            else:
                entry = ProgramArtifact(self._payload(ctx))
                cache.fetch_from_store("program", key, entry, entry.nbytes)
        if entry.loaded is not None:           # already loaded on this host
            ctx.program = entry.loaded
        else:
            ctx.program_payload = entry.payload
            ctx.program_entry = entry


class FetchProgramHead(FetchProgram):
    """Streamed-boot program fetch: the *head* sub-program when the
    deployment published a verified split, else exactly ``FetchProgram``.

    Sets ``ctx.split_program`` so FinalizeStream wraps the head in a
    ``SplitServe`` and acquires the tail and fused programs in the
    background. Any failure on the split path falls back to the fused
    program — the split is a latency optimisation, never a correctness
    dependency (the records still show which ran: ``FinalizeStream`` stamps
    ``deserialize_program_bg`` only after a head boot).
    """

    def __init__(self) -> None:
        self._split = False

    def _key(self, ctx: BootContext) -> str:
        return ctx.dep.head_program_key() if self._split else super()._key(ctx)

    def _payload(self, ctx: BootContext) -> bytes:
        return ctx.dep.fetch_head_payload() if self._split else super()._payload(ctx)

    def run(self, ctx: BootContext) -> None:
        dep = ctx.dep
        # a bucket program has no published split
        self._split = bool(getattr(dep, "split_ok", False)) \
            and ctx.bucket_rows in (None, dep.base_rows)
        if not self._split:
            super().run(ctx)
            return
        try:
            super().run(ctx)
        except Exception:  # noqa: BLE001 - fall back to the fused program
            self._split = False
            ctx.program = ctx.program_payload = ctx.program_entry = None
            super().run(ctx)
            return
        ctx.split_program = True


class DeserializeProgram(Stage):
    """Payload bytes -> runnable program (the unikernel 'boot' proper)."""

    name = "deserialize_program"
    track = TRACK_PROGRAM

    def run(self, ctx: BootContext) -> None:
        if ctx.program is not None:            # the host tier's loaded program
            return
        ctx.program = ctx.dep.cache.deserialize_program(ctx.program_payload)
        ctx.program_payload = None
        if ctx.program_entry is not None:
            # park the loaded program on the host tier entry: later boots of
            # this image on this host skip the deserialize (two boots racing
            # here both load it, and one load is wasted)
            ctx.program_entry.loaded = ctx.program
            ctx.program_entry = None


def fake_inputs(param_specs, token_shape: Tuple[int, int], device):
    """(mode, params, tokens): ``FakeTensor``s of ``device`` in a new
    ``FakeTensorMode`` for the parameter tree ``param_specs`` (shapes and
    dtypes) and int32 tokens of ``token_shape``. Nothing is allocated; run
    code on them inside ``mode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the device with its index ("cuda:0" for "cuda"), as deploy's weights
    # carry it into the graph it compiles
    device = torch.empty(0, device=device).device
    mode = FakeTensorMode()
    with mode:
        params = pytree.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), param_specs)
        tokens = torch.empty(token_shape, dtype=torch.int32, device=device)
    return mode, params, tokens


def export_on_fakes(dep, rows: Optional[int] = None) -> torch.export.ExportedProgram:
    """A new trace of ``dep``'s serve program at ``rows`` token rows (None:
    the request shape) on ``FakeTensor``s of the deployment's device: no
    weights are read or allocated."""
    _, params, tokens = fake_inputs(dep.abstract_params(), dep.abstract_tokens_for(rows),
                                    dep.device)
    fresh = type(dep.serve_fn)(dep.model, dep.spec)     # a new module: a new trace
    return torch.export.export(fresh, (params, tokens))


class TraceCompile(Stage):
    """The Docker-stack tier: re-trace and compile the serve program at boot.

    The JAX package re-traces and compiles with a fresh ``jax.jit``. The
    port re-traces a new ``ServeProgram`` with ``torch.export`` at the
    request (or bucket) shape, compiles it with AOTInductor as deploy does
    (:func:`repro_torch.core.compile_cache.compile_package`) and loads the
    package. It traces and compiles on ``FakeTensor``s of the deployment's
    device, not on ``meta`` tensors: export bakes the device of tensors
    ``forward`` allocates (the KV cache) into the graph, and fakes carry the
    real device without allocating the weights, so the compile holds no
    second copy of them.

    ``cached=False`` (``cold_jit``) compiles with every cache off;
    ``cached=True`` (``cold_jit_cached``) compiles through the compiled-package
    cache in the directory :func:`repro_torch.core.compile_cache.
    enable_inductor_disk_cache` names: a boot reads back the package of the
    same trace that deploy, or an earlier boot, compiled through it, and the
    first boot of a shape nobody compiled fills it. Boots that trace and
    compile at once take turns (:func:`repro_torch.core.compile_cache.
    build_slot`). The parts land in ``stage_s`` as ``trace``, ``compile`` and
    ``load`` beside ``trace_compile``; the turn's wait is in none of them.
    """

    name = "trace_compile"
    track = TRACK_PROGRAM

    def __init__(self, cached: bool = False) -> None:
        self.cached = cached

    def run(self, ctx: BootContext) -> None:
        from repro_torch.core.compile_cache import CompileCache, build_slot, compile_package
        with build_slot():                      # another boot's trace + compile first
            t0 = now()
            exported = export_on_fakes(ctx.dep, ctx.bucket_rows)
            t1 = now()
            package = compile_package(exported, disable_caches=not self.cached)
            del exported
            t2 = now()
        ctx.program = CompileCache.load_package(package)
        self.extra_s = {"trace": t1 - t0, "compile": t2 - t1, "load": now() - t2}


class RestoreWeightsHost(Stage):
    """Materialize host-side weights: a delta restore through the host chunk
    tier (v2 snapshots), the snapshot's mmap'd files (v1), or the generic
    checkpoint's full parse + cast (``source="generic"``, the cold_jit path).

    A fully memoized tree records as ``restore_weights_cached``; otherwise,
    with a host tier, the stage lands as ``restore_delta`` with
    ``fetch_chunks_peer`` / ``fetch_chunks_store`` sub-timings, and the
    moved/skipped bytes go to ``Timeline.bytes_fetched`` / ``bytes_deduped``.
    """

    name = "restore_weights_host"
    track = TRACK_WEIGHTS

    def __init__(self, source: str = "snapshot") -> None:
        if source not in ("snapshot", "generic"):
            raise ValueError(f"unknown weights source {source!r}")
        self.source = source

    def run(self, ctx: BootContext) -> None:
        dep = ctx.dep
        if self.source == "generic":
            ctx.host_params = load_generic_host(dep.generic_ckpt, dep.abstract_params())
            return
        key = dep.image.key
        if not (dep.snapshots.blobs is not None and dep.snapshots.is_chunked(key)):
            ctx.host_params = dep.snapshots.load_host(key)
            return
        cache = getattr(ctx.host, "cache", None)
        tree, stats = blobstore.delta_restore(dep.snapshots, key, cache)
        if stats.source == "cached":
            self.name = "restore_weights_cached"
        elif cache is not None:
            self.name = "restore_delta"
            self.extra_s = {}
            if stats.t_peer_s > 0.0:
                self.extra_s["fetch_chunks_peer"] = stats.t_peer_s
            if stats.t_store_s > 0.0:
                self.extra_s["fetch_chunks_store"] = stats.t_store_s
        ctx.bytes_fetched += stats.bytes_fetched
        ctx.bytes_deduped += stats.bytes_deduped
        ctx.chunks_rehashed += stats.chunks_rehashed
        ctx.chunks_refetched += stats.chunks_refetched
        ctx.host_params = tree


class DevicePut(Stage):
    """Stream host leaves to the deployment's device in ~32 MB chunks."""

    name = "device_put"
    track = TRACK_WEIGHTS

    def run(self, ctx: BootContext) -> None:
        ctx.params = streamed_device_put(ctx.host_params, ctx.dep.device, cancel=ctx.cancel,
                                         deadline=ctx.deadline)
        ctx.host_params = None


class AliasDonor(Stage):
    """COW-clone path: alias the donor's program + weight tensors (no copy)."""

    name = "alias_donor"
    track = TRACK_WEIGHTS

    def __init__(self, donor: Executor) -> None:
        self.donor = donor

    def run(self, ctx: BootContext) -> None:
        ctx.program = self.donor.program
        ctx.params = self.donor.params
        ctx.shared_weights = True


class ReuseDonor(Stage):
    """Dispatch onto the resident donor itself — the platform-overhead floor."""

    name = "reuse_donor"
    track = TRACK_JOIN

    def __init__(self, donor: Executor) -> None:
        self.donor = donor

    def run(self, ctx: BootContext) -> None:
        ctx.executor = self.donor


class PoolCheckout(Stage):
    """Warm-pool hit: the executor was already checked out under the pool lock."""

    name = "pool_checkout"
    track = TRACK_JOIN

    def __init__(self, ex: Executor) -> None:
        self.ex = ex

    def run(self, ctx: BootContext) -> None:
        ctx.executor = self.ex


class FetchParked(Stage):
    """Paused-container path: program + host weights parked in RAM at pause.

    Single-track on purpose: both artifacts are already in memory, so there
    is nothing to overlap — DevicePut (same track) consumes host_params next.
    """

    name = "fetch_parked"
    track = TRACK_WEIGHTS

    def __init__(self, program: Callable, host: Any) -> None:
        self.program = program
        self.host = host

    def run(self, ctx: BootContext) -> None:
        ctx.program = self.program
        ctx.host_params = self.host


class Finalize(Stage):
    """Join point: assemble the Executor from the tracks' outputs."""

    name = "finalize"
    track = TRACK_JOIN

    def run(self, ctx: BootContext) -> None:
        if ctx.executor is not None:
            return
        ctx.executor = Executor(ctx.dep.image.key, ctx.driver_name, ctx.program,
                                ctx.params, ctx.dep.device, shared_weights=ctx.shared_weights)


# ------------------------------------------------------------ streamed boot


class _StreamState:
    """Weights-stream handoff between StreamRestore and FinalizeStream."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.abort = threading.Event()         # dispose: stop a failed boot's stream
        self.error: Optional[BaseException] = None
        self.device_tree: Any = None
        self.bytes_fetched = 0
        self.bytes_deduped = 0
        self.chunks_rehashed = 0
        self.chunks_refetched = 0
        self.bytes_recorded = False            # True once ctx took the byte counts


def _leaf_to_device(leaf: torch.Tensor, device: torch.device,
                    stream: Optional["torch.cuda.Stream"]) -> torch.Tensor:
    """A copy of ``leaf`` on ``device`` whose copy has COMPLETED on return.

    On CUDA the copy runs on ``stream`` (the restore's side stream), ordered
    after the current stream's work (the allocator may hand back memory that
    work last used), and the host waits on an event recorded after it — a
    readiness gate opened after this call never exposes a copy in flight.
    """
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    if stream is None:
        return out.copy_(leaf)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out.copy_(leaf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


class StreamRestore(Stage):
    """Weights track of a streamed boot: restore + copy leaves to the device
    in first-use order on a background thread, opening a readiness gate per
    leaf once its copy has completed.

    The stage returns once the deployment's *head* leaves are resident (the
    head sub-program's read set — every leaf for the real split, a subset for
    synthetic programs); the remaining leaves keep streaming on the
    ``bootengine-stream`` thread and FinalizeStream's completion thread
    accounts them as ``restore_stream_tail_bg``. Both formats: v2 chunked
    snapshots through :func:`repro_torch.core.blobstore.stream_restore`
    (tier -> peer batch -> store), v1 snapshots through
    ``SnapshotStore.iter_restore``.
    """

    name = "restore_stream_head"
    track = TRACK_WEIGHTS

    def run(self, ctx: BootContext) -> None:
        dep = ctx.dep
        key = dep.image.key
        index = dep.snapshots.read_index(key)
        entries = index["leaves"]
        paths = [e["path"] for e in entries]
        path_set = set(paths)
        head = [p for p in getattr(dep, "head_leaves", ()) if p in path_set] or list(paths)
        gates = ReadinessGates(paths, head)
        ctx.gates = gates
        state = _StreamState()
        ctx.stream = state
        cancel, deadline = ctx.cancel, ctx.deadline
        chunked = dep.snapshots.blobs is not None and dep.snapshots.is_chunked(key)
        cache = getattr(ctx.host, "cache", None)
        device = torch.device(dep.device)
        side = torch.cuda.Stream(device) if device.type == "cuda" else None
        device_leaves: List[Any] = [None] * len(entries)

        def should_abort() -> bool:
            return state.abort.is_set() or (cancel is not None and cancel.is_set()) or \
                (deadline is not None and deadline.expired())

        def on_leaf(i: int, path: str, leaf) -> None:
            device_leaves[i] = _leaf_to_device(leaf, device, side)
            gates.mark_ready(path)

        def worker() -> None:
            try:
                if chunked:
                    _tree, stats = blobstore.stream_restore(dep.snapshots, key, cache,
                                                            on_leaf=on_leaf,
                                                            should_abort=should_abort)
                    state.bytes_fetched = stats.bytes_fetched
                    state.bytes_deduped = stats.bytes_deduped
                    state.chunks_rehashed = stats.chunks_rehashed
                    state.chunks_refetched = stats.chunks_refetched
                else:
                    for i, path, leaf in dep.snapshots.iter_restore(key):
                        if should_abort():
                            raise blobstore.RestoreAborted(key)
                        on_leaf(i, path, leaf)
                state.device_tree = _rebuild_structure(index["treedef"], device_leaves)
            except BaseException as e:  # noqa: BLE001 - relayed via the gates
                state.error = e
                gates.fail(e)
            finally:
                state.done.set()

        threading.Thread(target=worker, daemon=True, name="bootengine-stream").start()

        if len(head) == len(paths):
            # the head needs every leaf (the real split): nothing to overlap
            # with execution on the weights side — wait it out here so the
            # stage time is the critical path
            state.done.wait()
        else:
            try:
                gates.wait_leaves(head)
            except Exception:  # noqa: BLE001 - surface the stream's own error below
                state.done.wait()
        if state.error is not None:
            if isinstance(state.error, (blobstore.RestoreAborted, BootCancelled)):
                if deadline is not None and deadline.expired():
                    from repro_torch.core.resilience import DeadlineExceeded
                    raise DeadlineExceeded(f"stream deadline passed: {key}")
                raise BootCancelled(f"stream cancelled: {key}")
            raise state.error
        if state.done.is_set():
            ctx.bytes_fetched += state.bytes_fetched
            ctx.bytes_deduped += state.bytes_deduped
            ctx.chunks_rehashed += state.chunks_rehashed
            ctx.chunks_refetched += state.chunks_refetched
            state.bytes_recorded = True


def _acquire_program(cache, key: str, payload_fn: Callable[[], bytes]) -> Callable:
    """Load a program through the host program tier when one is attached (a
    tier hit may already be loaded; a miss parks the loaded program back on
    the tier entry for the next boot), else deserialize the payload."""
    from repro_torch.core.compile_cache import CompileCache
    if cache is not None:
        entry = cache.get("program", key)
        if entry is None:
            entry = cache.fetch_from_peer("program", key)
        if entry is None:
            entry = ProgramArtifact(payload_fn())
            cache.fetch_from_store("program", key, entry, entry.nbytes)
        if entry.loaded is None:
            entry.loaded = CompileCache.deserialize_program(entry.payload)
        return entry.loaded
    return CompileCache.deserialize_program(payload_fn())


class FinalizeStream(Stage):
    """Readiness-gated join: finalize a (possibly PARTIAL) streamed executor.

    If the stream already delivered everything and the program track booted
    the fused program, this is plain Finalize. Otherwise the executor starts
    PARTIAL behind its gates and a ``bootengine-stream-complete`` thread
    finishes the boot: wait out the weight tail, acquire the tail
    sub-program (opening the SplitServe's tail gate) and the fused program
    (so a fully restored executor runs the fused program — split serving is
    only the cold-start bridge), swap them in via ``_complete_restore``, and
    patch every bound timeline with the background stages and the extended
    wall.
    """

    name = "finalize"
    track = TRACK_JOIN

    def run(self, ctx: BootContext) -> None:
        if ctx.executor is not None:
            return
        dep = ctx.dep
        gates, state = ctx.gates, ctx.stream
        if gates is None or state is None:
            raise RuntimeError("FinalizeStream requires StreamRestore in the plan")
        device = dep.device
        weights_done = state.done.is_set() and state.error is None
        params = state.device_tree if weights_done else None
        split = ctx.split_program
        program: Callable = SplitServe(ctx.program, gates) if split else ctx.program
        if weights_done and not split:
            gates.mark_complete()              # nothing left: READY at once
            ctx.executor = Executor(dep.image.key, ctx.driver_name, program, params,
                                    device, gates=gates)
            return
        ex = Executor(dep.image.key, ctx.driver_name, program, params, device, gates=gates)
        ctx.executor = ex
        host_cache = getattr(ctx.host, "cache", None)

        def complete() -> None:
            t0 = now()
            try:
                state.done.wait()
                if state.error is not None:
                    raise state.error
                stage_extra: Dict[str, float] = {}
                if not weights_done:
                    stage_extra["restore_stream_tail_bg"] = now() - t0
                new_params = None if weights_done else state.device_tree
                fused = None
                if split:
                    t1 = now()
                    tail = _acquire_program(
                        host_cache, dep.tail_program_key(),
                        lambda: dep.cache.read_program_bytes(dep.tail_program_key()))
                    gates.set_tail_program(tail)
                    # "fully restored" means the fused program is resident
                    fused = _acquire_program(host_cache, dep.program_key(),
                                             dep.fetch_program_payload)
                    stage_extra["deserialize_program_bg"] = now() - t1
                ex._complete_restore(params=new_params, program=fused)
                gates.mark_complete()
                bf = bd = cr = cf = 0
                if not state.bytes_recorded:
                    bf, bd = state.bytes_fetched, state.bytes_deduped
                    cr, cf = state.chunks_rehashed, state.chunks_refetched
                    state.bytes_recorded = True
                gates.finish_timelines(stage_extra, now() - t0, bytes_fetched=bf,
                                       bytes_deduped=bd, chunks_rehashed=cr,
                                       chunks_refetched=cf)
            except BaseException as e:  # noqa: BLE001 - relayed via the gates
                gates.fail(e)

        threading.Thread(target=complete, daemon=True,
                         name="bootengine-stream-complete").start()


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
                 wall_s: float, bytes_fetched: int = 0,
                 bytes_deduped: int = 0, t_first_ready: float = 0.0,
                 chunks_rehashed: int = 0, chunks_refetched: int = 0) -> None:
        self.executor = executor
        self.stage_s = stage_s
        self.wall_s = wall_s
        self.bytes_fetched = bytes_fetched
        self.bytes_deduped = bytes_deduped
        self.chunks_rehashed = chunks_rehashed
        self.chunks_refetched = chunks_refetched
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

    def execute(self, plan: BootPlan, dep, tl: Timeline, driver_name: str,
                bucket_rows: Optional[int] = None, host=None) -> Executor:
        """Synchronous boot: run the plan, stamp ``tl``, return the executor."""
        result = self._run(plan, dep, driver_name, cancel=None,
                           bucket_rows=bucket_rows, host=host,
                           deadline=getattr(tl, "deadline", None))
        tl.record_boot(result.stage_s, result.wall_s,
                       bytes_fetched=result.bytes_fetched,
                       bytes_deduped=result.bytes_deduped,
                       t_first_ready=result.t_first_ready,
                       chunks_rehashed=result.chunks_rehashed,
                       chunks_refetched=result.chunks_refetched)
        return result.executor

    def launch(self, plan: BootPlan, dep, driver_name: str,
               bucket_rows: Optional[int] = None, host=None) -> BootHandle:
        """Speculative pre-boot: run the plan on a background thread."""
        handle = BootHandle(dep, driver_name)

        def run() -> None:
            try:
                result = self._run(plan, dep, driver_name, cancel=handle._cancel,
                                   bucket_rows=bucket_rows, host=host,
                                   on_stage=handle._note_stage)
            except BaseException as e:  # noqa: BLE001 - relayed via claim()
                handle._finish(None, e)
            else:
                handle._finish(result, None)

        threading.Thread(target=run, daemon=True, name="bootengine-preboot").start()
        return handle

    # ------------------------------------------------------------- internal
    def _run(self, plan: BootPlan, dep, driver_name: str,
             cancel: Optional[threading.Event], bucket_rows: Optional[int] = None,
             host=None, deadline=None, on_stage=None) -> BootResult:
        ctx = BootContext(dep, driver_name, bucket_rows=bucket_rows, host=host)
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
                    dt = now() - t0
                    # sub-stage splits, read from this stage's instance on
                    # this track's thread, are carved out of its own time
                    extras = getattr(stage, "extra_s", None)
                    with timing_lock:
                        if extras:
                            stage_s.update(extras)
                            dt = max(0.0, dt - sum(extras.values()))
                        stage_s[stage.name] = dt
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
        return BootResult(ctx.executor, stage_s, now() - t_begin,
                          bytes_fetched=ctx.bytes_fetched,
                          bytes_deduped=ctx.bytes_deduped,
                          t_first_ready=now(),
                          chunks_rehashed=ctx.chunks_rehashed,
                          chunks_refetched=ctx.chunks_refetched)

    @staticmethod
    def _dispose(ctx: BootContext) -> None:
        """Drop everything a failed/cancelled boot materialized (never a
        donor's executor or weights)."""
        if ctx.stream is not None:
            ctx.stream.abort.set()             # stop an in-flight weight stream
        if ctx.executor is not None and not ctx.shared_weights \
                and ctx.executor.driver not in ("process", "fork-donor"):
            ctx.executor.exit()
        ctx.program = ctx.params = ctx.host_params = ctx.program_payload = None


ENGINE = BootEngine()
