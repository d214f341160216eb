"""Executor instantiation strategies — the paper's runtime taxonomy (port of
``repro.core.drivers``).

Ordered fastest -> slowest start, with their Sec II/III analogues:

| driver            | paper analogue                  | start path                          |
|-------------------|---------------------------------|-------------------------------------|
| process           | bare process (`/bin/date`)      | reuse the resident donor executor   |
| fork              | fork()/clone(), solo5-spt       | alias donor weights (COW) + program |
| unikernel         | IncludeOS-hvt  (the paper's bet)| deserialize || snapshot -> device   |
| unikernel_stream  | unikernel + lazy restore        | head program || first-use stream    |
| paused            | Fn paused containers/Firecracker| cached program + host RAM -> device |
| warm              | warm Lambda / warm Fn-Docker    | pool checkout (no work, holds HBM)  |
| cold_jit_cached   | gVisor/runc                     | re-trace + compile-cache hit + ckpt |
| cold_jit          | full Docker stack               | re-trace + full compile + ckpt      |

Every driver is a declaration: ``plan(dep)`` returns a BootPlan over the
shared stage vocabulary in :mod:`repro_torch.core.boot`, and the shared
``start`` hands it to the BootEngine, which times every stage into
``Timeline.stage_s`` and overlaps the program and weights tracks.

The port's ``TraceCompile`` re-traces with ``torch.export`` and compiles
with AOTInductor: ``cold_jit`` with every compile cache off, so each boot
pays the whole compile; ``cold_jit_cached`` through the compiled-package
cache, so a boot reads back the package deploy (or an earlier boot of its
shape) compiled through that cache.

Invariants: a driver instance belongs to one Host's table (``host``), so its
boots consult that host's tiered artifact cache; only READY executors
re-enter the warm pool (a crashed one would poison every later checkout);
donors are shared, never exited by a request path, and evicted exactly once
at shutdown so their residency is accounted; ``supports_preboot`` /
``supports_batch`` gate speculation and coalescing to drivers whose plans are
pure at declaration time.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch import pytree
from repro_torch.core.boot import (
    ENGINE, AliasDonor, BootEngine, BootPlan, DevicePut, DeserializeProgram, FetchParked,
    FetchProgram, FetchProgramHead, Finalize, FinalizeStream, PoolCheckout,
    RestoreWeightsHost, ReuseDonor, StreamRestore, TraceCompile,
)
from repro_torch.core.deploy import Deployment
from repro_torch.core.executor import Executor, ExecutorState
from repro_torch.core.metrics import Timeline


class Driver:
    name: str = "base"
    engine: BootEngine = ENGINE
    # the Host whose driver table this instance lives in (set by make_drivers);
    # boot stages use it to consult the host's tiered artifact cache before the
    # global stores. None for standalone driver instances (no cache tier).
    host = None
    # drivers whose boots are pure (no pool/donor state mutated before the
    # executor is claimed) may be started speculatively by the dispatcher
    supports_preboot: bool = False
    # drivers whose boot can target a coalesced batch shape; pool/donor
    # drivers hold executors compiled for the base shape, so they stay unbatched
    supports_batch: bool = False
    # batch-capable drivers that boot from a serialized image need the bucket
    # program built into the registry first; re-tracing drivers trace the
    # bucket shape themselves
    needs_bucket_image: bool = False

    def plan(self, dep: Deployment) -> BootPlan:
        """Declare this driver's start path as a BootPlan."""
        raise NotImplementedError

    def start(self, dep: Deployment, tl: Timeline,
              bucket_rows: Optional[int] = None) -> Executor:
        """The one start body shared by every driver: execute the declaration
        (at a coalesced batch's bucket shape when ``bucket_rows`` is given)."""
        return self.engine.execute(self.plan(dep), dep, tl, driver_name=self.name,
                                   bucket_rows=bucket_rows, host=self.host)

    def finish(self, dep: Deployment, ex: Executor) -> None:
        """Post-request lifecycle. Cold drivers exit; pool drivers return."""
        ex.exit()


class UnikernelDriver(Driver):
    """Per-request cold start from a single-purpose image: program
    deserialize and snapshot restore run CONCURRENTLY."""

    name = "unikernel"
    supports_preboot = True
    supports_batch = True
    needs_bucket_image = True

    def plan(self, dep: Deployment) -> BootPlan:
        return BootPlan([
            FetchProgram(), DeserializeProgram(),            # program track
            RestoreWeightsHost("snapshot"), DevicePut(),     # weights track
            Finalize(),
        ])


class UnikernelStreamDriver(Driver):
    """Streamed cold start: serve the first request before the full restore.

    The program track boots the *head* sub-program (prefill + first token)
    when the deployment published a verified split; the weights track streams
    leaves to the device in first-use order behind per-leaf readiness gates
    (``StreamRestore``), and ``FinalizeStream`` hands back a PARTIAL executor
    whose tail — remaining leaves, the tail and fused programs — completes in
    the background while the request already runs. TTFR stops scaling with
    the image's size; ``t_boot_wall`` keeps the full-restore accounting.

    Unbatched on purpose: bucket programs have no published split.
    """

    name = "unikernel_stream"
    supports_preboot = True
    supports_batch = False

    def plan(self, dep: Deployment) -> BootPlan:
        return BootPlan([
            FetchProgramHead(), DeserializeProgram(),        # program track
            StreamRestore(),                                 # weights track
            FinalizeStream(),
        ])


class ForkDriver(Driver):
    """COW clone of a donor: share its immutable weight tensors and loaded program."""

    name = "fork"

    def __init__(self, on_exit=None) -> None:
        self.on_exit = on_exit
        self._donors: Dict[str, Executor] = {}
        self._lock = threading.Lock()

    def ensure_donor(self, dep: Deployment) -> Executor:
        with self._lock:
            donor = self._donors.get(dep.image.key)
            if donor is None or donor.params is None:
                donor = self.engine.execute(UnikernelDriver().plan(dep), dep, Timeline(),
                                            driver_name="fork-donor", host=self.host)
                self._donors[dep.image.key] = donor
            return donor

    def plan(self, dep: Deployment) -> BootPlan:
        return BootPlan([AliasDonor(self.ensure_donor(dep)), Finalize()])

    def donor_nbytes(self) -> int:
        with self._lock:
            return sum(d.nbytes for d in self._donors.values() if d.params is not None)

    def evict_donors(self) -> list:
        """Exit all donors (gateway shutdown) so their device residency is
        accounted via ``on_exit`` instead of silently vanishing."""
        with self._lock:
            donors = [d for d in self._donors.values() if d.params is not None]
            self._donors.clear()
        for d in donors:
            d.exit()
            if self.on_exit is not None:
                self.on_exit(d)
        return donors


class ProcessDriver(ForkDriver):
    """Dispatch onto the resident donor itself — the pure platform-overhead floor."""

    name = "process"

    def plan(self, dep: Deployment) -> BootPlan:
        return BootPlan([ReuseDonor(self.ensure_donor(dep))])

    def finish(self, dep: Deployment, ex: Executor) -> None:
        pass  # the donor stays resident


class PausedDriver(Driver):
    """Fn's paused containers: program loaded, weights parked in host RAM.

    Not pre-bootable: ``plan()`` on a cold park runs the whole host-side
    parking (program load + a full read of the weights) on the caller's
    thread, and the boot itself is just the device copy — speculation has
    nothing to overlap.
    """

    name = "paused"

    def __init__(self) -> None:
        self._parked: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def ensure_parked(self, dep: Deployment) -> tuple:
        with self._lock:
            entry = self._parked.get(dep.image.key)
            if entry is None:
                program = dep.load_program()
                # read into RAM now (a v1 snapshot is mmap'd): parked weights
                # are resident host memory, not pages still on disk
                host = pytree.tree_map(lambda t: t.contiguous().clone(),
                                       dep.snapshots.load_host(dep.image.key))
                entry = (program, host)
                self._parked[dep.image.key] = entry
            return entry

    def plan(self, dep: Deployment) -> BootPlan:
        program, host = self.ensure_parked(dep)
        return BootPlan([FetchParked(program, host), DevicePut(), Finalize()])


class WarmDriver(Driver):
    """The incumbent: a pool of fully resident executors (falls back cold on a miss)."""

    name = "warm"

    def __init__(self, fallback: Optional[Driver] = None, on_exit=None) -> None:
        self.fallback = fallback or UnikernelDriver()
        self.on_exit = on_exit
        self._pools: Dict[str, list] = {}
        self._lock = threading.Lock()

    def prewarm(self, dep: Deployment, n: int) -> None:
        for _ in range(n):
            ex = self.engine.execute(self.fallback.plan(dep), dep, Timeline(),
                                     driver_name=self.name, host=self.host)
            with self._lock:
                self._pools.setdefault(dep.image.key, []).append(ex)

    def _checkout(self, key: str) -> Optional[Executor]:
        with self._lock:
            pool = self._pools.setdefault(key, [])
            return pool.pop() if pool else None

    def plan(self, dep: Deployment) -> BootPlan:
        ex = self._checkout(dep.image.key)
        if ex is not None:
            return BootPlan([PoolCheckout(ex)])
        # cold miss: run (and time per stage) the fallback driver's plan
        return self.fallback.plan(dep)

    def finish(self, dep: Deployment, ex: Executor) -> None:
        if ex.state is not ExecutorState.READY:
            # a crashed or EXITED executor must never re-enter the pool — it
            # would poison every later checkout with a dead program
            return
        with self._lock:
            self._pools.setdefault(dep.image.key, []).append(ex)

    def pool_size(self, key: str) -> int:
        with self._lock:
            return len(self._pools.get(key, []))

    def pool_keys(self) -> list:
        with self._lock:
            return list(self._pools)

    def expire_idle(self, key: str, keep: int) -> list:
        """Idle-timeout eviction (the knob the paper calls a lose-lose trade-off)."""
        expired = []
        with self._lock:
            pool = self._pools.setdefault(key, [])
            while len(pool) > keep:
                expired.append(pool.pop())
        for ex in expired:
            ex.exit()
            if self.on_exit is not None:
                self.on_exit(ex)
        return expired

    def resident_nbytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for pool in self._pools.values() for e in pool)


class ColdJITDriver(Driver):
    """Full Docker-stack analogue: re-trace + the generic checkpoint (the
    trace still overlaps the checkpoint's parse — even the slow path gains
    from the staged pipeline). The checkpoint is written on the first plan
    (``Deployment.ensure_generic``)."""

    name = "cold_jit"
    supports_preboot = True
    supports_batch = True          # TraceCompile re-traces at the bucket shape

    cached = False                 # TraceCompile with every compile cache off

    def plan(self, dep: Deployment) -> BootPlan:
        dep.ensure_generic()
        return BootPlan([
            TraceCompile(cached=self.cached),                # program track
            RestoreWeightsHost("generic"), DevicePut(),      # weights track
            Finalize(),
        ])


class ColdJITCachedDriver(ColdJITDriver):
    """gVisor tier: still re-traces, and compiles through the persistent
    compiled-package cache (in the directory :func:`repro_torch.core.
    compile_cache.enable_inductor_disk_cache` names), so a boot reads back
    the package deploy, or an earlier boot of its shape, compiled through it
    instead of compiling."""

    name = "cold_jit_cached"
    cached = True


ALL_DRIVERS = ("process", "fork", "unikernel", "unikernel_stream", "paused",
               "warm", "cold_jit_cached", "cold_jit")


def make_drivers(on_exit=None, host=None) -> Dict[str, Driver]:
    """Every driver, by name, bound to ``host``. ``on_exit`` is the residency
    hook of the pool and donor drivers."""
    drivers: Dict[str, Driver] = {
        "process": ProcessDriver(on_exit=on_exit),
        "fork": ForkDriver(on_exit=on_exit),
        "unikernel": UnikernelDriver(),
        "unikernel_stream": UnikernelStreamDriver(),
        "paused": PausedDriver(),
        "warm": WarmDriver(on_exit=on_exit),
        "cold_jit_cached": ColdJITCachedDriver(),
        "cold_jit": ColdJITDriver(),
    }
    for drv in drivers.values():
        drv.host = host
    return drivers
