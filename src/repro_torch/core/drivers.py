"""Executor instantiation strategies (port of ``repro.core.drivers``).

Every driver is a declaration: ``plan(dep)`` returns a BootPlan over the
shared stage vocabulary in :mod:`repro_torch.core.boot`, and the shared
``start`` hands it to the BootEngine, which times every stage into
``Timeline.stage_s`` and overlaps the program and weights tracks.

Ported so far: ``unikernel``, the paper's bet — per-request cold start from a
single-purpose image, program deserialize concurrent with snapshot restore.
The other seven drivers of the JAX package (process, fork,
unikernel_stream, paused, warm, cold_jit_cached, cold_jit) come with later
slices.

Invariants: a driver instance belongs to one Host's table (``host``), so its
boots consult that host's tiered artifact cache; ``supports_preboot`` /
``supports_batch`` gate speculation and coalescing to drivers whose plans are
pure at declaration time.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.boot import (
    ENGINE, BootEngine, BootPlan, DevicePut, DeserializeProgram, FetchProgram, Finalize,
    RestoreWeightsHost,
)
from repro_torch.core.deploy import Deployment
from repro_torch.core.executor import Executor
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
    # program built into the registry first
    needs_bucket_image: bool = False

    def plan(self, dep: Deployment) -> BootPlan:
        """Declare this driver's start path as a BootPlan."""
        raise NotImplementedError

    def start(self, dep: Deployment, tl: Timeline) -> Executor:
        """The one start body shared by every driver: execute the declaration."""
        return self.engine.execute(self.plan(dep), dep, tl, driver_name=self.name,
                                   host=self.host)

    def finish(self, dep: Deployment, ex: Executor) -> None:
        """Post-request lifecycle. Cold drivers exit."""
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


def make_drivers(on_exit=None, host=None) -> Dict[str, Driver]:
    """The drivers ported so far, by name, bound to ``host``. ``on_exit`` is
    the residency hook of the pool and donor drivers (none ported yet)."""
    drivers: Dict[str, Driver] = {"unikernel": UnikernelDriver()}
    for drv in drivers.values():
        drv.host = host
    return drivers
