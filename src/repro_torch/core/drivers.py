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

    def plan(self, dep: Deployment) -> BootPlan:
        """Declare this driver's start path as a BootPlan."""
        raise NotImplementedError

    def start(self, dep: Deployment, tl: Timeline) -> Executor:
        """The one start body shared by every driver: execute the declaration."""
        return self.engine.execute(self.plan(dep), dep, tl, driver_name=self.name)

    def finish(self, dep: Deployment, ex: Executor) -> None:
        """Post-request lifecycle. Cold drivers exit."""
        ex.exit()


class UnikernelDriver(Driver):
    """Per-request cold start from a single-purpose image: program
    deserialize and snapshot restore run CONCURRENTLY."""

    name = "unikernel"

    def plan(self, dep: Deployment) -> BootPlan:
        return BootPlan([
            FetchProgram(), DeserializeProgram(),            # program track
            RestoreWeightsHost("snapshot"), DevicePut(),     # weights track
            Finalize(),
        ])


def make_drivers() -> Dict[str, Driver]:
    """The drivers ported so far, by name."""
    return {"unikernel": UnikernelDriver()}
