"""Agent: per-host executor lifecycle management (port of ``repro.core.agent``).

One request = select driver -> start executor -> run -> finish (exit /
repool), with Timeline stamps at each boundary and exact residency
accounting on exit.
With cold drivers "the lifecycle management functionality of the agent
becomes unnecessary" (paper Sec IV-A) — visible here as the trivial finish
path.

The agent is also the claim point for *speculative pre-boots*: the
dispatcher may have launched the executor boot (via ``preboot``) while the
request was still queued; ``handle`` then claims the finished boot instead of
starting a fresh one, and the boot's per-stage timings land in the request's
Timeline.

The port's requests carry numpy token arrays, as the JAX package's do: the
agent moves them to the deployment's device and brings the generated tokens
back as a numpy array. ``handle_batch`` serves one coalesced batch
(``repro_torch.core.batching``) on one executor booted at the batch's bucket
shape.

A streamed boot (``unikernel_stream``) hands back an executor whose tail is
still landing: the agent binds the request's Timeline to its readiness
gates, so the background stages and the extended boot wall land in it.

Invariants: a crashed executor never returns to a pool (it exits, so retries
always get a FRESH one); every exited executor's residency is accounted
exactly once; shared donors (``fork-donor``, the ``process`` driver's
executor) are never exited by a request's normal path — their residency is
accounted when the gateway evicts them; one coalesced batch = one boot, with
one member Timeline per request (own enqueue stamp, shared boot/exec stamps).
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.boot import BootCancelled, BootHandle
from repro_torch.core.cluster import Host
from repro_torch.core.deploy import Deployment
from repro_torch.core.executor import Executor
from repro_torch.core.metrics import Recorder, ResidencyTracker, Timeline
from repro_torch.core.metrics import now as _default_now


class Agent:
    def __init__(self, recorder: Recorder, residency: ResidencyTracker,
                 clock=None, claim_timeout_s: float = 600.0) -> None:
        self.recorder = recorder
        self.residency = residency
        # how long a request will wait for a speculative pre-boot it claimed
        # before giving up (the boot handle's timeout error names the boot's
        # last completed stage)
        self.claim_timeout_s = float(claim_timeout_s)
        self._now = clock.now if clock is not None else _default_now
        # executor acquisitions (boots and claimed pre-boots) — with
        # coalescing, requests_served / boots is the boots-per-request metric
        self.boots = 0
        self._lock = threading.Lock()

    def preboot(self, host: Host, dep: Deployment, driver_name: str,
                bucket_rows: Optional[int] = None) -> Optional[BootHandle]:
        """Kick off a speculative boot on ``host`` for a queued request (or
        a coalesced batch, at its bucket's ``bucket_rows``).

        Returns None for drivers whose starts are impure or trivially cheap —
        speculation only pays where a real boot pipeline runs.
        """
        driver = host.drivers.get(driver_name)
        if driver is None or not driver.supports_preboot:
            return None
        if bucket_rows is not None and not driver.supports_batch:
            return None
        return driver.engine.launch(driver.plan(dep), dep, driver_name=driver.name,
                                    bucket_rows=bucket_rows, host=host)

    def _claim_or_start(self, driver, dep: Deployment, tl: Timeline,
                        preboot: Optional[BootHandle],
                        bucket_rows: Optional[int] = None) -> Executor:
        with self._lock:
            self.boots += 1
        if preboot is not None:
            try:
                result = preboot.claim(self.claim_timeout_s)
            except BootCancelled:
                pass                          # lost a race — boot fresh below
            else:
                tl.record_boot(result.stage_s, result.wall_s,
                               bytes_fetched=result.bytes_fetched,
                               bytes_deduped=result.bytes_deduped,
                               t_first_ready=result.t_first_ready,
                               chunks_rehashed=result.chunks_rehashed,
                               chunks_refetched=result.chunks_refetched)
                tl.preboot = True
                return result.executor
        return driver.start(dep, tl, bucket_rows=bucket_rows)

    def _exit(self, ex: Executor) -> None:
        ex.exit()
        self.residency.add_residency(ex.nbytes, ex.resident_seconds, ex.busy_seconds)

    def _dispatched(self, host: Host, tl: Timeline) -> None:
        tl.t_dispatch = self._now()
        host.check_alive()
        deadline = getattr(tl, "deadline", None)
        if deadline is not None:
            # the slot-queue wait may already have eaten the budget: abort
            # BEFORE starting a boot that cannot possibly serve in time
            deadline.check("dispatch")

    def _serve(self, host: Host, dep: Deployment, driver_name: str, tl: Timeline,
               preboot: Optional[BootHandle], tokens: np.ndarray,
               valid_rows: Optional[int] = None,
               bucket_rows: Optional[int] = None) -> np.ndarray:
        """Start (or claim) an executor, run ``tokens`` on it — a coalesced
        batch when ``valid_rows`` is given — and finish it; returns the
        generated tokens as numpy."""
        driver = host.drivers[driver_name]
        tl.t_start_begin = self._now()
        ex = self._claim_or_start(driver, dep, tl, preboot, bucket_rows=bucket_rows)
        gates = getattr(ex, "gates", None)
        if gates is not None:
            # streamed boot: the tail's background stage timings and bytes
            # land in this request's Timeline once the restore completes
            gates.bind_timeline(tl)
        try:
            host.check_alive()
        except Exception:
            # the host died under a live executor: exit it (unless it is a
            # shared donor) so neither its device memory nor its residency
            # leaks while the dispatcher re-routes
            if ex.driver != "fork-donor":
                self._exit(ex)
            raise
        tl.t_exec_begin = self._now()
        try:
            device_tokens = torch.from_numpy(np.asarray(tokens, np.int32)).to(dep.device)
            if valid_rows is None:
                out = ex.run(device_tokens, timeline=tl)
            else:
                out = ex.run_batch(device_tokens, valid_rows=valid_rows, timeline=tl)
            out = out.cpu().numpy()
        except Exception:
            # a crashed executor must never return to a pool — exit it so the
            # dispatcher's retry instantiates a FRESH one (for a batch: the
            # WHOLE batch, every member exactly once per attempt)
            self._exit(ex)
            raise
        driver.finish(dep, ex)
        if ex.params is None and ex.driver != "fork-donor":
            # exited now (not pooled, not a resident donor) — account exact
            # residency
            self.residency.add_residency(ex.nbytes, ex.resident_seconds, ex.busy_seconds)
        host.check_alive()
        tl.t_done = self._now()
        return out

    def handle(self, host: Host, dep: Deployment, tokens: Optional[np.ndarray],
               driver_name: str, tl: Timeline, label: Optional[str] = None,
               preboot: Optional[BootHandle] = None) -> Any:
        self._dispatched(host, tl)
        if driver_name == "noop":                       # gateway/dispatch floor probe
            tl.t_start_begin = tl.t_exec_begin = self._now()
            tl.t_done = self._now()
            self.recorder.add(label or "noop", tl)
            return None
        out = self._serve(host, dep, driver_name, tl, preboot, tokens)
        self.recorder.add(label or f"{dep.name}:{driver_name}", tl)
        return out

    def handle_batch(self, host: Host, dep: Deployment, batch: Any,
                     driver_name: str, tl: Timeline, label: Optional[str] = None,
                     preboot: Optional[BootHandle] = None) -> np.ndarray:
        """One coalesced batch = ONE executor boot serving every member request.

        ``batch`` is a :class:`repro_torch.core.batching.CoalescedBatch`. The
        boot targets the batch's padded bucket shape; the result rows fan back
        out to members at the coalescer. Timeline accounting is batch-aware:
        one member timeline per request lands in the recorder, sharing the
        boot and execution stamps but keeping each request's own enqueue
        time — so queue-delay (which includes the coalescing window) stays
        per-request.
        """
        self._dispatched(host, tl)
        out = self._serve(host, dep, driver_name, tl, preboot, batch.tokens,
                          valid_rows=batch.valid_rows, bucket_rows=batch.padded_rows)
        tl.batch_size = batch.n_requests
        base_label = label or f"{dep.name}:{driver_name}"
        for i, t_enq in enumerate(batch.enqueue_times):
            member_label = batch.labels[i] or base_label
            self.recorder.add(member_label, tl.for_member(t_enq, batch.n_requests))
        return out
