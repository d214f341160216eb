"""Autoscaling (port of ``repro.core.autoscaler``): the warm-pool machinery
vs the cold-only trivial case.

``WarmPoolAutoscaler`` is the complexity the paper wants to delete: a
background control loop that, per function, tracks arrival rate and service
time, computes a target pool size (Little's law + headroom), prewarms
executors up to it, and expires idle ones past the idle timeout — "a
trade-off between wasting resources and experiencing frequent cold starts"
(Sec IV).

``ColdOnlyScaler`` is the paper's proposal: nothing. Scaling IS the request
queue — every request starts its own executor which exits on completion. The
class exists so cold and warm mode expose the same interface.

Invariants: each tick moves every (function, host) pool toward the per-host
share of the Little's-law target — prewarm when under, expire when over — and
the target decays to zero only after ``idle_timeout_s`` without arrivals;
expired executors always exit through ``on_exit`` so their device residency
is accounted, never silently dropped; ``per_host_residency`` is zero by
construction in cold mode.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from repro_torch.core import metrics
from repro_torch.core.cluster import Cluster
from repro_torch.core.deploy import Deployment
from repro_torch.core.drivers import WarmDriver
from repro_torch.core.simclock import Clock


class ColdOnlyScaler:
    """Load-driven by construction: no pools, no monitoring, no knobs."""

    def __init__(self) -> None:
        self.mode = "cold"

    def observe_arrival(self, fn_name: str) -> None:
        pass

    def observe_service_time(self, fn_name: str, seconds: float) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def target(self, fn_name: str) -> int:
        return 0

    def resident_nbytes(self, cluster: Cluster) -> int:
        return 0

    def per_host_residency(self, cluster: Cluster) -> Dict[int, int]:
        """Cold-only holds no executors between requests — zero everywhere, by
        construction (the placement report shows this next to warm's pools)."""
        return {h.host_id: 0 for h in cluster.hosts}


class WarmPoolAutoscaler:
    """Per-function pool targets from observed load; prewarm + idle-expiry loop."""

    def __init__(self, cluster: Cluster, deployments: Dict[str, Deployment], *,
                 interval_s: float = 0.25, idle_timeout_s: float = 5.0,
                 headroom: float = 1.5, max_pool: int = 8,
                 clock: Optional[Clock] = None, planner=None) -> None:
        self.mode = "warm"
        self.cluster = cluster
        self.deployments = deployments
        self.interval_s = interval_s
        self.idle_timeout_s = idle_timeout_s
        self.headroom = headroom
        self.max_pool = max_pool
        # a PreBootPlanner (repro_torch.core.forecast): when set, its
        # published pool targets REPLACE the reactive Little's-law +
        # idle-timeout math — including target zero (full cooldown) the
        # moment the forecast says traffic is gone
        self.planner = planner
        self._clock = clock if clock is not None else metrics.get_clock()
        self._now = self._clock.now
        self._arrivals: Dict[str, List[float]] = {}
        self._service: Dict[str, float] = {}
        self._last_seen: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick_event = None             # virtual-clock recurring tick

    # ------------------------------------------------------------ observations
    def observe_arrival(self, fn_name: str) -> None:
        t = self._now()
        with self._lock:
            buf = self._arrivals.setdefault(fn_name, [])
            buf.append(t)
            if len(buf) > 512:
                del buf[: len(buf) - 512]
            self._last_seen[fn_name] = t

    def observe_service_time(self, fn_name: str, seconds: float) -> None:
        with self._lock:
            prev = self._service.get(fn_name, seconds)
            self._service[fn_name] = 0.8 * prev + 0.2 * seconds     # EWMA

    # ---------------------------------------------------------------- control
    def service_time_estimate(self, fn_name: str) -> float:
        """EWMA service time (the planner's Little's-law input)."""
        with self._lock:
            return self._service.get(fn_name, 0.05)

    def target(self, fn_name: str) -> int:
        """Little's law: concurrency = arrival_rate x service_time, with headroom."""
        if self.planner is not None:
            planned = self.planner.pool_target(fn_name)
            if planned is not None:
                return min(planned, self.max_pool)
        # ONE timestamp for both the idle check and the rate window — two
        # now() reads used to skew the window against the idle cutoff
        t = self._now()
        with self._lock:
            buf = list(self._arrivals.get(fn_name, []))
            svc = self._service.get(fn_name, 0.05)
            last = self._last_seen.get(fn_name, 0.0)
        if not buf or t - last > self.idle_timeout_s:
            return 0
        horizon = 2.0
        recent = [x for x in buf if x > t - horizon]
        rate = len(recent) / horizon
        return min(self.max_pool, int(math.ceil(rate * svc * self.headroom)))

    def _tick(self) -> None:
        for name, dep in list(self.deployments.items()):
            tgt = self.target(name)
            # distribute the cluster-wide target: ceil-per-host used to hand
            # EVERY host the rounded-up share, overshooting the target by up
            # to n_hosts - 1 executors of phantom warm residency
            alive = sorted(self.cluster.alive_hosts(), key=lambda h: h.host_id)
            if not alive:
                continue
            base, rem = divmod(tgt, len(alive))
            for i, host in enumerate(alive):
                warm: WarmDriver = host.drivers["warm"]  # type: ignore[assignment]
                have = warm.pool_size(dep.image.key)
                per_host_target = base + (1 if i < rem else 0)
                if have < per_host_target:
                    try:
                        warm.prewarm(dep, per_host_target - have)
                    except Exception:
                        pass
                elif have > per_host_target:
                    warm.expire_idle(dep.image.key, per_host_target)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:
                pass

    def start(self) -> None:
        if self._clock.virtual:
            # no control thread under virtual time: the tick is a recurring
            # event on the simulation clock, re-armed until stop()
            def tick_event() -> None:
                if self._stop.is_set():
                    return
                try:
                    self._tick()
                except Exception:
                    pass
                self._tick_event = self._clock.schedule(self.interval_s,
                                                        tick_event)
            self._tick_event = self._clock.schedule(self.interval_s, tick_event)
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._tick_event is not None:
            self._tick_event.cancel()
            self._tick_event = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def resident_nbytes(self, cluster: Cluster) -> int:
        total = 0
        for host in cluster.hosts:
            warm: WarmDriver = host.drivers["warm"]  # type: ignore[assignment]
            total += warm.resident_nbytes()
        return total

    def per_host_residency(self, cluster: Cluster) -> Dict[int, int]:
        """Device memory held by each host's warm pools right now — the per-host view of
        the paper's resource-waste integral, reported by placement_summary."""
        return {h.host_id: h.drivers["warm"].resident_nbytes()
                for h in cluster.hosts}
