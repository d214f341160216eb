"""Virtual multi-host cluster: placement targets + failure injection.

Port of ``repro.core.cluster``. Each host's driver table is the port's
``make_drivers``: all eight drivers of ``ALL_DRIVERS``.

Each Host models one machine: a bounded slot pool (the paper's 24-core server that
degrades past 20 parallel starts), its own driver instances (so warm pools and fork
donors are per-host state, exactly like container pools are per-machine), a tiered
artifact cache (program payloads + refcounted snapshot chunks in host RAM — see
repro_torch.core.scheduler and repro_torch.core.blobstore), and a liveness flag. ``kill()`` simulates node failure: in-flight work raises HostFailure
at the next lifecycle boundary and the dispatcher re-routes — stateless cold-only
executors make this loss-free, which is the paper's predictability argument.

Routing lives in the Scheduler: ``route(image_key, bucket_rows)`` blends cache
affinity (rendezvous-hashed replica sets + actual tier residency) with live load,
so per-boot artifact cost drops as hosts are added instead of staying flat.

Invariants: ``Host.load`` counts exactly the work that entered the pool —
every increment has a matching decrement, including when the pool rejects a
submission at shutdown (no phantom load); ``kill`` never loses accepted work
silently — it surfaces as HostFailure for the dispatcher to retry; host ids
are stable and NEVER equal to list position once ``add_host``/``remove_host``
churn membership mid-run — lookups go through ``host_by_id``.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional

from repro_torch.core.drivers import make_drivers
from repro_torch.core.scheduler import HostArtifactCache, Scheduler, SchedulerConfig


class HostFailure(RuntimeError):
    pass


class Host:
    def __init__(self, host_id: int, n_slots: int = 4, on_exit=None,
                 cache: Optional[HostArtifactCache] = None) -> None:
        self.host_id = host_id
        self.n_slots = n_slots
        self.alive = True
        self.cache = cache
        self.drivers = make_drivers(on_exit=on_exit, host=self)
        self._pool = ThreadPoolExecutor(max_workers=n_slots,
                                        thread_name_prefix=f"host{host_id}")
        self._inflight = 0
        self._lock = threading.Lock()

    def submit(self, fn: Callable, *args) -> Future:
        if not self.alive:
            raise HostFailure(f"host {self.host_id} is dead")
        with self._lock:
            self._inflight += 1

        def wrapped():
            try:
                return fn(*args)
            finally:
                with self._lock:
                    self._inflight -= 1

        try:
            return self._pool.submit(wrapped)
        except RuntimeError as e:
            # an invoke racing Gateway.shutdown: the pool rejected the work, so
            # ``wrapped`` never runs — undo the increment or the host reports
            # phantom load forever
            with self._lock:
                self._inflight -= 1
            raise HostFailure(f"host {self.host_id} rejected work: {e}") from e

    @property
    def load(self) -> int:
        with self._lock:
            return self._inflight

    def check_alive(self) -> None:
        if not self.alive:
            raise HostFailure(f"host {self.host_id} died")

    def kill(self) -> None:
        self.alive = False

    def revive(self) -> None:
        self.alive = True

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class Cluster:
    def __init__(self, n_hosts: int = 1, slots_per_host: int = 4, on_exit=None,
                 scheduler: Optional[SchedulerConfig] = None) -> None:
        self.scheduler = Scheduler(self, scheduler or SchedulerConfig())
        self._slots_per_host = slots_per_host
        self._on_exit = on_exit
        self._lock = threading.Lock()
        self._next_id = n_hosts
        # the hosts list is copy-on-write: add/remove swap in a fresh list so
        # concurrent iterators (scheduler scoring, shutdown, reports) always
        # see a consistent snapshot without taking the membership lock
        self.hosts: List[Host] = [self._make_host(i, slots_per_host)
                                  for i in range(n_hosts)]

    def _make_host(self, host_id: int, n_slots: int) -> Host:
        return Host(host_id, n_slots, on_exit=self._on_exit,
                    cache=self.scheduler.make_cache(host_id))

    def alive_hosts(self) -> List[Host]:
        return [h for h in self.hosts if h.alive]

    def host_by_id(self, host_id: int) -> Optional[Host]:
        """The host with this id, dead or alive — NEVER index ``hosts`` by id:
        once hosts churn mid-run, id and list position diverge."""
        for h in self.hosts:
            if h.host_id == host_id:
                return h
        return None

    def _require(self, host_id: int) -> Host:
        host = self.host_by_id(host_id)
        if host is None:
            raise KeyError(f"no host with id {host_id}")
        return host

    def add_host(self, n_slots: Optional[int] = None) -> Host:
        """Join a fresh host mid-run (chaos/scale-out). Ids are never reused,
        so HRW placement re-ranks only the keys the new host wins."""
        with self._lock:
            host_id = self._next_id
            self._next_id += 1
            host = self._make_host(host_id, n_slots or self._slots_per_host)
            self.hosts = self.hosts + [host]
        return host

    def remove_host(self, host_id: int) -> Host:
        """Decommission a host: kill it (in-flight work surfaces HostFailure
        for the dispatcher to retry) and drop it from membership."""
        host = self._require(host_id)
        host.kill()
        with self._lock:
            self.hosts = [h for h in self.hosts if h.host_id != host_id]
        host.shutdown()
        return host

    def revive_host(self, host_id: int) -> Host:
        host = self._require(host_id)
        host.revive()
        return host

    def route(self, image_key: Optional[str] = None,
              bucket_rows: Optional[int] = None,
              exclude: Optional[set] = None, strict: bool = False) -> Host:
        """Affinity-aware placement (falls back to least-loaded for key-less
        work). ``strict=True`` raises instead of re-landing inside ``exclude``
        — the hedge path must never back up onto the straggler's own host."""
        host = self.scheduler.select(image_key, bucket_rows,
                                     exclude=exclude, strict=strict)
        if host is None:
            if not self.alive_hosts():
                raise HostFailure("no alive hosts")
            raise HostFailure("no alive host outside the excluded set")
        return host

    def kill_host(self, host_id: int) -> None:
        self._require(host_id).kill()

    def shutdown(self) -> None:
        for h in self.hosts:
            h.shutdown()
