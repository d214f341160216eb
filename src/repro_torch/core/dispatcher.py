"""Dispatcher: routing, retry-on-host-failure, and hedged straggler mitigation.

Port of ``repro.core.dispatcher``.

The cold-only simplification shows up here concretely: there is no warm-affinity
table and no per-function load monitor — any alive host can take any request, so
routing is just least-loaded. What remains is what any large fleet needs:

* retry: HostFailure -> re-dispatch to another host (stateless executors make this
  always-safe); a coalesced batch retries as ONE unit, so every member request is
  re-dispatched exactly once per attempt. Retries are resilience-governed
  (:mod:`repro_torch.core.resilience`): exponential backoff + jitter on the shared
  timer, a token-bucket retry budget that bounds attempt amplification under
  fleet-wide failure, per-host circuit breakers fed from attempt outcomes (the
  scheduler quarantines OPEN hosts), and per-request deadlines that refuse
  retries which cannot finish in time;
* hedging: if an attempt exceeds ``hedge_factor`` x the observed p95 latency for
  that (function, driver), launch a backup on a different host and take the first
  result — the tail-at-scale twin of the paper's overload observation (Fig 1/2:
  start latency blows up past the core count). Hedge deadlines live on ONE shared
  timer thread (a heap of deadlines), not one parked thread per in-flight request,
  and the p95 comes from an O(1) streaming P-square estimator, not a percentile
  over a sample window under a lock;
* speculative pre-boot: with ``speculative=True`` the dispatcher starts the
  executor boot (via the agent's BootEngine handle) the moment a host is picked
  — while the request may still be waiting for a slot — and cancels it cleanly
  if a hedge or retry wins the race, so no device memory leaks from the loser.

Invariants: a retry never re-lands on a host this request already touched;
hedges are STRICT — a backup launches only on a distinct alive host and
otherwise stands down (and is counted only when actually launched); the
request's Future settles exactly once no matter how many attempts raced; a
losing speculative boot is cancelled and any executor it built is exited.
"""
from __future__ import annotations

import random
import threading
from concurrent.futures import Future
from typing import Dict, Optional

from repro_torch.core import metrics
from repro_torch.core.agent import Agent
from repro_torch.core.batching import CoalescedBatch, settle_quietly as _settle
from repro_torch.core.cluster import Cluster, HostFailure
from repro_torch.core.deploy import Deployment
from repro_torch.core.metrics import P2Quantile, Timeline
from repro_torch.core.resilience import (Deadline, DeadlineExceeded,
                                         ResilienceConfig, RetryBudget)
from repro_torch.core.simclock import Clock
from repro_torch.core.timerwheel import DeadlineTimer


class _LatencyModel:
    """Streaming per-(fn, driver) latency quantile estimate for hedge deadlines.

    One P-square estimator per key: O(1) memory and O(1) per observation. This
    runs on EVERY submit and every hedge check — the previous spelling (a full
    ``np.percentile`` over a 256-sample window under a global lock) made the
    latency model itself a hot-path serialization point.
    """

    def __init__(self, min_samples: int = 8, p: float = 0.95) -> None:
        self._est: Dict[str, P2Quantile] = {}
        self._lock = threading.Lock()
        self.min_samples = min_samples
        self.p = p

    def observe(self, key: str, seconds: float) -> None:
        with self._lock:
            est = self._est.get(key)
            if est is None:
                est = self._est[key] = P2Quantile(self.p)
            est.observe(seconds)

    def p95(self, key: str) -> Optional[float]:
        with self._lock:
            est = self._est.get(key)
            if est is None or est.n < self.min_samples:
                return None
            return float(est.value)


def _is_transient(err: BaseException) -> bool:
    """Executor-crash faults worth re-dispatching (stateless executors make every
    retry safe — the cold-only design's fault-tolerance dividend). The JAX
    package's classification, unchanged: a PyTorch or CUDA error (a
    ``RuntimeError`` without "not found") is not retried, since a CUDA error
    usually leaves the process's context unusable."""
    name = type(err).__name__
    return name in ("JaxRuntimeError", "XlaRuntimeError") or (
        isinstance(err, RuntimeError) and "not found" in str(err).lower())


class Dispatcher:
    def __init__(self, cluster: Cluster, agent: Agent, *,
                 max_retries: int = 3, hedge_factor: float = 3.0,
                 hedging: bool = True, speculative: bool = False,
                 clock: Optional[Clock] = None,
                 resilience: Optional[ResilienceConfig] = None) -> None:
        self.cluster = cluster
        self.agent = agent
        self.max_retries = max_retries
        self.hedge_factor = hedge_factor
        self.hedging = hedging
        self.speculative = speculative
        self._clock = clock if clock is not None else metrics.get_clock()
        self._now = self._clock.now
        self.latency = _LatencyModel()
        self.hedges_launched = 0
        self.preboots_launched = 0
        self.retries = 0
        self.retries_denied = 0        # budget/deadline refused a retry
        self.submitted = 0             # requests (or batches) accepted
        self.attempts = 0              # attempts actually dispatched to a host
        self._lock = threading.Lock()
        self._hedge_timer = DeadlineTimer("dispatcher-hedge-timer",
                                          clock=self._clock)
        # retry storms are the classic resilience failure mode: every retry is
        # (a) delayed by exponential backoff + jitter (riding the SAME shared
        # timer as hedges — virtual-clock friendly) and (b) paid for out of a
        # token bucket that only refills with fresh traffic, so amplification
        # is bounded even when the whole fleet is failing
        self.res = resilience if resilience is not None else ResilienceConfig()
        self.retry_budget = RetryBudget(fraction=self.res.retry_fraction,
                                        floor=self.res.retry_floor,
                                        cap=self.res.retry_cap)
        # seeded: retry jitter must be reproducible under the virtual clock
        self._rng = random.Random(0x5EED)
        # the scheduler's per-host breakers quarantine flaky hosts out of
        # routing; the dispatcher is where attempt outcomes are observed, so
        # it feeds them (and binds the run's clock — breaker cooldowns must
        # follow virtual time in simulation)
        self._breakers = getattr(cluster.scheduler, "breakers", None) \
            if hasattr(cluster, "scheduler") else None
        if self._breakers is not None:
            self._breakers.bind_clock(self._clock)
        # a PreBootPlanner (repro_torch.core.forecast) parks forecast-driven
        # boots per (host, image); when set, _attempt claims a parked boot
        # before launching its own request-triggered speculation — a request
        # landing where the planner already warmed rides the planner's boot
        self.planner = None

    @property
    def timer(self) -> DeadlineTimer:
        """The shared deadline timer (hedge deadlines, retry backoffs — and
        the forecast planner's tick, which rides the same thread)."""
        return self._hedge_timer

    # ------------------------------------------------------------------ public
    def submit(self, dep: Optional[Deployment], tokens, driver_name: str,
               label: Optional[str] = None,
               speculative: Optional[bool] = None,
               deadline: Optional[Deadline] = None,
               hedging: Optional[bool] = None) -> Future:
        """Dispatch one request; returns a Future with the result.

        ``deadline`` rides the Timeline into every layer below (agent, boot
        stages, device streaming) as cooperative cancellation; ``hedging``
        overrides the dispatcher default per-request (brownout turns it off).
        """
        result: Future = Future()
        tl = Timeline(t_enqueue=self._now())
        tl.deadline = deadline
        spec = self.speculative if speculative is None else speculative
        hedge_ok = self.hedging if hedging is None else hedging
        with self._lock:
            self.submitted += 1
        self.retry_budget.deposit()
        # ONE mutable tried-set per request, shared by every attempt (primary,
        # retries, hedges) — see _attempt for the atomicity contract
        self._attempt(result, dep, tokens, driver_name, tl, tried=set(), n_try=0,
                      label=label, allow_hedge=hedge_ok, speculative=spec)
        return result

    def submit_batch(self, dep: Deployment, batch: CoalescedBatch,
                     driver_name: str, label: Optional[str] = None,
                     speculative: Optional[bool] = None,
                     deadline: Optional[Deadline] = None,
                     hedging: Optional[bool] = None) -> Future:
        """Dispatch one coalesced batch as a single unit.

        The batch rides the exact retry/hedge machinery of ``submit`` — a
        transient failure re-dispatches the whole batch (every member exactly
        once per attempt), a straggling batch gets one hedged backup — and the
        Future resolves to the stacked result rows; the coalescer fans them
        back out to the per-request Futures.
        """
        result: Future = Future()
        tl = Timeline(t_enqueue=batch.t_earliest)
        tl.deadline = deadline
        spec = self.speculative if speculative is None else speculative
        hedge_ok = self.hedging if hedging is None else hedging
        with self._lock:
            self.submitted += 1
        self.retry_budget.deposit()
        self._attempt(result, dep, batch, driver_name, tl, tried=set(), n_try=0,
                      label=label, allow_hedge=hedge_ok, speculative=spec)
        return result

    def close(self) -> None:
        """Stop the shared hedge-timer thread (gateway shutdown)."""
        self._hedge_timer.close()

    # ---------------------------------------------------------------- internal
    def _preboot(self, host, dep, driver_name: str,
                 bucket_rows: Optional[int] = None):
        """Start a speculative boot for a request (or a batch, at its bucket
        shape) headed to ``host``, if the agent and driver support it. A
        failure to start one is not the request's failure: the request boots
        on its own path instead."""
        pre_fn = getattr(self.agent, "preboot", None)
        if pre_fn is None:
            return None
        try:
            handle = pre_fn(host, dep, driver_name, bucket_rows=bucket_rows) \
                if bucket_rows is not None else pre_fn(host, dep, driver_name)
        except Exception:
            return None
        if handle is not None:
            with self._lock:
                self.preboots_launched += 1
        return handle

    def _record_host(self, host, ok: Optional[bool]) -> None:
        """Feed an attempt outcome to the host's circuit breaker.

        ``ok=None`` means "no evidence" (deadline expiry, cancelled attempt):
        nothing is recorded, but a half-open probe slot the router consumed
        for this attempt is released so the host cannot wedge in HALF_OPEN.
        """
        if self._breakers is None:
            return
        if ok is None:
            self._breakers.release_probe_host(host.host_id)
        else:
            self._breakers.record_host(host.host_id, ok)

    def _schedule_retry(self, result: Future, dep, tokens, driver_name: str,
                        tl: Timeline, tried: set, n_try: int, label,
                        allow_hedge: bool, speculative: bool,
                        err: BaseException) -> bool:
        """Queue attempt ``n_try + 1`` after exponential backoff + jitter.

        The delay rides the shared deadline timer (no parked threads; virtual-
        clock exact), and the retry is refused — settling ``err`` — when the
        request's deadline cannot outlive the backoff or the retry budget is
        dry (the no-retry-storm guarantee: budget refills only with FRESH
        traffic, so fleet-wide failure degrades to bounded amplification).
        """
        deadline = getattr(tl, "deadline", None)
        delay = self.res.backoff.delay(n_try, self._rng)
        if deadline is not None and deadline.remaining() <= delay:
            with self._lock:
                self.retries_denied += 1
            _settle(result, error=err)
            return False
        if not self.retry_budget.try_spend():
            with self._lock:
                self.retries_denied += 1
            _settle(result, error=err)
            return False
        with self._lock:
            self.retries += 1

        def do_retry() -> None:
            if result.done():
                return
            fresh = Timeline(t_enqueue=tl.t_enqueue)
            fresh.deadline = deadline
            self._attempt(result, dep, tokens, driver_name, fresh, tried,
                          n_try + 1, label, allow_hedge, speculative)

        entry = self._hedge_timer.schedule(delay, do_retry)
        if entry.cancelled:
            # timer already closed (shutdown mid-flight): run inline so the
            # Future is never orphaned
            do_retry()
        return True

    def _attempt(self, result: Future, dep, tokens, driver_name: str, tl: Timeline,
                 tried: set, n_try: int, label, allow_hedge: bool,
                 speculative: bool = False, hedge: bool = False) -> bool:
        """Dispatch one attempt; returns True if work was actually submitted.

        Placement is affinity-aware: the cluster routes on the deployment's
        program artifact key (and the batch's bucket shape) so boots land where
        the bytes already are. ``tried`` excludes hosts this request already
        ran on — retries re-route elsewhere, and a hedge (``hedge=True``) is
        strict about it: with no distinct host alive it silently stands down
        rather than racing the straggler on its own machine.
        """
        deadline = getattr(tl, "deadline", None)
        if deadline is not None and deadline.expired():
            # no point routing work that cannot finish in time — settle now
            # (a hedge just stands down: the primary still owns the request)
            if hedge:
                return False
            _settle(result, error=DeadlineExceeded(
                f"deadline passed before attempt {n_try}"))
            return False
        batch = tokens if isinstance(tokens, CoalescedBatch) else None
        key = f"{dep.name if dep else 'noop'}:{driver_name}"
        if batch is not None:
            key += f":b{batch.bucket}"      # service time scales with the bucket
        bucket_rows = None
        if batch is not None and dep is not None \
                and batch.padded_rows != dep.base_rows:
            bucket_rows = batch.padded_rows
        image = getattr(dep, "image", None)      # noop probes / test stand-ins
        try:
            with self._lock:
                # route + tried-set update are one atomic step: ``tried`` is
                # the request's SINGLE mutable set, so a hedge firing after a
                # retry (or concurrently with one) excludes every host any
                # attempt has touched — rebuilding ``tried | {id}`` into new
                # sets here used to let a late hedge land on a retry's host
                host = self.cluster.route(
                    image.key if image is not None else None,
                    bucket_rows=bucket_rows, exclude=tried, strict=hedge)
                tried.add(host.host_id)
        except HostFailure as e:
            if hedge:
                return False        # primary still owns the request — no backup
            _settle(result, error=e)
            return False

        preboot = None
        if self.planner is not None and image is not None and bucket_rows is None:
            # forecast fast path: a parked planner boot for this (host, image)
            # beats starting our own — the boot has a head start of up to one
            # planning horizon
            preboot = self.planner.claim(host.host_id, image.key)
            if preboot is not None:
                tl.planner_preboot = True
        if preboot is None and speculative and dep is not None:
            preboot = self._preboot(
                host, dep, driver_name,
                bucket_rows=batch.padded_rows if batch is not None else None)
        if preboot is not None:
            # whichever attempt settles the request first, an unclaimed
            # speculative boot must die with its executor
            result.add_done_callback(lambda _f: preboot.cancel())

        def work():
            if batch is not None:
                out = self.agent.handle_batch(host, dep, batch, driver_name, tl,
                                              label, preboot=preboot)
            elif preboot is None:
                out = self.agent.handle(host, dep, tokens, driver_name, tl, label)
            else:
                out = self.agent.handle(host, dep, tokens, driver_name, tl, label,
                                        preboot=preboot)
            self.latency.observe(key, tl.e2e)
            return out

        try:
            fut = host.submit(work)
        except HostFailure as e:
            # the host died (or its pool shut down) between route and submit
            if preboot is not None:
                preboot.cancel()
            self._record_host(host, False)
            if hedge:
                return False
            if n_try < self.max_retries:
                return self._schedule_retry(result, dep, tokens, driver_name,
                                            tl, tried, n_try, label,
                                            allow_hedge, speculative, e)
            _settle(result, error=e)
            return False

        with self._lock:
            self.attempts += 1

        def on_done(f: Future) -> None:
            err = f.exception()
            if preboot is not None and err is not None:
                preboot.cancel()              # failed before (or during) claim
            # breaker feed — even when the request already settled (a hedge
            # won), this attempt's outcome is still evidence about the host.
            # Deadline expiry is the REQUEST's fault, not the host's: record
            # nothing, just hand back any probe slot this attempt consumed.
            retryable = err is not None and (
                isinstance(err, HostFailure) or _is_transient(err))
            if err is None:
                self._record_host(host, True)
            elif retryable:
                self._record_host(host, False)
            else:
                self._record_host(host, None)
            if result.done():
                return
            if err is None:
                _settle(result, value=f.result())
                return
            if retryable and n_try < self.max_retries:
                self._schedule_retry(result, dep, tokens, driver_name, tl,
                                     tried, n_try, label, allow_hedge,
                                     speculative, err)
            else:
                _settle(result, error=err)

        fut.add_done_callback(on_done)

        # straggler hedging: one backup if this attempt exceeds hedged deadline.
        # The deadline sits on the shared timer thread; the attempt/result done
        # callbacks cancel it, so a settled request costs nothing further.
        p95 = self.latency.p95(key)
        if allow_hedge and p95 is not None and len(self.cluster.alive_hosts()) > 1:

            def fire_hedge() -> None:
                if result.done() or fut.done():
                    return          # finished / failed (retry path owns failures)
                fresh = Timeline(t_enqueue=tl.t_enqueue)
                fresh.deadline = getattr(tl, "deadline", None)
                # strict routing: the backup MUST land on a different host than
                # every attempt so far, or not launch at all
                if self._attempt(result, dep, tokens, driver_name, fresh, tried,
                                 n_try + 1, label, allow_hedge=False,
                                 hedge=True):
                    with self._lock:
                        self.hedges_launched += 1

            entry = self._hedge_timer.schedule(self.hedge_factor * p95, fire_hedge)
            fut.add_done_callback(lambda _f: entry.cancel())
            result.add_done_callback(lambda _f: entry.cancel())
        return True
