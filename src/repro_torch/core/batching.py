"""Adaptive request coalescing with shape-bucketed micro-batching (port of
``repro.core.batching``, copied whole: it is numpy and threads).

The paper's cold-only design pays one full boot per request. That is the right
trade at low load — but under heavy traffic the dominant cost is no longer the
boot, it is that every invoke runs ``program(params, tokens)`` for a SINGLE
request, so boots multiply linearly with traffic and the device sits badly
under-utilized (the overload regime of paper Fig 1/2, where start latency
blows up past the core count). The :class:`Coalescer` attacks the per-request
*share* of the fixed cost instead of the fixed cost itself:

* concurrent submissions to the same (function, driver) collect for an
  **adaptive window** — grown only while observed queue-delay stays under a
  fraction of observed batch service time, shrunk the moment waiting costs
  more than it saves (and immediately when traffic is too light to coalesce);
* the collected requests are stacked and **padded to a shape bucket** (a small
  set of request-count sizes), so one compiled program per bucket is reused
  forever instead of recompiling per batch size;
* the batch rides the normal dispatcher path as ONE unit — retry and hedging
  operate on whole batches, so a transient failure re-dispatches every member
  exactly once — and lands on ONE booted executor (``Executor.run_batch``, a
  ``torch.export`` program exported at the bucket's row count);
* results fan back out to per-request Futures, padding rows discarded.

In cold mode one unikernel boot now serves N coalesced requests:
boots-per-request drops from 1.0 toward 1/max_batch while every request keeps
its own queue-delay accounting (Timeline.batch_size / boots_share).

Granularity boundary: the coalescer batches at REQUEST granularity — one
fused bucket program runs every member for the full decode budget, so mixed
decode lengths pay the longest member's steps. Decode-shaped invokes
therefore BYPASS this layer entirely (``Gateway.invoke_decode``) and join
:class:`repro_torch.core.decode.DecodeScheduler`'s step-granular loop instead,
where a request occupies a batch row only for the steps it actually decodes.
Prefill/serve-shaped work keeps coalescing here; the two tiers share the
dispatcher's drivers and the same residency accounting.

Invariants: whole-batch retry = every member exactly once per attempt (the
batch rides the dispatcher as ONE unit — no member is ever re-dispatched solo
or dropped); every submitted Future settles exactly once, including on drain
at shutdown; only batch-capable drivers coalesce — pool/donor drivers bypass
the layer untouched; padding rows never reach a caller.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, InvalidStateError, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import metrics
from repro_torch.core.metrics import Series
from repro_torch.core.simclock import Clock
from repro_torch.core.timerwheel import DeadlineTimer, TimerEntry


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Knobs for the coalescing layer (Gateway(batching=...) accepts one)."""

    buckets: Tuple[int, ...] = (1, 2, 4, 8)   # request-count shape buckets
    min_window_s: float = 0.0005              # floor: ~free at light load
    max_window_s: float = 0.050               # cap: never hold a request >50ms
    delay_fraction: float = 0.5               # queue-delay budget vs service time
    grow: float = 1.5                         # window growth factor per good batch
    shrink: float = 0.5                       # window cut on over-delay / no traffic
    # at most this many dispatched-but-unfinished batches per (fn, driver):
    # while they run, new arrivals accumulate into the NEXT batch, so batch
    # size tracks the actual overload instead of a guessed window — at light
    # load nothing is in flight and requests dispatch after min_window_s
    max_inflight: int = 4

    @property
    def max_batch(self) -> int:
        return max(self.buckets)

    def bucket_for(self, n_requests: int) -> int:
        """Smallest bucket that fits ``n_requests`` coalesced requests."""
        for b in sorted(self.buckets):
            if b >= n_requests:
                return b
        return self.max_batch


@dataclasses.dataclass
class CoalescedBatch:
    """The unit the dispatcher/agent see: N stacked requests, padded to a bucket."""

    tokens: np.ndarray                 # (bucket * rows_per_request, prompt_len)
    n_requests: int
    bucket: int                        # padded request-slot count
    rows_per_request: int
    enqueue_times: List[float]
    labels: List[Optional[str]]

    @property
    def padded_rows(self) -> int:
        return self.tokens.shape[0]

    @property
    def valid_rows(self) -> int:
        return self.n_requests * self.rows_per_request

    @property
    def t_earliest(self) -> float:
        return min(self.enqueue_times)

    def rows_of(self, member: int) -> slice:
        r = self.rows_per_request
        return slice(member * r, (member + 1) * r)


class _Pending:
    __slots__ = ("tokens", "future", "t_enqueue", "label", "speculative",
                 "deadline")

    def __init__(self, tokens: np.ndarray, future: Future, label: Optional[str],
                 t_enqueue: float, speculative: Optional[bool] = None,
                 deadline=None):
        self.tokens = tokens
        self.future = future
        self.t_enqueue = t_enqueue
        self.label = label
        self.speculative = speculative
        self.deadline = deadline


class _FnQueue:
    """Per-(function, driver) pending set + adaptive-window state."""

    def __init__(self, dep, driver_name: str, needs_bucket_image: bool,
                 cfg: BatchingConfig) -> None:
        self.dep = dep
        self.driver_name = driver_name
        self.needs_bucket_image = needs_bucket_image
        self.window = cfg.min_window_s
        self.service_ewma: Optional[float] = None
        self.pending: List[_Pending] = []
        self.inflight = 0                  # dispatched, not yet fanned out
        self.timer_entry: Optional[TimerEntry] = None
        self.lock = threading.Lock()


def settle_quietly(fut: Future, value=None,
                   error: Optional[BaseException] = None) -> None:
    """Complete ``fut`` unless a concurrent path already did (hedge / retry /
    abandoned caller). Shared by the dispatcher and the coalescer."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


class Coalescer:
    """Collects concurrent submissions into shape-bucketed batches.

    Two mechanisms decide when a batch ships:

    * the **adaptive window** (grown only while queue-delay stays under
      ``delay_fraction`` x observed service time) bounds how long a request
      may sit waiting for company at light load, and
    * the **in-flight cap**: at most ``max_inflight`` dispatched batches per
      (function, driver); while those run, new arrivals accumulate into the
      next batch, so batch size follows real backpressure — exactly when the
      uncoalesced platform would be melting down, the batches get big.

    One flush timer entry per non-empty queue on a single shared
    :class:`DeadlineTimer` thread — coalescing 10k in-flight requests costs
    one parked thread, not 10k.
    """

    def __init__(self, dispatcher, config: Optional[BatchingConfig] = None,
                 clock: Optional[Clock] = None) -> None:
        self.dispatcher = dispatcher
        self.cfg = config or BatchingConfig()
        self._clock = clock if clock is not None else metrics.get_clock()
        self._now = self._clock.now
        self._queues: Dict[Tuple[str, str], _FnQueue] = {}
        self._timer = DeadlineTimer("coalescer-flush", clock=self._clock)
        self._lock = threading.Lock()
        self._inflight: set = set()
        self._draining = False
        # series for the report: how well is coalescing engaging?
        self.requests = 0                  # submissions accepted
        self.batches = 0                   # batches dispatched (first attempts)
        self.batch_sizes = Series()        # requests per dispatched batch
        self.queue_delay = Series()        # seconds each member waited to flush
        # set by the gateway's admission controller: while it returns True
        # (brownout), flush windows clamp to the minimum and batches dispatch
        # without hedging — shed latency slack, keep shipping work
        self.brownout: Optional[Callable[[], bool]] = None

    # ------------------------------------------------------------------ public
    def submit(self, dep, tokens, driver_name: str,
               label: Optional[str] = None,
               needs_bucket_image: bool = True,
               speculative: Optional[bool] = None,
               deadline=None) -> Future:
        """Enqueue one request; returns its per-request Future."""
        tokens = np.asarray(tokens)
        expected = (dep.spec.batch_size, dep.spec.prompt_len)
        if tokens.shape != expected:
            # reject HERE, synchronously: a nonconforming member inside a
            # stacked batch would silently shift every later member's rows
            raise ValueError(
                f"tokens shape {tokens.shape} != deployed request shape "
                f"{expected} for {dep.name}")
        fut: Future = Future()
        key = (dep.name, driver_name)
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _FnQueue(dep, driver_name,
                                                 needs_bucket_image, self.cfg)
            self.requests += 1
        with q.lock:
            q.pending.append(_Pending(tokens, fut, label, self._now(),
                                      speculative, deadline))
            n = len(q.pending)
            flush_now = self._draining or n >= self.cfg.max_batch
            if not flush_now and n == 1:
                window = q.window
                if self.brownout is not None and self.brownout():
                    # overload: stop buying batch size with wait time
                    window = self.cfg.min_window_s
                q.timer_entry = self._timer.schedule(
                    window, lambda: self._flush(q, from_timer=True))
        if flush_now:
            self._flush(q)
        return fut

    def drain(self, timeout: float = 60.0) -> None:
        """Flush everything pending and wait for in-flight batches (shutdown)."""
        with self._lock:
            self._draining = True
            queues = list(self._queues.values())
        deadline = self._now() + timeout
        while True:
            for q in queues:
                self._flush(q)
            with self._lock:
                inflight = list(self._inflight)
            if not inflight and not any(q.pending for q in queues):
                return
            remaining = deadline - self._now()
            if remaining <= 0:
                return
            if self._clock.virtual:
                # virtual time: the drain caller IS the event-loop driver, so
                # pump the clock instead of blocking on futures that can only
                # complete via events we would be preventing
                if not self._clock.run_until_idle():
                    return          # nothing can make further progress
            elif inflight:
                wait(inflight, timeout=min(1.0, remaining))

    def summary(self) -> Dict[str, float]:
        with self._lock:
            requests, batches = self.requests, self.batches
            queues = list(self._queues.items())   # snapshot: submit() inserts keys
        qd = self.queue_delay.stats()
        return {
            "requests": float(requests),
            "batches": float(batches),
            "boots_per_request": batches / max(requests, 1),
            "mean_batch_size": self.batch_sizes.mean,
            "queue_delay_p50_ms": qd.p50,
            "queue_delay_p99_ms": qd.p99,
            "windows_ms": {f"{k[0]}:{k[1]}": q.window * 1e3 for k, q in queues},
        }

    def close(self) -> None:
        """Stop the flush-timer thread (call after ``drain`` at shutdown)."""
        self._timer.close()

    # ---------------------------------------------------------------- internal
    def _flush(self, q: _FnQueue, from_timer: bool = False) -> None:
        """Dispatch as many batches as the in-flight cap allows right now.

        Pending requests beyond the cap stay queued and coalesce further —
        ``_fan_out`` re-flushes on every batch completion, so held requests
        ship the moment capacity frees up (in bigger batches).
        """
        while True:
            with q.lock:
                if from_timer:
                    q.timer_entry = None
                    from_timer = False
                if not q.pending or q.inflight >= self.cfg.max_inflight:
                    return
                take = min(len(q.pending), self.cfg.max_batch)
                members, q.pending = q.pending[:take], q.pending[take:]
                if not q.pending and q.timer_entry is not None:
                    q.timer_entry.cancel()
                    q.timer_entry = None
                q.inflight += 1
            self._dispatch(q, members)

    def _dispatch(self, q: _FnQueue, members: List[_Pending]) -> None:
        t_flush = self._now()
        # per-call speculative opt-ins survive coalescing: any member asking
        # for a speculative pre-boot gets one for the whole batch
        speculative = True if any(m.speculative for m in members) else None
        # the batch inherits the TIGHTEST member deadline — one boot serves
        # every member, so the first member to expire aborts it for all (the
        # dispatcher's retry then re-dispatches the whole unit)
        member_deadlines = [m.deadline for m in members if m.deadline is not None]
        batch_deadline = (min(member_deadlines, key=lambda d: d.t_deadline)
                          if member_deadlines else None)
        hedging = False if (self.brownout is not None and self.brownout()) \
            else None
        try:
            batch = self._build_batch(q, members, t_flush)
            fut = self.dispatcher.submit_batch(q.dep, batch, q.driver_name,
                                               label=members[0].label,
                                               speculative=speculative,
                                               deadline=batch_deadline,
                                               hedging=hedging)
        except BaseException as e:     # building/dispatch failed: fail members
            with q.lock:
                q.inflight -= 1
            for m in members:
                settle_quietly(m.future, error=e)
            return
        with self._lock:
            self.batches += 1
            self._inflight.add(fut)
        self.batch_sizes.add(len(members))
        for m in members:
            self.queue_delay.add(t_flush - m.t_enqueue)
        fut.add_done_callback(
            lambda f: self._fan_out(q, batch, members, t_flush, f))

    def _build_batch(self, q: _FnQueue, members: Sequence[_Pending],
                     t_flush: float) -> CoalescedBatch:
        rows_per_request = q.dep.spec.batch_size
        bucket = self.cfg.bucket_for(len(members))
        stacked = np.concatenate([m.tokens for m in members], axis=0)
        padded_rows = bucket * rows_per_request
        if stacked.shape[0] < padded_rows:
            pad = np.zeros((padded_rows - stacked.shape[0],) + stacked.shape[1:],
                           dtype=stacked.dtype)
            stacked = np.concatenate([stacked, pad], axis=0)
        if q.needs_bucket_image and padded_rows != q.dep.base_rows:
            q.dep.ensure_bucket(padded_rows)   # one compile per bucket, ever
        return CoalescedBatch(
            tokens=stacked, n_requests=len(members), bucket=bucket,
            rows_per_request=rows_per_request,
            enqueue_times=[m.t_enqueue for m in members],
            labels=[m.label for m in members])

    def _fan_out(self, q: _FnQueue, batch: CoalescedBatch,
                 members: List[_Pending], t_flush: float, fut: Future) -> None:
        with self._lock:
            self._inflight.discard(fut)
        with q.lock:
            q.inflight -= 1
        err = fut.exception()
        if err is not None:
            # the dispatcher already retried the whole batch through its
            # budget; a surviving failure fails every member
            for m in members:
                settle_quietly(m.future, error=err)
        else:
            out = fut.result()
            for i, m in enumerate(members):
                settle_quietly(m.future, value=out[batch.rows_of(i)])
        self._adapt_window(q, batch, t_flush, failed=err is not None)
        self._flush(q)      # capacity just freed: ship whatever coalesced meanwhile

    def _adapt_window(self, q: _FnQueue, batch: CoalescedBatch,
                      t_flush: float, failed: bool) -> None:
        """Grow the window only while queue-delay stays under
        ``delay_fraction`` x observed service time; shrink otherwise."""
        cfg = self.cfg
        service = self._now() - t_flush        # dispatch queue + boot + run
        with q.lock:
            prev = q.service_ewma
            q.service_ewma = service if prev is None else 0.8 * prev + 0.2 * service
            budget = cfg.delay_fraction * q.service_ewma
            delay = t_flush - batch.t_earliest
            if failed or delay > budget or batch.n_requests == 1:
                # waiting cost too much (or bought nothing): back off
                q.window = max(cfg.min_window_s, q.window * cfg.shrink)
            else:
                q.window = min(cfg.max_window_s, max(budget, cfg.min_window_s),
                               q.window * cfg.grow)
