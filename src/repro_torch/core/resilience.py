"""Resilience primitives: deadlines, retry budgets, breakers, admission.

The cold-path thesis only survives production if failure handling does not
amplify failures. This module is the one place those mechanisms live; the
serving stack threads them through rather than re-inventing them per layer:

* :class:`Deadline` — an absolute per-request deadline minted at the gateway,
  carried on the request's Timeline through dispatcher attempts and into
  BootPlan stages as cooperative cancellation (a boot that cannot finish in
  time aborts at the next stage/chunk boundary instead of squatting a slot);
* :class:`BackoffPolicy` + :class:`RetryBudget` — retries wait exponentially
  longer (with jitter, deterministic under a seeded rng) and draw from a
  token bucket refilled per submitted request, so a chaos event produces a
  bounded trickle of re-dispatches, never a retry storm;
* :class:`CircuitBreaker` / :class:`BreakerBoard` — per-target (host, peer,
  store) closed -> open -> half-open state machines. The scheduler reads the
  board to QUARANTINE open hosts out of routing and lets half-open probe
  traffic revive them, instead of blending a flaky host into the score;
* :class:`AdmissionController` — SLO-aware front door: sheds requests whose
  deadline is already infeasible, and flips the gateway into *brownout* under
  overload (hedging off, streamed boots fall back to eager restore, coalescer
  windows clamp to minimum).

Everything here is clock-pluggable (:mod:`repro_torch.core.simclock`), so the
virtual-clock scale harness can prove the no-amplification property at 10^4+
requests in wall-clock seconds.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

from repro_torch.core import metrics


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or during) an attempt/boot."""


class AdmissionRejected(RuntimeError):
    """The gateway shed this request before dispatch (infeasible deadline)."""


class Deadline:
    """An absolute deadline on a pluggable clock.

    Cheap enough to consult per boot stage and per streamed chunk: one float
    compare against ``now()``. ``None`` deadlines are represented by absent
    objects, not sentinel values — callers guard with ``if deadline:``.
    """

    __slots__ = ("t_deadline", "_now")

    def __init__(self, t_deadline: float, now_fn: Callable[[], float]) -> None:
        self.t_deadline = float(t_deadline)
        self._now = now_fn

    @classmethod
    def after(cls, budget_s: float, clock=None) -> "Deadline":
        clock = clock if clock is not None else metrics.get_clock()
        return cls(clock.now() + budget_s, clock.now)

    def remaining(self) -> float:
        return self.t_deadline - self._now()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, where: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the deadline has passed."""
        rem = self.remaining()
        if rem <= 0.0:
            suffix = f" at {where}" if where else ""
            raise DeadlineExceeded(
                f"deadline exceeded{suffix} ({-rem * 1e3:.1f} ms past)")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Deadline remaining={self.remaining():.3f}s>"


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with full-range-down jitter.

    ``delay(n, rng)`` for attempt n (0-based retry index) is
    ``min(cap, base * factor**n)`` scaled by ``uniform(1 - jitter, 1)`` — the
    jitter decorrelates retries that failed together (a killed host fails a
    whole slot-queue at one instant; without jitter they all re-land at the
    same tick on the same next-best host).
    """

    base_s: float = 0.025
    factor: float = 2.0
    cap_s: float = 2.0
    jitter: float = 0.5

    def delay(self, attempt: int, rng) -> float:
        d = min(self.cap_s, self.base_s * self.factor ** max(int(attempt), 0))
        return d * (1.0 - self.jitter * rng.random())


class RetryBudget:
    """Token-bucket retry budget: deposits per submitted request, spends per
    retry. With ``fraction=0.2`` sustained retries are capped at 20% of
    traffic no matter how hard the fleet flakes — the classic anti-storm
    bound. ``floor`` tokens are always available so a cold start can still
    retry, and ``cap`` bounds how much quiet-period credit can accumulate.
    """

    def __init__(self, fraction: float = 0.2, floor: float = 10.0,
                 cap: float = 1000.0) -> None:
        self.fraction = float(fraction)
        self.floor = float(floor)
        self.cap = float(cap)
        self._tokens = self.floor
        self._lock = threading.Lock()
        self.deposits = 0
        self.spent = 0
        self.denied = 0

    def deposit(self) -> None:
        with self._lock:
            self.deposits += 1
            self._tokens = min(self.cap, self._tokens + self.fraction)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probes.

    CLOSED counts consecutive failures; at ``failures`` it OPENs for
    ``cooldown_s``. The first ``allow()`` after cooldown flips to HALF_OPEN
    and admits up to ``probes`` concurrent trial requests; a probe success
    re-CLOSEs, a probe failure re-OPENs for another cooldown. ``health`` is
    the scheduler-facing score: 1.0 closed, 0.5 half-open, 0.0 open.
    """

    def __init__(self, failures: int = 5, cooldown_s: float = 30.0,
                 probes: int = 1,
                 now_fn: Optional[Callable[[], float]] = None) -> None:
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_s)
        self.probes = int(probes)
        self._now = now_fn if now_fn is not None else metrics.now
        self._lock = threading.Lock()
        self.state = CLOSED
        self._consecutive = 0
        self._t_retry = 0.0
        self._probes_inflight = 0
        self.opens = 0                 # transitions into OPEN (incl. re-opens)
        self.probe_revivals = 0        # HALF_OPEN -> CLOSED transitions

    def gate(self) -> str:
        """Tri-state admission: ``"ok"`` (closed), ``"probe"`` (half-open,
        one probe slot consumed — pair with a ``record_*`` or
        ``release_probe``), or ``"blocked"`` (open / probe slots full).

        The tri-state exists for callers that gate MANY targets and then
        pick one (the scheduler): they release the probe slots of the
        half-open hosts they considered but did not choose, so an unchosen
        recovering host can never wedge in HALF_OPEN with its slots leaked.
        """
        with self._lock:
            if self.state == CLOSED:
                return "ok"
            if self.state == OPEN:
                if self._now() < self._t_retry:
                    return "blocked"
                self.state = HALF_OPEN
                self._probes_inflight = 0
            if self._probes_inflight < self.probes:
                self._probes_inflight += 1
                return "probe"
            return "blocked"

    def allow(self) -> bool:
        """May traffic target this breaker's subject right now?

        In HALF_OPEN each True consumes one probe slot; the slot is released
        by the next ``record_success``/``record_failure``.
        """
        return self.gate() != "blocked"

    def release_probe(self) -> None:
        """Return an unused probe slot (the caller gated but sent no traffic)."""
        with self._lock:
            if self.state == HALF_OPEN and self._probes_inflight > 0:
                self._probes_inflight -= 1

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self.state == HALF_OPEN:
                self.state = CLOSED
                self._probes_inflight = 0
                self.probe_revivals += 1

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self.state == HALF_OPEN or (
                    self.state == CLOSED and self._consecutive >= self.failures):
                self.state = OPEN
                self.opens += 1
                self._probes_inflight = 0
                self._t_retry = self._now() + self.cooldown_s

    @property
    def health(self) -> float:
        with self._lock:
            return {CLOSED: 1.0, HALF_OPEN: 0.5, OPEN: 0.0}[self.state]


class BreakerBoard:
    """Registry of named circuit breakers sharing one clock.

    Targets are free-form strings (``host:3``, ``peer``, ``store``). The
    board is created by whoever owns the topology (the scheduler) and the
    clock is bound later by whoever owns time (the dispatcher) — breakers
    read it through the board, so a late ``bind_clock`` retrofits every
    existing breaker.
    """

    def __init__(self, failures: int = 5, cooldown_s: float = 30.0,
                 probes: int = 1, clock=None) -> None:
        self.failures = failures
        self.cooldown_s = cooldown_s
        self.probes = probes
        self._clock = clock if clock is not None else metrics.get_clock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def bind_clock(self, clock) -> None:
        self._clock = clock

    def _now(self) -> float:
        return self._clock.now()

    def breaker(self, target: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(target)
            if b is None:
                b = self._breakers[target] = CircuitBreaker(
                    self.failures, self.cooldown_s, self.probes,
                    now_fn=self._now)
            return b

    def allow(self, target: str) -> bool:
        with self._lock:
            b = self._breakers.get(target)
        # no breaker yet = no failures yet: allow without materializing one
        return True if b is None else b.allow()

    def gate(self, target: str) -> str:
        with self._lock:
            b = self._breakers.get(target)
        return "ok" if b is None else b.gate()

    def release_probe(self, target: str) -> None:
        with self._lock:
            b = self._breakers.get(target)
        if b is not None:
            b.release_probe()

    def record(self, target: str, ok: bool) -> None:
        b = self.breaker(target)
        b.record_success() if ok else b.record_failure()

    # --------------------------------------------------------- host shorthand
    @staticmethod
    def host_target(host_id: int) -> str:
        return f"host:{host_id}"

    def allow_host(self, host_id: int) -> bool:
        return self.allow(self.host_target(host_id))

    def gate_host(self, host_id: int) -> str:
        return self.gate(self.host_target(host_id))

    def release_probe_host(self, host_id: int) -> None:
        self.release_probe(self.host_target(host_id))

    def record_host(self, host_id: int, ok: bool) -> None:
        self.record(self.host_target(host_id), ok)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            items = list(self._breakers.items())
        states = {t: b.state for t, b in items}
        return {
            "opens": sum(b.opens for _, b in items),
            "probe_revivals": sum(b.probe_revivals for _, b in items),
            "open_now": sorted(t for t, s in states.items() if s == OPEN),
            "half_open_now": sorted(t for t, s in states.items()
                                    if s == HALF_OPEN),
            "targets": len(items),
        }


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Gateway/dispatcher resilience knobs (Gateway(resilience=...) accepts one)."""

    # deadline attached to every invoke when the caller passes none; None
    # keeps requests deadline-free (the seed behavior)
    default_deadline_s: Optional[float] = None
    backoff: BackoffPolicy = BackoffPolicy()
    # retry-budget token bucket: deposit per submit, spend per retry
    retry_fraction: float = 0.2
    retry_floor: float = 10.0
    retry_cap: float = 1000.0
    # admission control: brownout enters when in-flight requests exceed
    # hi x fleet slot capacity, exits below lo x capacity (hysteresis)
    brownout_hi: float = 3.0
    brownout_lo: float = 1.5
    # shed a deadlined request outright when its remaining budget is below
    # this floor (an estimate of the minimum feasible service time)
    shed_floor_s: float = 0.0


class AdmissionController:
    """SLO-aware front door: shed infeasible work early, brown out under load.

    Cheap by design — one lock, two counters — because it sits on every
    ``invoke``. Brownout is keyed off in-flight count vs fleet slot capacity
    (virtual-clock friendly: no wall-time windows), with hysteresis so the
    mode doesn't flap at the threshold. ``service_ewma`` tracks observed e2e
    seconds; during brownout it also backs the feasibility shed, so a
    deadline shorter than what the overloaded system is actually delivering
    is rejected in O(1) instead of timing out a host slot later.
    """

    def __init__(self, cfg: ResilienceConfig, capacity_slots: int) -> None:
        self.cfg = cfg
        self.capacity = max(int(capacity_slots), 1)
        self._lock = threading.Lock()
        self._inflight = 0
        self.brownout = False
        self.service_ewma: Optional[float] = None
        self.admitted = 0
        self.shed = 0
        self.brownout_entries = 0

    def try_admit(self, deadline: Optional[Deadline] = None) -> None:
        """Admit or raise :class:`AdmissionRejected`; admitted requests must
        be paired with exactly one ``release``."""
        with self._lock:
            if not self.brownout and \
                    self._inflight >= self.capacity * self.cfg.brownout_hi:
                self.brownout = True
                self.brownout_entries += 1
            if deadline is not None:
                rem = deadline.remaining()
                infeasible = rem <= self.cfg.shed_floor_s or (
                    self.brownout and self.service_ewma is not None
                    and rem < self.service_ewma)
                if infeasible:
                    self.shed += 1
                    raise AdmissionRejected(
                        f"shed: {rem * 1e3:.1f} ms budget is infeasible"
                        f"{' (brownout)' if self.brownout else ''}")
            self._inflight += 1
            self.admitted += 1

    def release(self, e2e_s: Optional[float] = None) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if e2e_s is not None and e2e_s >= 0.0:
                prev = self.service_ewma
                self.service_ewma = e2e_s if prev is None \
                    else 0.9 * prev + 0.1 * e2e_s
            if self.brownout and \
                    self._inflight <= self.capacity * self.cfg.brownout_lo:
                self.brownout = False

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {
                "admitted": float(self.admitted),
                "shed": float(self.shed),
                "inflight": float(self._inflight),
                "brownout": float(self.brownout),
                "brownout_entries": float(self.brownout_entries),
                "service_ewma_ms": (self.service_ewma or 0.0) * 1e3,
            }
