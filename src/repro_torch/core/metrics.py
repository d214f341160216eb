"""Latency / residency metrics with the paper's reporting conventions.

The paper reports boxplots with whiskers at the 1st/99th percentile (Sec III-B) and
medians (Table I). ``LatencyStats`` reproduces exactly those statistics; ``Timeline``
records the per-request phase breakdown (queue wait / startup / execution), mirroring
the cold-start decomposition in Sec III-C; ``ResidencyTracker`` integrates
device-memory-seconds so the warm-pool "resource waste" claim is measurable.

Invariants: every request gets exactly one Timeline per recorder label (batch
members each get their own view sharing the batch's boot/exec stamps but
keeping their own enqueue stamp); ``t_boot_wall <= sum(stage_s)`` — the gap is
the overlap win, never negative accounting; ``bytes_fetched``/``bytes_deduped``
only ever accumulate (one delta restore per boot, summed across retries).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.simclock import REAL, Clock


@dataclasses.dataclass
class LatencyStats:
    """Paper-style summary: median + quartiles + p1/p99 whiskers (+p95 for load)."""

    n: int
    p1: float
    p25: float
    p50: float
    p75: float
    p95: float
    p99: float
    mean: float

    @classmethod
    def from_samples(cls, samples_s: List[float]) -> "LatencyStats":
        a = np.asarray(samples_s, dtype=np.float64) * 1e3  # report in ms like the paper
        if a.size == 0:
            return cls(0, *([float("nan")] * 7))
        q = np.percentile(a, [1, 25, 50, 75, 95, 99])
        return cls(int(a.size), float(q[0]), float(q[1]), float(q[2]), float(q[3]),
                   float(q[4]), float(q[5]), float(a.mean()))

    def row(self) -> str:
        return (f"n={self.n:5d}  p1={self.p1:9.3f}  p25={self.p25:9.3f}  "
                f"p50={self.p50:9.3f}  p75={self.p75:9.3f}  p95={self.p95:9.3f}  "
                f"p99={self.p99:9.3f} ms")


class P2Quantile:
    """Jain & Chlamtac's P-square streaming quantile estimator.

    O(1) memory and O(1) per observation — five markers track the target
    quantile without retaining the sample window, so a per-request hot path
    (the dispatcher's hedge-deadline check) never sorts or percentiles a
    buffer under a lock.
    """

    def __init__(self, p: float = 0.95) -> None:
        assert 0.0 < p < 1.0
        self.p = p
        self.n = 0
        self._init: List[float] = []          # first five observations
        self._q: List[float] = []             # marker heights
        self._pos: List[float] = []           # marker positions (1-based)
        self._want: List[float] = []          # desired positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def observe(self, x: float) -> None:
        self.n += 1
        if not self._q:
            self._init.append(float(x))
            if len(self._init) == 5:
                self._init.sort()
                self._q = list(self._init)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                p = self.p
                self._want = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
            return
        q, pos = self._q, self._pos
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = next(i - 1 for i in range(1, 5) if x < q[i])
        for i in range(k + 1, 5):
            pos[i] += 1
        for i in range(5):
            self._want[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if (d >= 1 and pos[i + 1] - pos[i] > 1) or \
                    (d <= -1 and pos[i - 1] - pos[i] < -1):
                s = 1 if d >= 0 else -1
                qn = self._parabolic(i, s)
                if not (q[i - 1] < qn < q[i + 1]):
                    qn = self._linear(i, s)
                q[i] = qn
                pos[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        q, n = self._q, self._pos
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, s: int) -> float:
        q, n = self._q, self._pos
        return q[i] + s * (q[i + s] - q[i]) / (n[i + s] - n[i])

    @property
    def value(self) -> float:
        """Current quantile estimate (exact percentile while n < 5)."""
        if self._q:
            return self._q[2]
        if not self._init:
            return float("nan")
        return float(np.percentile(self._init, self.p * 100))


class Series:
    """Thread-safe stream of scalar samples with count/mean/summary queries.

    The batching layer uses these for its batch-size / queue-delay /
    boots-per-request series without dragging a Recorder (which is keyed by
    Timeline fields) into non-latency measurements.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._samples: List[float] = []

    def add(self, value: float) -> None:
        with self._lock:
            self._samples.append(float(value))

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def mean(self) -> float:
        with self._lock:
            if not self._samples:
                return float("nan")
            return float(np.mean(self._samples))

    def stats(self) -> LatencyStats:
        with self._lock:
            return LatencyStats.from_samples(self._samples)


# boot-stage -> coarse bucket, for the paper-style two-column summary:
# "program" = acquire the compiled program (fetch/deserialize or trace/compile;
# the tiered-cache variants record which source actually served the bytes),
# "weights" = materialize weights on the device (host restore + device_put).
PROGRAM_STAGES = ("fetch_program", "fetch_program_cached", "fetch_peer",
                  "deserialize_program", "deserialize_program_bg",
                  "trace_compile", "fetch_parked")
WEIGHT_STAGES = ("restore_weights_host", "restore_weights_cached",
                 "restore_weights_peer", "restore_delta", "fetch_chunks_peer",
                 "fetch_chunks_store", "device_put", "alias_donor",
                 "restore_stream_head", "restore_stream_tail_bg")


@dataclasses.dataclass
class Timeline:
    """Per-request phase timestamps (seconds, monotonic clock)."""

    t_enqueue: float = 0.0
    t_dispatch: float = 0.0          # dispatcher picked it up
    t_start_begin: float = 0.0       # executor instantiation began
    t_exec_begin: float = 0.0        # function body began
    t_done: float = 0.0
    # startup decomposition (paper Sec III-C: runtime layers), filled by the
    # BootEngine: stage name -> seconds, plus the combined boot wall time.
    # Because the program and weights tracks overlap, t_boot_wall can be LESS
    # than sum(stage_s.values()) — that gap is the overlap win.
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    t_boot_wall: float = 0.0
    # streaming-restore stamps (absolute, monotonic clock; 0.0 = not stamped):
    # t_first_ready = the executor could first accept a request (PARTIAL counts
    # — its head gates were open), t_ttfr = the first response token of this
    # request's execution existed. For an eager boot both coincide with full
    # restore; for a streamed boot they land while the tail is still moving.
    t_first_ready: float = 0.0
    t_ttfr: float = 0.0
    preboot: bool = False            # boot ran speculatively while queued
    # the speculation was FORECAST-driven: a PreBootPlanner parked this boot
    # ahead of the predicted arrival and the dispatcher claimed it
    planner_preboot: bool = False
    # coalescing: how many requests shared this executor's boot (1 = unbatched).
    # Member timelines of one batch share every stamp except t_enqueue, so
    # queue_wait stays per-request while startup/execution are the batch's.
    batch_size: int = 1
    # delta restore accounting (repro.core.blobstore): bytes that actually
    # moved for this boot's weights vs bytes already resident in the host
    # chunk tier. bytes_fetched << snapshot size is the dedup win.
    bytes_fetched: float = 0.0
    bytes_deduped: float = 0.0
    # integrity accounting (repro.core.blobstore): chunks whose BLAKE2 digest
    # was re-checked on read, and chunks that FAILED a peer-side check and
    # were transparently re-fetched from the global store. refetched > 0 with
    # a correct restore is the integrity layer working; a mismatch with no
    # fallback tier raises instead of serving wrong bytes.
    chunks_rehashed: float = 0.0
    chunks_refetched: float = 0.0
    # per-request deadline (repro.core.resilience.Deadline or None), attached
    # at the gateway and consulted by dispatcher attempts and boot stages
    deadline: Optional[Any] = None

    def record_boot(self, stage_s: Dict[str, float], wall_s: float,
                    bytes_fetched: float = 0.0,
                    bytes_deduped: float = 0.0,
                    t_first_ready: float = 0.0,
                    chunks_rehashed: float = 0.0,
                    chunks_refetched: float = 0.0) -> None:
        self.stage_s.update(stage_s)
        self.t_boot_wall += wall_s
        self.bytes_fetched += bytes_fetched
        self.bytes_deduped += bytes_deduped
        self.chunks_rehashed += chunks_rehashed
        self.chunks_refetched += chunks_refetched
        if t_first_ready:
            self.t_first_ready = t_first_ready

    @property
    def t_program(self) -> float:
        """Back-compat coarse bucket: time acquiring the compiled program."""
        return sum(self.stage_s.get(k, 0.0) for k in PROGRAM_STAGES)

    @property
    def t_weights(self) -> float:
        """Back-compat coarse bucket: time materializing weights on device."""
        return sum(self.stage_s.get(k, 0.0) for k in WEIGHT_STAGES)

    @property
    def boot_overlap_saved(self) -> float:
        """Seconds saved by running boot stages concurrently (>= 0)."""
        return max(0.0, sum(self.stage_s.values()) - self.t_boot_wall)

    def for_member(self, t_enqueue: float, batch_size: int) -> "Timeline":
        """A member-request view of a batch timeline: own enqueue stamp (so
        queue-delay includes the coalescing window), shared boot/exec stamps."""
        member = dataclasses.replace(self, t_enqueue=t_enqueue,
                                     batch_size=batch_size)
        return member

    @property
    def boots_share(self) -> float:
        """This request's share of one executor boot (1/batch_size)."""
        return 1.0 / max(self.batch_size, 1)

    @property
    def ttfr(self) -> float:
        """Time-to-first-response: executor start to first response token.

        Boot-relative on purpose (same origin as ``t_boot_wall``) so the
        streamed-vs-eager comparison is between commensurate quantities;
        0.0 when the boot path never stamped ``t_ttfr`` (warm/batch paths).
        """
        if not self.t_ttfr:
            return 0.0
        return self.t_ttfr - self.t_start_begin

    @property
    def queue_wait(self) -> float:
        return self.t_dispatch - self.t_enqueue

    @property
    def startup(self) -> float:
        return self.t_exec_begin - self.t_start_begin

    @property
    def execution(self) -> float:
        return self.t_done - self.t_exec_begin

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_enqueue


class Recorder:
    """Thread-safe collection of per-request timelines, grouped by label."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._groups: Dict[str, List[Timeline]] = {}

    def add(self, label: str, tl: Timeline) -> None:
        with self._lock:
            self._groups.setdefault(label, []).append(tl)

    def stats(self, label: str, field: str = "e2e") -> LatencyStats:
        with self._lock:
            tls = list(self._groups.get(label, []))
        return LatencyStats.from_samples([getattr(t, field) for t in tls])

    def labels(self) -> List[str]:
        with self._lock:
            return sorted(self._groups)

    def timelines(self, label: str) -> List[Timeline]:
        with self._lock:
            return list(self._groups.get(label, []))


class ResidencyTracker:
    """Integrates bytes x seconds of device residency, split busy vs idle.

    The paper's core resource argument: warm pools hold memory while idle. Every
    executor reports (bytes, busy intervals); idle byte-seconds = total - busy.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.total_byteseconds = 0.0
        self.busy_byteseconds = 0.0

    def add_residency(self, nbytes: int, resident_s: float, busy_s: float) -> None:
        with self._lock:
            self.total_byteseconds += nbytes * resident_s
            self.busy_byteseconds += nbytes * min(busy_s, resident_s)

    @property
    def idle_byteseconds(self) -> float:
        return self.total_byteseconds - self.busy_byteseconds

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {
                "total_GBs": self.total_byteseconds / 1e9,
                "busy_GBs": self.busy_byteseconds / 1e9,
                "idle_GBs": (self.total_byteseconds - self.busy_byteseconds) / 1e9,
            }


_clock: "Clock" = REAL


def get_clock() -> "Clock":
    """The process-default clock (REAL unless a test/harness installed one)."""
    return _clock


def set_clock(clock: "Clock | None") -> "Clock":
    """Install a process-default clock; returns the previous one.

    Most consumers take an explicit ``clock=`` parameter — prefer that. This
    global exists for the bare ``now()`` call sites (Timeline stamping deep in
    drivers/boot) that predate injection; the scale harness injects clocks
    explicitly and never touches it.
    """
    global _clock
    prev = _clock
    _clock = clock if clock is not None else REAL
    return prev


@contextlib.contextmanager
def use_clock(clock: "Clock"):
    """Temporarily install ``clock`` as the process default (tests)."""
    prev = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(prev)


def now() -> float:
    return _clock.now()
