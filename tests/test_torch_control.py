"""The port's control-plane modules on the CPU, held against the JAX package.

* the timer wheel, backoff, retry budget, circuit breakers and admission
  control make the same decisions as the JAX copies on one clock;
* the scheduler routes as the JAX one does with warm program and chunk
  tiers, peer fetches, load and quarantine;
* the dispatcher retries on ``HostFailure`` on another host, hedges strictly
  (one backup on a distinct host, none without one), refuses retries its
  budget or deadline cannot pay for, and cancels a losing speculative boot.
"""
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core import dispatcher as jax_dispatcher
from repro.core import resilience as jax_resilience
from repro.core import timerwheel as jax_timerwheel
from repro.core.cluster import Cluster as JaxCluster
from repro.core.cluster import HostFailure as JaxHostFailure
from repro.core.scheduler import ProgramArtifact as JaxProgramArtifact
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.core.simclock import VirtualClock as JaxVirtualClock
from repro_torch.core import dispatcher, resilience, timerwheel
from repro_torch.core.boot import (
    ENGINE, TRACK_PROGRAM, TRACK_WEIGHTS, BootCancelled, BootPlan, Finalize, Stage,
)
from repro_torch.core.cluster import Cluster, HostFailure
from repro_torch.core.metrics import now
from repro_torch.core.resilience import DeadlineExceeded
from repro_torch.core.scheduler import ProgramArtifact, SchedulerConfig
from repro_torch.core.simclock import VirtualClock

PORT = types.SimpleNamespace(cluster=Cluster, failure=HostFailure, cfg=SchedulerConfig,
                             artifact=ProgramArtifact, clock=VirtualClock,
                             dispatcher=dispatcher, resilience=resilience,
                             timerwheel=timerwheel)
JAX = types.SimpleNamespace(cluster=JaxCluster, failure=JaxHostFailure,
                            cfg=JaxSchedulerConfig, artifact=JaxProgramArtifact,
                            clock=JaxVirtualClock, dispatcher=jax_dispatcher,
                            resilience=jax_resilience, timerwheel=jax_timerwheel)


class _Clock:
    """A settable clock both packages' breakers and deadlines can read."""

    def __init__(self, t=0.0):
        self.t = t

    def now(self):
        return self.t


# ------------------------------------------------------------------ timer

def _timer_run(pkg):
    clock = pkg.clock()
    timer = pkg.timerwheel.DeadlineTimer("t", clock=clock)
    fired = []

    def note(name):
        def fn():
            fired.append((round(clock.now(), 9), name))
            if name == "a":                       # schedule from inside a callback
                timer.schedule(0.25, note("from-a"))
        return fn

    entries = {n: timer.schedule(d, note(n)) for n, d in
               (("a", 1.0), ("b", 0.5), ("c", 2.0), ("d", 0.5), ("e", 1.5))}
    entries["c"].cancel()
    clock.run_until(1.2)
    pending = timer.pending()
    clock.run_until_idle()
    timer.close()
    late = timer.schedule(0.1, note("after-close"))
    clock.run_until_idle()
    return fired, pending, late.cancelled


def test_timer_wheel_fires_like_jax_on_a_virtual_clock():
    got = _timer_run(PORT)
    assert got == _timer_run(JAX)
    assert got[0] == [(0.5, "b"), (0.5, "d"), (1.0, "a"), (1.25, "from-a"), (1.5, "e")]
    assert got[2] is True                         # closed: never fires


def test_timer_wheel_on_the_real_clock_fires_once_and_close_joins():
    timer = timerwheel.DeadlineTimer("real")
    hits = []
    done = threading.Event()
    timer.schedule(0.01, lambda: (hits.append(1), done.set()))
    cancelled = timer.schedule(0.02, lambda: hits.append(2))
    cancelled.cancel()
    assert done.wait(5)
    time.sleep(0.05)
    timer.close()
    assert hits == [1] and timer.pending() == 0
    assert not [t for t in threading.enumerate() if t.name == "real"]


# ------------------------------------------------------------- resilience

def test_backoff_policy_matches_jax():
    for args in ({}, {"base_s": 0.1, "factor": 3.0, "cap_s": 0.5, "jitter": 0.25}):
        p, j = resilience.BackoffPolicy(**args), jax_resilience.BackoffPolicy(**args)
        r1, r2 = random.Random(7), random.Random(7)
        assert [p.delay(n, r1) for n in range(12)] == [j.delay(n, r2) for n in range(12)]


def _budget_run(pkg):
    rng = np.random.default_rng(1)
    b = pkg.resilience.RetryBudget(fraction=0.3, floor=2.0, cap=4.0)
    out = []
    for _ in range(200):
        if rng.random() < 0.5:
            b.deposit()
            out.append(("d", b.tokens))
        else:
            out.append(("s", b.try_spend(), b.tokens))
    return out, (b.deposits, b.spent, b.denied)


def test_retry_budget_matches_jax():
    assert _budget_run(PORT) == _budget_run(JAX)


def _breaker_run(pkg):
    rng = np.random.default_rng(2)
    clock = _Clock()
    br = pkg.resilience.CircuitBreaker(failures=3, cooldown_s=5.0, probes=2,
                                       now_fn=clock.now)
    board = pkg.resilience.BreakerBoard(failures=2, cooldown_s=3.0, probes=1)
    board.bind_clock(clock)
    out = []
    for _ in range(300):
        clock.t += float(rng.choice([0.0, 0.5, 2.0]))
        op = int(rng.integers(0, 5))
        target = f"host:{int(rng.integers(0, 3))}"
        if op == 0:
            r = (br.gate(), board.gate(target))
        elif op == 1:
            br.record_success(), board.record(target, True)
            r = None
        elif op == 2:
            br.record_failure(), board.record(target, False)
            r = None
        elif op == 3:
            br.release_probe(), board.release_probe(target)
            r = None
        else:
            r = (br.allow(), board.allow(target))
        out.append((r, br.state, br.health, br.opens, br.probe_revivals, board.summary()))
    return out


def test_circuit_breakers_match_jax_on_one_clock():
    got = _breaker_run(PORT)
    assert got == _breaker_run(JAX)
    assert {s for _, s, *_ in got} == {"closed", "open", "half-open"}


def _admission_run(pkg):
    rng = np.random.default_rng(3)
    clock = _Clock(100.0)
    cfg = pkg.resilience.ResilienceConfig(brownout_hi=1.5, brownout_lo=0.5, shed_floor_s=0.05)
    adm = pkg.resilience.AdmissionController(cfg, capacity_slots=4)
    out = []
    for _ in range(300):
        clock.t += 0.01
        if rng.random() < 0.6:
            budget = float(rng.choice([0.0, 0.02, 0.5, 3.0, -1.0]))
            deadline = None if budget < 0 else pkg.resilience.Deadline.after(budget, clock)
            try:
                adm.try_admit(deadline)
                out.append(("admit", adm.brownout))
            except pkg.resilience.AdmissionRejected as e:
                out.append(("shed", str(e)))
        elif adm.inflight:
            adm.release(float(rng.choice([0.1, 1.0, 4.0])))
            out.append(("release", adm.brownout))
        out.append(adm.summary())
    return out


def test_admission_control_matches_jax():
    got = _admission_run(PORT)
    assert got == _admission_run(JAX)
    kinds = {x[0] for x in got if isinstance(x, tuple)}
    assert kinds == {"admit", "shed", "release"}


def test_deadline_and_resilience_config_match_jax():
    clock = _Clock(5.0)
    for pkg in (PORT, JAX):
        d = pkg.resilience.Deadline.after(0.5, clock)
        assert (d.remaining(), d.expired()) == (0.5, False)
    assert str(resilience.ResilienceConfig()) == \
        str(jax_resilience.ResilienceConfig()).replace("repro.core", "repro_torch.core")


# -------------------------------------------------------------- scheduler

def _routes(pkg):
    """Routes of 16 keys as tiers warm, peers serve, load piles up and a host
    is quarantined, then revived by a probe after its cooldown."""
    clock = _Clock()
    c = pkg.cluster(n_hosts=4, slots_per_host=4,
                    scheduler=pkg.cfg(breaker_failures=2, breaker_cooldown_s=10.0))
    c.scheduler.breakers.bind_clock(clock)
    keys = [f"img{i}" for i in range(16)]
    gate = threading.Event()
    out = []
    try:
        def routes():
            out.append([c.route(k).host_id for k in keys])
        routes()
        for i, k in enumerate(keys[:8]):         # programs cached on some hosts
            c.hosts[i % 4].cache.insert("program", k, pkg.artifact(b"p" * (i + 1)), i + 1)
        for i, k in enumerate(keys[4:12]):       # snapshots resident on others
            cache = c.hosts[(i + 1) % 4].cache
            cache.snapshots.register(k, {f"{k}-c": b"x" * 8}, 8)
            cache.publish_snapshot(k)
        routes()
        got = c.hosts[3].cache.fetch_from_peer("program", keys[0])   # host 0 serves it
        out.append((got.payload, got.loaded, c.hosts[3].cache.programs.contains(keys[0])))
        out.append(sorted(c.hosts[3].cache.fetch_chunks_from_peer(keys[5], [f"{keys[5]}-c"])))
        for hid in (0, 0, 1):                    # in-flight load on hosts 0 and 1
            c.host_by_id(hid).submit(gate.wait)
        routes()
        for _ in range(2):                       # host 2 fails twice: quarantined
            c.scheduler.breakers.record_host(2, False)
        routes()
        clock.t = 11.0                           # cooldown over: one probe admitted
        routes()
        c.scheduler.breakers.record_host(2, True)  # the probe succeeded: closed again
        routes()
        out.append([c.route(k, exclude={0, 1}).host_id for k in keys])
        with pytest.raises(pkg.failure):
            c.route(keys[0], exclude={0, 1, 2, 3}, strict=True)
        # every counter, the streamed restores' and the forecast planner's
        # prefetches included; only the hosts' live load is left out
        s = c.scheduler.summary()
        for hid, h in s["hosts"].items():
            s["hosts"][hid] = {k: v for k, v in h.items() if k != "load"}
        out.append(s)
    finally:
        gate.set()
        c.shutdown()
    return out


def test_scheduler_routes_like_jax_with_warm_tiers_peers_load_and_quarantine():
    got = _routes(PORT)
    assert got == _routes(JAX)
    summary = got[-1]
    assert summary["quarantine_skips"] > 0 and summary["affinity_routed"] > 0
    assert summary["breakers"]["probe_revivals"] == 1
    assert got[2] == (b"p", None, True)          # bytes travel, no loaded memo


def test_program_artifact_peer_copy_drops_the_loaded_memo():
    a = ProgramArtifact(b"abc", loaded="module")
    b = a.peer_copy()
    assert (b.payload, b.loaded, b.nbytes) == (b"abc", None, 3)


def test_scheduler_config_defaults_match_jax():
    assert str(SchedulerConfig()) == str(JaxSchedulerConfig())
    assert SchedulerConfig().snapshot_tier_bytes == 2 << 30


def test_cluster_hosts_carry_their_own_cache_and_drivers():
    c = Cluster(n_hosts=2, on_exit=lambda ex: None)
    try:
        h0, h1 = c.hosts
        assert h0.cache is not h1.cache and h0.cache.host_id == 0
        assert h0.drivers["unikernel"].host is h0 and h1.drivers["unikernel"].host is h1
        h2 = c.add_host()
        assert h2.cache.host_id == 2 and h2.drivers["unikernel"].host is h2
    finally:
        c.shutdown()


# ------------------------------------------------------------- dispatcher

class _FakeAgent:
    """Records which host served each attempt; ``behavior(n)`` returns,
    raises or sleeps."""

    def __init__(self, behavior):
        self.behavior = behavior
        self.calls = []
        self._lock = threading.Lock()

    def handle(self, host, dep, tokens, driver_name, tl, label, preboot=None):
        with self._lock:
            n = len(self.calls)
            self.calls.append(host.host_id)
        tl.t_dispatch = tl.t_dispatch or now()
        out = self.behavior(n)
        tl.t_done = now()
        return out


def _dispatch(pkg, behavior, n_hosts=2, submit_kw=None, seed_p95=None, **kw):
    cluster = pkg.cluster(n_hosts=n_hosts, slots_per_host=2)
    agent = _FakeAgent(behavior)
    disp = pkg.dispatcher.Dispatcher(cluster, agent, **kw)
    if seed_p95 is not None:
        for _ in range(10):
            disp.latency.observe("noop:proc", seed_p95)
    try:
        fut = disp.submit(None, [1], "proc", **(submit_kw or {}))
        try:
            result = fut.result(timeout=10)
        except Exception as e:                  # noqa: BLE001 - compared below
            result = type(e).__name__
        time.sleep(0.05)
        return (result, agent.calls, disp.retries, disp.retries_denied,
                disp.hedges_launched, disp.attempts)
    finally:
        disp.close()
        cluster.shutdown()


def _fail_first(pkg):
    def behavior(n):
        if n == 0:
            raise pkg.failure("injected")
        return "ok"
    return behavior


@pytest.mark.parametrize("case", ["retry", "exhaust", "not-retryable", "budget"])
def test_dispatcher_retries_like_jax(case):
    def run(pkg):
        if case == "retry":
            return _dispatch(pkg, _fail_first(pkg), hedging=False)
        if case == "exhaust":
            def always(n):
                raise pkg.failure(f"attempt {n}")
            return _dispatch(pkg, always, n_hosts=3, max_retries=3, hedging=False)
        if case == "not-retryable":
            def bad(n):
                raise ValueError("bad input")
            return _dispatch(pkg, bad, hedging=False)
        cfg = pkg.resilience.ResilienceConfig(retry_floor=0.0, retry_fraction=0.5)
        return _dispatch(pkg, _fail_first(pkg), hedging=False, resilience=cfg)
    got, want = run(PORT), run(JAX)
    assert got[0] == want[0] or (got[0], want[0]) == ("HostFailure", "HostFailure")
    assert got[1:] == want[1:]
    if case == "retry":
        assert got[0] == "ok" and got[2] == 1 and got[1][0] != got[1][1]
    if case == "exhaust":
        assert got[0] == "HostFailure" and len(got[1]) == 4 and got[2] == 3
    if case == "not-retryable":
        assert got[0] == "ValueError" and len(got[1]) == 1
    if case == "budget":                         # 0.5 tokens: the retry is refused
        assert got[0] == "HostFailure" and got[3] == 1 and len(got[1]) == 1


def test_dispatcher_refuses_a_retry_the_deadline_cannot_wait_for():
    clock = _Clock(0.0)
    deadline = resilience.Deadline(0.001, clock.now)       # less than any backoff
    got = _dispatch(PORT, _fail_first(PORT), hedging=False,
                    submit_kw={"deadline": deadline})
    assert got[0] == "HostFailure" and got[3] == 1 and len(got[1]) == 1
    expired = resilience.Deadline(-1.0, clock.now)
    got = _dispatch(PORT, lambda n: "ok", hedging=False, submit_kw={"deadline": expired})
    assert got[0] == DeadlineExceeded.__name__ and got[1] == []


def _straggler():
    def behavior(n):
        if n == 0:
            time.sleep(1.5)                  # 25x the hedge deadline of 3 x 0.02 s
            return "slow"
        return "fast"
    return behavior


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_dispatcher_hedges_strictly_like_jax(n_hosts):
    got = _dispatch(PORT, _straggler(), n_hosts=n_hosts, hedge_factor=3.0, seed_p95=0.02)
    want = _dispatch(JAX, _straggler(), n_hosts=n_hosts, hedge_factor=3.0, seed_p95=0.02)
    assert got == want
    if n_hosts == 2:                              # one backup, on the other host
        assert got[0] == "fast" and got[4] == 1 and len(set(got[1])) == 2
    else:                                         # no distinct host: stand down
        assert got[0] == "slow" and got[4] == 0 and got[1] == [0]


def test_latency_model_and_transient_classification_match_jax():
    lm, jlm = dispatcher._LatencyModel(), jax_dispatcher._LatencyModel()
    rng = np.random.default_rng(4)
    for x in rng.exponential(0.1, 200):
        lm.observe("k", float(x))
        jlm.observe("k", float(x))
        assert lm.p95("k") == jlm.p95("k")

    class XlaRuntimeError(Exception):
        pass

    errs = [XlaRuntimeError("dead"), RuntimeError("program not found in cache"),
            RuntimeError("CUDA error: an illegal memory access"), ValueError("not found"),
            HostFailure("gone")]
    assert [dispatcher._is_transient(e) for e in errs] == \
        [jax_dispatcher._is_transient(e) for e in errs] == [True, True, False, False, False]


# ------------------------------------------------- speculative pre-boots

class _SleepStage(Stage):
    def __init__(self, name, track, seconds, sets=()):
        self.name, self.track, self.seconds, self.sets = name, track, seconds, sets

    def run(self, ctx):
        time.sleep(self.seconds)
        for attr, value in self.sets:
            setattr(ctx, attr, value)


class _PrebootAgent(_FakeAgent):
    """Launches a real boot (two sleeping tracks + Finalize) per attempt; the
    first attempt fails its host before claiming, the retry claims its own."""

    def __init__(self):
        super().__init__(None)
        self.handles = []

    def preboot(self, host, dep, driver_name):
        plan = BootPlan([
            _SleepStage("deserialize_program", TRACK_PROGRAM, 0.05,
                        sets=[("program", lambda p, t: t)]),
            _SleepStage("device_put", TRACK_WEIGHTS, 0.05,
                        sets=[("params", {"w": torch.zeros(2)})]),
            Finalize()])
        handle = ENGINE.launch(plan, dep, driver_name, host=host)
        self.handles.append(handle)
        return handle

    def handle(self, host, dep, tokens, driver_name, tl, label, preboot=None):
        with self._lock:
            n = len(self.calls)
            self.calls.append(host.host_id)
        if n == 0:
            time.sleep(0.2)                       # the boot finishes unclaimed
            raise HostFailure("host died before the claim")
        result = preboot.claim(10)
        return result.executor


def test_dispatcher_cancels_a_losing_speculative_boot():
    cluster = Cluster(n_hosts=2, slots_per_host=2)
    agent = _PrebootAgent()
    disp = dispatcher.Dispatcher(cluster, agent, hedging=False, speculative=True)
    dep = types.SimpleNamespace(name="fn", image=types.SimpleNamespace(key="img-spec"),
                                device=torch.device("cpu"))
    try:
        ex = disp.submit(dep, None, "unikernel").result(timeout=10)
        assert disp.preboots_launched == 2 and disp.retries == 1
        loser, winner = agent.handles
        deadline = time.time() + 5
        while not loser.done() and time.time() < deadline:
            time.sleep(0.01)
        assert loser.cancelled and loser.done()
        with pytest.raises(BootCancelled):
            loser.claim(1)
        if loser._result is not None:        # it finished first: its executor exited
            assert loser._result.executor.params is None
        else:                                # the cancel stopped it mid-boot
            assert isinstance(loser._error, BootCancelled)
        assert not winner.cancelled and ex.params is not None
        assert agent.calls[0] != agent.calls[1]
    finally:
        disp.close()
        cluster.shutdown()
