"""The port's arrival forecasting and pre-boot planner on the CPU, held
against the JAX package.

* ``RateHistory`` windows (readback, negative-time buckets, quiet gaps, a
  wrapped ring) equal JAX's;
* the EWMA-seasonal and reactive forecasters, built by ``make_forecaster``,
  predict JAX's rates on the same replayed arrivals (the same numpy code:
  equal to float64 rounding), and ``ForecastError`` summarises the same pairs;
* ``LearnedForecaster``: JAX's parameters carried into the port's
  ``ForecastMLP`` (``convert.mlp_from_numpy``) predict JAX's rates within
  rtol 1e-5, and ``fit`` on the same windows, batch order and initial
  parameters gives JAX's per-epoch losses within rtol 1e-4 over 5 epochs;
* ``PreBootPlanner`` under the virtual clock: cool-down on quiet, parked
  pre-boots claimed or expired and never leaked, forecast-error pairs, and a
  tick that never raises into the timer — each with JAX's counts;
* the port ``Gateway(forecast=...)`` gives the JAX Gateway's
  ``forecast_summary`` counts, prefetches and claimed pre-boots on the same
  arrival script, and its shutdown leaves no thread and no parked boot.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
import repro.core.forecast as jax_forecast
from repro.core.gateway import Gateway as JaxGateway
from repro.core.simclock import VirtualClock as JaxVirtualClock
from repro.core.timerwheel import DeadlineTimer as JaxDeadlineTimer
import repro_torch.configs.base as torch_configs
import repro_torch.core.forecast as torch_forecast
from repro_torch.convert import mlp_from_numpy, params_from_numpy
from repro_torch.core import BatchingConfig, ForecastConfig, FunctionSpec, Gateway
from repro_torch.core.metrics import now
from repro_torch.core.simclock import VirtualClock
from repro_torch.core.timerwheel import DeadlineTimer

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
SPEC = dict(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=2)
PKGS = {"jax": (jax_forecast, JaxVirtualClock, JaxDeadlineTimer),
        "torch": (torch_forecast, VirtualClock, DeadlineTimer)}


class FixedClock:
    """now() is whatever the test last set (history reads pass t explicitly)."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def now(self) -> float:
        return self.t


def _sinusoid_arrivals(seed, duration, base=60.0, amplitude=0.9, period=60.0, t0=0.0):
    """Arrival times of a Poisson process of rate base * (1 + amplitude *
    sin(2 pi t / period)), by thinning a homogeneous one, numpy-seeded."""
    rng = np.random.default_rng(seed)
    peak = base * (1 + amplitude)
    t = np.cumsum(rng.exponential(1.0 / peak, int(duration * peak * 1.2) + 100))
    t = t[t < duration]
    keep = rng.uniform(size=t.size) < (1 + amplitude * np.sin(2 * np.pi * t / period)) / (
        1 + amplitude)
    return t[keep] + t0


# ------------------------------------------------------------- RateHistory

def _history_case(pkg, case):
    fc = PKGS[pkg][0]
    if case == "readback":
        hist = fc.RateHistory(fc.ForecastConfig(), FixedClock())
        for t in (0.2, 0.7, 1.1, 2.5, 2.6, 2.7):
            hist.observe("f", t=t)
        out = [hist.window_rates("f", 3, t=3.0)]
        hist.observe("f", t=3.4)
        out.append(hist.window_rates("f", 3, t=3.5))
    elif case == "negative":
        hist = fc.RateHistory(fc.ForecastConfig(), FixedClock())
        for k in range(10):
            hist.observe("f", t=-10.0 + k + 0.5)
        out = [hist.window_rates("f", 10, t=0.0), hist.current_rate("f", window_s=2.0, t=0.0)]
    elif case == "quiet":
        hist = fc.RateHistory(fc.ForecastConfig(), FixedClock())
        hist.observe("f", t=0.5)
        out = [hist.window_rates("f", 3, t=5.0)]
    else:                                            # a ring of 16 wrapped twice
        hist = fc.RateHistory(fc.ForecastConfig(history_buckets=16, bucket_s=0.5), FixedClock())
        for t in np.arange(0.0, 20.0, 0.3):
            hist.observe("f", t=float(t))
            hist.observe("g", t=float(t) * 0.5)
        out = [hist.window_rates(f, 24, t=20.1) for f in ("f", "g")]
    return [np.asarray(o).tolist() for o in out] + [hist.first_bucket("f"), hist.functions()]


@pytest.mark.parametrize("case", ["readback", "negative", "quiet", "wrapped"])
def test_rate_history_windows_equal_jax(case):
    got = _history_case("torch", case)
    assert got == _history_case("jax", case)
    if case == "readback":
        assert got[0] == got[1] == [2.0, 1.0, 3.0]


# ------------------------------------------------------------- forecasters

def _predictions(pkg, model):
    """Warm up on one seeded sinusoid replayed at t < 0, then predict along a
    fresh period while observing it (the JAX package's protocol)."""
    fc = PKGS[pkg][0]
    cfg = fc.ForecastConfig(model=model)
    hist = fc.RateHistory(cfg, FixedClock())
    f = fc.make_forecaster(cfg, hist)
    f.predict_rate("d", t=-600.0)
    for t in _sinusoid_arrivals(3, 600.0, t0=-600.0):
        hist.observe("d", t=float(t))
    f.predict_rate("d", t=0.0)
    pending = iter(_sinusoid_arrivals(4, 60.0))
    nxt = next(pending, None)
    out = []
    for t in range(5, 60, 5):
        while nxt is not None and nxt < t:
            hist.observe("d", t=float(nxt))
            nxt = next(pending, None)
        out.append((f.predict_rate("d", horizon_s=0.0, t=float(t)),
                    f.predict_rate("d", t=float(t))))
    return type(f).__name__, np.asarray(out)


@pytest.mark.parametrize("model", ["ewma", "reactive"])
def test_forecaster_predictions_equal_jax(model):
    name, got = _predictions("torch", model)
    jname, want = _predictions("jax", model)
    assert name == jname == {"ewma": "EwmaSeasonalForecaster",
                             "reactive": "ReactiveForecaster"}[model]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    truth = 60.0 * (1 + 0.9 * np.sin(2 * np.pi * np.arange(5, 60, 5) / 60.0))
    if model == "ewma":                              # the seasonal model tracks the wave
        assert np.abs(got[:, 0] - truth).max() / 60.0 < 0.25


def test_seasonal_read_and_make_forecaster_dispatch_equal_jax():
    reads = {}
    for pkg in PKGS:
        fc = PKGS[pkg][0]
        cfg = fc.ForecastConfig()
        f = fc.EwmaSeasonalForecaster(cfg, fc.RateHistory(cfg, FixedClock()))
        profile, counts = np.zeros(cfg.season_buckets), np.zeros(cfg.season_buckets)
        counts[1:4] = (50.0, 1.0, 3.0)
        profile[1:4] = (1e6, 0.3, 1e-9)
        reads[pkg] = [f._seasonal(profile, counts, ph) for ph in range(5)]
        hist = fc.RateHistory(cfg, FixedClock())
        kinds = {m: type(fc.make_forecaster(fc.ForecastConfig(model=m), hist)).__name__
                 for m in ("ewma", "reactive")}
        reads[pkg].append(kinds)
    assert reads["torch"] == reads["jax"]
    assert reads["torch"][0] == 1.0 and reads["torch"][1] == 10.0 and reads["torch"][3] == 0.1
    hist = torch_forecast.RateHistory(ForecastConfig(), FixedClock())
    learned = torch_forecast.make_forecaster(ForecastConfig(model="learned"), hist,
                                             device="cpu")
    assert isinstance(learned, torch_forecast.LearnedForecaster)
    assert learned.mlp.layers[0].weight.device.type == "cpu"
    assert dataclasses.asdict(ForecastConfig()) == dataclasses.asdict(
        jax_forecast.ForecastConfig())


def test_forecast_error_equals_jax():
    out = {}
    for pkg in PKGS:
        err = PKGS[pkg][0].ForecastError()
        for fn, p, a in (("f", 10.0, 8.0), ("f", 6.0, 8.0), ("g", 1.5, 0.0)):
            err.record(fn, p, a)
        out[pkg] = (err.summary(), err.pairs("f"), err.pairs("none"),
                    PKGS[pkg][0].ForecastError().summary()["n"])
    assert out["torch"] == out["jax"]
    s = out["torch"][0]
    assert s["n"] == 3 and s["mae"] == pytest.approx(5.5 / 3)
    assert out["torch"][1] == [(10.0, 8.0), (6.0, 8.0)]


# --------------------------------------------------------- learned forecaster

def _windows(window=8, n=96, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 10.0, size=(n, window)).astype(np.float32)
    X[5] = 0.0                                       # an all-quiet window is skipped
    return X, X.mean(axis=1) * rng.uniform(0.5, 1.5, n).astype(np.float32)


def _learned_pair(window=8):
    cfg = ForecastConfig(window=window)
    jfc = jax_forecast.LearnedForecaster(jax_forecast.ForecastConfig(window=window),
                                         jax_forecast.RateHistory(
                                             jax_forecast.ForecastConfig(window=window),
                                             FixedClock()))
    fc = torch_forecast.LearnedForecaster(cfg, torch_forecast.RateHistory(cfg, FixedClock()),
                                          device="cpu")
    return jfc, fc


def _numpy_params(jfc):
    return [(np.asarray(w), np.asarray(b)) for w, b in jfc.params]


def test_learned_forecaster_untrained_falls_back_to_the_window_mean():
    jfc, fc = _learned_pair(window=32)
    for f in (jfc, fc):
        for t in np.arange(0.0, 32.0, 0.5):
            f.history.observe("f", t=float(t))
    assert fc.predict_rate("f", t=32.0) == jfc.predict_rate("f", t=32.0) == pytest.approx(2.0)
    assert fc.predict_rate("quiet", t=32.0) == 0.0


def _jax_predict_window(jfc, window):
    """The JAX forecaster's prediction after one window (its ``predict_rate``
    body, on a window given directly)."""
    feats, scale = jfc.featurize(window)
    if scale <= 0.0:
        return 0.0
    return max(0.0, float(jfc._predict_jit(jfc.params, jfc._jnp.asarray(feats))) * scale)


def test_jax_params_carried_across_predict_jax_rates():
    jfc, fc = _learned_pair()
    X, y = _windows()
    jfc.fit(X, y, epochs=3, batch=32)
    mlp_from_numpy(fc.mlp, _numpy_params(jfc))
    fc.trained = True
    for f in (jfc, fc):
        for t in np.arange(0.0, 8.0, 0.4):
            f.history.observe("f", t=float(t))
    got = [fc.predict_window(w) for w in X[:16]] + [fc.predict_rate("f", t=8.0)]
    want = [_jax_predict_window(jfc, w) for w in X[:16]] + [jfc.predict_rate("f", t=8.0)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[5] == 0.0 and min(got) >= 0.0
    with pytest.raises(ValueError, match="layers"):
        mlp_from_numpy(fc.mlp, _numpy_params(jfc)[:2])


def test_fit_gives_jax_losses_epoch_by_epoch():
    jfc, fc = _learned_pair()
    mlp_from_numpy(fc.mlp, _numpy_params(jfc))       # the same initial parameters
    X, y = _windows(n=200, seed=1)
    want = jfc.fit(X, y, epochs=5, batch=32, seed=3)
    got = fc.fit(X, y, epochs=5, batch=32, seed=3)
    assert fc.trained and len(got) == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for (w, b), layer in zip(_numpy_params(jfc), fc.mlp.layers):
        np.testing.assert_allclose(layer.weight.detach().numpy().T, w, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(layer.bias.detach().numpy(), b, rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="no non-empty"):
        fc.fit(np.zeros((4, 8), np.float32), np.zeros(4, np.float32))


def test_the_learned_forecaster_lives_on_the_gpu_unless_asked_for_the_cpu():
    cfg = ForecastConfig(window=8)
    hist = torch_forecast.RateHistory(cfg, FixedClock())
    a = torch_forecast.LearnedForecaster(cfg, hist, device="cpu", seed=5)
    b = torch_forecast.LearnedForecaster(cfg, hist, device="cpu", seed=5)
    for la, lb in zip(a.mlp.layers, b.mlp.layers):   # one seed, one model
        assert torch.equal(la.weight, lb.weight) and not la.bias.any()
    if torch.cuda.is_available():
        f = torch_forecast.LearnedForecaster(cfg, hist)
        assert f.mlp.layers[0].weight.device.type == "cuda"
    else:                       # no card: the default device raises, no CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            torch_forecast.LearnedForecaster(cfg, hist)


# ----------------------------------------------------------------- planner

class _Dep:
    class _Img:
        key = "img"

    def __init__(self, name: str) -> None:
        self.name = name
        self.image = self._Img()


def _planner(pkg, clock, **cbs):
    fc, _, timer_cls = PKGS[pkg]
    cfg = fc.ForecastConfig(plan_interval_s=0.5, cool_rate_threshold=1.0)
    hist = fc.RateHistory(cfg, clock)
    timer = timer_cls(clock=clock)
    return fc.PreBootPlanner(cfg, fc.EwmaSeasonalForecaster(cfg, hist), timer, clock,
                             **cbs), hist, timer


def _scenario(pkg, case):
    clock = PKGS[pkg][1]()
    if case == "cooldown":
        planner, hist, timer = _planner(pkg, clock)
        planner.register(_Dep("f"))
        for t in np.arange(0.0, 5.0, 0.1):
            hist.observe("f", t=float(t))
        planner.tick_once(t=6.0)
        out = [planner.pool_target("f"), planner.predicted_rate("f")]
        planner.tick_once(t=120.0)                  # a long quiet: predicts ~0
        out += [planner.pool_target("f"), planner.cooldowns]
    elif case == "preboots":
        booted, cancelled = [], []

        class Handle:
            cancelled = False

            def cancel(self):
                cancelled.append(self)

        class Host:
            host_id = 0

        planner, hist, timer = _planner(
            pkg, clock, route=lambda key: Host(),
            preboot=lambda host, dep: booted.append(Handle()) or booted[-1])
        planner.register(_Dep("f"))
        for t in np.arange(0.0, 4.0, 0.05):         # 20 rps
            hist.observe("f", t=float(t))
        clock.run_until(4.0)
        planner.tick_once()
        out = [planner.preboots_planned, planner.claim(0, "img") is booted[0],
               planner.claim(0, "missing")]
        clock.run_until(clock.now() + planner.cfg.preboot_ttl_s + 1.0)
        out += [planner.parked_count(), planner.preboots_claimed, planner.preboots_expired,
                len(cancelled)]
        assert planner.preboots_claimed + planner.preboots_expired == planner.preboots_planned
        planner.stop()
    elif case == "errors":
        planner, hist, timer = _planner(pkg, clock)
        planner.register(_Dep("f"))
        for t in np.arange(0.0, 3.0, 0.1):
            hist.observe("f", t=float(t))
        planner.tick_once(t=3.0)
        planner.tick_once(t=3.0 + planner.cfg.horizon_s)
        out = [planner.error.summary(), planner.error.pairs("f")]
    else:                                           # the tick never raises
        def bad_route(key):
            raise RuntimeError("router down")

        planner, hist, timer = _planner(pkg, clock, route=bad_route)
        planner.register(_Dep("f"))
        for t in np.arange(0.0, 3.0, 0.05):
            hist.observe("f", t=float(t))
        planner.start()
        clock.run_until(5.0)
        planner.stop()
        out = [planner.ticks]
    summary = planner.summary()
    timer.close()
    return out + [{k: v for k, v in summary.items() if k != "forecast_error"}]


@pytest.mark.parametrize("case", ["cooldown", "preboots", "errors", "never_raises"])
def test_planner_scenarios_equal_jax(case):
    got = _scenario("torch", case)
    assert got == _scenario("jax", case)
    if case == "cooldown":
        assert got[0] > 0 and got[2] == 0 and got[3] == 1
    elif case == "preboots":
        assert got[0] >= 1 and got[1] and got[2] is None and got[3] == 0
    elif case == "errors":
        assert got[0]["n"] >= 1
    else:
        assert got[0] >= 1


# ---------------------------------------------------------------- gateway

def _register_f32_arch():
    for reg in (jax_configs, torch_configs):
        base = reg.get_config("llama3.2-3b")
        if F32_ARCH not in reg._REGISTRY:
            reg.register(F32_ARCH)(lambda base=base: dataclasses.replace(base, dtype="float32"))


@pytest.fixture(scope="module", autouse=True)
def _registered_arch_leaves_with_the_module():
    """The JAX package's config tests count the registered archs: the arch
    this module registers leaves both registries when the module ends."""
    yield
    for reg in (jax_configs, torch_configs):
        reg._REGISTRY.pop(F32_ARCH, None)


# the planner's own tick and its parked boots' TTL are pushed past the test:
# the script drives every tick at a chosen time
SCRIPT_FORECAST = dict(plan_interval_s=3600.0, preboot_ttl_s=3600.0)


def _forecast_script(gw, spec_cls, t0):
    """20 arrivals over the 10 s before ``t0``, a planning tick at ``t0`` (it
    prefetches a host and parks boots there), two requests, then a tick 200 s
    later (quiet: a cool-down)."""
    name = spec_cls(**SPEC).name
    planner = gw.planner
    for k in range(20):
        planner.history.observe(name, t=t0 - 10.0 + 0.5 * k)
    planner.tick_once(t=t0)
    parked = planner.parked_count()
    tokens = np.random.default_rng(6).integers(0, 512, (SPEC["batch_size"], SPEC["prompt_len"]),
                                               dtype=np.int32)
    outs = [np.asarray(gw.invoke(name, tokens, label=f"r{i}")).tolist() for i in range(2)]
    claimed = [gw.recorder.timelines(f"r{i}")[0].planner_preboot for i in range(2)]
    planner.tick_once(t=t0 + 200.0)
    s = gw.forecast_summary()
    counts = {k: v for k, v in s.items() if k != "forecast_error"}
    return (outs, parked, claimed, counts, s["forecast_error"]["n"],
            planner.pool_target(name), gw.placement_summary()["prefetched"])


def test_gateway_forecast_gives_jax_counts_prefetches_and_claims(tmp_path):
    _register_f32_arch()
    jgw = JaxGateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                     work_dir=str(tmp_path / "jax"),
                     forecast=jax_forecast.ForecastConfig(**SCRIPT_FORECAST))
    pgw = Gateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                  work_dir=str(tmp_path / "torch"), forecast=ForecastConfig(**SCRIPT_FORECAST),
                  device="cpu")
    try:
        jdep = jgw.deploy(jax_artifact.FunctionSpec(**SPEC))
        dep = pgw.deploy(FunctionSpec(**SPEC))
        pgw.snapshots.save(dep.image.key,
                           params_from_numpy(jgw.snapshots.load_host(jdep.image.key), "cpu"))
        t0 = now()
        got = _forecast_script(pgw, FunctionSpec, t0)
        want = _forecast_script(jgw, jax_artifact.FunctionSpec, t0)
    finally:
        jgw.shutdown()
        pgw.shutdown()
    assert got == want
    outs, parked, claimed, counts, n_err, target, prefetched = got
    assert parked == 2 and claimed == [True, True]
    assert counts["preboots_planned"] == counts["preboots_claimed"] == 2
    assert counts["prefetches"] == 1 and prefetched == 1
    assert counts["cooldowns"] == 1 and target == 0 and n_err >= 1
    assert pgw.planner.parked_count() == 0


def test_shutdown_with_batching_and_forecast_leaves_no_thread_or_parked_boot(tmp_path):
    _register_f32_arch()
    before = set(threading.enumerate())
    gw = Gateway(n_hosts=2, slots_per_host=2, hedging=False, work_dir=str(tmp_path),
                 batching=BatchingConfig(buckets=(1, 2), min_window_s=0.02),
                 forecast=ForecastConfig(plan_interval_s=0.05, preboot_ttl_s=30.0),
                 device="cpu")
    gw.deploy(FunctionSpec(**SPEC))
    gw.invoke_many(FunctionSpec(**SPEC).name, [None] * 3)
    deadline = time.time() + 10
    while not gw.planner.parked_count() and time.time() < deadline:
        time.sleep(0.02)
    assert gw.planner.parked_count() > 0              # the planner warmed ahead
    assert set(threading.enumerate()) - before
    gw.shutdown()
    assert gw.planner.parked_count() == 0
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.02)
    assert not set(threading.enumerate()) - before
