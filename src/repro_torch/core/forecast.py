"""Arrival forecasting: predictive pre-boot decides when pools warm and cool
(port of ``repro.core.forecast``: the numpy parts copied, the learned model
rewritten as a PyTorch MLP).

The reactive machinery (speculative pre-boot at submit time, warm pools sized
off *trailing* arrival rate with an idle timeout) only ever responds to load
that already happened — which is exactly the window where cold starts land.
This module closes the loop the paper's thesis needs: a per-function arrival
forecaster drives *when* to pre-boot, *which* host to warm (chunk/program-tier
prefetch before the request lands), and when to let a pool cool to ZERO — the
idle-timeout heuristic replaced by "predicted-quiet", so a pool stops paying
warm-seconds the moment the forecast says traffic is gone, not idle_timeout_s
later.

Three forecasters share one interface (``predict_rate(fn, horizon_s)``):

* ``ReactiveForecaster``    — trailing-window rate (the null model: what the
                              autoscaler already does, exposed for comparison);
* ``EwmaSeasonalForecaster``— an EWMA rate level times a multiplicative
                              seasonal profile (phase-bucketed over a period),
                              the cheap baseline that already beats reactive
                              on diurnal traffic;
* ``LearnedForecaster``     — a small MLP (:class:`ForecastMLP`, PyTorch, on
                              the gateway's device) over a normalized window of
                              bucket rates, trained with an inline Adam on
                              windows of rate traces; scale-invariant by
                              construction (windows are normalized by their
                              own mean), so one model serves every function.

``PreBootPlanner`` consumes a forecaster: a recurring tick on the SHARED
:class:`~repro_torch.core.timerwheel.DeadlineTimer` (virtual-clock exact, no extra
threads) predicts each function's rate one horizon ahead, schedules
speculative pre-boots just ahead of predicted arrivals, fires prefetch hints
so the chosen host's tiers are warm before the request lands, and publishes
pool targets the :class:`~repro_torch.core.autoscaler.WarmPoolAutoscaler` follows —
including target ZERO (full cooldown) whenever the predicted rate stays under
``cool_rate_threshold``.

Invariants: every parked pre-boot is either claimed by exactly one request or
cancelled by its TTL sweep — never leaked; predicted-vs-actual pairs are
recorded for every tick of every registered function, so forecast error is
always measurable; the planner never raises into the timer thread (prediction
is advisory — a forecaster bug degrades to reactive behavior, not an outage).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import metrics
from repro_torch.core.simclock import Clock
from repro_torch.core.timerwheel import DeadlineTimer


@dataclasses.dataclass
class ForecastConfig:
    """Forecaster + planner knobs (Gateway(forecast=...) accepts one)."""

    # rate history: arrivals are counted into fixed buckets of this width;
    # every forecaster consumes the same bucketed series
    bucket_s: float = 1.0
    # how many trailing buckets the learned model sees (its input window) and
    # the history ring retains (sized generously past the window)
    window: int = 32
    history_buckets: int = 512
    # how far ahead the planner predicts (and how early it pre-warms)
    horizon_s: float = 2.0
    # seasonal profile smoothing (one sample per phase bucket per period).
    # The LEVEL is not a knob: it is the trailing mean over exactly one
    # season period, which integrates the seasonal wave to zero by
    # construction — an EWMA level either tracks the wave (fast alpha) or
    # inflates through deseasonalization feedback (slow alpha + noisy
    # seasonal indices), and both recombine into a biased forecast.
    season_alpha: float = 0.25
    season_period_s: float = 60.0
    season_buckets: int = 60
    # planner: tick cadence, full-cooldown threshold (predicted rps below
    # this -> pool target 0), Little's-law sizing for the warm target
    plan_interval_s: float = 0.5
    cool_rate_threshold: float = 0.5
    headroom: float = 1.5
    max_pool: int = 8
    # speculative pre-boots parked ahead of predicted arrivals: how many per
    # (function, tick) at most, and how long an unclaimed one lives
    max_preboots_per_tick: int = 2
    preboot_ttl_s: float = 4.0
    # prediction below this expected-arrivals count doesn't justify a
    # pre-boot/prefetch (expected arrivals = rate * horizon)
    preboot_min_expected: float = 0.5
    # which forecaster Gateway builds: "ewma" | "learned" | "reactive"
    model: str = "ewma"


class RateHistory:
    """Per-function bucketed arrival counts on a shared clock.

    A ring of ``history_buckets`` fixed-width buckets per function; closing a
    bucket is implicit (``now`` indexes the ring), so ``observe`` is O(1) and
    reading a window is O(window). All rates are requests/second.
    """

    def __init__(self, cfg: ForecastConfig, clock: Clock) -> None:
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        # fn -> (counts ring, absolute index of the ring's current bucket,
        #        absolute index of the first bucket ever observed)
        self._rings: Dict[str, Tuple[np.ndarray, int, int]] = {}

    def _bucket_index(self, t: float) -> int:
        return int(t // self.cfg.bucket_s)

    def observe(self, fn_name: str, t: Optional[float] = None) -> None:
        t = self._clock.now() if t is None else t
        idx = self._bucket_index(t)
        n = self.cfg.history_buckets
        with self._lock:
            ring, cur, first = self._rings.get(fn_name, (None, -1, idx))
            if ring is None:
                ring = np.zeros(n, dtype=np.float64)
                cur = idx
            if idx > cur:
                # zero the buckets we skipped over (quiet time is data too)
                for j in range(cur + 1, min(idx, cur + n) + 1):
                    ring[j % n] = 0.0
                cur = idx
            ring[idx % n] += 1.0
            self._rings[fn_name] = (ring, cur, min(first, idx))

    def window_rates(self, fn_name: str, n_buckets: int,
                     t: Optional[float] = None) -> np.ndarray:
        """The last ``n_buckets`` bucket rates ending at the bucket BEFORE the
        one containing ``t`` (the current bucket is still filling — including
        it would bias every rate low). Missing history reads as zero."""
        t = self._clock.now() if t is None else t
        idx = self._bucket_index(t)
        size = self.cfg.history_buckets
        out = np.zeros(n_buckets, dtype=np.float64)
        with self._lock:
            entry = self._rings.get(fn_name)
            if entry is None:
                return out
            ring, cur, _first = entry
            for k in range(n_buckets):
                j = idx - 1 - k                      # newest last
                # a slot is trustworthy only inside the ring's live window
                # (cur - size, cur]; note buckets may be NEGATIVE (warmup
                # traces are replayed at t < 0), so "j < 0" is not a
                # validity test
                if j > cur or j <= cur - size or j < idx - size:
                    continue
                out[n_buckets - 1 - k] = ring[j % size]
        return out / self.cfg.bucket_s

    def current_rate(self, fn_name: str, window_s: float = 2.0,
                     t: Optional[float] = None) -> float:
        """Trailing-window arrival rate (the reactive estimate)."""
        n = max(1, int(round(window_s / self.cfg.bucket_s)))
        rates = self.window_rates(fn_name, n, t=t)
        return float(rates.mean()) if rates.size else 0.0

    def first_bucket(self, fn_name: str) -> Optional[int]:
        """Absolute index of the first bucket this function was ever seen in
        (None before any observation) — how far back a fresh forecaster
        should fold."""
        with self._lock:
            entry = self._rings.get(fn_name)
            return entry[2] if entry is not None else None

    def functions(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)


class ForecastError:
    """Predicted-vs-actual pairs per function: MAE / bias / count.

    The "stamps" the benchmarks and reports consume: every planner tick
    records (predicted rate for bucket B, then — one horizon later — the rate
    B actually saw), so forecast quality is a first-class output, not a
    side effect buried in pool behavior.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pairs: Dict[str, List[Tuple[float, float]]] = {}
        self.errors = metrics.Series()          # |predicted - actual|, fleet-wide

    def record(self, fn_name: str, predicted: float, actual: float) -> None:
        with self._lock:
            self._pairs.setdefault(fn_name, []).append((predicted, actual))
        self.errors.add(abs(predicted - actual))

    def pairs(self, fn_name: str) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._pairs.get(fn_name, ()))

    def summary(self) -> Dict[str, float]:
        with self._lock:
            pairs = [p for ps in self._pairs.values() for p in ps]
        if not pairs:
            return {"n": 0, "mae": float("nan"), "bias": float("nan"),
                    "mean_actual": float("nan")}
        a = np.asarray(pairs, dtype=np.float64)
        return {
            "n": int(a.shape[0]),
            "mae": float(np.abs(a[:, 0] - a[:, 1]).mean()),
            "bias": float((a[:, 0] - a[:, 1]).mean()),
            "mean_actual": float(a[:, 1].mean()),
        }


# ------------------------------------------------------------- forecasters

class Forecaster:
    """Interface: observe arrivals (via a shared RateHistory), predict rps."""

    name = "base"

    def __init__(self, cfg: ForecastConfig, history: RateHistory) -> None:
        self.cfg = cfg
        self.history = history

    def observe(self, fn_name: str, t: Optional[float] = None) -> None:
        self.history.observe(fn_name, t=t)

    def predict_rate(self, fn_name: str, horizon_s: Optional[float] = None,
                     t: Optional[float] = None) -> float:
        raise NotImplementedError


class ReactiveForecaster(Forecaster):
    """The null model: tomorrow looks exactly like the trailing window."""

    name = "reactive"

    def predict_rate(self, fn_name: str, horizon_s: Optional[float] = None,
                     t: Optional[float] = None) -> float:
        return self.history.current_rate(fn_name, t=t)


class EwmaSeasonalForecaster(Forecaster):
    """EWMA rate level x multiplicative seasonal profile.

    The level is the trailing mean rate over exactly one season period (the
    integer-period window integrates the wave to zero, so the level stays
    flat through the cycle); the seasonal profile is a phase-bucketed EWMA of
    rate/level, so a diurnal function's profile converges to its (normalized)
    daily shape after a couple of periods. Prediction at t+h multiplies the
    level by the profile at phase(t+h) — which is how the planner warms pools
    BEFORE the morning ramp instead of during it.
    """

    name = "ewma"

    def __init__(self, cfg: ForecastConfig, history: RateHistory) -> None:
        super().__init__(cfg, history)
        self._lock = threading.Lock()
        # fn -> (level, seasonal profile, per-phase sample counts,
        #        last folded bucket, total buckets ever folded)
        self._state: Dict[str, Tuple[float, np.ndarray, np.ndarray,
                                     int, int]] = {}

    def _phase(self, t: float) -> int:
        frac = (t % self.cfg.season_period_s) / self.cfg.season_period_s
        return min(int(frac * self.cfg.season_buckets),
                   self.cfg.season_buckets - 1)

    def _seasonal(self, profile: np.ndarray, counts: np.ndarray,
                  ph: int) -> float:
        """Bias-corrected seasonal factor for one phase bucket.

        The profile is an EWMA accumulated from ZERO; dividing by
        ``1 - (1-a)^n`` (Adam-style) makes the read an unbiased weighted
        mean of the samples seen so far. Without the correction a phase
        visited only a few times (once per period!) reads a factor shrunk
        toward the initial value, flattening the learned wave for the first
        several periods. An unvisited phase has no evidence and reads 1.0.

        The read is clamped to [0.1, 10] — the seasonal dynamic range the
        model can express. On non-periodic traffic (MMPP bursts landing in
        phases whose factors collapsed during quiet visits) the clamp keeps
        one noisy factor from zeroing out — or 10x-ing — the prediction.
        """
        n = counts[ph]
        if n <= 0:
            return 1.0
        corr = 1.0 - (1.0 - self.cfg.season_alpha) ** n
        return min(max(float(profile[ph]) / max(corr, 1e-9), 0.1), 10.0)

    def _ingest(self, fn_name: str, t: float) -> Tuple[float, np.ndarray,
                                                       np.ndarray]:
        """Fold every closed-but-unseen bucket into (level, profile)."""
        cur = int(t // self.cfg.bucket_s)
        period = self.cfg.season_buckets
        if (entry := self._state.get(fn_name)) is None:
            # first sight of this function: fold from its first observed
            # bucket, not from "now" — otherwise the first prediction over
            # an already-hot function reads level 0 and publishes a cooldown
            first = self.history.first_bucket(fn_name)
            start = cur - 1 if first is None else first - 1
        with self._lock:
            entry = self._state.get(fn_name)
            level, profile, counts, last, seen = entry if entry is not None \
                else (0.0, np.zeros(period), np.zeros(period), start, 0)
            n_new = min(cur - 1 - last, self.cfg.history_buckets - period)
            if n_new > 0:
                # the new span PLUS one period of lookback, so every new
                # bucket has a trailing-period mean to normalize against
                span = self.history.window_rates(fn_name, n_new + period, t=t)
                csum = np.concatenate([[0.0], np.cumsum(span)])
                a_sea = self.cfg.season_alpha
                for k in range(n_new):
                    i = period + k            # the new bucket's span index
                    seen += 1
                    # LEVEL: mean rate over the one period ending at this
                    # bucket. An integer-period window integrates the
                    # seasonal wave to zero, so the level never tracks the
                    # wave and never inflates through deseasonalization
                    # feedback (an EWMA level does one or the other and the
                    # recombined level x profile forecast ends up biased).
                    # A function younger than one period divides by what it
                    # has actually lived — the full-period denominator would
                    # read a brand-new hot function at a fraction of its
                    # true rate and cool it down mid-ramp.
                    span_n = min(period, seen)
                    level = float(csum[i + 1] - csum[i + 1 - span_n]) / span_n
                    if level > 1e-9:
                        bucket = cur - n_new + k
                        ph = self._phase(bucket * self.cfg.bucket_s)
                        factor = float(span[i]) / level
                        profile[ph] = a_sea * factor \
                            + (1.0 - a_sea) * profile[ph]
                        counts[ph] += 1.0
                last = cur - 1
                # renormalize: seasonal indices average 1 over the visited
                # phases (standard Holt-Winters hygiene — keeps the [0.1, 10]
                # clamp meaningful and the profile a pure SHAPE)
                vis = counts > 0
                if bool(vis.any()):
                    corr = 1.0 - (1.0 - a_sea) ** counts[vis]
                    mean_idx = float(np.mean(profile[vis] / corr))
                    if mean_idx > 1e-9:
                        profile /= mean_idx
            self._state[fn_name] = (level, profile, counts, last, seen)
            return level, profile.copy(), counts.copy()

    def predict_rate(self, fn_name: str, horizon_s: Optional[float] = None,
                     t: Optional[float] = None) -> float:
        t = self.history._clock.now() if t is None else t
        h = self.cfg.horizon_s if horizon_s is None else horizon_s
        level, profile, counts = self._ingest(fn_name, t)
        # an unvisited phase bucket predicts the plain level (profile 1.0):
        # seasonality only speaks once it has evidence
        factor = self._seasonal(profile, counts, self._phase(t + h))
        return max(0.0, level * factor)


class ForecastMLP(nn.Module):
    """The learned forecaster's model: ``window + 1 -> 32 -> 16 -> 1``, ReLU
    between the layers and softplus on the output, as the JAX package's.

    ``nn.Linear`` keeps its weight as ``[out, in]``, the transpose of the JAX
    package's ``[in, out]`` (see :func:`repro_torch.convert.mlp_from_numpy`).
    """

    def __init__(self, sizes: Tuple[int, ...]) -> None:
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(n_in, n_out)
                                    for n_in, n_out in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return nn.functional.softplus(self.layers[-1](h)).squeeze(-1)


class LearnedForecaster(Forecaster):
    """A small MLP over a normalized window of bucket rates.

    Input: the last ``cfg.window`` bucket rates divided by the window mean
    (plus the mean itself, log-compressed, as one extra feature) — so the
    model learns SHAPE (ramps, bursts, period position) independent of scale.
    Output: next-horizon mean rate as a multiple of the window mean, squashed
    through softplus to stay non-negative. Trained with an inline Adam (the
    JAX package's update, step for step, under ``torch.autograd``) on windows
    of rate traces.

    The model lives on ``device`` (the GPU unless the caller asks for the
    CPU). Its weights are drawn on the CPU from a ``torch.Generator`` seeded
    with ``seed`` (He-normal weights, zero biases) and then moved, so one seed
    gives the same model on every device; the batch order of ``fit`` is the
    JAX package's, ``np.random.default_rng(seed).permutation``.
    """

    name = "learned"

    def __init__(self, cfg: ForecastConfig, history: RateHistory,
                 hidden: Tuple[int, int] = (32, 16), seed: int = 0,
                 device="cuda") -> None:
        super().__init__(cfg, history)
        self.device = torch.device(device)
        sizes = (cfg.window + 1, *hidden, 1)
        self.mlp = ForecastMLP(sizes)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.mlp.layers:
                n_in = layer.in_features
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen)
                                   * math.sqrt(2.0 / n_in))
                layer.bias.zero_()
        self.mlp.to(self.device)
        self.trained = False
        self.train_losses: List[float] = []

    @staticmethod
    def featurize(window: np.ndarray) -> Tuple[np.ndarray, float]:
        """(normalized features, scale): rates/mean ++ log1p(mean)."""
        window = np.asarray(window, dtype=np.float32)
        scale = float(window.mean())
        if scale <= 1e-9:
            return np.zeros(window.size + 1, dtype=np.float32), 0.0
        feats = np.concatenate([window / scale,
                                [math.log1p(scale)]]).astype(np.float32)
        return feats, scale

    def fit(self, X: np.ndarray, y: np.ndarray, *, epochs: int = 60,
            batch: int = 256, lr: float = 1e-3, seed: int = 0) -> List[float]:
        """Train on (windows, next-horizon rates).

        ``X``: (n, window) raw bucket rates; ``y``: (n,) target mean rate over
        the following horizon. Features/targets are normalized per-window
        here, so callers pass raw rates. Returns the mean loss of each epoch.
        """
        feats, targets = [], []
        for window, target in zip(np.asarray(X), np.asarray(y)):
            f, scale = self.featurize(window)
            if scale <= 1e-9:
                continue                    # an all-quiet window teaches nothing
            feats.append(f)
            targets.append(target / scale)
        if not feats:
            raise ValueError("no non-empty training windows")
        Xf = torch.from_numpy(np.stack(feats)).to(self.device)
        yf = torch.from_numpy(np.asarray(targets, dtype=np.float32)).to(self.device)
        params = [p for layer in self.mlp.layers for p in (layer.weight, layer.bias)]
        # inline Adam, the JAX package's update term for term (no torch.optim:
        # its fused update orders the arithmetic differently)
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        b1, b2, eps = 0.9, 0.999, 1e-8
        rng = np.random.default_rng(seed)
        n = Xf.shape[0]
        step = 0
        losses: List[float] = []
        for _epoch in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            epoch_loss = 0.0
            n_batches = 0
            for s in range(0, n, batch):
                idx = order[s:s + batch]
                step += 1
                for p in params:
                    p.grad = None
                loss = torch.mean((self.mlp(Xf[idx]) - yf[idx]) ** 2)
                loss.backward()
                epoch_loss += float(loss.detach())
                n_batches += 1
                corr = math.sqrt(1 - b2 ** step) / (1 - b1 ** step)
                with torch.no_grad():
                    for i, p in enumerate(params):
                        g = p.grad
                        m[i] = b1 * m[i] + (1 - b1) * g
                        v[i] = b2 * v[i] + (1 - b2) * g ** 2
                        p.copy_(p - lr * corr * m[i] / (torch.sqrt(v[i]) + eps))
            losses.append(epoch_loss / max(n_batches, 1))
        for p in params:
            p.grad = None
        self.trained = True
        self.train_losses = losses
        return losses

    def predict_window(self, window: np.ndarray) -> float:
        """The predicted next-horizon rate after one window of bucket rates."""
        feats, scale = self.featurize(window)
        if scale <= 0.0:
            return 0.0
        if not self.trained:
            return scale                      # untrained: window-mean fallback
        with torch.no_grad():
            pred = float(self.mlp(torch.from_numpy(feats).to(self.device)))
        return max(0.0, pred * scale)

    def predict_rate(self, fn_name: str, horizon_s: Optional[float] = None,
                     t: Optional[float] = None) -> float:
        return self.predict_window(
            self.history.window_rates(fn_name, self.cfg.window, t=t))


def make_forecaster(cfg: ForecastConfig, history: RateHistory,
                    device="cuda") -> Forecaster:
    """The forecaster ``cfg.model`` names; a learned one on ``device``."""
    if cfg.model == "learned":
        return LearnedForecaster(cfg, history, device=device)
    if cfg.model == "reactive":
        return ReactiveForecaster(cfg, history)
    return EwmaSeasonalForecaster(cfg, history)


# ------------------------------------------------------------------ planner

class _ParkedBoot:
    __slots__ = ("handle", "ttl_entry")

    def __init__(self, handle: Any, ttl_entry: Any) -> None:
        self.handle = handle
        self.ttl_entry = ttl_entry


class PreBootPlanner:
    """Forecast-driven warming: pre-boots, prefetch hints, and pool targets.

    Runs a recurring tick on the SHARED deadline timer (the same one carrying
    hedge deadlines and coalescer windows — no new thread, virtual-clock
    exact). Each tick, per registered function:

    1. predict the arrival rate one horizon ahead, and record the predicted
       vs actual pair for the tick one horizon AGO (the error series);
    2. if the expected arrivals justify it, pick the affinity host (``route``)
       and fire a ``prefetch`` hint so its program/chunk tiers are warm before
       any request lands, plus park up to ``max_preboots_per_tick``
       speculative boots (``preboot``) the dispatcher can claim;
    3. publish a pool target: Little's law over the PREDICTED rate, or ZERO
       when the prediction is under ``cool_rate_threshold`` — the autoscaler
       follows it, replacing its idle-timeout heuristic.

    Callbacks (all optional — the planner does what its integration offers):
    ``route(image_key) -> host | None``, ``preboot(host, dep) -> handle | None``
    (handle must expose cancel(); claimable handles are parked for
    :meth:`claim`), ``prefetch(host, dep) -> bool`` (True if bytes moved),
    ``service_time(fn_name) -> seconds`` for the pool-target sizing.
    """

    def __init__(self, cfg: ForecastConfig, forecaster: Forecaster,
                 timer: DeadlineTimer, clock: Optional[Clock] = None, *,
                 route: Optional[Callable[[str], Any]] = None,
                 preboot: Optional[Callable[[Any, Any], Any]] = None,
                 prefetch: Optional[Callable[[Any, Any], bool]] = None,
                 service_time: Optional[Callable[[str], float]] = None) -> None:
        self.cfg = cfg
        self.forecaster = forecaster
        self.history = forecaster.history
        self.timer = timer
        self._clock = clock if clock is not None else metrics.get_clock()
        self._route = route
        self._preboot = preboot
        self._prefetch = prefetch
        self._service_time = service_time
        self.error = ForecastError()
        self._lock = threading.Lock()
        self._deployments: Dict[str, Any] = {}
        # (host_id, image_key) -> parked claimable pre-boots
        self._parked: Dict[Tuple[int, str], List[_ParkedBoot]] = {}
        # fn -> [(t_due, predicted_rate), ...] awaiting their actuals — a
        # QUEUE: ticks fire faster than one horizon, so several predictions
        # are typically in flight per function at once
        self._outstanding: Dict[str, List[Tuple[float, float]]] = {}
        self._targets: Dict[str, int] = {}
        self._tick_entry = None
        self._stopped = False
        # counters (summary)
        self.ticks = 0
        self.preboots_planned = 0
        self.preboots_claimed = 0
        self.preboots_expired = 0
        self.prefetches = 0
        self.cooldowns = 0                  # target transitions to 0

    # -------------------------------------------------------------- intake
    def register(self, dep: Any) -> None:
        """Track a deployment (anything with .name and .image.key)."""
        with self._lock:
            self._deployments[dep.name] = dep

    def observe_arrival(self, fn_name: str) -> None:
        self.forecaster.observe(fn_name)

    # ------------------------------------------------------------- control
    def start(self) -> None:
        self._stopped = False
        self._arm_tick()

    def stop(self) -> None:
        self._stopped = True
        with self._lock:
            entry = self._tick_entry
            self._tick_entry = None
            parked = [p for ps in self._parked.values() for p in ps]
            self._parked.clear()
        if entry is not None:
            entry.cancel()
        for p in parked:
            p.ttl_entry.cancel()
            try:
                p.handle.cancel()
            except Exception:
                pass

    def _arm_tick(self) -> None:
        if self._stopped:
            return
        self._tick_entry = self.timer.schedule(self.cfg.plan_interval_s,
                                               self._tick)

    def _tick(self) -> None:
        try:
            self.tick_once()
        except Exception:
            pass                      # advisory: never kill the shared timer
        self._arm_tick()

    # ---------------------------------------------------------------- tick
    def tick_once(self, t: Optional[float] = None) -> None:
        """One planning pass (public so tests/benches can drive it directly)."""
        t = self._clock.now() if t is None else t
        self.ticks += 1
        with self._lock:
            deps = dict(self._deployments)
        names = set(deps) | set(self.history.functions())
        for fn_name in sorted(names):
            predicted = self.forecaster.predict_rate(fn_name, t=t)
            self._score_outstanding(fn_name, t)
            with self._lock:
                queue = self._outstanding.setdefault(fn_name, [])
                queue.append((t + self.cfg.horizon_s, predicted))
                del queue[:-64]              # bound: planner outlives scoring
            self._publish_target(fn_name, predicted)
            dep = deps.get(fn_name)
            if dep is None:
                continue
            expected = predicted * self.cfg.horizon_s
            if expected < self.cfg.preboot_min_expected:
                continue
            self._warm_ahead(fn_name, dep, expected)

    def _score_outstanding(self, fn_name: str, t: float) -> None:
        """Resolve every prediction whose horizon has now elapsed."""
        with self._lock:
            queue = self._outstanding.get(fn_name, [])
            due = [p for p in queue if t >= p[0]]
            if due:
                self._outstanding[fn_name] = [p for p in queue if t < p[0]]
        for t_due, predicted in due:
            actual = self.history.current_rate(
                fn_name, window_s=self.cfg.horizon_s, t=t_due)
            self.error.record(fn_name, predicted, actual)

    def _publish_target(self, fn_name: str, predicted: float) -> None:
        if predicted < self.cfg.cool_rate_threshold:
            target = 0
        else:
            svc = self._service_time(fn_name) if self._service_time else 0.05
            target = min(self.cfg.max_pool,
                         int(math.ceil(predicted * svc * self.cfg.headroom)))
        with self._lock:
            prev = self._targets.get(fn_name)
            self._targets[fn_name] = target
        if target == 0 and prev not in (0, None):
            self.cooldowns += 1

    def _warm_ahead(self, fn_name: str, dep: Any, expected: float) -> None:
        if self._route is None:
            return
        try:
            host = self._route(dep.image.key)
        except Exception:
            host = None
        if host is None:
            return
        if self._prefetch is not None:
            try:
                if self._prefetch(host, dep):
                    self.prefetches += 1
            except Exception:
                pass
        if self._preboot is None:
            return
        n = min(self.cfg.max_preboots_per_tick, int(math.ceil(expected)))
        key = (host.host_id, dep.image.key)
        with self._lock:
            n -= len(self._parked.get(key, ()))
        for _ in range(max(0, n)):
            try:
                handle = self._preboot(host, dep)
            except Exception:
                handle = None
            if handle is None:
                return
            self._park(key, handle)

    def _park(self, key: Tuple[int, str], handle: Any) -> None:
        parked = _ParkedBoot(handle, None)

        def expire() -> None:
            with self._lock:
                lst = self._parked.get(key, [])
                if parked not in lst:
                    return                   # claimed first — TTL is a no-op
                lst.remove(parked)
            self.preboots_expired += 1
            try:
                handle.cancel()
            except Exception:
                pass

        parked.ttl_entry = self.timer.schedule(self.cfg.preboot_ttl_s, expire)
        with self._lock:
            stopped = self._stopped
            if not stopped:
                self._parked.setdefault(key, []).append(parked)
        if stopped:
            # a tick that passed its stop check before ``stop`` ran launched
            # this boot after ``stop`` flushed the parked ones: drop it here
            parked.ttl_entry.cancel()
            try:
                handle.cancel()
            except Exception:
                pass
            return
        self.preboots_planned += 1

    # ------------------------------------------------------------- serving
    def claim(self, host_id: int, image_key: str) -> Optional[Any]:
        """Pop a parked pre-boot for (host, image) — the dispatcher's fast
        path: a request routed to a host the planner already warmed rides the
        planner's boot instead of launching its own speculation."""
        with self._lock:
            lst = self._parked.get((host_id, image_key))
            if not lst:
                return None
            parked = lst.pop(0)
        parked.ttl_entry.cancel()
        if getattr(parked.handle, "cancelled", False):
            return None
        self.preboots_claimed += 1
        return parked.handle

    def predicted_rate(self, fn_name: str) -> Optional[float]:
        """Latest published prediction (None before the first tick covers the
        function — callers fall back to reactive estimates)."""
        with self._lock:
            queue = self._outstanding.get(fn_name)
        return queue[-1][1] if queue else None

    def pool_target(self, fn_name: str) -> Optional[int]:
        """The planner's pool-size verdict, or None with no prediction yet.
        Zero means FULL COOLDOWN — the autoscaler obeys immediately instead
        of waiting out an idle timeout."""
        with self._lock:
            return self._targets.get(fn_name)

    def parked_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._parked.values())

    def summary(self) -> Dict[str, Any]:
        return {
            "model": self.forecaster.name,
            "ticks": self.ticks,
            "preboots_planned": self.preboots_planned,
            "preboots_claimed": self.preboots_claimed,
            "preboots_expired": self.preboots_expired,
            "preboots_parked": self.parked_count(),
            "prefetches": self.prefetches,
            "cooldowns": self.cooldowns,
            "forecast_error": self.error.summary(),
        }
