"""Gateway: the platform front door (port of ``repro.core.gateway``).

Composes the whole stack:

    Gateway -> Dispatcher -> (Cluster of Hosts) -> Agent -> Driver -> Executor

``mode='cold'`` is the paper's proposal: every invoke is a unikernel cold
start, no pools, trivial scaling; ``mode='warm'`` is the incumbent (warm
pools + ``WarmPoolAutoscaler`` + idle timeouts, the ``warm`` driver by
default). Both run the same functions through the same dispatcher, and any
invoke may name any driver of ``repro_torch.core.drivers.ALL_DRIVERS``.
Deploy writes the image's program into the
CompileCache and its weights as a v2 chunked snapshot into a global
ChunkStore, so every host's boot goes through its program tier and its chunk
tier (a delta restore). ``decode=`` adds the continuous-batching decode tier
(:class:`repro_torch.core.decode.DecodeScheduler`) behind
``invoke_decode_async``. ``batching=`` adds the coalescer
(:mod:`repro_torch.core.batching`): concurrent invokes of a batch-capable
driver share one boot of a bucket program that ``deploy`` builds.
``forecast=`` adds the predictive pre-boot planner
(:mod:`repro_torch.core.forecast`), which parks boots and warms host tiers
ahead of predicted arrivals and publishes pool targets. The executors (and a
learned forecaster's model) run on ``device`` — the GPU unless the caller
asks for the CPU — and nothing falls back to another device.

Invariants: ``shutdown`` drains every decode loop and the coalescer (no
Future left dangling), cancels the planner's tick and parked boots before
the shared timer stops, stops every thread the gateway started (the shared
timer, the autoscaler, the host pools) and flushes every warm pool and donor
through the residency tracker — resident device memory is never silently
dropped from the accounting; deployments are immutable once published to
``self.deployments``.
"""
from __future__ import annotations

import tempfile
import threading
from concurrent.futures import Future
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.agent import Agent
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.autoscaler import ColdOnlyScaler, WarmPoolAutoscaler
from repro_torch.core.batching import BatchingConfig, Coalescer
from repro_torch.core.blobstore import ChunkStore, delta_restore
from repro_torch.core.cluster import Cluster
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.decode import DecodeConfig, DecodeScheduler
from repro_torch.core.deploy import Deployment, deploy
from repro_torch.core.dispatcher import Dispatcher
from repro_torch.core.forecast import (ForecastConfig, PreBootPlanner, RateHistory,
                                       make_forecaster)
from repro_torch.core.metrics import LatencyStats, Recorder, ResidencyTracker
from repro_torch.core.metrics import get_clock as _get_clock
from repro_torch.core.metrics import now as _default_now
from repro_torch.core.resilience import (AdmissionController, AdmissionRejected,
                                         Deadline, ResilienceConfig)
from repro_torch.core.scheduler import ProgramArtifact, SchedulerConfig
from repro_torch.core.simclock import Clock
from repro_torch.core.snapshot import SnapshotStore


class Gateway:
    def __init__(self, *, n_hosts: int = 1, slots_per_host: int = 4,
                 mode: str = "cold", work_dir: Optional[str] = None,
                 hedging: bool = True, speculative: bool = False,
                 batching: Union[bool, BatchingConfig] = False,
                 scheduler: Optional[SchedulerConfig] = None,
                 clock: Optional[Clock] = None,
                 default_driver: Optional[str] = None,
                 resilience: Union[bool, ResilienceConfig, None] = None,
                 forecast: Union[bool, ForecastConfig, None] = None,
                 decode: Union[bool, DecodeConfig, None] = None,
                 device="cuda") -> None:
        if mode not in ("cold", "warm"):
            raise ValueError(f"mode must be 'cold' or 'warm', got {mode!r}")
        self.mode = mode
        self.device = device
        self._default_driver = default_driver
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="repro_torch_faas_")
        Path(self.work_dir).mkdir(parents=True, exist_ok=True)
        self.cache = CompileCache(Path(self.work_dir) / "images")
        # the global chunk store makes every snapshot a v2 chunk manifest:
        # content-addressed, dedup'd across functions, delta-restorable
        self.blobs = ChunkStore(Path(self.work_dir) / "blobs")
        self.snapshots = SnapshotStore(Path(self.work_dir) / "snapshots",
                                       blobs=self.blobs)
        self.recorder = Recorder()
        self.residency = ResidencyTracker()
        self.cluster = Cluster(n_hosts=n_hosts, slots_per_host=slots_per_host,
                               on_exit=self._account_exit, scheduler=scheduler)
        self.agent = Agent(self.recorder, self.residency, clock=clock)
        self._now = clock.now if clock is not None else _default_now
        self._clock = clock
        # resilience=True (or a ResilienceConfig) adds per-request deadlines,
        # early shedding of deadline-infeasible work, and a brownout ladder
        # (hedging and speculation off, streamed restores fall back to eager,
        # coalescer windows clamp) that engages under overload
        self.res_cfg: Optional[ResilienceConfig] = None
        self.admission: Optional[AdmissionController] = None
        if resilience:
            self.res_cfg = resilience if isinstance(resilience, ResilienceConfig) \
                else ResilienceConfig()
            self.admission = AdmissionController(
                self.res_cfg, capacity_slots=n_hosts * slots_per_host)
        self.dispatcher = Dispatcher(self.cluster, self.agent, hedging=hedging,
                                     speculative=speculative, clock=clock,
                                     resilience=self.res_cfg)
        self.coalescer: Optional[Coalescer] = None
        if batching:
            cfg = batching if isinstance(batching, BatchingConfig) else BatchingConfig()
            self.coalescer = Coalescer(self.dispatcher, cfg, clock=clock)
            if self.admission is not None:
                self.coalescer.brownout = lambda: self.admission.brownout
        self.deployments: Dict[str, Deployment] = {}
        # decode=True (or a DecodeConfig) adds the step-granular continuous
        # batching tier: one DecodeScheduler per deployment, with its paged KV
        # pool and deploy-time admit/step programs. Decode-shaped invokes
        # bypass the coalescer's bucket programs entirely — the step loop IS
        # their batching.
        self.decode_cfg: Optional[DecodeConfig] = None
        self.decoders: Dict[str, DecodeScheduler] = {}
        if decode:
            self.decode_cfg = decode if isinstance(decode, DecodeConfig) \
                else DecodeConfig()
        # forecast=True (or a ForecastConfig) turns on predictive pre-boot:
        # a PreBootPlanner ticking on the dispatcher's shared timer predicts
        # per-function arrivals, parks speculative boots + prefetches host
        # tiers ahead of them, and publishes pool targets (zero = full
        # cooldown) that replace the warm autoscaler's idle-timeout heuristic
        self.forecast_cfg: Optional[ForecastConfig] = None
        self.planner: Optional[PreBootPlanner] = None
        if forecast:
            self.forecast_cfg = forecast if isinstance(forecast, ForecastConfig) \
                else ForecastConfig()
            history = RateHistory(self.forecast_cfg,
                                  clock if clock is not None else _get_clock())
            self.planner = PreBootPlanner(
                self.forecast_cfg,
                make_forecaster(self.forecast_cfg, history, device=device),
                self.dispatcher.timer, clock=clock,
                route=lambda image_key: self.cluster.route(image_key),
                preboot=self._planner_preboot,
                prefetch=self._planner_prefetch,
                service_time=self._service_time_estimate)
            self.dispatcher.planner = self.planner
        if mode == "warm":
            self.scaler = WarmPoolAutoscaler(self.cluster, self.deployments,
                                             clock=clock, planner=self.planner)
        else:
            self.scaler = ColdOnlyScaler()
        self.scaler.start()
        if self.planner is not None:
            self.planner.start()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ deploy
    def deploy(self, spec: FunctionSpec) -> Deployment:
        """Build the ExecutorImage (the `fn deploy` + IncludeOS `boot` step)
        on the gateway's device, and the decode bundle when the decode tier
        is on.

        With coalescing enabled the bucket programs are built here too — shape
        buckets are deploy-time artifacts exactly like the base image, so no
        request ever pays an export on the serve path.
        """
        dep = deploy(spec, self.cache, self.snapshots, self.work_dir, device=self.device)
        default = self.cluster.hosts[0].drivers.get(self.default_driver())
        if self.coalescer is not None and default is not None \
                and default.supports_batch:
            # skip in warm mode: the default driver never coalesces there, and
            # a batch-capable driver invoked explicitly builds buckets lazily
            dep.ensure_buckets(b * spec.batch_size for b in self.coalescer.cfg.buckets)
        with self._lock:
            self.deployments[spec.name] = dep
        if self.decode_cfg is not None:
            old = self.decoders.get(spec.name)
            if old is not None:
                # re-deploy of the same name: drain + cool the old scheduler
                # first, or its loop thread and any booted executor leak with
                # residency never accounted
                old.close()
            # decode bundle (admit + step) is a deploy-time artifact: built
            # here, never on a request
            self.decoders[spec.name] = DecodeScheduler(
                dep, self.cluster, self.recorder, self.decode_cfg,
                on_exit=self._account_exit, clock=self._clock)
        if self.planner is not None:
            self.planner.register(dep)
        return dep

    # ------------------------------------------------------- planner hooks
    def _planner_preboot(self, host, dep):
        """Park a forecast-driven boot on ``host`` (None for drivers whose
        starts are impure — the planner then only prefetches/targets)."""
        return self.agent.preboot(host, dep, self.default_driver())

    def _planner_prefetch(self, host, dep) -> bool:
        """Warm ``host``'s artifact tiers ahead of a predicted arrival:
        program payload into the program tier, snapshot chunks into the
        chunk tier (a delta restore — only missing chunks move). Returns
        True if any bytes actually shipped."""
        cache = getattr(host, "cache", None)
        if cache is None:
            return False
        payload = dep.fetch_program_payload()
        moved = cache.prefetch_program(dep.program_key(), ProgramArtifact(payload),
                                       len(payload))
        if not cache.snapshots.contains(dep.image.key):
            try:
                delta_restore(self.snapshots, dep.image.key, cache=cache)
                moved = True
            except Exception:  # noqa: BLE001 - prefetch is advisory: the boot pays
                pass
        return moved

    def _service_time_estimate(self, fn_name: str) -> float:
        est = getattr(self.scaler, "service_time_estimate", None)
        return est(fn_name) if est is not None else 0.05

    # ------------------------------------------------------------------ invoke
    def default_driver(self) -> str:
        if self._default_driver is not None:
            return self._default_driver
        return "unikernel" if self.mode == "cold" else "warm"

    def invoke_async(self, fn_name: str, tokens: Optional[np.ndarray] = None,
                     driver: Optional[str] = None, label: Optional[str] = None,
                     speculative: Optional[bool] = None,
                     deadline_s: Optional[float] = None) -> Future:
        """Submit one request; the Future resolves to the generated tokens
        ([batch, decode_steps] int32, numpy)."""
        dep = self.deployments[fn_name]
        driver = driver or self.default_driver()
        self.scaler.observe_arrival(fn_name)
        if self.planner is not None:
            self.planner.observe_arrival(fn_name)
        if tokens is None:
            tokens = dep.example_tokens()

        # ---- resilience front door: deadline mint + admission + brownout
        deadline = None
        hedging: Optional[bool] = None
        if deadline_s is None and self.res_cfg is not None:
            deadline_s = self.res_cfg.default_deadline_s
        if deadline_s is not None:
            deadline = Deadline.after(deadline_s)
        if self.admission is not None:
            try:
                self.admission.try_admit(deadline)
            except AdmissionRejected as e:
                # shed synchronously but settle asynchronously-shaped: callers
                # treat invoke_async uniformly, a shed is just a failed Future
                f: Future = Future()
                f.set_exception(e)
                return f
            t_admit = self._now()
            if self.admission.brownout:
                # brownout ladder: stop paying for tail insurance (hedges,
                # speculation) and stop carrying background restore tails —
                # eager restores release host slots predictably under overload
                hedging = False
                speculative = False
                if driver == "unikernel_stream":
                    driver = "unikernel"

        drv = self.cluster.hosts[0].drivers.get(driver)
        if self.coalescer is not None and drv is not None and drv.supports_batch:
            fut = self.coalescer.submit(
                dep, tokens, driver, label=label,
                needs_bucket_image=drv.needs_bucket_image,
                speculative=speculative, deadline=deadline)
        else:
            fut = self.dispatcher.submit(dep, tokens, driver, label=label,
                                         speculative=speculative,
                                         deadline=deadline, hedging=hedging)
        if self.admission is not None:
            fut.add_done_callback(
                lambda _f: self.admission.release(self._now() - t_admit))
        return fut

    def invoke_decode_async(self, fn_name: str,
                            tokens: Optional[np.ndarray] = None,
                            max_new: Optional[int] = None,
                            label: Optional[str] = None,
                            deadline_s: Optional[float] = None) -> Future:
        """Submit one request to the continuous-batching decode loop.

        The request joins the step loop at the next admission, decodes one
        token per step next to whoever else is resident, and leaves at
        EOS/budget — paying for exactly the tokens it generates. Bypasses
        the coalescer's bucket programs entirely. Resolves to the generated
        token ids ([n] int32).
        """
        decoder = self.decoders[fn_name]
        self.scaler.observe_arrival(fn_name)
        if self.planner is not None:
            self.planner.observe_arrival(fn_name)
        if tokens is None:
            tokens = decoder.dep.example_tokens()[:1]
        deadline = None
        if deadline_s is None and self.res_cfg is not None:
            deadline_s = self.res_cfg.default_deadline_s
        if deadline_s is not None:
            deadline = Deadline.after(deadline_s)
        return decoder.submit(tokens, max_new=max_new, label=label,
                              deadline=deadline)

    def invoke_decode(self, fn_name: str, tokens: Optional[np.ndarray] = None,
                      max_new: Optional[int] = None,
                      label: Optional[str] = None, timeout: float = 600.0,
                      deadline_s: Optional[float] = None) -> np.ndarray:
        return np.asarray(self.invoke_decode_async(
            fn_name, tokens, max_new=max_new, label=label,
            deadline_s=deadline_s).result(timeout))

    def invoke(self, fn_name: str, tokens: Optional[np.ndarray] = None,
               driver: Optional[str] = None, label: Optional[str] = None,
               timeout: float = 600.0, speculative: Optional[bool] = None,
               deadline_s: Optional[float] = None):
        return self.invoke_async(fn_name, tokens, driver, label,
                                 speculative=speculative,
                                 deadline_s=deadline_s).result(timeout)

    def invoke_many(self, fn_name: str,
                    tokens_list: Sequence[Optional[np.ndarray]],
                    driver: Optional[str] = None, label: Optional[str] = None,
                    timeout: float = 600.0) -> List[np.ndarray]:
        """Submit many requests at once and gather the results in order.

        With ``batching`` enabled this is the coalescer's best case: the whole
        burst lands in one window and shares a handful of executor boots.
        """
        futs = [self.invoke_async(fn_name, t, driver, label) for t in tokens_list]
        return [np.asarray(f.result(timeout)) for f in futs]

    def noop(self, label: str = "noop", timeout: float = 60.0):
        """The paper's /noop URL: platform overhead with no function work."""
        return self.dispatcher.submit(None, None, "noop", label=label).result(timeout)

    # ----------------------------------------------------------------- reports
    def stats(self, label: str, field: str = "e2e") -> LatencyStats:
        return self.recorder.stats(label, field)

    def residency_summary(self) -> Dict[str, float]:
        return self.residency.summary()

    def batching_summary(self) -> Optional[Dict[str, float]]:
        """Coalescing health: batches/requests, boots-per-request, queue delay."""
        if self.coalescer is None:
            return None
        return self.coalescer.summary()

    def placement_summary(self) -> Dict[str, object]:
        """Scheduler + tiered-cache health: per-host hit/miss/evict counters and
        bytes, fleet hit rates, peer vs store fetches, and per-host residency
        (warm-pool device memory for the warm scaler; zero by construction
        for cold)."""
        summary = self.cluster.scheduler.summary()
        residency = self.scaler.per_host_residency(self.cluster)
        for host_id, entry in summary["hosts"].items():
            entry["resident_bytes"] = residency.get(host_id, 0)
        summary["per_host_resident_bytes"] = residency
        return summary

    def resilience_summary(self) -> Dict[str, object]:
        """Attempt amplification, retry-budget state, breaker/quarantine
        counters, and (when admission is on) shed/brownout accounting."""
        d = self.dispatcher
        budget = d.retry_budget
        out: Dict[str, object] = {
            "submitted": d.submitted,
            "attempts": d.attempts,
            "attempt_amplification": d.attempts / max(d.submitted, 1),
            "retries": d.retries,
            "retries_denied": d.retries_denied,
            "retry_budget": {
                "tokens": budget.tokens,
                "deposits": budget.deposits,
                "spent": budget.spent,
                "denied": budget.denied,
            },
            "breakers": self.cluster.scheduler.breakers.summary(),
            "quarantine_skips": self.cluster.scheduler.quarantine_skips,
        }
        if self.admission is not None:
            out["admission"] = self.admission.summary()
        return out

    def forecast_summary(self) -> Optional[Dict[str, object]]:
        """Planner health: model, pre-boots planned/claimed/expired, prefetch
        and full-cooldown counts, and the forecast error (MAE/bias)."""
        if self.planner is None:
            return None
        return self.planner.summary()

    def _account_exit(self, ex) -> None:
        self.residency.add_residency(ex.nbytes, ex.resident_seconds, ex.busy_seconds)

    def decode_summary(self, fn_name: str) -> Optional[Dict[str, float]]:
        """Continuous-batching health: tokens, occupancy, admits, cooldowns."""
        decoder = self.decoders.get(fn_name)
        return decoder.summary() if decoder is not None else None

    # ---------------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        for decoder in self.decoders.values():
            # drain the step loops first: a resident request holds pages and
            # an executor whose residency must land in the tracker
            decoder.close()
        if self.coalescer is not None:
            # flush any requests still collecting in coalescing windows and
            # wait for in-flight batches — no Future may be left dangling
            self.coalescer.drain()
            self.coalescer.close()
        if self.planner is not None:
            # cancel the planner tick + every parked pre-boot BEFORE the
            # shared timer dies with the dispatcher
            self.planner.stop()
        self.dispatcher.close()         # shared hedge-timer thread
        self.scaler.stop()
        for host in self.cluster.hosts:
            # flush warm pools so their residency lands in the tracker (via on_exit)
            warm = host.drivers.get("warm")
            if warm is not None:
                for key in warm.pool_keys():
                    warm.expire_idle(key, 0)
            # evict fork/process donors too — they hold device memory for the
            # platform's whole lifetime and would otherwise never reach
            # _account_exit
            for name in ("fork", "process"):
                drv = host.drivers.get(name)
                if drv is not None:
                    drv.evict_donors()
        self.cluster.shutdown()
