"""The port's Gateway on the CPU, held against the JAX Gateway in cold mode.

The conftest spec (reduced llama3.2-3b, batch 2, prompt 16, 2 decode steps)
at float32, on two hosts with two slots each and no hedging, the port's
snapshot replaced by the JAX deployment's weights (the v2 formats are the
same):

* the port Gateway gives the JAX Gateway's tokens, for ``invoke``,
  ``invoke_many`` and ``invoke_decode``; ``invoke_decode`` also equals a
  standalone port ``DecodeScheduler``;
* under one invoke sequence (store path, the same host, a host killed,
  noop) each request's host and boot stage names equal the JAX Gateway's,
  and so do the tier counters of ``placement_summary``;
* a chunk tier smaller than the snapshot refuses it: every boot pays the
  delta restore again, as in JAX;
* cold residency leaves idle byte-seconds ~0 (checked where no decode tier
  holds an executor between requests); speculative pre-boots are claimed;
  ``shutdown`` leaves no thread behind;
* ``batching`` and ``forecast`` build the coalescer and the planner with
  the JAX package's defaults (``tests/test_torch_batching.py`` and
  ``tests/test_torch_forecast.py`` hold them to JAX; ``mode="warm"``:
  ``tests/test_torch_drivers.py``), an unknown mode raises, and the default
  device is the GPU, with no fallback to the CPU.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
from repro.core.decode import DecodeConfig as JaxDecodeConfig
from repro.core.gateway import Gateway as JaxGateway
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
import repro_torch.configs.base as torch_configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import FunctionSpec, Gateway
from repro_torch.core.cluster import Cluster
from repro_torch.core.decode import DecodeConfig, DecodeScheduler
from repro_torch.core.metrics import Recorder
from repro_torch.core.scheduler import SchedulerConfig

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
SPEC = dict(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=2)


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


def _pair(root, scheduler=None, decode=False, **kw):
    """A JAX and a port Gateway with the same deployment, the port's snapshot
    replaced by the JAX deployment's weights."""
    _register_f32_arch()
    jgw = JaxGateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                     work_dir=str(root / "jax"),
                     scheduler=JaxSchedulerConfig(**scheduler) if scheduler else None,
                     decode=JaxDecodeConfig(slots=2, page_size=8) if decode else None, **kw)
    pgw = Gateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                  work_dir=str(root / "torch"),
                  scheduler=SchedulerConfig(**scheduler) if scheduler else None,
                  decode=DecodeConfig(slots=2, page_size=8) if decode else None,
                  device="cpu", **kw)
    jdep = jgw.deploy(jax_artifact.FunctionSpec(**SPEC))
    dep = pgw.deploy(FunctionSpec(**SPEC))
    pgw.snapshots.save(dep.image.key,
                       params_from_numpy(jgw.snapshots.load_host(jdep.image.key), "cpu"))
    return jgw, pgw


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jgw, pgw = _pair(tmp_path_factory.mktemp("gw_pair"), decode=True)
    yield jgw, pgw
    jgw.shutdown()
    pgw.shutdown()


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (SPEC["batch_size"], SPEC["prompt_len"]), dtype=np.int32)
            for _ in range(n)]


def _name():
    return FunctionSpec(**SPEC).name


# ------------------------------------------------------------------ tokens

def test_port_gateway_on_jax_weights_gives_jax_gateway_tokens(pair):
    jgw, pgw = pair
    for tokens in _prompts(3, seed=1):
        want = np.asarray(jgw.invoke(_name(), tokens))
        got = pgw.invoke(_name(), tokens)
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    default = pgw.invoke(_name())                     # the deployment's example tokens
    np.testing.assert_array_equal(default, np.asarray(jgw.invoke(_name())))


def test_invoke_many_gives_jax_tokens_in_order(pair):
    jgw, pgw = pair
    prompts = _prompts(4, seed=2)
    got = pgw.invoke_many(_name(), prompts, label="many")
    want = jgw.invoke_many(_name(), prompts, label="many")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(pgw.recorder.timelines("many")) == 4


def test_invoke_decode_equals_jax_and_a_standalone_decode_scheduler(pair):
    jgw, pgw = pair
    name = _name()
    prompts = [p[:1] for p in _prompts(3, seed=3)]
    budgets = [2, 1, 2]
    futs = [pgw.invoke_decode_async(name, p, max_new=b, label=f"dec{i}")
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    got = [f.result(120) for f in futs]
    want = [jgw.invoke_decode(name, p, max_new=b) for p, b in zip(prompts, budgets)]
    dep = pgw.deployments[name]
    sched = DecodeScheduler(dep, Cluster(n_hosts=1), Recorder(),
                            DecodeConfig(slots=2, page_size=8))
    try:
        alone = [sched.submit(p, max_new=b).result(120) for p, b in zip(prompts, budgets)]
    finally:
        sched.close()
    for g, w, a, b in zip(got, want, alone, budgets):
        assert g.dtype == np.int32 and g.shape == (b,)
        assert g.tolist() == np.asarray(w).tolist() == a.tolist()
    s = pgw.decode_summary(name)
    assert s["requests"] >= 3 and s["boots"] >= 1
    assert pgw.decode_summary("nope") is None
    assert pgw.invoke_decode(name, max_new=1).shape == (1,)


def test_speculative_preboot_is_claimed_and_gives_the_same_tokens(pair):
    jgw, pgw = pair
    tokens = _prompts(1, seed=4)[0]
    got = pgw.invoke(_name(), tokens, speculative=True, label="spec")
    np.testing.assert_array_equal(got, np.asarray(jgw.invoke(_name(), tokens)))
    (tl,) = pgw.recorder.timelines("spec")
    assert tl.preboot and tl.t_boot_wall > 0
    assert pgw.dispatcher.preboots_launched >= 1


# ------------------------------------------------------ one invoke sequence

def _sequence(gw):
    """Store path, the same host, request 1's host killed, noop."""
    hosts = {}
    handle = gw.agent.handle

    def observed(host, dep, tokens, driver_name, tl, label=None, **kw):
        hosts[label] = host.host_id
        return handle(host, dep, tokens, driver_name, tl, label, **kw)

    gw.agent.handle = observed
    tokens = _prompts(1, seed=5)[0]
    outs = [np.asarray(gw.invoke(_name(), tokens, label="r1")),
            np.asarray(gw.invoke(_name(), tokens, label="r2"))]
    gw.cluster.kill_host(hosts["r1"])
    outs.append(np.asarray(gw.invoke(_name(), tokens, label="r3")))
    gw.noop(label="noop")
    stages = [sorted(gw.recorder.timelines(k)[0].stage_s) for k in ("r1", "r2", "r3")]
    placement = gw.placement_summary()
    # the program payloads differ in size between the packages (a torch.export
    # program, an XLA executable): compare their counts, and every chunk byte
    tiers = {hid: {"program": {k: h["program"][k] for k in ("items", "hits", "misses",
                                                             "evictions")},
                   **{k: h[k] for k in ("snapshot", "peer_fetches", "store_fetches",
                                        "peer_serves", "alive")}}
             for hid, h in placement["hosts"].items()}
    res = gw.resilience_summary()
    residency = gw.residency_summary()
    assert placement["per_host_resident_bytes"] == {0: 0, 1: 0}
    assert gw.stats("r1").n == 1
    return (hosts, stages, tiers, [o.tolist() for o in outs],
            {k: res[k] for k in ("submitted", "attempts", "retries", "retries_denied")},
            residency["total_GBs"] > 0 and residency["idle_GBs"] <= 0.05 * residency["total_GBs"])


def test_invoke_sequence_stages_hosts_and_tiers_equal_jax(tmp_path):
    jgw, pgw = _pair(tmp_path)
    try:
        got, want = _sequence(pgw), _sequence(jgw)
    finally:
        jgw.shutdown()
        pgw.shutdown()
    assert got == want
    hosts, stages, *_, cold_residency = got
    assert cold_residency                  # idle byte-seconds ~0: executors exit at once
    assert hosts["r2"] == hosts["r1"] != hosts["r3"]
    assert stages[0] == sorted(["fetch_program", "fetch_chunks_store", "restore_delta",
                                "deserialize_program", "device_put", "finalize"])
    assert stages[1] == sorted(["fetch_program_cached", "deserialize_program",
                                "restore_weights_cached", "device_put", "finalize"])
    # the survivor never held the image, and a dead peer serves nothing: the
    # store path again
    assert stages[2] == stages[0]


def test_a_chunk_tier_smaller_than_the_snapshot_refuses_it_like_jax(tmp_path):
    jgw, pgw = _pair(tmp_path, scheduler={"snapshot_tier_bytes": 4096})
    try:
        got, want = _sequence(pgw), _sequence(jgw)
    finally:
        jgw.shutdown()
        pgw.shutdown()
    assert got == want
    hosts, stages, tiers, *_ = got
    assert hosts["r2"] == hosts["r1"]
    # the program memo still hits; the weights pay the store path every time
    assert stages[1] == sorted(["fetch_program_cached", "fetch_chunks_store",
                                "restore_delta", "deserialize_program", "device_put",
                                "finalize"])
    assert all(t["snapshot"]["items"] == 0 for t in tiers.values())


# ---------------------------------------------------------------- lifecycle

def test_shutdown_leaves_no_thread_behind(tmp_path):
    _register_f32_arch()
    before = set(threading.enumerate())
    gw = Gateway(n_hosts=2, slots_per_host=2, hedging=True, work_dir=str(tmp_path),
                 decode=DecodeConfig(slots=2, page_size=8), device="cpu")
    gw.deploy(FunctionSpec(**SPEC))
    gw.invoke_many(_name(), [None] * 3)
    gw.invoke_decode(_name(), max_new=1)
    gw.noop()
    assert set(threading.enumerate()) - before         # it did start threads
    gw.shutdown()
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.02)
    assert not set(threading.enumerate()) - before


@pytest.mark.parametrize("kw, item", [({"batching": True}, "A4c"), ({"forecast": True}, "A7")])
def test_unported_modes_raise_naming_the_roadmap_item(tmp_path, kw, item):
    """The modes ROADMAP ``item`` ported (they raised until then) now build
    their component with the JAX Gateway's default configuration; an unknown
    mode still raises."""
    gw = Gateway(work_dir=str(tmp_path), device="cpu", **kw)
    jgw = JaxGateway(work_dir=str(tmp_path / "jax"), **kw)
    try:
        if item == "A4c":
            assert gw.planner is None and gw.forecast_summary() is None
            assert dataclasses.asdict(gw.coalescer.cfg) == dataclasses.asdict(jgw.coalescer.cfg)
            assert gw.batching_summary()["requests"] == 0.0
        else:
            assert gw.coalescer is None and gw.batching_summary() is None
            assert gw.dispatcher.planner is gw.planner
            assert dataclasses.asdict(gw.forecast_cfg) == dataclasses.asdict(jgw.forecast_cfg)
            assert gw.forecast_summary()["model"] == jgw.forecast_summary()["model"] == "ewma"
    finally:
        gw.shutdown()
        jgw.shutdown()
    with pytest.raises(ValueError):
        Gateway(mode="lukewarm", work_dir=str(tmp_path), device="cpu")


def test_the_gateway_runs_on_the_gpu_unless_asked_for_the_cpu(tmp_path):
    gw = Gateway(work_dir=str(tmp_path))
    spec = FunctionSpec(arch="llama3.2-3b", batch_size=1, prompt_len=8, decode_steps=1)
    try:
        assert gw.device == "cuda"
        if torch.cuda.is_available():
            assert gw.deploy(spec).device.type == "cuda"
        else:                       # no card: deploy raises instead of using the CPU
            with pytest.raises((RuntimeError, AssertionError)):
                gw.deploy(spec)
            assert gw.deployments == {}
    finally:
        gw.shutdown()
