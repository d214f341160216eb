"""The port's first-use-ordered streamed restore on the CPU: readiness gates,
PARTIAL executors, fault paths (a failed stream settles exactly once), cancel
hygiene, and the ``unikernel_stream`` driver through the Gateway against the
JAX package's (the cases of tests/test_streaming.py, on the port)."""
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
from repro.core.gateway import Gateway as JaxGateway
import repro_torch.configs.base as torch_configs
import repro_torch.core.blobstore as blobstore_mod
from repro_torch import pytree
from repro_torch.convert import params_from_numpy
from repro_torch.core import FunctionSpec, Gateway
from repro_torch.core.blobstore import ChunkStore, delta_restore, stream_restore
from repro_torch.core.boot import (
    ENGINE, TRACK_PROGRAM, BootCancelled, BootPlan, FinalizeStream, Stage, StreamRestore,
)
from repro_torch.core.dispatcher import _is_transient
from repro_torch.core.drivers import UnikernelDriver, UnikernelStreamDriver
from repro_torch.core.executor import ExecutorState, ReadinessGates
from repro_torch.core.metrics import Timeline
from repro_torch.core.scheduler import CacheDirectory, HostArtifactCache, SchedulerConfig
from repro_torch.core.snapshot import SnapshotStore

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
SPEC = dict(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=2)


# --------------------------------------------------------------- gate units


def _paths():
    return ["['a']", "['b']", "['c']"]


def test_gates_subset_wait_returns_before_completion():
    gates = ReadinessGates(_paths(), head_paths=["['a']"])
    gates.mark_ready("['a']")
    gates.wait_leaves(["['a']"], timeout=1)      # returns: the head is resident
    assert not gates.is_complete()


def test_gates_unknown_leaf_blocks_until_completion():
    """A leaf the stream never announced must block (only full completion
    proves it exists on the device) — never read garbage."""
    gates = ReadinessGates(_paths())
    with pytest.raises(RuntimeError, match="completion timed out"):
        gates.wait_leaves(["['zzz']"], timeout=0.1)
    gates.mark_complete()
    gates.wait_leaves(["['zzz']"], timeout=1)    # completion opens everything


def test_gates_failure_is_transient_for_the_dispatcher():
    gates = ReadinessGates(_paths(), head_paths=["['a']"])
    gates.fail(IOError("peer withdrew chunk deadbeef"))
    for waiter in (lambda: gates.wait_leaves(["['a']"], timeout=1),
                   lambda: gates.wait_complete(timeout=1),
                   lambda: gates.wait_tail_program(timeout=1)):
        with pytest.raises(RuntimeError) as exc_info:
            waiter()
        assert _is_transient(exc_info.value)
    assert not gates.is_complete()               # failed != complete


def test_gates_patch_timelines_bound_before_and_after_finish():
    gates = ReadinessGates(_paths())
    early = Timeline()
    gates.bind_timeline(early)                   # bound while the tail is in flight
    gates.finish_timelines({"restore_stream_tail_bg": 0.5}, 0.5, bytes_fetched=128)
    late = Timeline()
    gates.bind_timeline(late)                    # bound after the tail landed
    for tl in (early, late):
        assert tl.stage_s["restore_stream_tail_bg"] == 0.5
        assert tl.t_boot_wall == 0.5
        assert tl.bytes_fetched == 128


# ------------------------------------------------- synthetic streamed boots


def _serve(params, tokens):
    return params["a"] * 2.0 + params["b"].sum() + params["c"].sum() + tokens


class _SetProgram(Stage):
    name, track = "deserialize_program", TRACK_PROGRAM

    def run(self, ctx):
        ctx.program = _serve


def _stream_dep(tmp_path, chunked=True, head=None, order=None):
    """A minimal Deployment stand-in with a real snapshot on disk."""
    blobs = ChunkStore(tmp_path / "blobs") if chunked else None
    snaps = SnapshotStore(tmp_path / "snaps", blobs=blobs)
    rng = np.random.default_rng(3)
    # integer-valued floats: exact under any summation order
    params = {"a": torch.from_numpy(rng.integers(-4, 5, size=(4, 4)).astype(np.float32)),
              "b": torch.from_numpy(rng.integers(-4, 5, size=(8,)).astype(np.float32)),
              "c": torch.from_numpy(rng.integers(-4, 5, size=(2, 3)).astype(np.float32))}
    key = f"img-stream-torch-{'v2' if chunked else 'v1'}-{tmp_path.name}"
    snaps.save(key, params, first_use_order=order)
    dep = types.SimpleNamespace(image=types.SimpleNamespace(key=key), snapshots=snaps,
                                head_leaves=list(head or []), device=torch.device("cpu"))
    return dep, params


def _stream_plan():
    return BootPlan([_SetProgram(), StreamRestore(), FinalizeStream()])


def _cids(dep, path):
    return {c for e in dep.snapshots.read_index(dep.image.key)["leaves"]
            if e["path"] == path for c in e["chunks"]}


@pytest.mark.parametrize("chunked", [True, False], ids=["v2", "v1"])
def test_streamed_restore_matches_eager_both_formats(tmp_path, chunked):
    order = ["['b']", "['c']", "['a']"]           # non-ordinal on purpose
    dep, params = _stream_dep(tmp_path, chunked=chunked, order=order)
    tokens = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    tl = Timeline()
    ex = ENGINE.execute(_stream_plan(), dep, tl, driver_name="t")
    out = ex.run(tokens, timeline=tl)
    assert torch.equal(out, _serve(params, tokens))
    assert "restore_stream_head" in tl.stage_s
    assert tl.t_first_ready > 0.0 and tl.t_ttfr > 0.0
    # the device tree is a copy, never the host memo's or the snapshot's tensors
    assert all(a is not b for a, b in zip(pytree.leaves(ex.params), pytree.leaves(params)))
    ex.exit()


def test_partial_executor_gates_requests_until_the_tail_lands(tmp_path):
    """A request issued BEFORE the tail finishes blocks on the gates (never
    reads a half-assembled tree) and still returns the eager answer; the bound
    timeline then grows the background stage and the extended wall."""
    dep, params = _stream_dep(tmp_path, head=["['a']"], order=["['a']", "['b']", "['c']"])
    release = threading.Event()
    real_get = ChunkStore.get
    b_cids = _cids(dep, "['b']")

    def stalling_get(self, cid, verify=True):
        if cid in b_cids:                         # stall the tail mid-stream
            assert release.wait(30)
        return real_get(self, cid, verify)

    tokens = torch.zeros((4, 4))
    tl = Timeline()
    try:
        ChunkStore.get = stalling_get
        ex = ENGINE.execute(_stream_plan(), dep, tl, driver_name="t")
        assert ex.state is ExecutorState.PARTIAL  # dispatchable before done
        assert tl.t_first_ready > 0.0
        wall_at_head = tl.t_boot_wall
        ex.gates.bind_timeline(tl)
        done, box = threading.Event(), []

        def request():
            box.append(ex.run(tokens, timeline=tl))
            done.set()

        threading.Thread(target=request, daemon=True).start()
        assert not done.wait(0.3)                 # gated: the tail is still streaming
    finally:
        ChunkStore.get = real_get
        release.set()
    assert done.wait(30)
    assert torch.equal(box[0], _serve(params, tokens))
    ex.gates.wait_complete(30)
    assert ex.state is ExecutorState.READY
    assert tl.stage_s["restore_stream_tail_bg"] > 0.0
    assert tl.t_boot_wall > wall_at_head          # the full-restore wall
    ex.exit()


def test_stream_store_error_fails_gates_and_retries_settle_once(tmp_path):
    """A chunk fetch that dies mid-stream trips the gates: the PARTIAL
    executor's request raises the transient error (so the dispatcher
    re-dispatches) and a fresh boot serves the retry."""
    dep, params = _stream_dep(tmp_path, head=["['a']"], order=["['a']", "['b']", "['c']"])
    real_get = ChunkStore.get
    b_cids = _cids(dep, "['b']")
    fail, proceed = threading.Event(), threading.Event()
    fail.set()

    def failing_get(self, cid, verify=True):
        if fail.is_set() and cid in b_cids:
            assert proceed.wait(30)               # hold the failure until PARTIAL
            raise KeyError(f"chunk {cid} gone")
        return real_get(self, cid, verify)

    tokens = torch.zeros((4, 4))
    try:
        ChunkStore.get = failing_get
        tl = Timeline()
        ex = ENGINE.execute(_stream_plan(), dep, tl, driver_name="t")
        assert ex.state is ExecutorState.PARTIAL
        proceed.set()
        with pytest.raises(RuntimeError) as exc_info:
            ex.run(tokens, timeline=tl)
        assert _is_transient(exc_info.value)
        assert ex.state is ExecutorState.PARTIAL  # crashed, never READY
        ex.exit()
        fail.clear()                              # "the store recovered": retry
        ex2 = ENGINE.execute(_stream_plan(), dep, Timeline(), driver_name="t")
        out = ex2.run(tokens)
    finally:
        ChunkStore.get = real_get
    assert torch.equal(out, _serve(params, tokens))
    ex2.exit()


def test_head_covering_all_leaves_boots_ready_not_partial(tmp_path):
    dep, params = _stream_dep(tmp_path)           # head_leaves = []: every leaf
    ex = ENGINE.execute(_stream_plan(), dep, Timeline(), driver_name="t")
    assert ex.state is ExecutorState.READY and ex.gates.is_complete()
    tokens = torch.ones((4, 4))
    assert torch.equal(ex.run(tokens), _serve(params, tokens))
    ex.exit()


def test_preboot_cancel_mid_stream_stops_transfers_and_leaks_nothing(tmp_path):
    dep, _ = _stream_dep(tmp_path, head=["['a']"], order=["['a']", "['b']", "['c']"])
    stalled, release = threading.Event(), threading.Event()
    real_get = ChunkStore.get
    b_cids = _cids(dep, "['b']")

    def stalling_get(self, cid, verify=True):
        if cid in b_cids:
            stalled.set()
            assert release.wait(30)
        return real_get(self, cid, verify)

    try:
        ChunkStore.get = stalling_get
        handle = ENGINE.launch(_stream_plan(), dep, driver_name="t")
        assert stalled.wait(30)                   # the stream is mid-flight
        handle.cancel()
        release.set()
        deadline = time.time() + 30
        while not handle.done() and time.time() < deadline:
            time.sleep(0.01)
        assert handle.done()
        with pytest.raises(BootCancelled):
            handle.claim(timeout=1)
        if handle._result is not None:
            assert handle._result.executor.state is ExecutorState.EXITED
    finally:
        ChunkStore.get = real_get
        release.set()
    deadline = time.time() + 5
    while time.time() < deadline and [t for t in threading.enumerate()
                                      if t.name.startswith("bootengine-stream")]:
        time.sleep(0.02)
    lingering = [t for t in threading.enumerate()
                 if t.name.startswith("bootengine-stream") and t.is_alive()]
    assert not lingering, lingering


def test_stream_restore_equals_delta_restore_in_first_use_order(tmp_path):
    """The producer delivers every leaf once, in the manifest's order, and
    assembles the delta restore's tree; a second stream through the same
    host tier is served from the memo, still leaf by leaf."""
    order = ["['c']", "['a']", "['b']"]
    dep, params = _stream_dep(tmp_path, order=order)
    cache = HostArtifactCache(0, SchedulerConfig(), CacheDirectory())
    seen = []
    tree, stats = stream_restore(dep.snapshots, dep.image.key, cache,
                                 on_leaf=lambda i, p, leaf: seen.append((i, p)))
    want, _ = delta_restore(dep.snapshots, dep.image.key)
    assert [p for _, p in seen] == order and [i for i, _ in seen] == [2, 0, 1]
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(tree), pytree.leaves(want)))
    assert stats.source == "stream" and stats.bytes_fetched == stats.bytes_total > 0
    s = cache.summary()
    assert s["partial_restores"] == 1 and s["partial_in_flight"] == 0
    seen.clear()
    _, stats = stream_restore(dep.snapshots, dep.image.key, cache,
                              on_leaf=lambda i, p, leaf: seen.append(p))
    assert seen == order and stats.source == "cached"
    with pytest.raises(blobstore_mod.RestoreAborted):      # a cancelled boot's stream
        stream_restore(dep.snapshots, dep.image.key, None, should_abort=lambda: True)


def test_a_partial_restore_is_in_flight_until_its_stream_ends(tmp_path):
    dep, _ = _stream_dep(tmp_path, head=["['a']"], order=["['a']", "['b']", "['c']"])
    cache = HostArtifactCache(0, SchedulerConfig(), CacheDirectory())
    host = types.SimpleNamespace(cache=cache)
    release = threading.Event()
    real_get = ChunkStore.get
    b_cids = _cids(dep, "['b']")

    def stalling_get(self, cid, verify=True):
        if cid in b_cids:
            assert release.wait(30)
        return real_get(self, cid, verify)

    try:
        ChunkStore.get = stalling_get
        ex = ENGINE.execute(_stream_plan(), dep, Timeline(), driver_name="t", host=host)
        assert cache.summary()["partial_in_flight"] == 1
    finally:
        ChunkStore.get = real_get
        release.set()
    ex.gates.wait_complete(30)
    s = cache.summary()
    assert s["partial_in_flight"] == 0 and s["partial_restores"] == 1
    assert cache.snapshots.contains(dep.image.key)      # registered once whole
    ex.exit()


# ----------------------------------------------- full platform integration


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


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_pair")
    _register_f32_arch()
    jgw = JaxGateway(n_hosts=2, slots_per_host=2, hedging=False, work_dir=str(root / "jax"))
    pgw = Gateway(n_hosts=2, slots_per_host=2, hedging=False, work_dir=str(root / "torch"),
                  device="cpu")
    jdep = jgw.deploy(jax_artifact.FunctionSpec(**SPEC))
    dep = pgw.deploy(FunctionSpec(**SPEC))
    pgw.snapshots.save(dep.image.key,
                       params_from_numpy(jgw.snapshots.load_host(jdep.image.key), "cpu"),
                       first_use_order=dep.first_use_order)
    yield jgw, pgw
    jgw.shutdown()
    pgw.shutdown()


def _name():
    return FunctionSpec(**SPEC).name


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (SPEC["batch_size"], SPEC["prompt_len"]), dtype=np.int32)


def test_stream_driver_end_to_end_matches_eager_and_jax(pair):
    jgw, pgw = pair
    tokens = _tokens(11)
    ref = pgw.invoke(_name(), tokens, driver="unikernel", label="stream:ref")
    out = pgw.invoke(_name(), tokens, driver="unikernel_stream", label="stream:out")
    want = np.asarray(jgw.invoke(_name(), tokens, driver="unikernel_stream"))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, want)
    tl = pgw.recorder.timelines("stream:out")[-1]
    assert "restore_stream_head" in tl.stage_s
    assert tl.t_first_ready > 0.0 and tl.t_ttfr > 0.0 and tl.ttfr > 0.0


def test_stream_driver_failed_stream_settles_exactly_once(pair):
    """A store failure in the FIRST streamed restore: the dispatcher classifies
    it transient, re-dispatches, and resolves the future once, correctly."""
    _, pgw = pair
    tokens = _tokens(13)
    ref = pgw.invoke(_name(), tokens, driver="unikernel", label="fault:ref")
    real_stream = blobstore_mod.stream_restore
    calls = []

    def failing_stream(store, key, cache=None, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError(f"chunks for {key} not found (injected)")
        return real_stream(store, key, cache, **kw)

    # a fresh host, so the stream goes to the chunk tiers and the store
    for host in pgw.cluster.hosts:
        host.cache.snapshots.drop(pgw.deployments[_name()].image.key)
    try:
        blobstore_mod.stream_restore = failing_stream
        out = pgw.invoke(_name(), tokens, driver="unikernel_stream", label="fault:out")
    finally:
        blobstore_mod.stream_restore = real_stream
    np.testing.assert_array_equal(out, ref)
    assert len(calls) >= 2                        # failed once, retried
    assert len(pgw.recorder.timelines("fault:out")) == 1      # settled exactly once


def test_stream_boot_completion_extends_the_recorded_timeline(pair):
    """With the real split the background thread swaps in the tail and fused
    programs after the first response: the timeline carries the background
    program stage, and the executor ends on the fused program."""
    _, pgw = pair
    dep = pgw.deployments[_name()]
    assert dep.split_ok
    host = pgw.cluster.hosts[0]
    tl = Timeline()
    ex = host.drivers["unikernel_stream"].start(dep, tl)
    ex.gates.bind_timeline(tl)
    tokens = torch.from_numpy(_tokens(17))
    out = ex.run(tokens, timeline=tl)
    ex.gates.wait_complete(30)
    deadline = time.time() + 30
    while "deserialize_program_bg" not in tl.stage_s and time.time() < deadline:
        time.sleep(0.01)
    assert tl.stage_s["deserialize_program_bg"] > 0.0
    assert 0.0 < tl.t_first_ready <= tl.t_ttfr
    assert tl.t_boot_wall >= tl.stage_s["deserialize_program_bg"]
    assert ex.state is ExecutorState.READY
    assert not getattr(ex.program, "gate_aware", False)     # the fused program now
    assert torch.equal(ex.run(tokens), out)
    ex.exit()
    assert pgw.snapshots.read_index(dep.image.key).get("first_use_order")


def test_a_failed_head_fetch_falls_back_to_the_fused_program(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]

    def missing():
        raise FileNotFoundError("head program gone")

    broken = dataclasses.replace(dep)             # standalone driver: no host tier
    broken.fetch_head_payload = missing
    tl = Timeline()
    ex = UnikernelStreamDriver().start(broken, tl)
    tokens = torch.from_numpy(_tokens(19))
    out = ex.run(tokens, timeline=tl)
    assert not getattr(ex.program, "gate_aware", False)
    assert "fetch_program" in tl.stage_s
    eager = UnikernelDriver().start(dep, Timeline())
    assert torch.equal(out, eager.run(tokens))
    ex.exit()
    eager.exit()


def test_brownout_serves_a_stream_request_eagerly_like_jax(pair):
    """Under brownout the gateway stops carrying background restore tails: a
    ``unikernel_stream`` request boots through ``unikernel``, as in JAX."""
    from repro.core.resilience import AdmissionController as JaxAdmissionController
    from repro.core.resilience import ResilienceConfig as JaxResilienceConfig
    from repro_torch.core.resilience import AdmissionController, ResilienceConfig
    jgw, pgw = pair
    stages = []
    for gw, cfg, adm in ((jgw, JaxResilienceConfig, JaxAdmissionController),
                         (pgw, ResilienceConfig, AdmissionController)):
        gw.res_cfg = cfg(brownout_hi=0.0, default_deadline_s=None)
        gw.admission = adm(gw.res_cfg, capacity_slots=4)    # every admit is in brownout
        try:
            gw.invoke(_name(), _tokens(23), driver="unikernel_stream", label="brownout")
        finally:
            gw.res_cfg = gw.admission = None
        (tl,) = gw.recorder.timelines("brownout")
        stages.append(sorted(tl.stage_s))
    assert stages[0] == stages[1]
    assert "restore_stream_head" not in stages[1] and "device_put" in stages[1]
