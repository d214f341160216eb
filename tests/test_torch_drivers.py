"""The driver taxonomy of the port on the CPU, held against the JAX package.

The conftest spec (reduced llama3.2-3b, batch 2, prompt 16, 2 decode steps)
at float32, a JAX and a port Gateway on two hosts with two slots each and no
hedging, the port's snapshot replaced by the JAX deployment's weights:

* ``ALL_DRIVERS`` and every driver's flags equal JAX's; every driver serves
  through ``Gateway.invoke(..., driver=name)`` with the JAX Gateway's tokens
  (int32, exactly) and the JAX Gateway's stage names, request by request;
* pre-boot is refused for the stateful drivers exactly where JAX refuses it;
* a warm cold-miss records the fallback's stages and a pool hit only
  ``pool_checkout``; a crashed executor never re-enters the pool; donor
  eviction accounts residency; boot threads do not accumulate;
* ``Gateway(mode="warm")`` serves from its pool, and ``WarmPoolAutoscaler``'s
  targets and per-host pool sizes equal JAX's on a virtual clock;
* the image pieces: the head/tail split is bit-identical to the fused
  program, ``first_use_order`` equals JAX's on llama (a pinned difference on
  xlstm and jamba, see below), the generic checkpoint and v1/v2 snapshots
  with a first-use order cross-load in both directions, ``TraceCompile``
  traces on fake tensors, ``Executor.pause`` parks the weights on the host.
"""
import dataclasses
import os
import threading
import time
import types
import zipfile

import jax
import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
from repro.core import snapshot as jax_snapshot
from repro.core.autoscaler import WarmPoolAutoscaler as JaxWarmPoolAutoscaler
from repro.core.blobstore import ChunkStore as JaxChunkStore
from repro.core.deploy import first_use_order as jax_first_use_order
from repro.core.deploy import make_serve_fn as jax_make_serve_fn
from repro.core.drivers import ALL_DRIVERS as JAX_ALL_DRIVERS
from repro.core.drivers import make_drivers as jax_make_drivers
from repro.core.gateway import Gateway as JaxGateway
from repro.core.simclock import VirtualClock as JaxVirtualClock
from repro.dist.sharding import abstract_state
from repro.models import build_model as jax_build_model
import repro_torch.configs.base as torch_configs
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import FunctionSpec, Gateway
from repro_torch.core import compile_cache
from repro_torch.core.autoscaler import WarmPoolAutoscaler
from repro_torch.core.blobstore import ChunkStore
from repro_torch.core.boot import ENGINE, BootPlan, TraceCompile
from repro_torch.core.deploy import ServeProgram, first_use_order, make_tail_fn
from repro_torch.core.drivers import ALL_DRIVERS, WarmDriver, make_drivers
from repro_torch.core.executor import Executor, ExecutorState
from repro_torch.core.metrics import Timeline
from repro_torch.core.simclock import VirtualClock
from repro_torch.core.snapshot import (SnapshotStore, load_generic_checkpoint,
                                       load_generic_host, save_generic_checkpoint)
from repro_torch.models import build_model

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
SPEC = dict(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=2)
FETCH = {"fetch_program", "fetch_program_cached", "fetch_peer"}
RESTORE = {"restore_weights_cached", "restore_delta"}
TRACE_COMPILE_PARTS = {"trace", "compile", "load"}    # the port's sub-stages of trace_compile


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


def _pair(root, mode="cold"):
    """A JAX and a port Gateway with the same deployment, the port's snapshot
    replaced (first-use order kept) by the JAX deployment's weights."""
    _register_f32_arch()
    jgw = JaxGateway(n_hosts=2, slots_per_host=2, mode=mode, hedging=False,
                     work_dir=str(root / "jax"))
    pgw = Gateway(n_hosts=2, slots_per_host=2, mode=mode, hedging=False,
                  work_dir=str(root / "torch"), device="cpu")
    jdep = jgw.deploy(jax_artifact.FunctionSpec(**SPEC))
    dep = pgw.deploy(FunctionSpec(**SPEC))
    pgw.snapshots.save(dep.image.key,
                       params_from_numpy(jgw.snapshots.load_host(jdep.image.key), "cpu"),
                       first_use_order=dep.first_use_order)
    return jgw, pgw


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jgw, pgw = _pair(tmp_path_factory.mktemp("drivers_pair"))
    yield jgw, pgw
    jgw.shutdown()
    pgw.shutdown()


def _name():
    return FunctionSpec(**SPEC).name


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (SPEC["batch_size"], SPEC["prompt_len"]), dtype=np.int32)
            for _ in range(n)]


def _settled(tl, timeout=30.0):
    """A streamed boot's timeline once its background tail has landed."""
    deadline = time.time() + timeout
    while "deserialize_program_bg" not in tl.stage_s and time.time() < deadline:
        time.sleep(0.01)
    return tl


# ------------------------------------------------------------------ taxonomy

def test_all_drivers_equal_jax_and_every_host_holds_them(pair):
    _, pgw = pair
    assert ALL_DRIVERS == JAX_ALL_DRIVERS
    assert tuple(make_drivers()) == ALL_DRIVERS
    for host in pgw.cluster.hosts:
        assert tuple(host.drivers) == ALL_DRIVERS
        assert all(d.host is host for d in host.drivers.values())


@pytest.mark.parametrize("name", ALL_DRIVERS)
def test_driver_flags_equal_jax(name):
    got, want = make_drivers()[name], jax_make_drivers()[name]
    assert got.name == want.name == name
    for flag in ("supports_preboot", "supports_batch", "needs_bucket_image"):
        assert getattr(got, flag) == getattr(want, flag), flag


@pytest.mark.parametrize("name", ALL_DRIVERS)
def test_every_driver_gives_jax_tokens_and_stage_names(pair, name):
    """Each driver serves two requests through both Gateways: the same int32
    tokens and, request by request, the same boot stage names; the port's
    ``trace_compile`` also records its parts (``TRACE_COMPILE_PARTS``)."""
    jgw, pgw = pair
    for i, tokens in enumerate(_prompts(2, seed=10 + ALL_DRIVERS.index(name))):
        label = f"taxonomy:{name}:{i}"
        got = pgw.invoke(_name(), tokens, driver=name, label=label)
        want = np.asarray(jgw.invoke(_name(), tokens, driver=name, label=label))
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        (ptl,), (jtl,) = pgw.recorder.timelines(label), jgw.recorder.timelines(label)
        if name == "unikernel_stream":
            _settled(ptl), _settled(jtl)
        parts = TRACE_COMPILE_PARTS if "trace_compile" in jtl.stage_s else set()
        assert sorted(ptl.stage_s) == sorted(set(jtl.stage_s) | parts), (name, i)
        assert ptl.t_boot_wall >= 0.0 and all(v >= 0.0 for v in ptl.stage_s.values())


def test_stage_names_per_driver(pair):
    """The stage vocabulary each driver records, as in tests/test_boot.py."""
    _, pgw = pair
    expected = {
        "process": [{"reuse_donor"}],
        "fork": [{"alias_donor"}, {"finalize"}],
        "unikernel": [FETCH, {"deserialize_program"}, RESTORE, {"device_put"}, {"finalize"}],
        "unikernel_stream": [FETCH, {"deserialize_program"}, {"restore_stream_head"},
                             {"finalize"}, {"deserialize_program_bg"}],
        "paused": [{"fetch_parked"}, {"device_put"}, {"finalize"}],
        "warm": [{"pool_checkout"} | FETCH],
        "cold_jit": [{"trace_compile"}, {"restore_weights_host"}, {"device_put"},
                     {"finalize"}],
        "cold_jit_cached": [{"trace_compile"}, {"restore_weights_host"}, {"device_put"},
                            {"finalize"}],
    }
    for name, groups in expected.items():
        label = f"vocab:{name}"
        pgw.invoke(_name(), driver=name, label=label)
        tl = pgw.recorder.timelines(label)[-1]
        if name == "unikernel_stream":
            _settled(tl)
        for variants in groups:
            assert variants & set(tl.stage_s), (name, variants, tl.stage_s)


@pytest.mark.parametrize("name", ALL_DRIVERS)
def test_preboot_is_refused_where_jax_refuses_it(pair, name):
    """warm/fork/process mutate pool or donor state, and paused would run its
    whole parking on the dispatcher's thread: none may pre-boot."""
    jgw, pgw = pair
    handle = pgw.agent.preboot(pgw.cluster.hosts[0], pgw.deployments[_name()], name)
    want = jgw.agent.preboot(jgw.cluster.hosts[0], jgw.deployments[_name()], name)
    assert (handle is None) == (want is None)
    assert (handle is None) == (name in ("process", "fork", "paused", "warm"))
    for h in (handle, want):
        if h is not None:
            h.cancel()
            deadline = time.time() + 60
            while not h.done() and time.time() < deadline:
                time.sleep(0.01)
            assert h.done()


def test_speculative_stream_boot_is_claimed_with_the_same_tokens(pair):
    jgw, pgw = pair
    tokens = _prompts(1, seed=30)[0]
    got = pgw.invoke(_name(), tokens, driver="unikernel_stream", speculative=True,
                     label="spec:stream")
    np.testing.assert_array_equal(got, np.asarray(jgw.invoke(_name(), tokens)))
    (tl,) = pgw.recorder.timelines("spec:stream")
    assert tl.preboot and "restore_stream_head" in tl.stage_s


# ---------------------------------------------------------- pools and donors

def test_warm_cold_miss_records_fallback_stage_timings(pair):
    jgw, pgw = pair
    got = {}
    for gw in (pgw, jgw):
        dep = gw.deployments[_name()]
        for host in gw.cluster.hosts:                     # force a cold miss
            host.drivers["warm"].expire_idle(dep.image.key, 0)
        gw.invoke(_name(), driver="warm", label="warmmiss")
        miss = gw.recorder.timelines("warmmiss")[-1]
        for host in gw.cluster.hosts:                     # pools are per host:
            host.drivers["warm"].prewarm(dep, 1)          # guarantee a hit
        gw.invoke(_name(), driver="warm", label="warmhit")
        hit = gw.recorder.timelines("warmhit")[-1]
        for host in gw.cluster.hosts:                     # leave no pools behind
            host.drivers["warm"].expire_idle(dep.image.key, 0)
        got[gw is pgw] = (sorted(miss.stage_s), sorted(hit.stage_s))
    miss, hit = got[True]
    assert {"deserialize_program", "device_put"} <= set(miss) and RESTORE & set(miss)
    assert hit == ["pool_checkout"]
    assert got[True] == got[False]


def test_warm_finish_never_pools_crashed_executors():
    warm = WarmDriver()
    dep = types.SimpleNamespace(image=types.SimpleNamespace(key="img-pool-torch"))
    ok = Executor("img-pool-torch", "warm", lambda p, t: t, {}, "cpu")
    dead = Executor("img-pool-torch", "warm", lambda p, t: t, {}, "cpu")
    dead.exit()
    warm.finish(dep, dead)
    assert warm.pool_size("img-pool-torch") == 0          # EXITED is never pooled
    warm.finish(dep, ok)
    assert warm.pool_size("img-pool-torch") == 1
    assert warm.expire_idle("img-pool-torch", 0) == [ok]
    assert ok.state is ExecutorState.EXITED


def test_a_crashed_executor_is_exited_and_never_pooled(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]
    host = pgw.cluster.hosts[0]
    warm = host.drivers["warm"]
    warm.expire_idle(dep.image.key, 0)
    warm.prewarm(dep, 1)
    (ex,) = warm._pools[dep.image.key]
    good = ex.program

    def crash(*args, **kwargs):
        raise ValueError("program crashed")

    ex.program = crash
    with pytest.raises(ValueError):
        pgw.agent.handle(host, dep, dep.example_tokens(), "warm", Timeline())
    assert ex.state is ExecutorState.EXITED and warm.pool_size(dep.image.key) == 0
    ex.program = good                                     # a fresh boot serves again
    out = pgw.agent.handle(host, dep, dep.example_tokens(), "warm", Timeline())
    assert out.shape == (SPEC["batch_size"], SPEC["decode_steps"])
    assert warm.pool_size(dep.image.key) == 1
    warm.expire_idle(dep.image.key, 0)


def test_donor_eviction_accounts_residency(pair):
    _, pgw = pair
    pgw.invoke(_name(), driver="fork", label="donor:seed")   # materialize a donor
    forks = [h.drivers["fork"] for h in pgw.cluster.hosts if h.drivers["fork"].donor_nbytes()]
    assert forks
    before = pgw.residency.total_byteseconds
    evicted = [d for f in forks for d in f.evict_donors()]
    assert evicted and all(d.state is ExecutorState.EXITED for d in evicted)
    assert all(d.driver == "fork-donor" for d in evicted)
    assert pgw.residency.total_byteseconds > before           # landed in the tracker
    assert all(h.drivers["fork"].donor_nbytes() == 0 for h in pgw.cluster.hosts)


def test_fork_clone_shares_the_donor_and_process_reuses_it(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]
    host = pgw.cluster.hosts[0]
    fork, process = host.drivers["fork"], host.drivers["process"]
    clone = fork.start(dep, Timeline())
    donor = fork.ensure_donor(dep)
    assert clone.shared_weights and clone.nbytes == 0 and clone.params is donor.params
    fork.finish(dep, clone)                               # the clone exits ...
    assert clone.state is ExecutorState.EXITED and donor.params is not None  # ... not the donor
    ex = process.start(dep, Timeline())
    assert ex is process.ensure_donor(dep) and ex.driver == "fork-donor"
    process.finish(dep, ex)
    assert ex.state is ExecutorState.READY                # the donor stays resident


def test_threads_do_not_accumulate(pair):
    """Boot worker threads are per boot and must not pile up."""
    _, pgw = pair
    for name in ("unikernel", "unikernel_stream", "cold_jit"):
        pgw.invoke(_name(), driver=name, label="threads")
    deadline = time.time() + 10
    while time.time() < deadline:
        lingering = [t for t in threading.enumerate()
                     if t.name.startswith("bootengine-") and t.is_alive()]
        if len(lingering) <= 2:
            break
        time.sleep(0.05)
    assert len(lingering) <= 2, lingering


# ------------------------------------------------------------------- warm mode

def test_warm_gateway_serves_from_its_pool_and_shutdown_accounts_it(tmp_path):
    jgw, pgw = _pair(tmp_path, mode="warm")
    try:
        assert pgw.default_driver() == "warm" and pgw.scaler.mode == "warm"
        pgw.scaler.stop()                           # no background ticks in this test
        tokens = _prompts(1, seed=40)[0]
        want = np.asarray(jgw.invoke(_name(), tokens))
        for label in ("w1", "w2"):
            np.testing.assert_array_equal(pgw.invoke(_name(), tokens, label=label), want)
        assert "pool_checkout" not in pgw.recorder.timelines("w1")[0].stage_s
        assert pgw.recorder.timelines("w2")[0].stage_s.keys() == {"pool_checkout"}
        resident = pgw.placement_summary()["per_host_resident_bytes"]
        assert sum(resident.values()) > 0
        assert pgw.scaler.resident_nbytes(pgw.cluster) == sum(resident.values())
        idle_before = pgw.residency_summary()["idle_GBs"]
    finally:
        jgw.shutdown()
        pgw.shutdown()
    assert pgw.residency_summary()["idle_GBs"] > idle_before   # the pool's idle time counted
    assert all(h.drivers["warm"].resident_nbytes() == 0 for h in pgw.cluster.hosts)


def test_warm_pool_autoscaler_targets_and_pools_equal_jax(pair):
    """On a virtual clock: the Little's-law target under a burst, the per-host
    pool sizes a tick prewarms, and the decay to zero past the idle timeout."""
    jgw, pgw = pair
    scalers = [(JaxWarmPoolAutoscaler(jgw.cluster, jgw.deployments, clock=JaxVirtualClock(),
                                      idle_timeout_s=5.0), jgw),
               (WarmPoolAutoscaler(pgw.cluster, pgw.deployments, clock=VirtualClock(),
                                   idle_timeout_s=5.0), pgw)]
    trace = {}
    for scaler, gw in scalers:
        key = gw.deployments[_name()].image.key
        clock = scaler._clock
        steps = []

        def pools():
            return [h.drivers["warm"].pool_size(key) for h in gw.cluster.hosts]

        for host in gw.cluster.hosts:
            host.drivers["warm"].expire_idle(key, 0)
        steps.append(scaler.target(_name()))                       # no arrivals: 0
        scaler.observe_service_time(_name(), 0.4)
        for _ in range(7):                                         # 7 arrivals in 0.7 s
            scaler.observe_arrival(_name())
            clock.run_for(0.1)
        steps.append(scaler.target(_name()))
        scaler._tick()
        steps.append(pools())
        scaler.observe_service_time(_name(), 0.05)                 # a faster service
        steps.append(scaler.target(_name()))
        scaler._tick()
        steps.append(pools())
        clock.run_for(6.0)                                         # past the idle timeout
        steps.append(scaler.target(_name()))
        scaler._tick()
        steps.append(pools())
        trace[gw is pgw] = steps
    assert trace[True] == trace[False]
    assert trace[True][1] > 0 and sum(trace[True][2]) == trace[True][1]
    assert trace[True][-1] == [0, 0]


# ----------------------------------------------------------------- image pieces

def test_split_programs_are_bit_identical_to_the_fused_program(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]
    assert dep.split_ok and dep.image.manifest.extra["split_serve"]
    assert dep.head_leaves == [p for p, _ in pytree.flatten_with_paths(
        pgw.snapshots.load_host(dep.image.key))]
    params = pgw.snapshots.load_host(dep.image.key)            # the JAX weights
    head = dep.cache.load_program(dep.head_program_key())
    tail = dep.cache.load_program(dep.tail_program_key())
    fused = dep.load_program()
    for tokens in _prompts(3, seed=50):
        tokens = torch.from_numpy(tokens)
        with torch.inference_mode():
            tok0, logits, cache = head(params, tokens)
            kept = pytree.tree_map(torch.clone, cache)
            split = tail(params, logits, cache)
            want = fused(params, tokens)
        assert split.dtype == torch.int32 and torch.equal(split, want)
        assert torch.equal(tok0[:, 0], want[:, 0])
        # the tail clones the cache once and writes its copy, never the input
        assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(cache), pytree.leaves(kept)))
    graph = torch.export.export(make_tail_fn(dep.model, dep.spec),
                                (params, logits, cache)).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert not any("scatter" in t for t in targets)
    assert targets.count("aten.clone.default") == len(pytree.leaves(cache))
    assert targets.count("repro_torch.decode_attention.default") == \
        dep.model.cfg.n_layers * SPEC["decode_steps"]


def test_fetch_head_payload_only_for_a_verified_split(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]
    assert dep.fetch_head_payload() == dep.cache.read_program_bytes(dep.head_program_key())
    off = dataclasses.replace(dep, split_ok=False)
    assert off.fetch_head_payload() is None


def test_first_use_order_equals_jax_on_llama(pair):
    jgw, pgw = pair
    got = pgw.deployments[_name()].first_use_order
    want = jgw.deployments[_name()].first_use_order
    assert got == want
    assert got[0] == "['embed']['tok']" and got[-1] == "['final']['scale']"
    assert pgw.snapshots.read_index(pgw.deployments[_name()].image.key)[
        "first_use_order"] == got


def _block(path):
    return path.rsplit("[", 1)[0]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_first_use_order_on_xlstm_and_jamba_pins_the_difference(arch):
    """The two walks agree on the order of the blocks (embedding, each block
    kind in the order the layer runs it, final norm, unembedding) and give a
    permutation of every leaf. Within a block they differ for a reason of the
    trace: the JAX walk takes a nested jaxpr whose signature does not match
    its call as ONE use of all its operands, in flattening (sorted) order,
    while the exported graph has no nested calls, so the port lists the
    block's leaves in the order its ops use them."""
    spec = dict(arch=arch, batch_size=2, prompt_len=16, decode_steps=2)
    jcfg = jax_configs.get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, max_seq=18)
    want = jax_first_use_order(
        jax_make_serve_fn(jmodel, jax_artifact.FunctionSpec(**spec)),
        abstract_state(jmodel.param_specs()), jax.ShapeDtypeStruct((2, 16), jax.numpy.int32))
    model = build_model(get_config(arch).reduced(), max_seq=18)
    with torch._subclasses.fake_tensor.FakeTensorMode():
        params = pytree.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                                 model.param_specs())
        tokens = torch.empty((2, 16), dtype=torch.int32)
    got = first_use_order(torch.export.export(ServeProgram(model, FunctionSpec(**spec)),
                                              (params, tokens)))
    assert sorted(got) == sorted(want) and len(set(got)) == len(got)
    blocks = lambda order: list(dict.fromkeys(_block(p) for p in order))  # noqa: E731
    assert blocks(got) == blocks(want)
    assert got != want                                  # the pinned within-block difference


def _jax_tree(rng):
    import ml_dtypes
    return {"w": rng.standard_normal((3, 5)).astype(np.float32).astype(ml_dtypes.bfloat16),
            "a": {"b": rng.standard_normal((4,)).astype(np.float32),
                  "c": rng.standard_normal((2, 2)).astype(np.float32)},
            "list": [rng.standard_normal((6,)).astype(np.float32)]}


def test_generic_checkpoint_cross_loads_in_both_directions(tmp_path):
    tree = _jax_tree(np.random.default_rng(0))
    port_tree = params_from_numpy(tree, "cpu")
    jax_snapshot.save_generic_checkpoint(tmp_path / "jax.npz", tree)
    save_generic_checkpoint(tmp_path / "port.npz", port_tree)
    # the same arrays under the same names, in JAX's flattening order
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files) == ["a0", "a1", "a2", "a3"]
        for f in zj.files:
            assert zj[f].dtype == zp[f].dtype == np.float32
            assert zj[f].tobytes() == zp[f].tobytes(), f
    with zipfile.ZipFile(tmp_path / "port.npz") as z:
        assert [i.compress_type for i in z.infolist()] == [zipfile.ZIP_STORED] * 4
    back = load_generic_host(tmp_path / "jax.npz", port_tree)        # JAX -> port
    for (p, got), (_, want) in zip(pytree.flatten_with_paths(back),
                                   pytree.flatten_with_paths(port_tree)):
        assert got.dtype == want.dtype and torch.equal(got, want), p
    jback = jax_snapshot.load_generic_host(tmp_path / "port.npz", tree)  # port -> JAX
    for got, want in zip(jax.tree.leaves(jback), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    on_dev = load_generic_checkpoint(tmp_path / "jax.npz", port_tree, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(on_dev),
                                                  pytree.leaves(port_tree)))


@pytest.mark.parametrize("chunked", [False, True], ids=["v1", "v2"])
def test_snapshot_with_first_use_order_cross_loads_in_both_directions(tmp_path, chunked):
    tree = _jax_tree(np.random.default_rng(1))
    port_tree = params_from_numpy(tree, "cpu")
    order = ["['list'][0]", "['w']", "['a']['c']"]       # partial: ['a']['b'] appended
    stores = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        cls, blobs = ((jax_snapshot.SnapshotStore, JaxChunkStore) if who == "jax"
                      else (SnapshotStore, ChunkStore))
        store = cls(root / "snaps", blobs=blobs(root / "blobs") if chunked else None)
        store.save("img", tree if who == "jax" else port_tree, first_use_order=order)
        stores[who] = (root, cls, blobs)
    for writer, reader in (("jax", "port"), ("port", "jax")):
        root, _, _ = stores[writer]
        _, cls, blobs = stores[reader]
        store = cls(root / "snaps", blobs=blobs(root / "blobs") if chunked else None)
        index = store.read_index("img")
        assert index["first_use_order"] == order
        assert store.leaf_order(index) == [2, 3, 1, 0]
        if reader == "port":
            got = [(i, p, leaf) for i, p, leaf in store.iter_restore("img")]
            want = pytree.flatten_with_paths(port_tree)
            assert [i for i, _, _ in got] == [2, 3, 1, 0]
            for i, p, leaf in got:
                assert p == want[i][0] and torch.equal(leaf, want[i][1])
        else:
            got = list(store.iter_restore("img"))
            want = jax.tree.leaves(tree)
            assert [i for i, _, _ in got] == [2, 3, 1, 0]
            for i, _, leaf in got:
                assert np.asarray(leaf).tobytes() == want[i].tobytes()
    # the two packages write the same index
    assert stores["jax"][1](tmp_path / "jax" / "snaps").read_index("img") == \
        SnapshotStore(tmp_path / "port" / "snaps").read_index("img")


def test_ensure_generic_writes_once_and_equals_the_jax_deployments_file(pair):
    jgw, pgw = pair
    dep, jdep = pgw.deployments[_name()], jgw.deployments[_name()]
    path = dep.ensure_generic()
    assert path == dep.generic_ckpt and path.endswith(f"{dep.image.key}_generic.npz")
    mtime = os.stat(path).st_mtime_ns
    assert dep.ensure_generic() == path
    assert os.stat(path).st_mtime_ns == mtime                       # not rewritten
    with np.load(path) as zp, np.load(jdep.generic_ckpt) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zj.files:
            assert zp[f].tobytes() == zj[f].tobytes(), f


def test_trace_compile_traces_on_fake_tensors_and_gives_the_fused_tokens(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]
    real_export = torch.export.export
    seen = []

    def spy(mod, args, *a, **kw):
        seen.extend(type(t).__name__ for t in pytree.leaves(args))
        return real_export(mod, args, *a, **kw)

    class JustTrace(TraceCompile):
        def run(self, ctx):
            super().run(ctx)
            ctx.executor = Executor(dep.image.key, "t", ctx.program,
                                    pgw.snapshots.load_host(dep.image.key), "cpu")

    torch.export.export = spy
    try:
        ex = ENGINE.execute(BootPlan([JustTrace()]), dep, Timeline(), driver_name="t")
    finally:
        torch.export.export = real_export
    assert seen and set(seen) == {"FakeTensor"}
    tokens = torch.from_numpy(dep.example_tokens(seed=3))
    with torch.inference_mode():
        want = dep.load_program()(ex.params, tokens)
    assert torch.equal(ex.run(tokens), want)
    ex.exit()


def test_executor_pause_parks_the_weights_on_the_host():
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    ex = Executor("img-pause-torch", "paused", lambda p, t: p["w"] + t, params, "cpu")
    host = ex.pause()
    assert ex.state is ExecutorState.PAUSED and ex.params is None
    assert torch.equal(host["w"], params["w"]) and host["w"] is not params["w"]
    with pytest.raises(RuntimeError, match="not runnable"):
        ex.run(torch.ones(1))


def test_inductor_disk_cache_pair_sets_and_restores_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR", raising=False)
    monkeypatch.setenv("TORCHINDUCTOR_FX_GRAPH_CACHE", "0")
    compile_cache.enable_inductor_disk_cache(tmp_path / "cache")
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "cache")
    assert os.environ["TORCHINDUCTOR_FX_GRAPH_CACHE"] == "1"
    assert (tmp_path / "cache").is_dir()
    compile_cache.disable_inductor_disk_cache()
    assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ
    assert os.environ["TORCHINDUCTOR_FX_GRAPH_CACHE"] == "0"
