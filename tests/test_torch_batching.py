"""The port's coalescer and bucket programs on the CPU, held against the JAX package.

The conftest spec (reduced llama3.2-3b, batch 2, prompt 16, 2 decode steps)
at float32, a JAX and a port Gateway with ``batching=`` on two hosts with two
slots each and no hedging, the port's snapshot replaced by the JAX
deployment's weights:

* the cases of the JAX package's ``tests/test_batching.py`` that the port
  has: bucket rounding, fan-out of mixed burst sizes, batch-aware Timelines,
  the padding mask and ``Executor.run_batch``, a bucket program built once
  and reused (and refused when it does not verify), a non-batchable driver
  bypassing the coalescer, drain and shutdown, whole-batch retry exactly once
  per member, a terminal failure failing every member, the adaptive window
  (step for step JAX's on a virtual clock), a nonconforming token shape
  rejected;
* ``tests/test_batching_equiv.py``'s bucket equivalence: a coalesced batch,
  whatever its bucket and composition, gives each member exactly its
  per-request tokens (float32 on the CPU: the rows of torch's CPU GEMM do
  not depend on M here), which are also the JAX package's tokens;
* the port Gateway(batching=...) gives the JAX Gateway's tokens, boot stage
  names, hosts and ``batching_summary`` counts on one invoke sequence, for
  ``unikernel`` and for ``cold_jit`` (whose ``TraceCompile`` traces at the
  bucket shape).
"""
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
from repro.core.batching import BatchingConfig as JaxBatchingConfig
from repro.core.batching import CoalescedBatch as JaxCoalescedBatch
from repro.core.batching import Coalescer as JaxCoalescer
from repro.core.batching import _FnQueue as _JaxFnQueue
from repro.core.gateway import Gateway as JaxGateway
from repro.core.simclock import VirtualClock as JaxVirtualClock
import repro_torch.configs.base as torch_configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import FunctionSpec, Gateway
from repro_torch.core.batching import BatchingConfig, CoalescedBatch, Coalescer, _FnQueue
from repro_torch.core.cluster import Cluster, HostFailure
from repro_torch.core.dispatcher import Dispatcher
from repro_torch.core.executor import Executor
from repro_torch.core.metrics import now
from repro_torch.core.simclock import VirtualClock

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
SPEC = dict(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=2)
WINDOW_S = 0.02                       # wide enough that a burst lands in one batch


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


def _pair(root, buckets=(1, 2, 4, 8)):
    """A JAX and a port Gateway with coalescing on and the same deployment,
    the port's snapshot replaced by the JAX deployment's weights."""
    _register_f32_arch()
    jgw = JaxGateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                     work_dir=str(root / "jax"),
                     batching=JaxBatchingConfig(buckets=buckets, min_window_s=WINDOW_S))
    pgw = Gateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                  work_dir=str(root / "torch"),
                  batching=BatchingConfig(buckets=buckets, min_window_s=WINDOW_S), device="cpu")
    jdep = jgw.deploy(jax_artifact.FunctionSpec(**SPEC))
    dep = pgw.deploy(FunctionSpec(**SPEC))
    pgw.snapshots.save(dep.image.key,
                       params_from_numpy(jgw.snapshots.load_host(jdep.image.key), "cpu"))
    return jgw, pgw


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jgw, pgw = _pair(tmp_path_factory.mktemp("batching_pair"))
    yield jgw, pgw
    jgw.shutdown()
    pgw.shutdown()


def _name():
    return FunctionSpec(**SPEC).name


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (SPEC["batch_size"], SPEC["prompt_len"]), dtype=np.int32)
            for _ in range(n)]


def _unbatched(gw, tokens, label="ref"):
    dep = gw.deployments[_name()]
    return np.asarray(gw.dispatcher.submit(dep, tokens, "unikernel", label=label).result(300))


def _make_batch(toks, bucket):
    rows = SPEC["batch_size"]
    stacked = np.concatenate(toks, axis=0)
    padded = np.concatenate([stacked, np.zeros((bucket * rows - stacked.shape[0],
                                                stacked.shape[1]), stacked.dtype)], axis=0)
    return CoalescedBatch(tokens=padded, n_requests=len(toks), bucket=bucket,
                          rows_per_request=rows, enqueue_times=[now()] * len(toks),
                          labels=[None] * len(toks))


def _fake_dep(batch_size=2, prompt_len=4, name="fn"):
    return types.SimpleNamespace(
        name=name, base_rows=batch_size,
        spec=types.SimpleNamespace(batch_size=batch_size, prompt_len=prompt_len),
        ensure_bucket=lambda rows: None)


# -------------------------------------------------------------- configuration

@pytest.mark.parametrize("buckets", [(1, 2, 4, 8), (1, 2, 4), (2, 3), (8,)])
def test_bucket_rounding_equals_jax(buckets):
    cfg, jcfg = BatchingConfig(buckets=buckets), JaxBatchingConfig(buckets=buckets)
    assert [cfg.bucket_for(n) for n in range(1, 11)] == [jcfg.bucket_for(n)
                                                          for n in range(1, 11)]
    assert cfg.max_batch == jcfg.max_batch
    assert dataclasses.asdict(BatchingConfig()) == dataclasses.asdict(JaxBatchingConfig())


# ---------------------------------------------------------------- integration

@pytest.mark.parametrize("burst", [5, 2, 1])
def test_fan_out_of_mixed_burst_sizes_gives_per_request_and_jax_tokens(pair, burst):
    """Bursts of different sizes coalesce into different buckets; every request
    gets back exactly what the unbatched program gives for ITS tokens, and
    what the JAX Gateway's coalesced path gives."""
    jgw, pgw = pair
    toks = _prompts(burst, seed=10 + burst)
    outs = pgw.invoke_many(_name(), toks, label=f"mixed:{burst}")
    want = jgw.invoke_many(_name(), toks, label=f"mixed:{burst}")
    for out, w, t in zip(outs, want, toks):
        assert out.shape == (SPEC["batch_size"], SPEC["decode_steps"]) and out.dtype == np.int32
        np.testing.assert_array_equal(out, _unbatched(pgw, t))
        np.testing.assert_array_equal(out, np.asarray(w))
    summary = pgw.batching_summary()
    assert summary["requests"] >= burst
    if burst > 1:
        assert summary["boots_per_request"] < 1.0          # coalescing engaged


def test_coalesced_timelines_are_batch_aware(pair):
    """One timeline per member request: shared boot stamps, own queue-delay."""
    _, pgw = pair
    pgw.invoke_many(_name(), _prompts(4, seed=100), label="tl:batch")
    tls = pgw.recorder.timelines("tl:batch")
    assert len(tls) == 4
    coalesced = [t for t in tls if t.batch_size > 1]
    assert coalesced
    for t in coalesced:
        assert t.queue_wait >= 0
        assert t.boots_share == pytest.approx(1.0 / t.batch_size)
    by_done = {}
    for t in coalesced:
        by_done.setdefault(t.t_done, []).append(t)
    for members in by_done.values():
        assert len({id(m.stage_s) for m in members}) == 1
        assert len({m.t_boot_wall for m in members}) == 1


def test_padding_mask_and_run_batch_drop_the_padding_rows(pair):
    """3 requests padded to the 4-bucket: padding rows are dropped and real
    rows match the unbatched program exactly; ``Executor.run_batch`` slices
    the rows of any program."""
    _, pgw = pair
    dep = pgw.deployments[_name()]
    toks = _prompts(3, seed=200)
    batch = _make_batch(toks, 4)
    dep.ensure_bucket(batch.padded_rows)
    out = pgw.dispatcher.submit_batch(dep, batch, "unikernel", label="pad").result(300)
    assert out.shape[0] == batch.valid_rows
    for i, t in enumerate(toks):
        np.testing.assert_array_equal(out[batch.rows_of(i)], _unbatched(pgw, t))
    ex = Executor("run-batch-toy", "test", lambda p, t: t * 2, {"w": torch.ones(2)}, "cpu")
    got = ex.run_batch(torch.arange(8).reshape(4, 2), valid_rows=3)
    assert got.shape == (3, 2)
    np.testing.assert_array_equal(got.numpy(), (np.arange(8).reshape(4, 2) * 2)[:3])


def test_bucket_program_built_once_reused_and_keyed_like_jax(pair):
    jgw, pgw = pair
    dep, jdep = pgw.deployments[_name()], jgw.deployments[_name()]
    rows = 4 * SPEC["batch_size"]
    dep.ensure_bucket(rows)
    assert {f"bucket{rows}_{k}" for k in ("export", "save", "load", "verify")} <= set(dep.build_s)
    export = torch.export.export
    torch.export.export = None                            # a second build would fail
    try:
        dep.ensure_bucket(rows)
    finally:
        torch.export.export = export
    assert callable(dep.load_program(bucket_rows=rows))
    for d in (dep, jdep):
        assert d.program_key(rows) == d.bucket_image_key(rows) == f"{d.image.key}-b{rows}"
        assert d.program_key(None) == d.program_key(d.base_rows) == d.image.key
        with pytest.raises(KeyError, match="ensure_bucket"):
            d.load_program(bucket_rows=6)
    assert dep.abstract_tokens_for(rows) == tuple(jdep.abstract_tokens_for(rows).shape)
    assert dep.fetch_program_payload(rows) == dep.cache.read_program_bytes(
        dep.bucket_image_key(rows))


def test_buckets_built_together_restore_the_weights_once(pair):
    """``ensure_buckets`` restores the snapshot's weights once for every
    bucket still to build, skips the base shape and built buckets, and
    registers each one verified."""
    _, pgw = pair
    dep = pgw.deployments[_name()]
    rows = [7 * SPEC["batch_size"], 9 * SPEC["batch_size"]]
    load_host, loads = dep.snapshots.load_host, []
    dep.snapshots.load_host = lambda key: loads.append(key) or load_host(key)
    try:
        dep.ensure_buckets(rows + [rows[0], dep.base_rows])
        dep.ensure_buckets(rows)
    finally:
        dep.snapshots.load_host = load_host
    assert loads == [dep.image.key]
    assert "buckets_restore" in dep.build_s
    for r in rows:
        assert r in dep._buckets and dep.cache.has(dep.bucket_image_key(r))
        assert {f"bucket{r}_{k}" for k in ("export", "save", "load", "verify")} <= \
            set(dep.build_s)
    assert dep.base_rows not in dep._buckets


def test_a_bucket_program_that_does_not_verify_raises_and_is_not_registered(pair):
    _, pgw = pair
    dep = pgw.deployments[_name()]
    load = dep.cache.load_program
    dep.cache.load_program = lambda key: (lambda params, tokens: torch.zeros(
        tokens.shape[0], SPEC["decode_steps"], dtype=torch.int32))
    try:
        with pytest.raises(RuntimeError, match="differ from the eager"):
            dep.ensure_bucket(12)
    finally:
        dep.cache.load_program = load
    assert 12 not in dep._buckets and not dep.cache.has(dep.bucket_image_key(12))
    with pytest.raises(KeyError):
        dep.load_program(bucket_rows=12)


def test_non_batchable_driver_bypasses_the_coalescer(pair):
    jgw, pgw = pair
    before = pgw.coalescer.requests
    tokens = _prompts(1, seed=300)[0]
    out = pgw.invoke(_name(), tokens, driver="warm", label="bypass:warm")
    assert pgw.coalescer.requests == before
    np.testing.assert_array_equal(out, np.asarray(jgw.invoke(_name(), tokens, driver="warm")))


def test_coalescer_drains_cleanly(pair):
    """Requests still sitting in a (long) coalescing window complete on drain."""
    _, pgw = pair
    dep = pgw.deployments[_name()]
    co = Coalescer(pgw.dispatcher, BatchingConfig(min_window_s=30.0, max_window_s=60.0))
    futs = [co.submit(dep, t, "unikernel", label="drain") for t in _prompts(3, seed=400)]
    assert not any(f.done() for f in futs)                # held by the 30 s window
    co.drain()
    for f in futs:
        assert np.asarray(f.result(1)).shape == (SPEC["batch_size"], SPEC["decode_steps"])
    co.close()


def test_gateway_shutdown_drains_coalescer(tmp_path):
    gw = Gateway(n_hosts=1, slots_per_host=1, mode="cold", hedging=False, batching=True,
                 work_dir=str(tmp_path), device="cpu")
    drained = []
    gw.coalescer.drain = lambda *a, **k: drained.append(True)
    gw.shutdown()
    assert drained


# ----------------------------------------------------------- dispatcher level

def test_batch_retry_redispatches_all_members_exactly_once():
    """A transient batch failure retries the WHOLE batch as one unit: every
    member is re-dispatched exactly once, and every member future resolves."""
    cluster = Cluster(n_hosts=2, slots_per_host=2)
    calls, lock = [], threading.Lock()

    class BatchAgent:
        def handle_batch(self, host, dep, batch, driver_name, tl, label=None,
                         preboot=None):
            with lock:
                calls.append(batch)
                n = len(calls)
            tl.t_dispatch = tl.t_dispatch or now()
            if n == 1:
                raise HostFailure("injected")
            tl.t_done = now()
            return batch.tokens[:batch.valid_rows] * 2

    disp = Dispatcher(cluster, BatchAgent(), hedging=False)
    co = Coalescer(disp, BatchingConfig(min_window_s=0.05, max_window_s=0.1))
    try:
        futs = [co.submit(_fake_dep(), np.full((2, 4), i, np.int32), "unikernel",
                          needs_bucket_image=False) for i in range(3)]
        outs = [np.asarray(f.result(10)) for f in futs]
        assert len(calls) == 2                        # fail once, retry once
        assert disp.retries == 1
        assert all(c.n_requests == 3 for c in calls)  # the whole batch each attempt
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(out, np.full((2, 4), 2 * i))
        assert co.summary()["batches"] == 1.0         # one logical batch
    finally:
        co.close()
        disp.close()
        cluster.shutdown()


def test_batch_terminal_failure_fails_every_member():
    cluster = Cluster(n_hosts=2, slots_per_host=2)

    class BadAgent:
        def handle_batch(self, host, dep, batch, driver_name, tl, label=None,
                         preboot=None):
            raise ValueError("bad batch")             # not transient

    disp = Dispatcher(cluster, BadAgent(), hedging=False)
    co = Coalescer(disp, BatchingConfig(min_window_s=0.05, max_window_s=0.1))
    try:
        futs = [co.submit(_fake_dep(), np.zeros((2, 4), np.int32), "unikernel",
                          needs_bucket_image=False) for _ in range(2)]
        for f in futs:
            with pytest.raises(ValueError):
                f.result(10)
        assert disp.retries == 0
    finally:
        co.close()
        disp.close()
        cluster.shutdown()


# ------------------------------------------------------------ window control

def _windows(pkg, clock):
    """The window after each of a fixed sequence of batches: healthy
    coalescing, queue delay over budget, a singleton, a failure, then
    healthy again."""
    config_cls, coalescer_cls, queue_cls, batch_cls = pkg
    co = coalescer_cls(dispatcher=None, clock=clock, config=config_cls(
        min_window_s=0.001, max_window_s=0.05, delay_fraction=0.5))
    q = queue_cls(_fake_dep(), "unikernel", False, co.cfg)
    out = []
    for t, n, delay, service, failed in [(1.0, 2, 0.001, 0.1, False),
                                         (2.0, 2, 0.001, 0.1, False),
                                         (3.0, 2, 10.0, 0.001, False),
                                         (4.0, 1, 0.0, 0.1, False),
                                         (5.0, 3, 0.002, 0.2, True),
                                         (6.0, 4, 0.001, 0.3, False)]:
        clock.run_until(t)
        batch = batch_cls(tokens=np.zeros((2 * n, 4), np.int32), n_requests=n, bucket=n,
                          rows_per_request=2, enqueue_times=[t - service - delay] * n,
                          labels=[None] * n)
        co._adapt_window(q, batch, t_flush=t - service, failed=failed)
        out.append(q.window)
    co.close()
    return out


def test_adaptive_window_grows_and_shrinks_like_jax():
    got = _windows((BatchingConfig, Coalescer, _FnQueue, CoalescedBatch), VirtualClock())
    assert got == _windows((JaxBatchingConfig, JaxCoalescer, _JaxFnQueue, JaxCoalescedBatch),
                           JaxVirtualClock())
    assert got[1] > got[0] > 0.001                    # healthy coalescing grows it
    assert got[2] < got[1]                            # over the delay budget: shrink
    assert got[3] <= got[2] and got[4] <= got[3]      # a singleton, a failure: shrink
    assert min(got) >= 0.001


def test_submit_rejects_nonconforming_token_shape():
    """A wrong-shaped member would silently shift every later member's rows in
    the stacked batch — it is rejected synchronously instead."""
    co = Coalescer(dispatcher=None, config=BatchingConfig())
    with pytest.raises(ValueError, match="request shape"):
        co.submit(_fake_dep(batch_size=2, prompt_len=4), np.zeros((1, 4), np.int32),
                  "unikernel")
    with pytest.raises(ValueError, match="request shape"):
        co.submit(_fake_dep(batch_size=2, prompt_len=4), np.zeros((2, 8), np.int32),
                  "unikernel")
    assert co.requests == 0
    co.close()


# ------------------------------------------------- bucket equivalence (equiv)

# composition size -> bucket it rounds to: every bucket, full and padded
COMPOSITIONS = [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8)]


@pytest.mark.parametrize("n,bucket", COMPOSITIONS, ids=[f"n{n}b{b}" for n, b in COMPOSITIONS])
def test_every_bucket_equals_per_request_and_jax(pair, n, bucket):
    jgw, pgw = pair
    dep = pgw.deployments[_name()]
    toks = _prompts(n, seed=1000 + 10 * bucket + n)
    dep.ensure_bucket(bucket * SPEC["batch_size"])
    batch = _make_batch(toks, bucket)
    out = pgw.dispatcher.submit_batch(dep, batch, "unikernel",
                                      label=f"equiv:b{bucket}").result(300)
    assert out.shape[0] == batch.valid_rows
    for i, t in enumerate(toks):
        np.testing.assert_array_equal(out[batch.rows_of(i)], _unbatched(pgw, t))
        np.testing.assert_array_equal(out[batch.rows_of(i)], _unbatched(jgw, t))


def test_mixed_composition_duplicates_and_degenerate(pair):
    """Distinct, duplicated and all-zero prompts in one batch: duplicates come
    back identical to each other and to their solo run."""
    _, pgw = pair
    dep = pgw.deployments[_name()]
    a, b = _prompts(2, seed=2000)
    z = np.zeros_like(a)
    toks = [a, b, a, z, z]                            # 5 members -> bucket 8
    dep.ensure_bucket(8 * SPEC["batch_size"])
    batch = _make_batch(toks, 8)
    out = pgw.dispatcher.submit_batch(dep, batch, "unikernel", label="equiv:mixed").result(300)
    member = [out[batch.rows_of(i)] for i in range(len(toks))]
    np.testing.assert_array_equal(member[0], member[2])
    np.testing.assert_array_equal(member[3], member[4])
    for t, got in zip((a, b, z), (member[0], member[1], member[3])):
        np.testing.assert_array_equal(got, _unbatched(pgw, t))


def test_whole_batch_retry_is_bit_exact(pair):
    """One transient failure injected into the real batch agent: the whole batch
    re-dispatches as a unit and every member still gets its unbatched tokens."""
    _, pgw = pair
    agent = pgw.dispatcher.agent
    state = {"calls": 0}
    real = agent.handle_batch

    def flaky(*args, **kwargs):
        state["calls"] += 1
        if state["calls"] == 1:
            raise HostFailure("injected batch failure")
        return real(*args, **kwargs)

    retries0 = pgw.dispatcher.retries
    agent.handle_batch = flaky
    try:
        toks = _prompts(3, seed=4000)
        outs = pgw.invoke_many(_name(), toks, label="equiv:retry")
    finally:
        agent.handle_batch = real
    assert state["calls"] >= 2
    assert pgw.dispatcher.retries > retries0
    for out, t in zip(outs, toks):
        np.testing.assert_array_equal(out, _unbatched(pgw, t))


# ------------------------------------------------ the Gateway against JAX's

def _coalesced_sequence(gw, driver):
    """A pair (one batch in the 2-bucket), a single (the base program), then
    a pair again (the memos): each step's tokens, boot stages and host."""
    hosts = {}
    handle_batch = gw.agent.handle_batch

    def observed(host, dep, batch, driver_name, tl, *args, **kwargs):
        out = handle_batch(host, dep, batch, driver_name, tl, *args, **kwargs)
        hosts.setdefault(batch.labels[0], []).append(host.host_id)
        return out

    gw.agent.handle_batch = observed
    toks = _prompts(5, seed=5000)
    steps = [("s1", toks[:2]), ("s2", toks[2:3]), ("s3", toks[3:])]
    out = []
    for label, batch in steps:
        res = gw.invoke_many(_name(), batch, driver=driver, label=label)
        tls = gw.recorder.timelines(label)
        out.append(([np.asarray(r).tolist() for r in res], hosts[label],
                    [sorted(t.stage_s) for t in tls], [t.batch_size for t in tls]))
    s = gw.batching_summary()
    out.append({k: s[k] for k in ("requests", "batches", "boots_per_request",
                                  "mean_batch_size")})
    return out


@pytest.mark.parametrize("driver", ["unikernel", "cold_jit"])
def test_gateway_batching_gives_jax_tokens_stages_hosts_and_counts(tmp_path, driver):
    jgw, pgw = _pair(tmp_path, buckets=(1, 2))
    try:
        got, want = _coalesced_sequence(pgw, driver), _coalesced_sequence(jgw, driver)
    finally:
        jgw.shutdown()
        pgw.shutdown()
    # the port's trace_compile also records its parts; JAX's has none
    parts = {"trace", "compile", "load"}
    if driver == "cold_jit":
        assert all(parts <= set(stages) for step in got[:3] for stages in step[2])
    for step in got[:3]:
        step[2][:] = [[name for name in stages if name not in parts] for stages in step[2]]
    assert got == want
    assert [step[3] for step in got[:3]] == [[2, 2], [1], [2, 2]]
    assert got[3] == {"requests": 5.0, "batches": 3.0, "boots_per_request": 0.6,
                      "mean_batch_size": 5 / 3}
    if driver == "cold_jit":
        assert all("trace_compile" in stages for step in got[:3] for stages in step[2])
