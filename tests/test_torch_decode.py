"""The port's continuous-batching decode tier on the CPU, held against the JAX package.

* ``DecodeScheduler`` token-exact against the JAX ``DecodeScheduler`` (on a
  ``repro.core.cluster.Cluster``) and against the dense per-request greedy
  oracle, reduced llama3.2-3b in float32 on the JAX package's weights, with
  mixed budgets sharing the loop, on the compiled decode bundle.
* The bundle's admit and step programs are AOTInductor packages: loaded
  from their bytes, they match the JAX package's compiled admit and step
  programs on the same weights (logits, the K/V written into the chain's
  pages, the next greedy token; f32, within 1e-4); they write the caller's
  pools in place, return those same tensors and allocate nothing as large
  as one layer's pool; ``ensure_decode`` takes the JAX package's
  ``max_pages`` and ``n_pages``; the deploy-time gate refuses a loaded
  program whose logits drift, whose greedy token changes, whose written
  pages drift or which returns copies of the pools.
* The behaviours of ``tests/test_decode_loop.py`` on the port: backfill, FIFO
  under page exhaustion, cool-to-zero and reboot, EOS and deadline
  retirement, ``max_new`` range rejection, close during an in-flight admit,
  a step failure settling every future, a boot failure exiting the executor.
* The ported modules of the control plane (``paging``, and the routing of
  ``scheduler`` and ``cluster``) against the JAX ones under identical
  operation sequences.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
from repro.core import paging as jax_paging
from repro.core import scheduler as jax_scheduler
from repro.core.cluster import Cluster as JaxCluster
from repro.core.cluster import HostFailure as JaxHostFailure
from repro.core.compile_cache import CompileCache as JaxCompileCache
from repro.core.decode import DecodeConfig as JaxDecodeConfig
from repro.core.decode import DecodeScheduler as JaxDecodeScheduler
from repro.core.deploy import deploy as jax_deploy
from repro.core.metrics import Recorder as JaxRecorder
from repro.core import resilience as jax_resilience
from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
from repro.core.drivers import ALL_DRIVERS as JAX_ALL_DRIVERS
import repro_torch.configs.base as torch_configs
from repro_torch.core import paging, scheduler
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.cluster import Cluster, HostFailure
from repro_torch.convert import params_from_numpy
from repro_torch.core.compile_cache import (
    AOTI, CompileCache, decode_admit_key, decode_step_key, package_op_calls,
)
from repro_torch.core.decode import DecodeConfig, DecodeScheduler
from repro_torch.core.deploy import deploy
from repro_torch.core.executor import ExecutorState
from repro_torch.core.metrics import Recorder
from repro_torch.core.paging import PagePool
from repro_torch.core.resilience import Deadline, DeadlineExceeded
from repro_torch.core.snapshot import SnapshotStore

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
PROMPT, BUDGET = 8, 12
BUDGETS = [12, 3, 7, 12, 1, 5]


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
def deps(tmp_path_factory):
    """The JAX and the port deployment of one reduced f32 spec; the port's
    snapshot is replaced by the JAX package's (the formats are the same), so
    both decode tiers run on the same weights."""
    _register_f32_arch()
    root = tmp_path_factory.mktemp("torch_decode")
    jspec = jax_artifact.FunctionSpec(arch=F32_ARCH, batch_size=1, prompt_len=PROMPT,
                                      decode_steps=BUDGET)
    jdep = jax_deploy(jspec, JaxCompileCache(root / "jc"), JaxSnapshotStore(root / "js"),
                      str(root))
    spec = FunctionSpec(arch=F32_ARCH, batch_size=1, prompt_len=PROMPT, decode_steps=BUDGET)
    dep = deploy(spec, CompileCache(root / "tc"), SnapshotStore(root / "ts"), str(root),
                 device="cpu")
    dep.snapshots.save(dep.image.key, SnapshotStore(root / "js").load_host(jdep.image.key))
    return jdep, dep


@pytest.fixture(scope="module")
def dep(deps):
    return deps[1]


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, 512, (1, PROMPT), dtype=np.int32)


def _dense_greedy(dep, tokens, budget):
    """The request-granular oracle: prefill + per-token greedy decode on a
    contiguous cache (the math of the fused serve program)."""
    params = dep.snapshots.load_host(dep.image.key)
    with torch.inference_mode():
        lg, cache = dep.model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                      capacity=PROMPT + BUDGET)
        toks = []
        for _ in range(budget):
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            toks.append(int(tok[0, 0]))
            lg, cache = dep.model.decode(params, cache, tok)
    return toks


def _sched(dep, on_exit=None, **kw):
    kw = {"slots": 3, "page_size": 8, "cool_after_s": 0.1, **kw}
    return DecodeScheduler(dep, Cluster(n_hosts=1), Recorder(), DecodeConfig(**kw),
                           on_exit=on_exit)


# ------------------------------------------------------------------ the tier

def test_mixed_budgets_token_exact_vs_jax_scheduler_and_dense_oracle(deps):
    jdep, dep = deps
    prompts = [_prompt(i) for i in range(len(BUDGETS))]
    jsched = JaxDecodeScheduler(jdep, JaxCluster(n_hosts=1), JaxRecorder(),
                                JaxDecodeConfig(slots=3, page_size=8, cool_after_s=0.1))
    try:
        jfuts = [jsched.submit(p, max_new=b) for p, b in zip(prompts, BUDGETS)]
        jouts = [f.result(300) for f in jfuts]
    finally:
        jsched.close()
    sched = _sched(dep)
    try:
        futs = [sched.submit(p, max_new=b, label=f"req{i}")
                for i, (p, b) in enumerate(zip(prompts, BUDGETS))]
        outs = [f.result(300) for f in futs]
    finally:
        sched.close()
    for p, b, out, jout in zip(prompts, BUDGETS, outs, jouts):
        assert out.dtype == np.int32 and out.shape == (b,)
        assert out.tolist() == np.asarray(jout).tolist()
        assert out.tolist() == _dense_greedy(dep, p, b)
    s = sched.summary()
    assert s["requests"] == s["admits"] == len(BUDGETS)
    assert s["tokens_generated"] == sum(BUDGETS)
    assert s["steps"] < sum(BUDGETS) and s["occupancy"] > 0.25
    assert s["page_alloc_failures"] == 0 and s["boots"] == s["cooldowns"] == 1
    tl = sched.recorder.timelines("req0")[-1]
    assert tl.t_exec_begin <= tl.t_ttfr <= tl.t_done          # first token at admit


def test_backfill_fills_a_freed_slot_before_the_next_step(dep):
    """Two slots, one long request and three one-step ones: each short request
    joins as soon as the previous one leaves, so every step runs inside the
    long request's lifetime."""
    sched = _sched(dep, slots=2)
    budgets = [8, 2, 2, 2]
    try:
        outs = [f.result(300) for f in [sched.submit(_prompt(10 + i), max_new=b)
                                        for i, b in enumerate(budgets)]]
    finally:
        sched.close()
    assert [len(o) for o in outs] == budgets
    assert sched.steps == budgets[0] - 1                       # 7: the long row alone sets it
    assert sched.step_rows == sum(b - 1 for b in budgets)
    assert sched.admits == 4 and sched.pool.used_pages == 0


def test_page_exhaustion_queues_fifo_without_corruption(dep):
    """Only one request's reservation fits: the queue head waits, later
    requests never jump it, and each still decodes token-exactly."""
    sched = _sched(dep)
    sched.pool = PagePool(4, 8)            # 3 allocatable pages = one 20-token chain
    order = []
    try:
        futs = []
        for i in range(3):
            fut = sched.submit(_prompt(i), max_new=BUDGET)
            fut.add_done_callback(lambda _f, i=i: order.append(i))
            futs.append(fut)
        outs = [f.result(300) for f in futs]
    finally:
        sched.close()
    for i, out in enumerate(outs):
        assert out.tolist() == _dense_greedy(dep, _prompt(i), BUDGET)
    assert order == [0, 1, 2]
    assert sched.admit_waits >= 1 and sched.pool.alloc_failures >= 1
    assert sched.steps == sched.step_rows                     # one resident at a time
    assert sched.pool.used_pages == 0


def test_cool_to_zero_and_reboot(dep):
    exited = []
    sched = _sched(dep, on_exit=exited.append)
    try:
        assert sched.submit(_prompt(1), max_new=2).result(300).shape == (2,)
        deadline = time.time() + 10
        while sched.cooldowns < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert sched.cooldowns == 1 and sched._ex is None
        assert sched._k_pages is None                          # the pools went too
        assert len(exited) == 1 and exited[0].state is ExecutorState.EXITED
        assert exited[0].busy_seconds > 0
        out = sched.submit(_prompt(1), max_new=2).result(300)
        assert out.tolist() == _dense_greedy(dep, _prompt(1), 2)
        assert sched.boots == 2
    finally:
        sched.close()
    assert sched.cooldowns == 2 and len(exited) == 2


def test_eos_retires_early(dep):
    toks = _dense_greedy(dep, _prompt(99), 6)
    eos = toks[2]
    sched = _sched(dep, eos_token=eos)
    try:
        out = sched.submit(_prompt(99)).result(300)
    finally:
        sched.close()
    assert out.tolist() == toks[:toks.index(eos) + 1]
    assert sched.pool.used_pages == 0


class _StepDeadline:
    """Expires at the ``n``-th decode step it is checked at (boot stages and
    the admit see it alive)."""

    def __init__(self, n):
        self.n = n

    def expired(self):
        return False

    def check(self, where=""):
        if where == "decode-step":
            self.n -= 1
            if self.n <= 0:
                raise DeadlineExceeded(where)


def test_deadline_retirement(dep):
    sched = _sched(dep)
    try:
        with pytest.raises(DeadlineExceeded):
            sched.submit(_prompt(4), max_new=3, deadline=Deadline.after(-1.0)).result(300)
        # expiring mid-decode settles the request truncated, with what it has
        out = sched.submit(_prompt(4), max_new=8, deadline=_StepDeadline(2)).result(300)
        assert out.tolist() == _dense_greedy(dep, _prompt(4), 3)
        assert sched.submit(_prompt(4), max_new=1).result(300).shape == (1,)
    finally:
        sched.close()
    assert sched.pool.used_pages == 0


def test_submit_rejects_malformed_oversized_and_out_of_range(dep):
    sched = _sched(dep)
    try:
        with pytest.raises(ValueError, match="prompt must be"):
            sched.submit(np.zeros((2, PROMPT), np.int32)).result(1)
        for bad in (0, -1, BUDGET + 1):
            with pytest.raises(ValueError, match="max_new must be in"):
                sched.submit(_prompt(0), max_new=bad).result(1)
        assert sched.submit(_prompt(0)).result(300).shape == (BUDGET,)   # None = full
    finally:
        sched.close()
    big = _sched(dep, max_new=1000)
    try:
        with pytest.raises(ValueError, match="pages"):
            big.submit(_prompt(0)).result(1)
    finally:
        big.close()
    assert big.boots == 0


def test_close_during_inflight_admit_settles_the_future(dep):
    sched = _sched(dep, slots=2)
    real = sched.bundle
    started = threading.Event()

    def slow_admit(*a, **k):
        started.set()
        time.sleep(0.3)                   # hold the request in the admit gap
        return real.admit(*a, **k)

    sched.bundle = dataclasses.replace(real, admit=slow_admit)
    fut = sched.submit(_prompt(3), max_new=6)
    assert started.wait(60)
    sched.close()                         # races the in-flight admit
    assert fut.result(1).tolist() == _dense_greedy(dep, _prompt(3), 6)
    assert sched.pool.used_pages == 0 and sched._ex is None


def test_step_failure_settles_every_future_and_the_loop_survives(dep):
    sched = _sched(dep, slots=2)
    real = sched.bundle

    def boom(*_a, **_k):
        raise RuntimeError("injected step failure")

    sched.bundle = dataclasses.replace(real, step=boom)
    try:
        futs = [sched.submit(_prompt(7 + i), max_new=4) for i in range(3)]   # one queued
        for f in futs:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(300)
        assert sched.pool.used_pages == 0 and sched._ex is None
        sched.bundle = real                       # next burst: fresh boot
        out = sched.submit(_prompt(7), max_new=4).result(300)
    finally:
        sched.close()
    assert out.tolist() == _dense_greedy(dep, _prompt(7), 4)
    assert sched.boots == 2


def test_boot_failure_after_start_exits_the_executor(dep, monkeypatch):
    exited = []
    sched = _sched(dep, slots=2, on_exit=exited.append)
    real_init = type(dep.model).init_page_pool
    fail = {"on": True}

    def flaky_init(self, *a, **k):
        if fail["on"]:
            raise RuntimeError("injected pool-init failure")
        return real_init(self, *a, **k)

    monkeypatch.setattr(type(dep.model), "init_page_pool", flaky_init)
    try:
        with pytest.raises(RuntimeError, match="injected pool-init"):
            sched.submit(_prompt(5), max_new=2).result(300)
        assert len(exited) == 1 and exited[0].state is ExecutorState.EXITED
        assert sched._ex is None and sched.pool.used_pages == 0
        fail["on"] = False
        out = sched.submit(_prompt(5), max_new=2).result(300)
    finally:
        sched.close()
    assert out.tolist() == _dense_greedy(dep, _prompt(5), 2)


def test_decode_bundle_is_a_deploy_time_artifact(dep):
    b1 = dep.ensure_decode(3, 8)
    assert dep.ensure_decode(2, 16) is b1                   # built once, ever
    assert b1.n_pages == 1 + b1.slots * b1.max_pages and b1.max_pages == 3
    key = dep.image.key
    assert dep.cache.has(decode_admit_key(key)) and dep.cache.has(decode_step_key(key))
    assert {"export", "compile", "save", "load", "verify"} <= set(b1.build_s)
    L = dep.model.cfg.n_layers
    admit_calls = package_op_calls(dep.cache.read_program_bytes(decode_admit_key(key)))
    step_calls = package_op_calls(dep.cache.read_program_bytes(decode_step_key(key)))
    assert admit_calls == ["repro_torch::flash_attention"] * L
    assert step_calls == ["repro_torch::paged_decode_attention"] * L
    assert "repro_torch::decode_attention" not in step_calls
    for kind in ("admit", "step"):
        g = b1.gate[kind]
        print(f"ensure_decode gate, {kind}: {g}")   # the comparison, with pytest -s
        assert g["in_place"]
        # bit for bit, or the compiled programs' rule with its errors logged
        assert g["equal"] or (g["argmax_equal"] and
                              all(c <= 2 * b for c, b in g["rel_l2"].values())), g


def _skewed_load(dep, how):
    """``load_program`` of ``dep``'s cache with the step program skewed:
    its logits scaled (greedy tokens kept), its greedy token changed by the
    smallest step, the K row it wrote scaled, a stray row written into a
    live page it should leave alone (the last page, off the probe's chain),
    or copies of the pools returned."""
    real_load = dep.cache.load_program

    def load(key):
        program = real_load(key)
        if key != decode_step_key(dep.image.key):
            return program

        def run(params, k, v, table, pos, tok):
            logits, k2, v2 = program(params, k, v, table, pos, tok)
            if how == "logits":
                return logits * 1.5, k2, v2
            if how == "token":
                logits = logits.clone()
                top = logits[0].topk(2)
                logits[0, top.indices[1]] = top.values[0] + 1e-3 * top.values[0].abs()
                return logits, k2, v2
            if how == "pages":
                p0 = int(pos[0])
                k2[:, int(table[0, p0 // 8]), p0 % 8] *= 1.5
                return logits, k2, v2
            if how == "stray":
                k2[:, k2.shape[1] - 1, 0] += 1.0
                return logits, k2, v2
            return logits, k2.clone(), v2.clone()
        return run
    return load


def test_ensure_decode_refuses_a_saved_program_that_differs(dep, monkeypatch):
    """The loaded step program is held to the eager one; one whose logits
    drift farther from the f32 plain route than twice the eager bf16 program
    (its greedy tokens kept) is refused, not installed."""
    fresh = dataclasses.replace(dep, _decode_bundle=None, _decode_lock=threading.Lock())
    monkeypatch.setattr(fresh.cache, "load_program", _skewed_load(dep, "logits"))
    with pytest.raises(RuntimeError, match="differ from the eager"):
        fresh.ensure_decode(3, 8)
    assert fresh._decode_bundle is None


@pytest.mark.parametrize("how, match", [("token", "differ from the eager"),
                                        ("pages", "differ from the eager"),
                                        ("stray", "differ from the eager"),
                                        ("copies", "in place")])
def test_ensure_decode_refuses_a_changed_token_drifted_pages_or_pool_copies(dep, monkeypatch,
                                                                             how, match):
    fresh = dataclasses.replace(dep, _decode_bundle=None, _decode_lock=threading.Lock())
    monkeypatch.setattr(fresh.cache, "load_program", _skewed_load(dep, how))
    with pytest.raises(RuntimeError, match=match):
        fresh.ensure_decode(3, 8)
    assert fresh._decode_bundle is None


def _jax_weights(jdep):
    """The JAX deployment's weights: (the host tree, its arrays)."""
    host = jax.tree.map(np.asarray, jdep.snapshots.load_host(jdep.image.key))
    return host, jax.tree.map(jnp.asarray, host)


def _close(want, got):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-4, rtol=1e-4)


def _admit_and_step(jbundle, jparams, admit, step, params, pools, ids, rows):
    """Two requests admitted into ``ids`` by the JAX programs and by
    ``admit``, then one step of both with slot 1 empty (rows: the slot of
    each request): the JAX and the port's logits and pools after each."""
    jk, jv = [jnp.asarray(p.numpy()) for p in pools]
    tk, tv = [p.clone() for p in pools]
    out = {"admit": []}
    for r in range(2):
        jl, jk, jv = jbundle.admit(jparams, jnp.asarray(_prompt(20 + r)), jk, jv,
                                   jnp.asarray(ids[r]))
        with torch.inference_mode():
            tl, tk2, tv2 = admit(params, torch.from_numpy(_prompt(20 + r)), tk, tv,
                                 torch.from_numpy(ids[r]))
        assert tk2.data_ptr() == tk.data_ptr() and tv2.data_ptr() == tv.data_ptr()
        out["admit"].append((jl, tl))
    out["admit_pools"] = ((jk, jv), (tk.clone(), tv.clone()))
    table = np.zeros((jbundle.slots, jbundle.max_pages), np.int32)
    pos = np.zeros((jbundle.slots,), np.int32)
    tok = np.zeros((jbundle.slots, 1), np.int32)
    for r, slot in enumerate(rows):
        table[slot], pos[slot] = ids[r], PROMPT
        tok[slot, 0] = int(np.argmax(np.asarray(out["admit"][r][0])))
    jl, jk, jv = jbundle.step(jparams, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                              jnp.asarray(tok))
    with torch.inference_mode():
        tl, tk2, tv2 = step(params, tk, tv, torch.from_numpy(table), torch.from_numpy(pos),
                            torch.from_numpy(tok))
    assert tk2.data_ptr() == tk.data_ptr() and tv2.data_ptr() == tv.data_ptr()
    out["step"] = (jl, tl, (jk, jv), (tk, tv), table, pos)
    return out


def test_compiled_admit_and_step_from_their_bytes_match_jax_compiled_programs(deps):
    """The packages alone (their payload bytes, loaded anew) against the JAX
    package's compiled admit and step programs, on the JAX weights: f32,
    within 1e-4 absolute and relative (the eager programs' tolerance in
    tests/test_torch_paged.py)."""
    jdep, dep = deps
    bundle, jbundle = dep.ensure_decode(3, 8), jdep.ensure_decode(3, 8)
    assert (bundle.slots, bundle.max_pages, bundle.n_pages) == \
        (jbundle.slots, jbundle.max_pages, jbundle.n_pages)
    key = dep.image.key
    admit, step = (CompileCache.deserialize_program(dep.cache.read_program_bytes(k))
                   for k in (decode_admit_key(key), decode_step_key(key)))
    assert dep.cache.program_format(decode_admit_key(key)) == AOTI
    assert dep.cache.program_format(decode_step_key(key)) == AOTI
    jhost, jparams = _jax_weights(jdep)
    params = params_from_numpy(jhost, "cpu")
    pools = dep.model.init_page_pool(bundle.n_pages, bundle.page_size, "cpu")
    ids = np.array([[4, 2, 0], [7, 1, 9]], np.int32)
    out = _admit_and_step(jbundle, jparams, admit, step, params,
                          (pools["k_pages"], pools["v_pages"]), ids, rows=(0, 2))
    for jl, tl in out["admit"]:
        _close(jl, tl)
    (jk, jv), (tk, tv) = out["admit_pools"]
    for r in range(2):                                   # the chains' pages
        chain = ids[r][ids[r] > 0]
        _close(np.asarray(jk)[:, chain], tk[:, chain])
        _close(np.asarray(jv)[:, chain], tv[:, chain])
    jl, tl, (jk, jv), (tk, tv), table, pos = out["step"]
    for slot in (0, 2):                                   # live rows
        _close(jl[slot], tl[slot])
        assert int(np.argmax(np.asarray(jl[slot]))) == int(torch.argmax(tl[slot]))
        page, off = table[slot, pos[slot] // 8], pos[slot] % 8
        _close(np.asarray(jk)[:, page, off], tk[:, page, off])
        _close(np.asarray(jv)[:, page, off], tv[:, page, off])


def test_loaded_programs_write_the_callers_pools_in_place_and_copy_no_pool(dep):
    """The input pools change, the returned pools are those same tensors, and
    no allocation the call makes is as large as one layer's pool: no copy of
    a pool, whole or one layer's, is made and written back."""
    from torch.profiler import ProfilerActivity, profile
    bundle = dep.ensure_decode(3, 8)
    params = dep.snapshots.load_host(dep.image.key)
    pools = dep.model.init_page_pool(bundle.n_pages, bundle.page_size, "cpu")
    kp, vp = pools["k_pages"], pools["v_pages"]
    layer_bytes = kp[0].numel() * kp.element_size()
    chain = torch.arange(1, bundle.max_pages + 1, dtype=torch.int32)
    table = torch.zeros((bundle.slots, bundle.max_pages), dtype=torch.int32)
    table[1] = chain
    pos = torch.tensor([0, PROMPT, 0], dtype=torch.int32)
    tok = torch.tensor([[0], [5], [0]], dtype=torch.int32)
    calls = (("admit", lambda: bundle.admit(params, torch.from_numpy(_prompt(3)), kp, vp,
                                            chain)),
             ("step", lambda: bundle.step(params, kp, vp, table, pos, tok)))
    for kind, call in calls:
        before = (kp.clone(), vp.clone())
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU],
                                             profile_memory=True) as prof:
            _, k2, v2 = call()
        assert k2 is kp and v2 is vp, kind
        assert not torch.equal(kp, before[0]) and not torch.equal(vp, before[1]), kind
        largest = max(e.cpu_memory_usage for e in prof.events())
        assert 0 < largest < layer_bytes, (kind, largest, layer_bytes)


def test_ensure_decode_takes_jax_max_pages_and_n_pages(deps, tmp_path):
    """``ensure_decode(slots, page_size, max_pages, n_pages)`` builds the
    geometry the JAX package's does, and its programs there give the JAX
    programs' logits."""
    jdep, dep = deps
    jfresh = dataclasses.replace(jdep, _decode_bundle=None)
    fresh = dataclasses.replace(dep, cache=CompileCache(tmp_path / "c"), _decode_bundle=None,
                                _decode_lock=threading.Lock())
    jb = jfresh.ensure_decode(2, 8, max_pages=4, n_pages=7)
    b = fresh.ensure_decode(2, 8, max_pages=4, n_pages=7)
    assert (b.slots, b.page_size, b.max_pages, b.n_pages) == \
        (jb.slots, jb.page_size, jb.max_pages, jb.n_pages) == (2, 8, 4, 7)
    jhost, jparams = _jax_weights(jdep)
    params = params_from_numpy(jhost, "cpu")
    pools = fresh.model.init_page_pool(b.n_pages, b.page_size, "cpu")
    ids = np.array([[3, 1, 0, 0], [2, 6, 5, 4]], np.int32)
    out = _admit_and_step(jb, jparams, b.admit, b.step, params, (pools["k_pages"], pools["v_pages"]), ids, rows=(1, 0))
    for jl, tl in out["admit"]:
        _close(jl, tl)
    jl, tl = out["step"][:2]
    for slot in (0, 1):
        _close(jl[slot], tl[slot])


# ------------------------------------------------------------ the copies

def test_paging_copy_matches_jax_under_one_operation_sequence():
    rng = np.random.default_rng(0)
    pools = [jax_paging.PagePool(40, 8), paging.PagePool(40, 8)]
    live = [[], []]
    for _ in range(300):
        op = rng.integers(0, 4)
        n = int(rng.integers(1, 60))
        pick = int(rng.integers(0, 1 << 30))
        got = []
        for pool, chains in zip(pools, live):
            if op == 0 or not chains:
                c = pool.alloc_chain(n)
                if c is not None:
                    chains.append(c)
                got.append(None if c is None else list(c.pages))
            elif op == 1:
                got.append(pool.release(chains.pop(pick % len(chains))))
            elif op == 2:
                c = chains[pick % len(chains)]
                got.append((pool.extend(c, c.capacity + n), list(c.pages)))
            else:
                c = pool.fork(chains[pick % len(chains)])
                chains.append(c)
                got.append(list(c.table_row(12)))
        assert got[0] == got[1]
        assert pools[0].stats() == pools[1].stats()


def _cluster_ops(cluster_cls):
    c = cluster_cls(n_hosts=4)
    keys = [f"img{i}" for i in range(24)]
    routes = [[c.route(k).host_id for k in keys]]
    c.kill_host(1)
    routes.append([c.route(k).host_id for k in keys])
    c.add_host()
    routes.append([c.route(k).host_id for k in keys])
    c.revive_host(1)
    c.remove_host(2)
    routes.append([c.route(k, bucket_rows=4).host_id for k in keys])
    routes.append([h.host_id for h in c.alive_hosts()])
    c.shutdown()
    return routes


def test_cluster_and_scheduler_copies_route_like_jax_under_kill_and_add():
    assert _cluster_ops(Cluster) == _cluster_ops(JaxCluster)
    assert scheduler.hrw_hosts("k", [0, 3, 5, 9], 2) == \
        jax_scheduler.hrw_hosts("k", [0, 3, 5, 9], 2)
    hosts = Cluster(n_hosts=2).hosts
    assert tuple(hosts[0].drivers) == JAX_ALL_DRIVERS
    assert hosts[0].drivers["unikernel"] is not hosts[1].drivers["unikernel"]   # per host


def _routes_under_load(cluster_cls, failure_cls):
    """Routes of 16 keys while in-flight work piles onto hosts 0 and 1, then
    key-less and excluding routes, then the strict refusal."""
    c = cluster_cls(n_hosts=3, slots_per_host=4)
    gate = threading.Event()
    keys = [f"img{i}" for i in range(16)]
    routes = []
    try:
        for hid in (None, 0, 0, 1, 0, 1):
            if hid is not None:
                c.host_by_id(hid).submit(gate.wait)
            routes.append([c.route(k).host_id for k in keys])
        routes.append([c.route().host_id for _ in range(4)])
        routes.append([c.route(k, exclude={0, 2}).host_id for k in keys])
        routes.append([h.load for h in c.hosts])
        with pytest.raises(failure_cls):
            c.route(keys[0], exclude={0, 1, 2}, strict=True)
    finally:
        gate.set()
        c.shutdown()
    return routes


def test_scheduler_copy_routes_like_jax_under_load_and_exclusion():
    assert _routes_under_load(Cluster, HostFailure) == \
        _routes_under_load(JaxCluster, JaxHostFailure)


def test_deadline_copy_matches_jax_on_one_clock():
    """The port keeps only ``Deadline`` of the resilience module: on the same
    clock it expires when the JAX one does, with the same message."""
    class Clock:
        t = 100.0

        def now(self):
            return self.t

    clock = Clock()
    for Dl, Exc in ((Deadline, DeadlineExceeded),
                    (jax_resilience.Deadline, jax_resilience.DeadlineExceeded)):
        clock.t = 100.0
        d = Dl.after(0.5, clock)
        d.check("admit")
        assert (d.remaining(), d.expired()) == (0.5, False)
        clock.t = 100.75
        assert d.expired()
        with pytest.raises(Exc, match=r"deadline exceeded at decode-step \(250\.0 ms past\)"):
            d.check("decode-step")
