"""The port's image layer and cold-start path on the CPU, held against the JAX package.

* v1 snapshots are interchangeable between the packages, byte for byte;
* the slice end to end: port ``deploy`` -> ``UnikernelDriver`` boot (program
  track concurrent with the weights track) -> ``Executor.run`` -> exit;
* cross-package: the port's exported serve program, run on the snapshot the
  JAX package's ``deploy`` wrote, gives the JAX executor's tokens;
* the boot engine's overlap, cancellation and chunked device copy.
"""
import dataclasses
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
from repro.core.compile_cache import CompileCache as JaxCompileCache
from repro.core.deploy import deploy as jax_deploy
from repro.core.drivers import UnikernelDriver as JaxUnikernelDriver
from repro.core.metrics import Timeline as JaxTimeline
from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
import repro.core.artifact as jax_artifact
import repro_torch.configs.base as torch_configs
from repro_torch import pytree
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.boot import (
    ENGINE, TRACK_PROGRAM, TRACK_WEIGHTS, BootCancelled, BootPlan, Finalize, Stage,
    _plan_chunks, streamed_device_put,
)
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.deploy import deploy
from repro_torch.core.drivers import UnikernelDriver, make_drivers
from repro_torch.core.executor import ExecutorState
from repro_torch.core.metrics import Timeline
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.kernels import ops

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages


def _register_f32_arch():
    for reg in (jax_configs, torch_configs):
        base = reg.get_config("llama3.2-3b")
        if F32_ARCH not in reg._REGISTRY:
            reg.register(F32_ARCH)(lambda base=base: dataclasses.replace(base, dtype="float32"))


# ------------------------------------------------------------------- fixtures

@pytest.fixture(scope="session")
def torch_deployment(tmp_path_factory):
    """One exported reduced deployment of the port, shared by this file."""
    root = tmp_path_factory.mktemp("torch_dep")
    spec = FunctionSpec(arch="llama3.2-3b", batch_size=2, prompt_len=16, decode_steps=3)
    dep = deploy(spec, CompileCache(root / "programs"), SnapshotStore(root / "snapshots"),
                 str(root), device="cpu")
    return dep


# ------------------------------------------------------------------ snapshots

def _mixed_tree(rng):
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {"layers": {"w": f32, "b": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16)},
            "emb": {"tok": rng.standard_normal((6, 4)).astype(np.float32).astype(
                ml_dtypes.bfloat16)},
            "list": [np.arange(4, dtype=np.int32), np.zeros((), np.float32)],
            "final": {}}


def _uint_bytes(arr):
    arr = np.asarray(arr)
    return arr.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[arr.dtype.itemsize]).tobytes()


def test_jax_snapshot_loads_into_port_byte_for_byte(tmp_path):
    tree = _mixed_tree(np.random.default_rng(0))
    JaxSnapshotStore(tmp_path).save("img", tree)
    back = SnapshotStore(tmp_path).load_host("img")
    want = dict((jax.tree_util.keystr(p), x)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(pytree.flatten_with_paths(back))
    assert list(got) == list(want)                 # same ordinals, same path strings
    for path, x in want.items():
        t = got[path]
        assert t.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32,
                           "int32": torch.int32}[x.dtype.name]
        assert tuple(t.shape) == x.shape
        raw = t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])
        assert raw.numpy().tobytes() == _uint_bytes(x), path


def test_port_snapshot_loads_into_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"b": {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
                  .to(torch.bfloat16)},
            "a": [torch.arange(5, dtype=torch.int32), torch.ones(2, 2)]}
    SnapshotStore(tmp_path / "p").save("img", tree)
    back = JaxSnapshotStore(tmp_path / "p").load_host("img")
    assert back["b"]["w"].dtype == np.dtype(ml_dtypes.bfloat16)
    assert _uint_bytes(back["b"]["w"]) == \
        tree["b"]["w"].view(torch.int16).numpy().tobytes()
    np.testing.assert_array_equal(back["a"][0], tree["a"][0].numpy())
    np.testing.assert_array_equal(back["a"][1], tree["a"][1].numpy())
    # and the two packages write the same index and the same leaf files
    host = jax.tree.map(lambda t: t.numpy() if t.dtype != torch.bfloat16 else
                        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16), tree)
    JaxSnapshotStore(tmp_path / "j").save("img", host)
    for name in ["index.json"] + [f"leaf_{i:05d}.npy" for i in range(3)]:
        assert (tmp_path / "p" / "img" / name).read_bytes() == \
            (tmp_path / "j" / "img" / name).read_bytes(), name


# ------------------------------------------------------------- end to end (CPU)

def test_cold_start_path_end_to_end(torch_deployment):
    dep = torch_deployment
    assert dep.cache.has(dep.image.key) and dep.snapshots.has(dep.image.key)
    assert dep.image.manifest.extra["program_format"] == "torch.export"
    assert set(make_drivers()) == {"unikernel"}
    tokens = torch.from_numpy(dep.example_tokens(seed=3))
    driver = UnikernelDriver()
    tl = Timeline()
    ex = driver.start(dep, tl)
    assert {"fetch_program", "deserialize_program", "restore_weights_host",
            "device_put", "finalize"} <= set(tl.stage_s)
    assert tl.t_boot_wall < sum(tl.stage_s.values())          # the tracks overlapped
    assert ex.state is ExecutorState.READY
    out = ex.run(tokens, timeline=tl)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 3)
    with torch.inference_mode():
        eager = dep.serve_fn(dep.snapshots.load_host(dep.image.key), tokens)
    assert torch.equal(out, eager)
    driver.finish(dep, ex)
    assert ex.state is ExecutorState.EXITED and ex.params is None and ex.program is None
    with pytest.raises(RuntimeError, match="not runnable"):
        ex.run(tokens)


def test_exported_program_calls_the_custom_ops(torch_deployment):
    dep = torch_deployment
    program = dep.load_program()
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"repro_torch.flash_attention.default",
            "repro_torch.decode_attention.default"} <= targets
    n_decode = sum(str(n.target) == "repro_torch.decode_attention.default"
                   for n in program.graph.nodes)
    assert n_decode == dep.model.cfg.n_layers * dep.spec.decode_steps
    # the cache writes stay in place (no functionalized whole-cache copies)
    assert not any("scatter" in str(n.target) for n in program.graph.nodes)


def test_port_program_on_jax_snapshot_gives_jax_tokens(tmp_path):
    _register_f32_arch()
    jspec = jax_artifact.FunctionSpec(arch=F32_ARCH, batch_size=2, prompt_len=16,
                                      decode_steps=4)
    jdep = jax_deploy(jspec, JaxCompileCache(tmp_path / "jc"),
                      JaxSnapshotStore(tmp_path / "js"), str(tmp_path))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 16), dtype=np.int32)
    jex = JaxUnikernelDriver().start(jdep, JaxTimeline())
    jtokens = np.asarray(jex.run(jnp.asarray(tokens)))
    jex.exit()

    spec = FunctionSpec(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=4)
    dep = deploy(spec, CompileCache(tmp_path / "tc"), SnapshotStore(tmp_path / "ts"),
                 str(tmp_path), device="cpu")
    params = SnapshotStore(tmp_path / "js").load_host(jdep.image.key)
    with torch.inference_mode():
        out = dep.load_program()(params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(out.numpy(), jtokens)


# --------------------------------------------------------------- boot engine

class _SleepStage(Stage):
    def __init__(self, name, track, seconds, sets=()):
        self.name, self.track, self.seconds, self.sets = name, track, seconds, sets

    def run(self, ctx):
        time.sleep(self.seconds)
        for attr, value in self.sets:
            setattr(ctx, attr, value)


def _fake_dep():
    return types.SimpleNamespace(image=types.SimpleNamespace(key="img-torch-boot"),
                                 device=torch.device("cpu"))


def _two_track_plan(seconds=0.05):
    return BootPlan([
        _SleepStage("deserialize_program", TRACK_PROGRAM, seconds,
                    sets=[("program", lambda p, t: t)]),
        _SleepStage("restore_weights_host", TRACK_WEIGHTS, seconds, sets=[("params", {})]),
        Finalize(),
    ])


def test_engine_overlaps_program_and_weights_tracks():
    tl = Timeline()
    ex = ENGINE.execute(_two_track_plan(0.05), _fake_dep(), tl, driver_name="t")
    assert ex.state is ExecutorState.READY
    assert tl.stage_s["deserialize_program"] >= 0.05
    assert tl.stage_s["restore_weights_host"] >= 0.05
    assert tl.t_boot_wall < sum(tl.stage_s.values())
    assert tl.boot_overlap_saved > 0.02
    ex.exit()


def test_cancelled_preboot_disposes_its_executor():
    handle = ENGINE.launch(_two_track_plan(0.05), _fake_dep(), driver_name="t")
    handle.cancel()
    with pytest.raises(BootCancelled):
        handle.claim(timeout=5.0)
    assert handle.done()


def test_duplicate_stage_names_are_refused():
    with pytest.raises(ValueError, match="duplicate"):
        BootPlan([Finalize(), Finalize()])


# ---------------------------------------------------------- chunked device copy

def test_chunks_split_large_leaves_and_cover_every_byte():
    sizes = [10, 0, 25, 3]
    chunks = _plan_chunks(sizes, chunk_bytes=8)
    assert all(sum(b - a for _, a, b in c) <= 8 for c in chunks)
    covered = {i: [] for i in range(len(sizes))}
    for c in chunks:
        for i, a, b in c:
            covered[i].append((a, b))
    for i, n in enumerate(sizes):
        spans = sorted(covered[i])
        assert sum(b - a for a, b in spans) == n
        assert all(spans[k][1] == spans[k + 1][0] for k in range(len(spans) - 1))


def test_streamed_device_put_copies_every_leaf_exactly():
    rng = np.random.default_rng(2)
    tree = {"a": torch.from_numpy(rng.standard_normal((40, 33)).astype(np.float32))
            .to(torch.bfloat16),
            "b": [torch.arange(7, dtype=torch.int32), torch.zeros(())], "c": {}}
    out = streamed_device_put(tree, "cpu", chunk_bytes=100)
    assert pytree.flatten_with_paths(out)[0][0] == "['a']"
    for (p, x), (q, y) in zip(pytree.flatten_with_paths(tree),
                              pytree.flatten_with_paths(out)):
        assert p == q and y.dtype == x.dtype and torch.equal(x, y)
        assert y.data_ptr() != x.data_ptr()


def test_streamed_device_put_stops_on_cancel_and_deadline():
    tree = {"a": torch.ones(1000)}
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(BootCancelled):
        streamed_device_put(tree, "cpu", chunk_bytes=64, cancel=cancel)

    class Expired(Exception):
        pass

    class Deadline:
        def expired(self):
            return True

        def check(self, what):
            raise Expired(what)

    with pytest.raises(Expired):
        streamed_device_put(tree, "cpu", chunk_bytes=64, deadline=Deadline())


def test_launch_counters_start_at_zero_on_cpu(torch_deployment):
    """The CPU path runs the plain versions: no kernel launch is counted."""
    ops.reset_launch_counts()
    dep = torch_deployment
    ex = UnikernelDriver().start(dep, Timeline())
    ex.run(torch.from_numpy(dep.example_tokens()))
    ex.exit()
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "paged_decode_attention": 0, "mlstm": 0,
                                   "selective_scan": 0}


def test_manifest_roundtrip(torch_deployment):
    dep = torch_deployment
    m = dep.cache.load_manifest(dep.image.key)
    assert m == dep.image.manifest
    assert json.loads(m.to_json())["param_count"] == m.param_count
    assert m.snapshot_bytes == dep.snapshots.nbytes(dep.image.key)
