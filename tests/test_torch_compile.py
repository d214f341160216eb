"""The port's compile step on the CPU: AOTInductor packages, and the compile
cache that ``cold_jit_cached`` reads.

The f32-registered reduced llama3.2-3b (batch 2, prompt 16, 2 decode steps)
through a port Gateway beside a JAX one, the port's snapshot replaced by the
JAX deployment's weights (``params_from_numpy``), as in
``tests/test_torch_gateway.py``:

* deploy stores the fused serve program, its head and tail, a bucket
  program and the decode bundle's admit and step programs as AOTInductor
  packages (``program_format == "aoti"``, per key and in the manifest);
* each package, loaded from its payload bytes alone, gives the JAX compiled
  program's tokens on the same weights and prompts (the bucket at 4 rows;
  head + tail as the streamed boot runs them);
* ``cold_jit`` compiles with every cache off: no compiled-package cache hit
  and no Inductor cache hit, even with a filled cache directory;
  ``cold_jit_cached``'s first boot after ``enable_inductor_disk_cache``
  fills the directory and its second boot reads the package back, its
  ``compile`` part far below ``cold_jit``'s; every boot gives request 1's
  tokens;
* a payload's format is read from its tag, never guessed: an untagged
  payload, or one tagged ``torch.export``, is refused;
* ``precompile`` traces deploy's serve, head and tail programs on fake
  tensors (each family's trace has the keys of the trace on weights) and
  compiles them into the package cache, and a later deploy reads all three
  back; with a decode geometry it does the same for the decode bundle's
  admit and step programs, which ``ensure_decode`` then reads back.

``tests/test_torch_imports.py`` checks that no module of the port imports JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
import repro.core.artifact as jax_artifact
from repro.core.decode import DecodeConfig as JaxDecodeConfig
from repro.core.deploy import make_serve_fn as jax_serve_fn
from repro.core.gateway import Gateway as JaxGateway
import repro_torch.configs.base as torch_configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import FunctionSpec, Gateway
from repro_torch.core import compile_cache
from repro_torch.core.compile_cache import (
    AOTI, CompileCache, decode_admit_key, decode_step_key, package_op_calls,
)
from repro_torch.core.decode import DecodeConfig

F32_ARCH = "llama3.2-3b:f32"          # the registered llama3.2-3b in float32, both packages
SPEC = dict(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=2)
BUCKET = 4


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


def _name():
    return FunctionSpec(**SPEC).name


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port Gateway (decode tier on) with the same deployment, the
    port's snapshot replaced by the JAX deployment's weights, and the port's
    bucket program at ``BUCKET`` rows; plus the JAX weights."""
    _register_f32_arch()
    root = tmp_path_factory.mktemp("compile_pair")
    jgw = JaxGateway(n_hosts=1, slots_per_host=2, mode="cold", hedging=False,
                     work_dir=str(root / "jax"), decode=JaxDecodeConfig(slots=2, page_size=8))
    pgw = Gateway(n_hosts=1, slots_per_host=2, mode="cold", hedging=False,
                  work_dir=str(root / "torch"), decode=DecodeConfig(slots=2, page_size=8),
                  device="cpu")
    jdep = jgw.deploy(jax_artifact.FunctionSpec(**SPEC))
    dep = pgw.deploy(FunctionSpec(**SPEC))
    jparams = jgw.snapshots.load_host(jdep.image.key)
    pgw.snapshots.save(dep.image.key, params_from_numpy(jparams, "cpu"))
    dep.ensure_bucket(BUCKET)
    yield jgw, pgw, jdep, dep, jparams
    jgw.shutdown()
    pgw.shutdown()


def _jax_tokens(jdep, jparams, tokens):
    """The JAX package's compiled serve program's tokens."""
    fn = jax.jit(jax_serve_fn(jdep.model, jdep.spec))
    return np.asarray(fn(jparams, jnp.asarray(tokens)))


def _prompts(rows, seed):
    return np.random.default_rng(seed).integers(0, 512, (rows, SPEC["prompt_len"]),
                                                dtype=np.int32)


def test_deploy_stores_aoti_packages_the_decode_bundle_among_them(pair):
    _, pgw, _, dep, _ = pair
    cache, key = dep.cache, dep.image.key
    extra = dep.image.manifest.extra
    assert extra["program_format"] == AOTI and dep.split_ok
    assert "program_formats" not in extra                            # one format for all
    assert _name() in pgw.decoders                                   # the bundle is built
    for k in (key, dep.head_program_key(), dep.tail_program_key(),
              dep.bucket_image_key(BUCKET), decode_admit_key(key), decode_step_key(key)):
        assert cache.program_format(k) == AOTI, k
    assert {"export", "compile", "save", "load", "verify"} <= set(dep.build_s)
    assert {"export", "compile", "save", "load", "verify"} <= \
        set(pgw.decoders[_name()].bundle.build_s)
    assert {f"bucket{BUCKET}_{s}" for s in ("export", "compile", "save", "load", "verify")} \
        <= set(dep.build_s)


@pytest.mark.parametrize("program", ["serve", "head_tail", "bucket"])
def test_each_package_from_its_bytes_gives_the_jax_compiled_tokens(pair, program):
    _, _, jdep, dep, jparams = pair
    params = params_from_numpy(jparams, "cpu")
    rows = BUCKET if program == "bucket" else SPEC["batch_size"]
    tokens = _prompts(rows, seed=7)
    t = torch.from_numpy(tokens)
    load = CompileCache.deserialize_program
    with torch.inference_mode():
        if program == "head_tail":
            head = load(dep.cache.read_program_bytes(dep.head_program_key()))
            tail = load(dep.cache.read_program_bytes(dep.tail_program_key()))
            tok0, logits, inner = head(params, t)
            got = tail(params, logits, inner)
            assert np.array_equal(tok0[:, 0].numpy(), got[:, 0].numpy())
        else:
            payload = dep.fetch_program_payload(BUCKET if program == "bucket" else None)
            calls = package_op_calls(payload)
            assert calls.count("repro_torch::flash_attention") == dep.model.cfg.n_layers
            got = load(payload)(params, t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_tokens(jdep, jparams, tokens))


def _hits(counts) -> dict:
    return {k: v for k, v in counts.items() if "cache_hit" in k and v}


def test_cold_jit_compiles_uncached_and_cold_jit_cached_reads_the_cache(pair, tmp_path):
    jgw, pgw, _, dep, _ = pair
    tokens = _prompts(SPEC["batch_size"], seed=11)
    want = np.asarray(jgw.invoke(_name(), tokens))
    first = pgw.invoke(_name(), tokens, label="compile:request1")
    np.testing.assert_array_equal(first, want)
    from torch._dynamo.utils import counters

    def boot(driver, label):
        ours, inductor = dict(compile_cache.counters()), dict(counters["inductor"])
        got = pgw.invoke(_name(), tokens, driver=driver, label=label)
        np.testing.assert_array_equal(got, first)                   # request 1's tokens
        (tl,) = pgw.recorder.timelines(label)
        assert {"trace_compile", "trace", "compile", "load"} <= set(tl.stage_s)
        delta = {k: v - ours.get(k, 0) for k, v in compile_cache.counters().items()}
        idelta = {k: v - inductor.get(k, 0) for k, v in counters["inductor"].items()}
        return tl, delta, idelta

    compile_cache.enable_inductor_disk_cache(tmp_path / "inductor")
    try:
        tl1, d1, _ = boot("cold_jit_cached", "compile:cached1")
        assert d1.get("aoti_package_cache_miss") == 1 and not _hits(d1)
        assert list((tmp_path / "inductor" / "repro_torch_aoti").glob("*.pt2"))
        tl2, d2, _ = boot("cold_jit_cached", "compile:cached2")
        assert d2.get("aoti_package_cache_hit") == 1 and not d2.get("aoti_package_cache_miss")
        # a filled cache directory, and cold_jit still hits nothing
        tl3, d3, i3 = boot("cold_jit", "compile:uncached")
        assert d3.get("aoti_package_cache_disabled") == 1 and not _hits(d3)
        assert not _hits(i3)
    finally:
        compile_cache.disable_inductor_disk_cache()
    assert tl2.stage_s["compile"] < 0.25 * tl3.stage_s["compile"]
    assert tl2.stage_s["compile"] < 0.25 * tl1.stage_s["compile"]


def test_package_key_is_the_same_for_a_trace_on_fakes_and_on_weights(pair):
    """TraceCompile traces on fake tensors, deploy on the weights: the same
    program shape has one key, so a boot can read what deploy compiled (the
    key's parts deploy recorded in the manifest)."""
    from repro_torch.core.boot import export_on_fakes
    _, _, _, dep, jparams = pair
    params = params_from_numpy(jparams, "cpu")
    tokens = torch.zeros((SPEC["batch_size"], SPEC["prompt_len"]), dtype=torch.int32)
    real = torch.export.export(type(dep.serve_fn)(dep.model, dep.spec), (params, tokens))
    fake = export_on_fakes(dep)
    assert compile_cache.package_key(real) == compile_cache.package_key(fake)
    assert compile_cache.aoti_package_key_parts(fake) == \
        dep.image.manifest.extra["package_key_parts"]
    other = torch.export.export(type(dep.serve_fn)(dep.model, dep.spec),
                                (params, torch.zeros((1, SPEC["prompt_len"]), dtype=torch.int32)))
    assert compile_cache.package_key(other) != compile_cache.package_key(real)


class _Tiny(torch.nn.Module):
    def forward(self, x):
        return torch.sin(x) * 2.0


def test_package_key_is_the_same_before_and_after_a_compile():
    """AOTInductor fills its metadata option in place as it compiles: a
    compile must leave the process's option as it was, or the first compile
    of a process changes the configuration hash, and so the key, of every
    later trace (a re-trace then misses the package deploy compiled)."""
    from torch._inductor import config as inductor_config
    exported = torch.export.export(_Tiny(), (torch.ones(8),))
    with inductor_config.patch({"aot_inductor.metadata": {}}):   # before any compile
        before = compile_cache.aoti_package_key_parts(exported)
        package = compile_cache.compile_package(exported, disable_caches=True)
        assert inductor_config.aot_inductor.metadata == {}
        assert compile_cache.aoti_package_key_parts(exported) == before
    out = CompileCache.load_package(package)(torch.ones(8))
    torch.testing.assert_close(out, torch.sin(torch.ones(8)) * 2.0)


def test_calls_of_one_loaded_program_take_turns_and_count_their_waits():
    import threading
    import time
    program = compile_cache.CompiledProgram(lambda: time.sleep(0.2))
    compile_cache.PROGRAM_WAITS.reset()
    threads = [threading.Thread(target=program) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    waits = compile_cache.PROGRAM_WAITS.summary()
    assert waits["calls"] == 2 and 0.1 < waits["max_s"] <= waits["total_s"]


def test_payload_format_is_read_from_its_tag(pair, tmp_path):
    _, _, _, dep, _ = pair
    payload = dep.fetch_program_payload()
    assert compile_cache.payload_format(payload)[0] == AOTI
    body = payload[compile_cache.payload_format(payload)[1]:]
    for bad in (body, b"repro_torch program onnx\n" + body,
                b"repro_torch program torch.export\n" + body):
        with pytest.raises(ValueError):
            CompileCache.deserialize_program(bad)
    cache = CompileCache(tmp_path / "c")
    assert cache.put_package("k", body) == len(payload)
    assert cache.read_program_bytes("k") == payload and cache.program_format("k") == AOTI


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b", "kimi-k2-1t-a32b",
                                  "qwen2-vl-2b"])
def test_a_trace_on_fakes_has_the_package_keys_of_the_trace_on_weights(arch):
    """What ``precompile`` compiles is what deploy compiles, for every
    family's serve, head and tail program: mutating ops (xlstm, jamba), MoE
    routing (jamba, Kimi) and M-RoPE (qwen2-vl) trace on fakes as on the
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import _split_args, make_serve_fn, trace_on_fakes
    from repro_torch.models import build_model
    spec = FunctionSpec(arch=arch, reduced=True, batch_size=2, prompt_len=16, decode_steps=2)
    fake = {kind: compile_cache.package_key(ep) for kind, ep in trace_on_fakes(spec, "cpu")}
    model = build_model(get_config(arch).reduced(), max_seq=spec.prompt_len + spec.decode_steps)
    params = model.init(torch.Generator().manual_seed(spec.seed))
    tokens = torch.zeros((spec.batch_size, spec.prompt_len), dtype=torch.int32)
    real = {"serve": torch.export.export(make_serve_fn(model, spec), (params, tokens))}
    real.update((kind, torch.export.export(fn, args))
                for kind, fn, args in _split_args(model, spec, params, tokens))
    assert list(fake) == ["serve", "head", "tail"]
    assert fake == {kind: compile_cache.package_key(ep) for kind, ep in real.items()}


def test_precompile_fills_the_packages_a_later_deploy_reads(monkeypatch, tmp_path):
    from repro_torch.core.deploy import deploy, precompile
    from repro_torch.core.snapshot import SnapshotStore
    _register_f32_arch()
    monkeypatch.setattr(compile_cache, "package_cache_dir", lambda: tmp_path / "aoti")

    def lookups(fn):
        before = dict(compile_cache.counters())
        out = fn()
        return out, {k: v - before.get(k, 0) for k, v in compile_cache.counters().items()
                     if v - before.get(k, 0)}

    times, built = lookups(lambda: precompile(FunctionSpec(**SPEC), "cpu"))
    assert built == {"aoti_package_cache_miss": 3}
    assert set(times) == {f"{k}_{s}" for k in ("serve", "head", "tail")
                          for s in ("trace", "compile")}
    assert len(list((tmp_path / "aoti").glob("*.pt2"))) == 3
    dep, read = lookups(lambda: deploy(FunctionSpec(**SPEC), CompileCache(tmp_path / "c"),
                                       SnapshotStore(tmp_path / "s"), str(tmp_path),
                                       device="cpu"))
    assert read == {"aoti_package_cache_hit": 3}          # serve, head and tail
    assert dep.split_ok and dep.image.manifest.extra["program_format"] == AOTI


def _decode_traces_on_weights(spec, decode):
    """The admit and step programs ``ensure_decode(*decode)`` of a deploy of
    ``spec`` on the CPU traces, on its initial weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import (
        _decode_inputs, decode_geometry, make_admit_fn, make_step_fn)
    from repro_torch.models import build_model
    model = build_model(get_config(spec.arch).reduced(),
                        max_seq=spec.prompt_len + spec.decode_steps)
    params = model.init(torch.Generator().manual_seed(spec.seed))
    max_pages, n_pages = decode_geometry(spec, *decode)
    admit_args, step_args = _decode_inputs(model, spec.prompt_len, decode[0], decode[1],
                                           max_pages, n_pages, "cpu")
    return {"decode_admit": torch.export.export(make_admit_fn(model, max_pages, decode[1]),
                                                (params,) + admit_args),
            "decode_step": torch.export.export(make_step_fn(model), (params,) + step_args)}


@pytest.mark.parametrize("decode", [(2, 8), (3, 8, 4, 7)], ids=["default", "jax_geometry"])
def test_a_trace_on_fakes_has_the_decode_package_keys_of_the_trace_on_weights(decode):
    """What ``precompile`` compiles for a decode geometry is what
    ``ensure_decode`` compiles: the admit and step programs traced on fakes
    have the keys of the traces on weights."""
    from repro_torch.core.deploy import trace_on_fakes
    _register_f32_arch()
    spec = FunctionSpec(**SPEC)
    fake = {kind: compile_cache.package_key(ep)
            for kind, ep in trace_on_fakes(spec, "cpu", decode=decode)}
    assert list(fake) == ["serve", "head", "tail", "decode_admit", "decode_step"]
    real = _decode_traces_on_weights(spec, decode)
    assert {k: fake[k] for k in real} == \
        {kind: compile_cache.package_key(ep) for kind, ep in real.items()}


def test_precompile_with_a_decode_geometry_fills_the_bundle_ensure_decode_reads(pair,
                                                                                 tmp_path):
    """``precompile(..., decode=(3, 8))`` compiles the admit and step
    programs of ``ensure_decode(3, 8)`` into the package cache beside the
    serve, head and tail programs (which the pair's deploy compiled: hits;
    it built its bundle at (2, 8)); a deployment that then builds its bundle
    at (3, 8) reads both packages back and compiles nothing."""
    import threading
    from repro_torch.core.deploy import precompile
    _, _, _, dep, _ = pair
    kinds = ("serve", "head", "tail", "decode_admit", "decode_step")

    def lookups(fn):
        before = dict(compile_cache.counters())
        out = fn()
        return out, {k: v - before.get(k, 0) for k, v in compile_cache.counters().items()
                     if v - before.get(k, 0)}

    times, built = lookups(lambda: precompile(dep.spec, "cpu", decode=(3, 8)))
    assert sum(built.values()) == 5 and built.get("aoti_package_cache_hit", 0) >= 3
    assert set(times) == {f"{k}_{s}" for k in kinds for s in ("trace", "compile")}
    from torch._inductor import config as inductor_config
    for kind, ep in _decode_traces_on_weights(dep.spec, (3, 8)).items():
        with inductor_config.patch(compile_cache.compile_options()):   # as compile_package
            path = compile_cache.package_cache_dir() / f"{compile_cache.package_key(ep)}.pt2"
        assert path.exists(), kind
    fresh = dataclasses.replace(dep, cache=CompileCache(tmp_path / "c"), _decode_bundle=None,
                                _decode_lock=threading.Lock())
    bundle, read = lookups(lambda: fresh.ensure_decode(3, 8))
    assert read == {"aoti_package_cache_hit": 2}
    assert (bundle.slots, bundle.page_size) == (3, 8) and bundle.gate["step"]["in_place"]
