"""The port's dense, MoE and vision families vs the JAX package: configs,
param trees, prefill, decode, greedy serving, M-RoPE with patches, paged
decode, and deploy -> ``unikernel`` boot -> run.

Each family at the JAX package's ``reduced()`` cut in float32 (2 layers,
d_model 128, 4 heads, vocab 512; Kimi: one first-k-dense head layer and one
MoE layer of 4 experts, top-2, with a shared expert; Arctic: 4 experts,
top-2, with the dense residual MLP), with the JAX package's weights from
``build_model(cfg).init(PRNGKey(0))`` carried over by
``repro_torch.convert.params_from_numpy``. The two packages sum in different
orders, so values are compared at atol 1e-4 / rtol 1e-4; position ids and
greedy tokens must be equal. The port runs its plain kernels and the JAX
package its reference path.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
from repro.configs import get_config as jax_config
from repro.core.artifact import FunctionSpec as JaxSpec
from repro.core.blobstore import ChunkStore as JaxChunkStore
from repro.core.blobstore import stream_restore as jax_stream_restore
from repro.core.compile_cache import CompileCache as JaxCompileCache
from repro.core.deploy import deploy as jax_deploy
from repro.core.deploy import make_admit_fn as jax_admit_fn
from repro.core.deploy import make_serve_fn as jax_serve_fn
from repro.core.drivers import UnikernelDriver as JaxUnikernelDriver
from repro.core.metrics import Timeline as JaxTimeline
from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
from repro.models import build_model as jax_build
from repro.models import frontends as jfront
from repro.models import layers as jl
from repro.models import transformer as jtr
import repro_torch.configs.base as torch_configs
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.blobstore import ChunkStore, stream_restore
from repro_torch.core.compile_cache import CompileCache, package_op_calls
from repro_torch.core.deploy import deploy, make_admit_fn, make_serve_fn
from repro_torch.core.drivers import UnikernelDriver
from repro_torch.core.metrics import Timeline
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import frontends as tfront
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr

ATOL = RTOL = 1e-4
CAPACITY = 24
KIMI, ARCTIC, QWEN_VL = "kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-2b"
ARCHS = ["olmo-1b", "qwen2.5-32b", "starcoder2-3b", KIMI, ARCTIC, QWEN_VL]
NEW_ARCHS = ARCHS + ["whisper-medium"]
F32 = ":f32"                # suffix of the reduced float32 archs registered in both packages


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=ATOL, rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jm, tm = jax_build(jcfg, CAPACITY), build_model(tcfg, CAPACITY)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, 16), dtype=np.int32)


def _register_f32_arch(arch) -> str:
    name = arch + F32
    for reg in (jax_configs, torch_configs):
        if name not in reg._REGISTRY:
            base = reg.get_config(arch).reduced()
            reg.register(name)(lambda base=base: dataclasses.replace(base, dtype="float32"))
    return name


@pytest.fixture(scope="module", autouse=True)
def _registered_archs_leave_with_the_module():
    """The JAX package's config tests count the registered archs: the archs
    this module registers leave both registries when the module ends."""
    yield
    for reg in (jax_configs, torch_configs):
        for name in [n for n in reg._REGISTRY if n.endswith(F32)]:
            reg._REGISTRY.pop(name)


def _flat(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _spec_rows(jspecs, tspecs):
    jd = [(jax.tree_util.keystr(p), s.shape, np.dtype(s.dtype).name) for p, s in
          jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]]
    td = [(p, s.shape, str(s.dtype).replace("torch.", ""))
          for p, s in pytree.flatten_with_paths(tspecs, is_leaf=tl.is_spec)]
    return jd, td


# ---------------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_copy_equals_jax_field_by_field(arch, reduced):
    j, t = jax_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_every_jax_arch_is_registered_in_the_port():
    assert torch_configs.list_archs() == sorted(
        n for n in jax_configs.list_archs() if not n.endswith(F32))


# ----------------------------------------------------------------------- params

@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_paths_shapes_and_dtypes_match(arch):
    jm, jp, tm, tp = _models(arch)
    jflat = _flat(jp)
    tflat = pytree.flatten_with_paths(tp)
    assert [p for p, _ in tflat] == [p for p, _ in jflat]      # same paths, same order
    for (path, x), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == x.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(x))
    # and in the model's own dtype (bf16), with its f32 router
    jd, td = _spec_rows(jax_build(jax_config(arch).reduced(), CAPACITY).param_specs(),
                        build_model(get_config(arch).reduced(), CAPACITY).param_specs())
    assert td == jd
    paths = [p for p, _, _ in td]
    if arch == KIMI:
        assert "['stack']['head'][0]['mlp']['w_up']" in paths
        assert "['stack']['layers']['moe']['shared']['w_up']" in paths
    if arch == ARCTIC:
        assert "['stack']['layers']['moe']['dense']['w_up']" in paths
    assert {p for p, _, d in td if d == "float32"} == (
        {"['stack']['layers']['moe']['router']"} if arch in (KIMI, ARCTIC) else set())


# ------------------------------------------------------------------------ model

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_every_cache_leaf_match(arch, tokens):
    jm, jp, tm, tp = _models(arch)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    _close(jlog, tlog)
    jflat, tflat = _flat(jc["inner"]), pytree.flatten_with_paths(tc["inner"])
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    assert [p for p, _ in tflat] == (["['head'][0]['k']", "['head'][0]['v']", "['k']", "['v']"]
                                     if arch == KIMI else ["['k']", "['v']"])
    for (_, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape
        _close(a, b)
    assert tc["pos"] == int(jc["pos"])
    specs = pytree.flatten_with_paths(tm.cache_specs(2, CAPACITY)["inner"], is_leaf=tl.is_spec)
    assert [(p, s.shape, s.dtype) for p, s in specs] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tflat]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_scalar_and_per_row_pos(arch, tokens):
    jm, jp, tm, tp = _models(arch)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    for _ in range(3):                              # lock-step batch: scalar pos
        tok = np.asarray(jnp.argmax(jlog, axis=-1))[:, None].astype(np.int32)
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok))
        _close(jlog, tlog)
    # per-row positions (rows at different depths), same cache state
    pos = np.array([19, 17], np.int32)
    tok = np.array([[3], [4]], np.int32)
    jlog, jc = jm.decode(jp, {"inner": jc["inner"], "pos": jnp.asarray(pos)}, jnp.asarray(tok))
    tlog, tc = tm.decode(tp, {"inner": tc["inner"], "pos": torch.from_numpy(pos)},
                         torch.from_numpy(tok))
    _close(jlog, tlog)
    for (path, a), (_, b) in zip(_flat(jc["inner"]), pytree.flatten_with_paths(tc["inner"])):
        _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_equal(arch, tokens):
    jm, jp, tm, tp = _models(arch)
    jspec = JaxSpec(arch=arch, batch_size=2, prompt_len=16, decode_steps=8)
    tspec = FunctionSpec(arch=arch, batch_size=2, prompt_len=16, decode_steps=8)
    jout = np.asarray(jax.jit(jax_serve_fn(jm, jspec))(jp, jnp.asarray(tokens)))
    with torch.inference_mode():
        tout = make_serve_fn(tm, tspec)(tp, torch.from_numpy(tokens))
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (2, 8)
    np.testing.assert_array_equal(tout.numpy(), jout)


@pytest.mark.parametrize("arch", [KIMI, ARCTIC])
def test_train_mode_aux_loss_matches(arch, tokens):
    """The uniform stack's summed MoE aux loss (the train slice's; prefill
    drops it)."""
    jm, jp, tm, tp = _models(arch)
    jx = jp["embed"]["tok"][jnp.asarray(tokens)]
    tx = tp["embed"]["tok"][torch.from_numpy(tokens)]
    jy, _, jaux = jtr.uniform_forward(jm.cfg, jp["stack"], jx,
                                      jtr.make_positions(jm.cfg, 2, 16), "train")
    ty, cache, taux = ttr.uniform_forward(tm.cfg, tp["stack"], tx,
                                          ttr.make_positions(tm.cfg, 2, 16), "train")
    assert cache is None
    _close(jy, ty)
    _close(jaux, taux)
    assert ttr.uniform_forward(tm.cfg, tp["stack"], tx, None, "prefill")[2] is None


# ------------------------------------------------------------------------ M-RoPE

@pytest.mark.parametrize("B,S,n_patches", [(2, 16, 0), (2, 16, 4), (2, 16, 9), (1, 40, 16),
                                           (3, 20, 1)])
def test_make_positions_match_with_and_without_patches(B, S, n_patches):
    for arch in (QWEN_VL, "llama3.2-3b", "whisper-medium"):
        want = jtr.make_positions(jax_config(arch), B, S, n_patches)
        got = ttr.make_positions(get_config(arch), B, S, n_patches)
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("head_dim", [32, 128])
def test_apply_mrope_matches(head_dim):
    assert tl.mrope_sections(head_dim) == jl.mrope_sections(head_dim)
    assert tl.MROPE_SECTION_FRACS == jl.MROPE_SECTION_FRACS
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 16, 4, head_dim)).astype(np.float32)
    pos = np.asarray(jtr.make_positions(jax_config(QWEN_VL), 2, 16, 9))
    pos = pos + np.array([0, 3, 5], np.int32)[:, None, None]     # three distinct axes
    _close(jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6))
    # text ids on every axis: M-RoPE is RoPE
    flat = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    torch.testing.assert_close(
        tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(np.stack([flat] * 3)), 1e6),
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(flat), 1e6), rtol=0, atol=0)


def _patches(cfg, B=2, S=16, seed=3):
    n = tfront.n_patches_for(S)
    return np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)


def test_qwen2_vl_logits_caches_and_decode_with_patches_match(tokens):
    jm, jp, tm, tp = _models(QWEN_VL)
    patches = _patches(tm.cfg)
    assert patches.shape[1] == jfront.n_patches_for(16) == 4
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)},
                          capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                               "patches": torch.from_numpy(patches)}, capacity=CAPACITY)
    _close(jlog, tlog)
    for (_, a), (_, b) in zip(_flat(jc["inner"]), pytree.flatten_with_paths(tc["inner"])):
        _close(a, b)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jlog, axis=-1))[:, None].astype(np.int32)
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok))
        _close(jlog, tlog)


def test_patch_merge_changes_output(tokens):
    _, _, tm, tp = _models(QWEN_VL)
    batch = {"tokens": torch.from_numpy(tokens), "patches": torch.from_numpy(_patches(tm.cfg))}
    l1, _ = tm.prefill(tp, batch, capacity=16)
    l2, _ = tm.prefill(tp, dict(batch, patches=batch["patches"] * 0 + 1.0), capacity=16)
    l3, _ = tm.prefill(tp, {"tokens": batch["tokens"]}, capacity=16)
    assert (l1 - l2).abs().max() > 1e-4 and (l1 - l3).abs().max() > 1e-4


@pytest.mark.parametrize("arch", [QWEN_VL, "whisper-medium", "llama3.2-3b"])
def test_frontend_inputs_match_jax(arch):
    """``frontend_input_specs`` gives JAX's shapes and dtypes (as meta
    tensors); ``synth_frontend`` draws them on the generator's device, the
    same for the same seed."""
    cfg = get_config(arch)
    want = jfront.frontend_input_specs(jax_config(arch), 4, 512)
    got = tfront.frontend_input_specs(cfg, 4, 512)
    assert sorted(got) == sorted(want)
    for name, meta in got.items():
        assert meta.device.type == "meta" and tuple(meta.shape) == want[name].shape
        assert str(meta.dtype).replace("torch.", "") == np.dtype(want[name].dtype).name
    a = tfront.synth_frontend(cfg, 2, 64, torch.Generator().manual_seed(0))
    b = tfront.synth_frontend(cfg, 2, 64, torch.Generator().manual_seed(0))
    assert sorted(a) == sorted(want)
    for name, t in a.items():
        assert t.device.type == "cpu" and t.dtype == torch.bfloat16 and torch.equal(t, b[name])
    if arch == QWEN_VL:
        assert tuple(a["patches"].shape) == (2, 25, cfg.d_model)         # a 5 x 5 grid
        assert tfront.N_PATCHES == jfront.N_PATCHES == tfront.n_patches_for(512) == 256


# ------------------------------------------------------------------ paged decode

PAGE, MAX_PAGES, SLOTS, PROMPT = 8, 3, 3, 16


@pytest.mark.parametrize("arch", [ARCTIC, "starcoder2-3b", "olmo-1b", "qwen2.5-32b", QWEN_VL])
def test_decode_paged_matches_jax(arch):
    """Two requests admitted into one pool by both packages' admit programs,
    then three continuous-batching steps with an empty slot: the logits of
    the live rows and every page but the null page."""
    jm, jp, tm, tp = _models(arch)
    n_pages = 1 + SLOTS * MAX_PAGES
    prompts = np.random.default_rng(1).integers(0, 512, (2, 1, PROMPT), dtype=np.int32)
    ids = np.array([[4, 2, 0], [7, 1, 9]], np.int32)
    jadmit = jax.jit(jax_admit_fn(jm, MAX_PAGES, PAGE))
    tadmit = make_admit_fn(tm, MAX_PAGES, PAGE)
    jpool, tpool = jm.init_page_pool(n_pages, PAGE), tm.init_page_pool(n_pages, PAGE, "cpu")
    jk, jv, tk, tv = jpool["k_pages"], jpool["v_pages"], tpool["k_pages"], tpool["v_pages"]
    for r in range(2):
        jlog, jk, jv = jadmit(jp, jnp.asarray(prompts[r]), jk, jv, jnp.asarray(ids[r]))
        with torch.inference_mode():
            tlog, _, _ = tadmit(tp, torch.from_numpy(prompts[r]), tk, tv,
                                torch.from_numpy(ids[r]))
        _close(jlog, tlog)
    table = np.zeros((SLOTS, MAX_PAGES), np.int32)
    table[0], table[2] = ids[0], ids[1]                      # slot 1 is empty
    pos = np.array([PROMPT, 0, PROMPT], np.int32)
    tok = np.array([[5], [0], [77]], np.int32)
    for _ in range(3):
        jlog, jk, jv = jax.jit(jm.decode_paged)(jp, jk, jv, jnp.asarray(table),
                                                 jnp.asarray(pos), jnp.asarray(tok))
        with torch.inference_mode():
            tlog, _, _ = tm.decode_paged(tp, tk, tv, torch.from_numpy(table),
                                         torch.from_numpy(pos), torch.from_numpy(tok))
        for r in (0, 2):
            _close(jlog[r], tlog[r])
        _close(jk[:, 1:], tk[:, 1:])
        _close(jv[:, 1:], tv[:, 1:])
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0, 1], np.int32)


def test_kimi_paged_decode_is_refused_as_in_jax():
    jm, jp, tm, tp = _models(KIMI)
    for model in (jm, tm):
        with pytest.raises(ValueError, match="unstacked head layers"):
            model.page_pool_specs(4, PAGE)
    with pytest.raises(ValueError, match="unstacked head layers"):
        jm.decode_paged(jp, None, None, None, jnp.zeros((2,), jnp.int32),
                        jnp.zeros((2, 1), jnp.int32))
    with pytest.raises(ValueError, match="unstacked head layers"):
        tm.decode_paged(tp, None, None, None, torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 1, dtype=torch.int32))


# ------------------------------------------------------------- deploy and boot

DEPLOY_K = 4


@functools.lru_cache(maxsize=None)
def _deployed_pair(arch, root):
    """The reduced float32 ``arch`` deployed by both packages on the CPU
    (v1 snapshots), and the tokens of one ``unikernel`` boot of each."""
    name = _register_f32_arch(arch)
    spec = FunctionSpec(arch=name, batch_size=2, prompt_len=16, decode_steps=DEPLOY_K,
                        reduced=False)
    dep = deploy(spec, CompileCache(root / "tc"), SnapshotStore(root / "ts"), str(root),
                 device="cpu")
    jspec = JaxSpec(arch=name, batch_size=2, prompt_len=16, decode_steps=DEPLOY_K,
                    reduced=False)
    jdep = jax_deploy(jspec, JaxCompileCache(root / "jc"), JaxSnapshotStore(root / "js"),
                      str(root))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 16), dtype=np.int32)
    ops.reset_launch_counts()
    tl_ = Timeline()
    ex = UnikernelDriver().start(dep, tl_)
    out = ex.run(torch.from_numpy(tokens), timeline=tl_).numpy()
    ex.exit()
    assert sum(ops.launch_counts().values()) == 0          # CPU: the plain versions
    jex = JaxUnikernelDriver().start(jdep, JaxTimeline())
    jout = np.asarray(jex.run(jnp.asarray(tokens)))
    jex.exit()
    return dep, jdep, tokens, out, jout


@pytest.fixture(scope="module")
def deploy_root(tmp_path_factory):
    return tmp_path_factory.mktemp("families_deploy")


@pytest.mark.parametrize("arch", [KIMI, QWEN_VL])
def test_deploy_unikernel_boot_gives_jax_tokens_both_ways(arch, deploy_root):
    """The port's deploy exports, compiles, saves, loads and verifies the
    serve program (one flash node per layer, one decode node per layer and
    step) and its head/tail split; booted by the ``unikernel`` driver it gives the eager
    tokens. Each package's program on the other's v1 snapshot gives that
    package's executor tokens: the port's program on JAX's snapshot gives the
    JAX executor's tokens, and JAX's serve function on the port's snapshot
    the port executor's."""
    dep, jdep, tokens, out, jout = _deployed_pair(arch, deploy_root / arch)
    assert dep.split_ok and set(dep.build_s) == {
        "init", "export", "compile", "save", "load", "verify", "split", "first_use_order",
        "snapshot"}
    program = dep.load_program()
    params = dep.snapshots.load_host(dep.image.key)
    graph = torch.export.export(dep.serve_fn, (params, torch.from_numpy(tokens))).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    L = dep.model.cfg.n_layers
    assert targets.count("repro_torch.flash_attention.default") == L
    assert targets.count("repro_torch.decode_attention.default") == L * DEPLOY_K
    # the package calls each op as an opaque call, as the graph does; of the
    # last step's decode calls, whose logits no token reads, Inductor drops
    # those that nothing else needs (none for Kimi, whose steps write its
    # ``head`` layer's cache)
    calls = package_op_calls(dep.fetch_program_payload())
    assert calls.count("repro_torch::flash_attention") == L
    assert L * (DEPLOY_K - 1) <= calls.count("repro_torch::decode_attention") <= L * DEPLOY_K
    with torch.inference_mode():
        eager = dep.serve_fn(dep.snapshots.load_host(dep.image.key), torch.from_numpy(tokens))
    np.testing.assert_array_equal(out, eager.numpy())
    params = SnapshotStore(deploy_root / arch / "js").load_host(jdep.image.key)
    with torch.inference_mode():
        np.testing.assert_array_equal(program(params, torch.from_numpy(tokens)).numpy(), jout)
    jparams = JaxSnapshotStore(deploy_root / arch / "ts").load_host(dep.image.key)
    want = np.asarray(jax.jit(jax_serve_fn(jdep.model, jdep.spec))(jparams,
                                                                  jnp.asarray(tokens)))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("arch", [KIMI, QWEN_VL])
def test_v1_snapshots_restore_byte_for_byte_across_packages(arch, deploy_root):
    dep, jdep, *_ = _deployed_pair(arch, deploy_root / arch)
    root = deploy_root / arch
    for writer_root, key in ((root / "ts", dep.image.key), (root / "js", jdep.image.key)):
        tback = pytree.flatten_with_paths(SnapshotStore(writer_root).load_host(key))
        jback = _flat(JaxSnapshotStore(writer_root).load_host(key))
        assert [p for p, _ in tback] == [p for p, _ in jback]
        for (path, t), (_, x) in zip(tback, jback):
            raw = t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])
            assert raw.numpy().tobytes() == np.asarray(x).tobytes(), path
    if arch == KIMI:
        assert any(p.startswith("['stack']['head'][0]") for p, _ in tback)


def test_kimi_head_list_through_split_first_use_order_and_streamed_restore(deploy_root,
                                                                           tmp_path):
    """Kimi's unstacked ``head`` layer gets through the head program's cache
    output, ``first_use_order`` (its leaves between the embedding and the
    stacked layers, the blocks in JAX's order) and a v2 snapshot, whose
    index paths and streamed leaf list equal JAX's."""
    dep, jdep, tokens, out, _ = _deployed_pair(KIMI, deploy_root / KIMI)
    params = dep.snapshots.load_host(dep.image.key)
    head = dep.cache.load_program(dep.head_program_key())
    with torch.inference_mode():
        tok0, _, inner = head(params, torch.from_numpy(tokens))
    assert tuple(inner["head"][0]["k"].shape) == (2, 16 + DEPLOY_K, 2, 32)
    assert np.array_equal(tok0[:, 0].numpy(), out[:, 0])

    order = dep.first_use_order
    assert sorted(order) == sorted(p for p, _ in pytree.flatten_with_paths(params))
    first = lambda prefix: min(i for i, p in enumerate(order) if p.startswith(prefix))  # noqa
    assert first("['embed']") < first("['stack']['head'][0]") < first("['stack']['layers']")
    block = lambda p: p.rsplit("[", 1)[0]  # noqa: E731
    blocks = lambda o: list(dict.fromkeys(block(p) for p in o))  # noqa: E731
    assert blocks(order) == blocks(jdep.first_use_order)

    seen = {}
    for who, store in (("port", SnapshotStore(tmp_path / "p", blobs=ChunkStore(tmp_path / "b"))),
                       ("jax", JaxSnapshotStore(tmp_path / "p",
                                                blobs=JaxChunkStore(tmp_path / "b")))):
        if who == "port":
            store.save("img", params, first_use_order=order)
        leaves = []
        restore = stream_restore if who == "port" else jax_stream_restore
        restore(store, "img", on_leaf=lambda i, path, leaf: leaves.append((i, path)))
        seen[who] = (store.read_index("img"), leaves)
    assert seen["port"] == seen["jax"]
    index, leaves = seen["port"]
    assert [e["path"] for e in index["leaves"]] == [p for p, _ in _flat(
        JaxSnapshotStore(deploy_root / KIMI / "ts").load_host(dep.image.key))]
    assert [path for _, path in leaves] == order


def test_kimi_card_cut_counts_3_76_billion_parameters():
    """The config the card runs: 2 of 61 layers (the first-k dense layer and
    one MoE layer) and 16 of 384 experts, every width as published."""
    cuts = {}
    for name, get in (("jax", jax_config), ("torch", get_config)):
        cfg = get(KIMI)
        cuts[name] = dataclasses.replace(cfg, n_layers=2,
                                         moe=dataclasses.replace(cfg.moe, n_experts=16))
    tspecs = pytree.leaves(build_model(cuts["torch"], 528).param_specs(), is_leaf=tl.is_spec)
    jspecs = jax.tree.leaves(jax_build(cuts["jax"], 528).param_specs(),
                             is_leaf=lambda s: hasattr(s, "axes"))
    n = sum(math.prod(s.shape) for s in tspecs)
    assert n == sum(math.prod(s.shape) for s in jspecs)
    assert 3.75e9 < n < 3.77e9
