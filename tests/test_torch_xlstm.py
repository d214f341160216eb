"""The port's xLSTM slice vs the JAX package: config, blocks, model, serve
program, deploy, snapshots.

The reduced ``xlstm-1.3b`` (1 mLSTM + 1 sLSTM block, d_model 128, 4 heads,
Dk 32, Dv 64) in float32, with the JAX package's weights from
``build_model(cfg).init(PRNGKey(0))`` carried over by
``repro_torch.convert.params_from_numpy``. The two packages sum in different
orders, so values are compared at atol 1e-4 / rtol 1e-4; greedy tokens must
be equal. On the CPU the mLSTM runs its plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs.base as jax_configs
from repro.configs import get_config as jax_config
from repro.core.artifact import FunctionSpec as JaxSpec
from repro.core.compile_cache import CompileCache as JaxCompileCache
from repro.core.deploy import deploy as jax_deploy
from repro.core.deploy import make_serve_fn as jax_serve_fn
from repro.core.drivers import UnikernelDriver as JaxUnikernelDriver
from repro.core.metrics import Timeline as JaxTimeline
from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
import repro_torch.configs.base as torch_configs
from repro_torch import pytree
from repro_torch.configs import ArchConfig, MoEConfig, SSMConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.deploy import deploy, make_serve_fn
from repro_torch.core.drivers import UnikernelDriver
from repro_torch.core.metrics import Timeline
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm

ARCH = "xlstm-1.3b"
ATOL = RTOL = 1e-4
CAPACITY = 24
# the reduced xlstm at 4 blocks (2 periods of 1 mLSTM + 1 sLSTM) in float32,
# registered in both packages
X4_ARCH = "xlstm-1.3b:f32x4"


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=ATOL, rtol=RTOL)


def _register_x4_arch():
    for reg in (jax_configs, torch_configs):
        if X4_ARCH not in reg._REGISTRY:
            base = reg.get_config(ARCH).reduced()
            reg.register(X4_ARCH)(lambda base=base: dataclasses.replace(
                base, n_layers=4, dtype="float32"))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jm, tm = jax_build(jcfg, CAPACITY), build_model(tcfg, CAPACITY)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, 16), dtype=np.int32)


def _block_params(jp, tp, kind):
    """The first block of ``kind`` ('mlstm' or 'slstm') in both trees."""
    jl, tl_ = jp["stack"]["layers"][kind], tp["stack"]["layers"][kind]
    if kind == "mlstm":
        return (jax.tree.map(lambda a: a[0, 0], jl), pytree.tree_map(lambda a: a[0, 0], tl_))
    return jax.tree.map(lambda a: a[0], jl), pytree.tree_map(lambda a: a[0], tl_)


# ---------------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_equals_jax_field_by_field(reduced):
    j, t = jax_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if reduced:
        assert tssm.mlstm_dims(t) == (256, 4, 32, 64)
    else:
        assert tssm.mlstm_dims(t) == (4096, 4, 512, 1024)


def _port_config(jcfg) -> ArchConfig:
    fields = dataclasses.asdict(jcfg)
    fields["moe"] = MoEConfig(**fields["moe"]) if fields["moe"] else None
    fields["ssm"] = SSMConfig(**fields["ssm"]) if fields["ssm"] else None
    return ArchConfig(**fields)


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_other_families_still_raise_not_implemented(arch):
    """MoE on the uniform stack, encoder-decoder and vision configs (built
    from the JAX package's own, reduced) go through the dispatchers and are
    refused."""
    cfg = _port_config(jax_config(arch).reduced())
    model = build_model(cfg, 16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.param_specs()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.cache_specs(1, 16)


# ----------------------------------------------------------------------- params

def test_param_tree_paths_shapes_and_dtypes_match(models):
    jm, jp, tm, tp = models
    jflat = {jax.tree_util.keystr(p): np.asarray(x)
             for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = dict(pytree.flatten_with_paths(tp))
    assert list(tflat) == list(jflat)                 # same paths, same order
    for path, x in jflat.items():
        assert tuple(tflat[path].shape) == x.shape, path
        np.testing.assert_array_equal(tflat[path].numpy(), x)
    specs = pytree.flatten_with_paths(tm.param_specs(), is_leaf=tl.is_spec)
    assert [(p, s.shape) for p, s in specs] == [(p, x.shape) for p, x in jflat.items()]
    # and in the model's own dtype (bf16), with its f32 leaves
    jspec = jax_build(jax_config(ARCH).reduced(), CAPACITY).param_specs()
    tspec = build_model(get_config(ARCH).reduced(), CAPACITY).param_specs()
    jd = [(jax.tree_util.keystr(p), s.shape, np.dtype(s.dtype).name) for p, s in
          jax.tree_util.tree_flatten_with_path(
              jspec, is_leaf=lambda s: hasattr(s, "axes"))[0]]
    td = [(p, s.shape, str(s.dtype).replace("torch.", ""))
          for p, s in pytree.flatten_with_paths(tspec, is_leaf=tl.is_spec)]
    assert td == jd
    assert {p for p, _, d in td if d == "float32"} == {
        "['stack']['layers']['mlstm']['f_bias']", "['stack']['layers']['slstm']['b_in']"}


def test_bf16_and_f32_leaves_carry_over_bit_exact():
    jp = jax_build(jax_config(ARCH).reduced(), 8).init(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, device="cpu")
    for (path, a), (tpath, t) in zip(
            ((jax.tree_util.keystr(p), x) for p, x in
             jax.tree_util.tree_flatten_with_path(host)[0]),
            pytree.flatten_with_paths(tp)):
        assert path == tpath
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, path
        raw = t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()
        assert raw.tobytes() == a.tobytes(), path


def test_init_draws_every_leaf_with_its_own_initializer():
    tm = build_model(get_config(ARCH).reduced(), 8)
    tp = tm.init(torch.Generator().manual_seed(0))
    ml = tp["stack"]["layers"]["mlstm"]
    assert torch.equal(ml["f_bias"], torch.full_like(ml["f_bias"], 3.0))
    assert torch.equal(tp["stack"]["layers"]["slstm"]["b_in"],
                       torch.zeros_like(tp["stack"]["layers"]["slstm"]["b_in"]))
    assert ml["w_q"].dtype == torch.bfloat16 and ml["w_q"].std() > 0
    cache = tl.init_tree(tm.cache_specs(2, 8), torch.Generator())
    assert torch.all(cache["inner"]["mlstm"]["m"] == -1e30)
    assert torch.all(cache["inner"]["slstm"]["m"] == -1e30)


# ----------------------------------------------------------------------- blocks

def test_mlstm_and_slstm_blocks_and_steps_match(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    x_t = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    for kind in ("mlstm", "slstm"):
        jb, tb = _block_params(jp, tp, kind)
        jfwd = getattr(jssm, f"{kind}_forward")
        tfwd = getattr(tssm, f"{kind}_forward")
        jy, jst = jfwd(jm.cfg, jb, jnp.asarray(x))
        ty, tst = tfwd(cfg, tb, torch.from_numpy(x))
        _close(jy, ty)
        assert len(jst) == len(tst)
        for a, b in zip(jst, tst):
            assert tuple(b.shape) == a.shape
            _close(a, b)
        jstep = jssm.mlstm_decode_step if kind == "mlstm" else jssm.slstm_step
        tstep = tssm.mlstm_decode_step if kind == "mlstm" else tssm.slstm_step
        jy2, jst2 = jstep(jm.cfg, jb, jnp.asarray(x_t), jst)
        ty2, tst2 = tstep(cfg, tb, torch.from_numpy(x_t), tst)
        _close(jy2, ty2)
        for a, b in zip(jst2, tst2):
            _close(a, b)


def test_causal_conv_with_history_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for history in (None, hist):
        jout, jh = jssm._causal_depthwise_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if history is None else jnp.asarray(history))
        tout, th = tssm._causal_depthwise_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if history is None else torch.from_numpy(history))
        _close(jout, tout)
        _close(jh, th)


# ------------------------------------------------------------------------ model

def test_prefill_logits_and_every_cache_leaf_match(models, tokens):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    _close(jlog, tlog)
    jflat = jax.tree_util.tree_flatten_with_path(jc["inner"])[0]
    tflat = pytree.flatten_with_paths(tc["inner"])
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    assert len(tflat) == 8
    for (_, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape
        _close(a, b)
    assert tc["pos"] == int(jc["pos"])
    specs = pytree.flatten_with_paths(tm.cache_specs(2, CAPACITY)["inner"], is_leaf=tl.is_spec)
    assert [(p, s.shape, s.dtype) for p, s in specs] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tflat]


def test_decode_steps_match(models, tokens):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlog, axis=-1))[:, None].astype(np.int32)
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok))
        _close(jlog, tlog)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jc["inner"])[0],
                              pytree.flatten_with_paths(tc["inner"])):
        _close(a, b)


def test_serve_greedy_tokens_equal(models, tokens):
    jm, jp, tm, tp = models
    jspec = JaxSpec(arch=ARCH, batch_size=2, prompt_len=16, decode_steps=8)
    tspec = FunctionSpec(arch=ARCH, batch_size=2, prompt_len=16, decode_steps=8)
    jout = np.asarray(jax.jit(jax_serve_fn(jm, jspec))(jp, jnp.asarray(tokens)))
    with torch.inference_mode():
        tout = make_serve_fn(tm, tspec)(tp, torch.from_numpy(tokens))
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (2, 8)
    np.testing.assert_array_equal(tout.numpy(), jout)


# ------------------------------------------------------------- deploy and boot

def test_deploy_exports_one_slstm_node_per_block_and_gives_jax_tokens(tmp_path):
    """The port's deploy exports, saves, loads and verifies the serve program
    of a 4-block xlstm on the CPU. Per pass (the prefill, each decode step)
    the program holds one ``slstm_scan`` node per sLSTM block; the prefill
    one ``mlstm`` node per mLSTM block, each decode step one ``mlstm_step``
    node per mLSTM block; the state is written in place. Booted on the
    snapshot the JAX package's deploy wrote, it gives the JAX executor's
    tokens."""
    _register_x4_arch()
    spec = FunctionSpec(arch=X4_ARCH, batch_size=2, prompt_len=16, decode_steps=4,
                        reduced=False)
    dep = deploy(spec, CompileCache(tmp_path / "tc"), SnapshotStore(tmp_path / "ts"),
                 str(tmp_path), device="cpu")
    assert set(dep.build_s) == {"init", "export", "save", "load", "verify", "snapshot"}
    program = dep.load_program()
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    passes = 1 + spec.decode_steps
    assert targets.count("repro_torch.slstm_scan.default") == 2 * passes
    assert targets.count("repro_torch.mlstm.default") == 2
    assert targets.count("repro_torch.mlstm_step.default") == 2 * spec.decode_steps
    assert not any("attention" in t or "scatter" in t for t in targets)

    tokens = np.random.default_rng(5).integers(0, 512, (2, 16), dtype=np.int32)
    ops.reset_launch_counts()
    tl_ = Timeline()
    ex = UnikernelDriver().start(dep, tl_)
    out = ex.run(torch.from_numpy(tokens), timeline=tl_)
    with torch.inference_mode():
        eager = dep.serve_fn(dep.snapshots.load_host(dep.image.key), torch.from_numpy(tokens))
    assert torch.equal(out, eager) and tuple(out.shape) == (2, 4)
    ex.exit()
    assert ops.launch_counts()["mlstm"] == 0            # CPU: the plain version

    jspec = JaxSpec(arch=X4_ARCH, batch_size=2, prompt_len=16, decode_steps=4, reduced=False)
    jdep = jax_deploy(jspec, JaxCompileCache(tmp_path / "jc"),
                      JaxSnapshotStore(tmp_path / "js"), str(tmp_path))
    jex = JaxUnikernelDriver().start(jdep, JaxTimeline())
    jtokens = np.asarray(jex.run(jnp.asarray(tokens)))
    jex.exit()
    params = SnapshotStore(tmp_path / "js").load_host(jdep.image.key)
    with torch.inference_mode():
        got = program(params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), jtokens)


def test_xlstm_snapshot_restores_byte_for_byte_across_packages(tmp_path):
    jp = jax_build(jax_config(ARCH).reduced(), 8).init(jax.random.PRNGKey(2))
    host = jax.tree.map(np.asarray, jp)
    JaxSnapshotStore(tmp_path / "j").save("img", host)
    back = SnapshotStore(tmp_path / "j").load_host("img")
    want = [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(host)[0]]
    got = pytree.flatten_with_paths(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, t) in zip(want, got):
        raw = t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])
        assert raw.numpy().tobytes() == x.tobytes(), path
    # and back: the port writes what the JAX package reads, the same files
    tp = params_from_numpy(host, device="cpu")
    SnapshotStore(tmp_path / "p").save("img", tp)
    jback = JaxSnapshotStore(tmp_path / "p").load_host("img")
    for (path, x), (_, y) in zip(want, ((jax.tree_util.keystr(p), y) for p, y in
                                        jax.tree_util.tree_flatten_with_path(jback)[0])):
        assert np.asarray(y).dtype == x.dtype and np.asarray(y).tobytes() == x.tobytes(), path
    assert any(np.asarray(x).dtype == np.dtype(ml_dtypes.bfloat16) for _, x in want)
    for name in ("index.json", "leaf_00000.npy"):
        assert (tmp_path / "p" / "img" / name).read_bytes() == \
            (tmp_path / "j" / "img" / name).read_bytes(), name
