"""The port's jamba slice vs the JAX package: config, Mamba blocks, MoE,
model, serve program, deploy, snapshots.

The reduced ``jamba-1.5-large-398b`` (2 periods of 3 Mamba + 1 attention
blocks, MoE on every other slot with 4 experts, top-2, d_model 128, d_state
8) in float32, with the JAX package's weights from
``build_model(cfg).init(PRNGKey(0))`` carried over by
``repro_torch.convert.params_from_numpy``. The two packages sum in different
orders, so values are compared at atol 1e-4 / rtol 1e-4; expert ids and
greedy tokens must be equal. On the CPU the selective scan runs its plain
version.
"""
import dataclasses
import math

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
from repro.models import layers as jax_layers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtr
import repro_torch.configs.base as torch_configs
from repro_torch import pytree
from repro_torch.configs import get_config
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
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

ARCH = "jamba-1.5-large-398b"
ATOL = RTOL = 1e-4
CAPACITY = 24
# the reduced jamba in float32, registered in both packages
F32_ARCH = "jamba-1.5-large-398b:f32"


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=ATOL, rtol=RTOL)


def _register_f32_arch():
    for reg in (jax_configs, torch_configs):
        if F32_ARCH not in reg._REGISTRY:
            base = reg.get_config(ARCH).reduced()
            reg.register(F32_ARCH)(lambda base=base: dataclasses.replace(base, dtype="float32"))


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


def _first(jtree, ttree, n_lead: int):
    """Block 0 of a [P, ...] (n_lead 1) or [P, n, ...] (n_lead 2) tree in both."""
    idx = (0,) * n_lead
    return jax.tree.map(lambda a: a[idx], jtree), pytree.tree_map(lambda a: a[idx], ttree)


# ---------------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_equals_jax_field_by_field(reduced):
    j, t = jax_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tssm.mamba_dims(t) == jssm.mamba_dims(j)
    assert ttr._jamba_layout(t) == jtr._jamba_layout(j)
    if reduced:
        assert tssm.mamba_dims(t) == (256, 8, 8, 4)
        assert ttr._jamba_layout(t) == (4, 2, [1, 3], [0, 2])
    else:
        assert tssm.mamba_dims(t) == (16384, 512, 16, 4)
        assert ttr._jamba_layout(t) == (8, 9, [1, 3, 5, 7], [0, 2, 4, 6])


def test_one_period_with_four_experts_is_the_card_cut():
    """The config the card runs: one period of 8 layers and 4 of the 16
    experts, every width as published: 16.2 B parameters, 32.5 GB in bf16,
    counted from the specs of both packages."""
    cut = {}
    for name, get in (("jax", jax_config), ("torch", get_config)):
        cfg = get(ARCH)
        cut[name] = dataclasses.replace(cfg, n_layers=cfg.ssm.attn_every,
                                        moe=dataclasses.replace(cfg.moe, n_experts=4))
    assert cut["jax"].param_counts()["total"] == 16_246_915_072
    tspecs = pytree.leaves(build_model(cut["torch"], 528).param_specs(), is_leaf=tl.is_spec)
    jspecs = jax.tree.leaves(jax_build(cut["jax"], 528).param_specs(),
                             is_leaf=lambda s: hasattr(s, "axes"))
    n = sum(math.prod(s.shape) for s in tspecs)
    assert n == sum(math.prod(s.shape) for s in jspecs) == 16_246_923_264   # + norm scales
    nbytes = sum(math.prod(s.shape) * (4 if s.dtype == torch.float32 else 2) for s in tspecs)
    assert 32.4e9 < nbytes < 32.6e9


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
    assert tuple(tflat["['stack']['layers']['mamba']['a_log']"].shape) == (2, 3, 256, 8)
    assert tuple(tflat["['stack']['layers']['moe']['w_up']"].shape) == (2, 2, 4, 128, 64)
    assert tuple(tflat["['stack']['layers']['mlp']['w_up']"].shape) == (2, 2, 128, 64)
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
        "['stack']['layers']['mamba']['a_log']", "['stack']['layers']['mamba']['d_skip']",
        "['stack']['layers']['mamba']['dt_bias']", "['stack']['layers']['moe']['router']"}
    assert "pos" not in tspec["embed"] and "unembed" in tspec["embed"]


def test_bf16_and_f32_leaves_carry_over_bit_exact():
    jp = jax_build(jax_config(ARCH).reduced(), 8).init(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, device="cpu")
    pairs = list(zip(((jax.tree_util.keystr(p), x) for p, x in
                      jax.tree_util.tree_flatten_with_path(host)[0]),
                     pytree.flatten_with_paths(tp)))
    assert {str(t.dtype) for _, (_, t) in pairs} == {"torch.bfloat16", "torch.float32"}
    for (path, a), (tpath, t) in pairs:
        assert path == tpath
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, path
        raw = t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()
        assert raw.tobytes() == a.tobytes(), path


def test_init_draws_every_leaf_with_its_own_initializer():
    tm = build_model(get_config(ARCH).reduced(), 8)
    tp = tm.init(torch.Generator().manual_seed(0))
    mb = tp["stack"]["layers"]["mamba"]
    want_a = torch.log(torch.arange(1, 9, dtype=torch.float32)).expand(2, 3, 256, 8)
    assert torch.equal(mb["a_log"], want_a)
    assert torch.equal(mb["d_skip"], torch.ones_like(mb["d_skip"]))
    assert torch.equal(mb["dt_bias"], torch.full_like(mb["dt_bias"],
                                                      math.log(math.expm1(0.01))))
    assert mb["in_proj"].dtype == torch.bfloat16 and mb["in_proj"].std() > 0
    assert tp["stack"]["layers"]["moe"]["router"].dtype == torch.float32
    cache = tl.init_tree(tm.cache_specs(2, 8), torch.Generator())
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache["inner"].items()} == {
        "conv": ((2, 3, 2, 3, 256), torch.bfloat16), "ssm": ((2, 3, 2, 256, 8), torch.float32),
        "k": ((2, 2, 8, 2, 32), torch.bfloat16), "v": ((2, 2, 8, 2, 32), torch.bfloat16)}


# ----------------------------------------------------------------------- blocks

@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv_with_history_matches(S, with_history):
    """The Mamba conv at its own widths: cw 4 over d_inner channels."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 256)).astype(np.float32)
    w = rng.standard_normal((4, 256)).astype(np.float32)
    b = rng.standard_normal((256,)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 256)).astype(np.float32) if with_history else None
    jout, jh = jssm._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if hist is None else jnp.asarray(hist))
    tout, th = tssm._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if hist is None else torch.from_numpy(hist))
    _close(jout, tout)
    _close(jh, th)


def test_mamba_block_and_step_match(models):
    """A Mamba block from a zero state and from a given one, then decode
    steps from its state: outputs and (conv, ssm) states."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    jb, tb = _first(jp["stack"]["layers"]["mamba"], tp["stack"]["layers"]["mamba"], 2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jy, jst = jssm.mamba_forward(jm.cfg, jb, jnp.asarray(x))
    ty, tst = tssm.mamba_forward(cfg, tb, torch.from_numpy(x))
    _close(jy, ty)
    for a, b in zip(jst, tst):
        assert tuple(b.shape) == a.shape
        _close(a, b)
    # a second prompt continuing from that state
    jy, jst = jssm.mamba_forward(jm.cfg, jb, jnp.asarray(x[:, :5]), state=jst)
    ty, tst = tssm.mamba_forward(cfg, tb, torch.from_numpy(x[:, :5]), state=tst)
    _close(jy, ty)
    tst = (tst[0], tst[1].clone())
    for t in range(3):
        x_t = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jssm.mamba_step(jm.cfg, jb, jnp.asarray(x_t), jst)
        h = tst[1]
        ty, tst = tssm.mamba_step(cfg, tb, torch.from_numpy(x_t), tst)
        assert tst[1] is h                                # updated in place
        _close(jy, ty)
        for a, b in zip(jst, tst):
            _close(a, b)


def _router_ids(jlogits_fn, tlogits_fn, k):
    jidx = np.asarray(jax.lax.top_k(jax.nn.softmax(jlogits_fn(), axis=-1), k)[1])
    tidx = torch.topk(torch.softmax(tlogits_fn(), dim=-1), k, dim=-1)[1].numpy()
    return jidx, tidx


@pytest.mark.parametrize("capacity_factor", [2.0, 1.25, 0.5])
def test_moe_forward_matches_expert_ids_y_and_aux(models, capacity_factor):
    """The same expert ids, outputs and aux loss; at capacity factor 0.5 the
    capacity drops tokens (some expert is sent more than it holds)."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    jb, tb = _first(jp["stack"]["layers"]["moe"], tp["stack"]["layers"]["moe"], 2)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    T, E, k = 32, cfg.moe.n_experts, cfg.moe.top_k
    jidx, tidx = _router_ids(lambda: jnp.asarray(x.reshape(T, -1)) @ jb["router"],
                             lambda: torch.from_numpy(x.reshape(T, -1)) @ tb["router"], k)
    np.testing.assert_array_equal(tidx, jidx)
    C = tmoe.expert_capacity(T, E, k, capacity_factor)
    assert C == jmoe.expert_capacity(T, E, k, capacity_factor)
    dropped = np.bincount(tidx.reshape(-1), minlength=E).max() > C
    assert dropped == (capacity_factor == 0.5)
    jy, jaux = jmoe.moe_forward(jm.cfg, jb, jnp.asarray(x), capacity_factor=capacity_factor)
    ty, taux = tmoe.moe_forward(cfg, tb, torch.from_numpy(x), capacity_factor=capacity_factor)
    _close(jy, ty)
    _close(jaux, taux)
    ty2, none = tmoe.moe_forward(cfg, tb, torch.from_numpy(x), capacity_factor=capacity_factor,
                                 with_aux=False)
    assert none is None and torch.equal(ty2, ty)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_moe_shared_experts_and_dense_residual_match(arch):
    """The always-on paths the uniform-stack MoE families carry (Kimi's
    shared expert, Arctic's dense residual MLP), on their reduced configs."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    fields = dataclasses.asdict(jcfg)
    fields["moe"] = torch_configs.MoEConfig(**fields["moe"])
    tcfg = torch_configs.ArchConfig(**fields)
    jp = jax_layers.init_tree(jmoe.moe_specs(jcfg, jnp.float32), jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert ("shared" in tp) == bool(jcfg.moe.n_shared_experts)
    assert ("dense" in tp) == jcfg.moe.dense_residual
    x = np.random.default_rng(4).standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x), capacity_factor=1.25)
    ty, taux = tmoe.moe_forward(tcfg, tp, torch.from_numpy(x), capacity_factor=1.25)
    _close(jy, ty)
    _close(jaux, taux)


# ------------------------------------------------------------------------ model

def test_prefill_logits_and_every_cache_leaf_match(models, tokens):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    _close(jlog, tlog)
    jflat = jax.tree_util.tree_flatten_with_path(jc["inner"])[0]
    tflat = pytree.flatten_with_paths(tc["inner"])
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat] == \
        ["['conv']", "['k']", "['ssm']", "['v']"]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape
        _close(a, b)
    assert tc["pos"] == int(jc["pos"])
    specs = pytree.flatten_with_paths(tm.cache_specs(2, CAPACITY)["inner"], is_leaf=tl.is_spec)
    assert [(p, s.shape, s.dtype) for p, s in specs] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tflat]


def test_train_mode_aux_loss_matches(models, tokens):
    """The stack's summed MoE aux loss (the train slice's; prefill drops it)."""
    jm, jp, tm, tp = models
    jx = jp["embed"]["tok"][jnp.asarray(tokens)]
    tx = tp["embed"]["tok"][torch.from_numpy(tokens)]
    positions = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (2, 16))
    jy, _, jaux = jtr.jamba_forward(jm.cfg, jp["stack"], jx, positions, "train")
    ty, cache, taux = ttr.jamba_forward(tm.cfg, tp["stack"], tx, "train")
    assert cache is None
    _close(jy, ty)
    _close(jaux, taux)
    assert ttr.jamba_forward(tm.cfg, tp["stack"], tx, "prefill")[2] is None


def test_decode_steps_match(models, tokens):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    for _ in range(4):
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


def test_paged_decode_is_refused_for_jamba():
    with pytest.raises(ValueError, match="uniform stack only"):
        build_model(get_config(ARCH).reduced(), 16).page_pool_specs(4, 4)


# ------------------------------------------------------------- deploy and boot

def test_deploy_exports_one_scan_node_per_mamba_layer_and_gives_jax_tokens(tmp_path):
    """The port's deploy exports, saves, loads and verifies the serve program
    of the reduced jamba on the CPU: one ``selective_scan`` node per Mamba
    layer (the prefill), one ``mamba_step`` node per Mamba layer and decode
    step, one flash node per attention layer and one decode-attention node
    per attention layer and step. Booted on the snapshot the JAX package's
    deploy wrote, it gives the JAX executor's tokens."""
    _register_f32_arch()
    spec = FunctionSpec(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=4,
                        reduced=False)
    dep = deploy(spec, CompileCache(tmp_path / "tc"), SnapshotStore(tmp_path / "ts"),
                 str(tmp_path), device="cpu")
    assert set(dep.build_s) == {"init", "export", "save", "load", "verify", "snapshot"}
    program = dep.load_program()
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    K, n_mamba, n_attn = spec.decode_steps, 6, 2
    assert targets.count("repro_torch.selective_scan.default") == n_mamba
    assert targets.count("repro_torch.mamba_step.default") == n_mamba * K
    assert targets.count("repro_torch.flash_attention.default") == n_attn
    assert targets.count("repro_torch.decode_attention.default") == n_attn * K
    assert not any("mlstm" in t or "slstm" in t or "paged" in t for t in targets)

    tokens = np.random.default_rng(5).integers(0, 512, (2, 16), dtype=np.int32)
    ops.reset_launch_counts()
    tl_ = Timeline()
    ex = UnikernelDriver().start(dep, tl_)
    out = ex.run(torch.from_numpy(tokens), timeline=tl_)
    with torch.inference_mode():
        eager = dep.serve_fn(dep.snapshots.load_host(dep.image.key), torch.from_numpy(tokens))
    assert torch.equal(out, eager) and tuple(out.shape) == (2, 4)
    ex.exit()
    assert ops.launch_counts()["selective_scan"] == 0    # CPU: the plain version

    jspec = JaxSpec(arch=F32_ARCH, batch_size=2, prompt_len=16, decode_steps=4, reduced=False)
    jdep = jax_deploy(jspec, JaxCompileCache(tmp_path / "jc"),
                      JaxSnapshotStore(tmp_path / "js"), str(tmp_path))
    jex = JaxUnikernelDriver().start(jdep, JaxTimeline())
    jtokens = np.asarray(jex.run(jnp.asarray(tokens)))
    jex.exit()
    params = SnapshotStore(tmp_path / "js").load_host(jdep.image.key)
    with torch.inference_mode():
        got = program(params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), jtokens)


def test_jamba_snapshot_restores_byte_for_byte_across_packages(tmp_path):
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
