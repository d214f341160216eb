"""The port's configs, layers and model vs the JAX package.

The reduced ``llama3.2-3b`` in float32, with the JAX package's weights from
``build_model(cfg).init(PRNGKey(seed))`` carried over by
``repro_torch.convert.params_from_numpy``. The two packages sum in different
orders, so values are compared at atol 1e-4 / rtol 1e-4; greedy tokens must be
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JaxMoEConfig
from repro.configs import get_config as jax_config
from repro.core.artifact import FunctionSpec as JaxSpec
from repro.core.deploy import make_serve_fn as jax_serve_fn
from repro.models import build_model as jax_build
from repro.models import layers as jl
from repro_torch.configs import ArchConfig, MoEConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.deploy import make_serve_fn
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models.transformer import split_layers, uniform_specs

ATOL = RTOL = 1e-4
CAPACITY = 24


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    jm, tm = jax_build(jcfg, CAPACITY), build_model(tcfg, CAPACITY)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, 16), dtype=np.int32)


# ---------------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_equals_jax_field_by_field(reduced):
    j, t = jax_config("llama3.2-3b"), get_config("llama3.2-3b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_other_families_are_not_yet_ported():
    """Once refused, MoE on the uniform stack is ported: a llama with 4
    experts builds the JAX package's param specs and cache specs (paths,
    shapes, dtypes)."""
    moe = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
    jmoe = dataclasses.replace(jax_config("llama3.2-3b").reduced(),
                               moe=JaxMoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
    assert isinstance(moe, ArchConfig) and dataclasses.asdict(moe) == dataclasses.asdict(jmoe)
    from repro_torch import pytree
    jm, tm = jax_build(jmoe, 16), build_model(moe, 16)
    for jspec, tspec in ((jm.param_specs(), tm.param_specs()),
                         (jm.cache_specs(1, 16), tm.cache_specs(1, 16))):
        jd = [(jax.tree_util.keystr(p), s.shape, np.dtype(s.dtype).name) for p, s in
              jax.tree_util.tree_flatten_with_path(
                  jspec, is_leaf=lambda s: hasattr(s, "axes"))[0]]
        td = [(p, s.shape, str(s.dtype).replace("torch.", ""))
              for p, s in pytree.flatten_with_paths(tspec, is_leaf=tl.is_spec)]
        assert td == jd
    assert uniform_specs(moe, torch.float32)["layers"]["moe"]["w_up"].shape == (2, 4, 128, 64)


# ----------------------------------------------------------------------- params

def test_param_tree_paths_shapes_and_layout_match(models):
    jm, jp, tm, tp = models
    jflat = {jax.tree_util.keystr(p): np.asarray(x)
             for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    from repro_torch import pytree
    tflat = dict(pytree.flatten_with_paths(tp))
    assert list(tflat) == list(jflat)                 # same paths, same order
    for path, x in jflat.items():
        assert tuple(tflat[path].shape) == x.shape, path
        np.testing.assert_array_equal(tflat[path].numpy(), x)
    specs = pytree.flatten_with_paths(tm.param_specs(), is_leaf=tl.is_spec)
    assert [(p, s.shape) for p, s in specs] == [(p, x.shape) for p, x in jflat.items()]


def test_bf16_leaves_carry_over_bit_exact():
    jp = jax_build(jax_config("llama3.2-3b").reduced(), 8).init(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, device="cpu")
    a = np.asarray(host["embed"]["tok"]).view(np.uint16)
    b = tp["embed"]["tok"].view(torch.int16).numpy().view(np.uint16)
    assert tp["embed"]["tok"].dtype == torch.bfloat16
    np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------- layers

def test_rms_norm_rope_and_mlp_match(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((cfg.d_model,)).astype(np.float32)
    _close(jl.rms_norm(jnp.asarray(x), jnp.asarray(w)),
           tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)))
    h = rng.standard_normal((2, 16, cfg.n_heads, cfg.resolved_head_dim)).astype(np.float32)
    pos = np.tile(np.arange(5, 21, dtype=np.int32), (2, 1))
    _close(jl.apply_rope(jnp.asarray(h), jnp.asarray(pos), cfg.rope_theta),
           tl.apply_rope(torch.from_numpy(h), torch.from_numpy(pos), cfg.rope_theta))
    jmlp = jax.tree.map(lambda a: a[0], jp["stack"]["layers"]["mlp"])
    tmlp = {k: v[0] for k, v in tp["stack"]["layers"]["mlp"].items()}
    _close(jl.apply_mlp(jm.cfg, jmlp, jnp.asarray(x)),
           tl.apply_mlp(cfg, tmlp, torch.from_numpy(x)))


# ------------------------------------------------------------------------ model

def test_prefill_logits_and_cache_match(models, tokens):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    _close(jlog, tlog)
    for name in ("k", "v"):
        assert tuple(tc["inner"][name].shape) == jc["inner"][name].shape
        _close(jc["inner"][name], tc["inner"][name])
    assert tc["pos"] == int(jc["pos"])


def test_decode_steps_match_scalar_and_per_row_pos(models, tokens):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    for _ in range(3):                              # lock-step batch: scalar pos
        tok = np.asarray(jnp.argmax(jlog, axis=-1))[:, None].astype(np.int32)
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok))
        _close(jlog, tlog)
    for name in ("k", "v"):
        _close(jc["inner"][name], tc["inner"][name])
    # per-row positions (rows at different depths), same cache state
    pos = np.array([19, 17], np.int32)
    tok = np.array([[3], [4]], np.int32)
    jlog2, jc2 = jm.decode(jp, {"inner": jc["inner"], "pos": jnp.asarray(pos)},
                           jnp.asarray(tok))
    tlog2, tc2 = tm.decode(tp, {"inner": tc["inner"], "pos": torch.from_numpy(pos)},
                           torch.from_numpy(tok))
    _close(jlog2, tlog2)
    for name in ("k", "v"):
        _close(jc2["inner"][name], tc2["inner"][name])


def test_split_layers_gives_the_same_logits(models, tokens):
    _, _, tm, tp = models
    split = {**tp, "stack": split_layers(tp["stack"])}
    a, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    b, _ = tm.prefill(split, {"tokens": torch.from_numpy(tokens)}, capacity=CAPACITY)
    assert torch.equal(a, b)


def test_serve_greedy_tokens_equal(models, tokens):
    jm, jp, tm, tp = models
    jspec = JaxSpec(arch="llama3.2-3b", batch_size=2, prompt_len=16, decode_steps=8)
    tspec = FunctionSpec(arch="llama3.2-3b", batch_size=2, prompt_len=16, decode_steps=8)
    jout = np.asarray(jax.jit(jax_serve_fn(jm, jspec))(jp, jnp.asarray(tokens)))
    with torch.inference_mode():
        tout = make_serve_fn(tm, tspec)(tp, torch.from_numpy(tokens))
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (2, 8)
    np.testing.assert_array_equal(tout.numpy(), jout)
