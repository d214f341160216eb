"""The port's encoder-decoder (whisper-medium) vs the JAX package: the
encoder, cross-attention in prefill and decode, the cache with the
encoder's K/V, greedy serving through the ``Model`` API, and ``deploy``,
which refuses whisper in both packages (its serve program takes tokens only
and the encoder reads ``frames``).

The JAX package's ``reduced()`` whisper in float32 (2 encoder and 2 decoder
layers, d_model 128, 4/4 heads of 32, 16 encoder frames, vocab 512,
LayerNorm, GELU, biases, learned decoder positions), with the JAX package's
weights carried over by ``repro_torch.convert.params_from_numpy``; values are
compared at atol 1e-4 / rtol 1e-4, greedy tokens must be equal. The port
runs its plain kernels and the JAX package its reference path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.artifact import FunctionSpec as JaxSpec
from repro.core.compile_cache import CompileCache as JaxCompileCache
from repro.core.deploy import deploy as jax_deploy
from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import transformer as jtr
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.deploy import deploy
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr

ARCH = "whisper-medium"
ATOL = RTOL = 1e-4
CAPACITY = 24
K = 6


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=ATOL, rtol=RTOL)


def _flat(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jm, tm = jax_build(jcfg, CAPACITY), build_model(tcfg, CAPACITY)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 512, (2, 16), dtype=np.int32),
            "frames": rng.standard_normal((2, 16, 128)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_reduced_whisper_is_the_cut_under_test(models):
    cfg = models[2].cfg
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.encoder_seq, cfg.d_model) == (2, 2, 16, 128)
    assert ttr.family_kind(cfg) == jtr.family_kind(models[0].cfg) == "encdec"
    assert cfg.rope == "none" and cfg.norm == "layernorm" and cfg.act == "gelu"


def test_param_tree_paths_shapes_and_dtypes_match(models):
    jm, jp, tm, tp = models
    jflat, tflat = _flat(jp), pytree.flatten_with_paths(tp)
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (path, x), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == x.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(x))
    paths = [p for p, _ in tflat]
    for leaf in ("['stack']['enc_pos']", "['stack']['enc_final']['scale']",
                 "['stack']['enc_layers']['attn']['wq']", "['stack']['layers']['xattn']['bk']",
                 "['stack']['layers']['lnx']['bias']", "['embed']['pos']"):
        assert leaf in paths, leaf
    jspec = jax_build(jax_config(ARCH).reduced(), CAPACITY).param_specs()
    tspec = build_model(get_config(ARCH).reduced(), CAPACITY).param_specs()
    jd = [(jax.tree_util.keystr(p), s.shape, np.dtype(s.dtype).name) for p, s in
          jax.tree_util.tree_flatten_with_path(jspec, is_leaf=lambda s: hasattr(s, "axes"))[0]]
    td = [(p, s.shape, str(s.dtype).replace("torch.", ""))
          for p, s in pytree.flatten_with_paths(tspec, is_leaf=tl.is_spec)]
    assert td == jd


def test_encoder_forward_matches(models, batch):
    jm, jp, tm, tp = models
    want = jtr.encoder_forward(jm.cfg, jp["stack"], jnp.asarray(batch["frames"]))
    got = ttr.encoder_forward(tm.cfg, tp["stack"], torch.from_numpy(batch["frames"]))
    assert tuple(got.shape) == want.shape == (2, 16, 128)
    _close(want, got)


def test_cross_attention_prefill_and_decode_match(models, batch):
    """``attention_full(kv_from=...)``: K/V from the encoder output, no
    causal mask; ``attention_decode(cross=True)``: all positions of the
    encoder's K/V, which it leaves as they are."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    enc = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["stack"]["layers"]["xattn"])
    tx = {k: v[0] for k, v in tp["stack"]["layers"]["xattn"].items()}
    jy, (jk, jv) = jattn.attention_full(jm.cfg, jx, jnp.asarray(x), None,
                                        kv_from=jnp.asarray(enc))
    ty, (tk, tv) = tattn.attention_full(tm.cfg, tx, torch.from_numpy(x), None,
                                        kv_from=torch.from_numpy(enc))
    for a, b in ((jy, ty), (jk, tk), (jv, tv)):
        _close(a, b)
    assert tuple(tk.shape) == (2, 16, 4, 32)
    x_t = x[:, :1]
    jy, jk2, _ = jattn.attention_decode(jm.cfg, jx, jnp.asarray(x_t), jk, jv,
                                        jnp.int32(3), cross=True)
    before = tk.clone()
    ty, tk2, _ = tattn.attention_decode(tm.cfg, tx, torch.from_numpy(x_t), tk, tv, 3, None,
                                        cross=True)
    _close(jy, ty)
    assert tk2 is tk and torch.equal(tk, before)


def test_prefill_logits_and_every_cache_leaf_match(models, batch):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, _jax(batch), capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, _torch(batch), capacity=CAPACITY)
    _close(jlog, tlog)
    jflat, tflat = _flat(jc["inner"]), pytree.flatten_with_paths(tc["inner"])
    assert [p for p, _ in tflat] == [p for p, _ in jflat] == \
        ["['k']", "['v']", "['xk']", "['xv']"]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape
        _close(a, b)
    assert tuple(tc["inner"]["xk"].shape) == (2, 2, 16, 4, 32)       # encoder_seq, not capacity
    assert tuple(tc["inner"]["k"].shape) == (2, 2, CAPACITY, 4, 32)
    specs = pytree.flatten_with_paths(tm.cache_specs(2, CAPACITY)["inner"], is_leaf=tl.is_spec)
    assert [(p, s.shape, s.dtype) for p, s in specs] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tflat]


def test_decode_steps_match_scalar_and_per_row_pos(models, batch):
    jm, jp, tm, tp = models
    jlog, jc = jm.prefill(jp, _jax(batch), capacity=CAPACITY)
    tlog, tc = tm.prefill(tp, _torch(batch), capacity=CAPACITY)
    xk = tc["inner"]["xk"].clone()
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlog, axis=-1))[:, None].astype(np.int32)
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok))
        _close(jlog, tlog)
    assert torch.equal(tc["inner"]["xk"], xk)                  # the cross cache is read only
    pos = np.array([19, 17], np.int32)
    tok = np.array([[3], [4]], np.int32)
    jlog, jc = jm.decode(jp, {"inner": jc["inner"], "pos": jnp.asarray(pos)}, jnp.asarray(tok))
    tlog, tc = tm.decode(tp, {"inner": tc["inner"], "pos": torch.from_numpy(pos)},
                         torch.from_numpy(tok))
    _close(jlog, tlog)
    for (_, a), (_, b) in zip(_flat(jc["inner"]), pytree.flatten_with_paths(tc["inner"])):
        _close(a, b)


def _greedy_jax(jm, jp, batch):
    logits, cache = jm.prefill(jp, _jax(batch), capacity=CAPACITY)
    toks = []
    for _ in range(K):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        logits, cache = jm.decode(jp, cache, tok)
        toks.append(np.asarray(tok[:, 0]))
    return np.stack(toks, axis=1)


def _greedy_torch(tm, tp, batch):
    with torch.inference_mode():
        logits, cache = tm.prefill(tp, _torch(batch), capacity=CAPACITY)
        toks = []
        for _ in range(K):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits, cache = tm.decode(tp, cache, tok)
            toks.append(tok[:, 0])
    return torch.stack(toks, dim=1).numpy()


def test_serve_greedy_tokens_equal_through_the_model_api(models, batch):
    """The serve function's body (prefill + K greedy decode steps) with the
    frames in the batch: the same tokens in both packages."""
    jm, jp, tm, tp = models
    got = _greedy_torch(tm, tp, batch)
    assert got.dtype == np.int32 and got.shape == (2, K)
    np.testing.assert_array_equal(got, _greedy_jax(jm, jp, batch))


def test_frames_change_the_output(models, batch):
    _, _, tm, tp = models
    l1, _ = tm.prefill(tp, _torch(batch), capacity=16)
    l2, _ = tm.prefill(tp, dict(_torch(batch), frames=torch.full((2, 16, 128), -0.5)),
                       capacity=16)
    assert (l1 - l2).abs().max() > 1e-4


def test_deploy_of_whisper_fails_in_both_packages(tmp_path):
    """``FunctionSpec`` carries tokens only and the encoder reads
    ``batch["frames"]``: both packages' ``deploy`` raise the same KeyError
    while tracing the serve program."""
    spec = dict(arch=ARCH, batch_size=2, prompt_len=8, decode_steps=2)
    with pytest.raises(KeyError, match="frames"):
        jax_deploy(JaxSpec(**spec), JaxCompileCache(tmp_path / "jc"),
                   JaxSnapshotStore(tmp_path / "js"), str(tmp_path))
    with pytest.raises(KeyError, match="frames"):
        deploy(FunctionSpec(**spec), CompileCache(tmp_path / "tc"),
               SnapshotStore(tmp_path / "ts"), str(tmp_path), device="cpu")
