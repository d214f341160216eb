"""The port's optimizer, train step and data pipeline vs the JAX package.

* ``cosine_schedule`` over steps 0..total, warmup and decay, within 1e-6
  relative.
* ``AdamW.update`` on seeded float32 params and grads (a matrix, a vector, a
  stacked ``[L, d]`` norm scale, an embedding), two steps in a row, for each
  ``state_dtype``, with the clip active and inactive: params, float32 and
  bfloat16 moments within 1e-6 relative of JAX's (bfloat16 moments: equal,
  or one bfloat16 step apart); int8 ``q`` within 1 of JAX's and ``scale``
  within 1e-6 relative; the stats likewise.
* The int8 codec rounds half to even, as ``jnp.round``.
* ``state_specs``: the same key paths, shapes and dtypes as JAX's.
* ``make_train_step`` at ``grad_accum`` 1 and 2 on the reduced llama in
  float32: params and metrics after one step within 1e-5 relative of JAX's
  (params: each leaf's relative L2 error, since Adam's first step moves an
  element by about ``lr * g / (|g| + eps)``, which turns the rounding-level
  difference of a gradient element near ``eps`` into up to ``lr`` — 1 to 5
  elements of a leaf of 16,384-65,536; moments: max-abs relative).
* ``SyntheticTokenPipeline``: the same batches as JAX's, exactly.
* A JAX ``opt_state`` (every moment dtype, and the step) carries over through
  ``params_from_numpy`` leaf for leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import one_torch_thread  # noqa: F401
from _torch_train_ref import jit, models
from repro.data import SyntheticTokenPipeline as JaxPipeline
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch import pytree
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models import layers as tl
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.optim import adamw as tadamw
from repro_torch.train import make_train_step

RTOL = 1e-6
STEP_RTOL = 1e-5
STATE_DTYPES = ("float32", "bfloat16", "int8")


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want) -> float:
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jflat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup,total,end_frac", [(4, 20, 0.1), (0, 10, 0.1), (10, 10, 0.0),
                                                   (3, 50, 0.25)])
def test_cosine_schedule_matches_jax(warmup, total, end_frac):
    kw = dict(peak_lr=3e-4, warmup=warmup, total=total, end_frac=end_frac)
    for step in range(total + 3):
        want = float(jax_cosine(step, **kw))
        got = cosine_schedule(step, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= RTOL * max(abs(want), 1e-12), (step, float(got), want)
    t = cosine_schedule(torch.tensor(3, dtype=torch.int32), **kw)
    assert abs(float(t) - float(jax_cosine(3, **kw))) <= RTOL * 3e-4


# ---------------------------------------------------------------------- update

def _tree(rng, scale=1.0, offset=0.0):
    return {"w": (scale * rng.standard_normal((8, 16))).astype(np.float32),
            "b": (scale * rng.standard_normal(16)).astype(np.float32),
            "ln": {"scale": (offset + scale * rng.standard_normal((2, 16))).astype(np.float32)},
            "emb": (scale * rng.standard_normal((32, 8))).astype(np.float32)}


def _compare_state(tstate, jstate, state_dtype):
    assert int(tstate["step"]) == int(jstate["step"]) and tstate["step"].dtype == torch.int32
    for key in ("m", "v"):
        if state_dtype == "int8":
            is_mom = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}
            tl_ = pytree.leaves(tstate[key], is_leaf=is_mom)
            jl_ = jax.tree.leaves(jstate[key], is_leaf=is_mom)
            assert len(tl_) == len(jl_)
            for t, j in zip(tl_, jl_):
                assert t["q"].dtype == torch.int8 and t["scale"].dtype == torch.float32
                dq = np.abs(t["q"].numpy().astype(np.int32) - np.asarray(j["q"], np.int32))
                assert dq.max() <= 1, key
                assert _rel(t["scale"], j["scale"]) <= RTOL, key
        else:
            for (path, j), t in zip(_jflat(jstate[key]), pytree.leaves(tstate[key])):
                assert str(t.dtype).removeprefix("torch.") == state_dtype, path
                if state_dtype == "bfloat16":
                    # equal, or one bf16 step apart where the f32 values straddle a
                    # rounding boundary
                    got, want = t.float().numpy(), np.asarray(j, np.float32)
                    ulp = np.abs(want) * 2.0 ** -7
                    assert np.all(np.abs(got - want) <= ulp + 1e-30), (key, path)
                else:
                    assert _rel(t, j) <= RTOL, (key, path)


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
@pytest.mark.parametrize("clip_active", [True, False])
def test_adamw_update_matches_jax(state_dtype, clip_active):
    rng = np.random.default_rng(0)
    params = _tree(rng, offset=1.0)
    grads = [_tree(rng, 3.0 if clip_active else 1e-3) for _ in range(2)]
    kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, state_dtype=state_dtype)
    jopt, topt = JaxAdamW(JaxAdamWConfig(**kw)), AdamW(AdamWConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, jstate, jstats = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        tp, tstate, tstats = topt.update(params_from_numpy(g, device="cpu"), tstate, tp)
        for (path, j), t in zip(_jflat(jp), pytree.leaves(tp)):
            assert t.dtype == torch.float32 and _rel(t, j) <= RTOL, path
        _compare_state(tstate, jstate, state_dtype)
        assert sorted(tstats) == sorted(jstats) == ["clip", "grad_norm", "lr"]
        for key in jstats:
            assert _rel(tstats[key], jstats[key]) <= RTOL, key
        assert (float(tstats["clip"]) < 1.0) == clip_active


def test_weight_decay_reaches_matrix_leaves_only_and_stacked_norm_scales():
    """Decoupled weight decay applies to every leaf of rank >= 2, the stacked
    [L, d] norm scales among them (JAX's rule, kept with the stacked layout)."""
    rng = np.random.default_rng(1)
    params = _tree(rng, offset=1.0)
    zero = {k: (np.zeros_like(v) if not isinstance(v, dict) else
                {kk: np.zeros_like(vv) for kk, vv in v.items()}) for k, v in params.items()}
    opt = AdamW(AdamWConfig(peak_lr=1e-2, warmup=1, total_steps=10, weight_decay=0.5))
    tp = params_from_numpy(params, device="cpu")        # updated in place (f32 moments)
    new, _, _ = opt.update(params_from_numpy(zero, device="cpu"), opt.init(tp), tp)
    tp = params_from_numpy(params, device="cpu")
    assert torch.equal(new["b"], tp["b"])                          # rank 1: untouched
    for leaf in (("w",), ("emb",), ("ln", "scale")):
        a, b = new, tp
        for k in leaf:
            a, b = a[k], b[k]
        assert not torch.equal(a, b), leaf                         # rank 2: decayed
        torch.testing.assert_close(a, b * (1 - 1e-2 * 0.5), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(), (3,), (4, 5), (2, 3, 7)])
def test_int8_codec_matches_jax_and_rounds_half_to_even(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    x = np.asarray(rng.standard_normal(shape) * 10, np.float32)
    jq, js = jadamw._q8_encode(jnp.asarray(x))
    tq, ts = tadamw._q8_encode(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max(initial=0) <= 1
    assert _rel(ts, js) <= RTOL
    assert _rel(tadamw._q8_decode(tq, ts), jadamw._q8_decode(jq, js)) <= 1e-2
    # exact halves of the scale round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    tq, _ = tadamw._q8_encode(torch.from_numpy(half))
    jq, _ = jadamw._q8_encode(jnp.asarray(half))
    assert tq.tolist() == np.asarray(jq).tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_state_specs_match_jax(state_dtype):
    jm, _, tm, _ = models("llama3.2-3b", 17)
    jspecs = JaxAdamW(JaxAdamWConfig(state_dtype=state_dtype)).state_specs(jm.param_specs())
    tspecs = AdamW(AdamWConfig(state_dtype=state_dtype)).state_specs(tm.param_specs())
    jd = [(jax.tree_util.keystr(p), tuple(s.shape), np.dtype(s.dtype).name, tuple(s.axes))
          for p, s in jax.tree_util.tree_flatten_with_path(
              jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]]
    td = [(p, tuple(s.shape), str(s.dtype).removeprefix("torch."), tuple(s.axes))
          for p, s in pytree.flatten_with_paths(tspecs, is_leaf=tl.is_spec)]
    assert td == jd
    # the specs' init gives the state init gives
    gen = torch.Generator()
    made = pytree.tree_map(lambda s: s.init(gen, s.shape, s.dtype), tspecs, is_leaf=tl.is_spec)
    _, _, _, tp = models("llama3.2-3b", 17)
    init = AdamW(AdamWConfig(state_dtype=state_dtype)).init(tp)
    for a, b in zip(pytree.leaves(made), pytree.leaves(init)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------ train step

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    jm, jp, tm, tp = models("llama3.2-3b", 17)
    tokens = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (4, 17), dtype=np.int32)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10)
    jopt, topt = JaxAdamW(JaxAdamWConfig(**kw)), AdamW(AdamWConfig(**kw))
    jstep = jax_make_train_step(jm, jopt, grad_accum=grad_accum)
    tstep = make_train_step(tm, topt, grad_accum=grad_accum)
    jp2, jstate, jmet = jit(jstep, jp, jopt.init(jp), {"tokens": jnp.asarray(tokens)})
    tp = pytree.tree_map(torch.clone, tp)        # the step updates it in place
    tp2, tstate, tmet = tstep(tp, topt.init(tp), {"tokens": torch.from_numpy(tokens)})
    assert sorted(tmet) == sorted(jmet)
    for key in jmet:
        assert _rel(tmet[key], jmet[key]) <= STEP_RTOL, key
    for (path, j), t in zip(_jflat(jp2), pytree.leaves(tp2)):
        assert _rel_l2(t, j) <= STEP_RTOL, path
    for key in ("m", "v"):
        for (path, j), t in zip(_jflat(jstate[key]), pytree.leaves(tstate[key])):
            assert _rel(t, j) <= STEP_RTOL, (key, path)
    assert int(tstate["step"]) == 1
    assert all(not p.requires_grad for p in pytree.leaves(tp2))


def test_grad_accum_refuses_a_batch_it_cannot_divide():
    _, _, tm, tp = models("llama3.2-3b", 17)
    opt = AdamW(AdamWConfig())
    step = make_train_step(tm, opt, grad_accum=3)
    with pytest.raises(ValueError, match="3 micro-batches"):
        step(tp, opt.init(tp), {"tokens": torch.zeros((4, 17), dtype=torch.int32)})


# ------------------------------------------------------------------------ data

@pytest.mark.parametrize("seed", [0, 7])
def test_pipeline_batches_equal_jax(seed):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=seed)
    jpipe, tpipe = JaxPipeline(**kw), SyntheticTokenPipeline(**kw)
    for step in (0, 1, 5, 1000):
        np.testing.assert_array_equal(tpipe.global_batch_at(step), jpipe.global_batch_at(step))
        for n_hosts in (1, 2, 4):
            for host in range(n_hosts):
                a = tpipe.batch_dict(step, host, n_hosts)
                b = jpipe.batch_dict(step, host, n_hosts)
                assert sorted(a) == sorted(b) == ["tokens"]
                assert a["tokens"].dtype == np.int32
                np.testing.assert_array_equal(a["tokens"], b["tokens"])


# --------------------------------------------------------------------- convert

@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_a_jax_opt_state_carries_over_through_params_from_numpy(state_dtype):
    rng = np.random.default_rng(4)
    jopt = JaxAdamW(JaxAdamWConfig(peak_lr=1e-2, warmup=1, state_dtype=state_dtype))
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    _, jstate, _ = jopt.update(jax.tree.map(jnp.asarray, _tree(rng)), jopt.init(jp), jp)
    tstate = params_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    jl = _jflat(jstate)
    tl_ = pytree.flatten_with_paths(tstate)
    assert [p for p, _ in tl_] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl_):
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, path
        assert tuple(t.shape) == j.shape, path
        # bit for bit: the same bytes
        assert t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(j).tobytes(), path
