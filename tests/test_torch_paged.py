"""The port's paged decode attention and paged decode step vs the JAX package.

* The plain paged version (``repro_torch.kernels.ref``, the CPU route of
  ``ops.paged_decode_attention``) against the Pallas paged kernel in interpret
  mode and against ``repro.kernels.ref``: the cases of
  ``tests/test_paged_kernel.py`` (GQA/MQA, bf16/f32, lengths {0, 1, 8, 9, 17,
  24}, shuffled layouts bit-identical, a NaN null page, length-0 rows exactly
  0). Tolerances are that file's own: f32 2e-5, bf16 2e-2.
* ``Model.decode_paged`` and the admit program against the JAX ones on the
  JAX package's weights (``convert.params_from_numpy``), reduced llama3.2-3b
  in float32: logits and both pools after the write, at atol/rtol 1e-4 (the
  packages sum in different orders).
* The exported admit and step programs keep the pool writes in place.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.deploy import make_admit_fn as jax_admit_fn
from repro.kernels import paged_decode_attention as jpda
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.deploy import make_admit_fn, make_step_fn
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.layers import positional_tables

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
LENGTHS = [0, 1, 8, 9, 17, 24]          # page_size 8, 3 pages: S = 24


def _build_paged(seed, B, max_pages, page_size, Hq, Hkv, D, dtype, *, lengths,
                 null_fill=0.0, shuffle_seed=None, map_dead=True):
    """A logical cache [B, S] scattered into a page pool, as numpy f32 arrays
    (the values already rounded to ``dtype``), for both packages.

    Returns (q, k_cache, v_cache, k_pages, v_pages, table, lengths).
    ``map_dead=False`` leaves table entries past each row's live pages at the
    null page 0, which holds ``null_fill``.
    """
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    S = max_pages * page_size

    def draw(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(x, jdt), np.float32)

    q, k_cache, v_cache = draw((B, Hq, D)), draw((B, S, Hkv, D)), draw((B, S, Hkv, D))
    P = 1 + B * max_pages
    ids = np.arange(1, P)
    if shuffle_seed is not None:
        ids = np.random.RandomState(shuffle_seed).permutation(ids)
    k_pages = np.full((P, page_size, Hkv, D), null_fill, np.float32)
    v_pages = np.full((P, page_size, Hkv, D), null_fill, np.float32)
    table = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        live = max_pages if map_dead else -(-int(lengths[b]) // page_size)
        pages = ids[b * max_pages:b * max_pages + live]
        table[b, :live] = pages
        k_pages[pages] = k_cache[b].reshape(max_pages, page_size, Hkv, D)[:live]
        v_pages[pages] = v_cache[b].reshape(max_pages, page_size, Hkv, D)[:live]
    return q, k_cache, v_cache, k_pages, v_pages, table, np.asarray(lengths, np.int32)


def _to_jax(arrs, dtype):
    jdt = DTYPES[dtype][0]
    return [jnp.asarray(a, jdt if a.dtype == np.float32 else a.dtype) for a in arrs]


def _to_torch(arrs, dtype):
    tdt = DTYPES[dtype][1]
    return [torch.from_numpy(a).to(tdt) if a.dtype == np.float32 else torch.from_numpy(a)
            for a in arrs]


def _plain(q, kp, vp, table, lengths):
    """The port's CPU route (ops -> plain version) on torch inputs."""
    return ops.paged_decode_attention(q, kp, vp, table, lengths)


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (6, 1)], ids=["mha", "gqa4", "mqa6"])
def test_plain_paged_matches_pallas_ref_and_contiguous(Hq, Hkv, dtype):
    arrs = _build_paged(1, len(LENGTHS), 3, 8, Hq, Hkv, 16, dtype, lengths=LENGTHS,
                        shuffle_seed=7)
    q, kc, vc, kp, vp, table, ln = arrs
    jq, jkp, jvp, jtable, jln = _to_jax([q, kp, vp, table, ln], dtype)
    tq, tkc, tvc, tkp, tvp, ttable, tln = _to_torch(arrs, dtype)
    got = _plain(tq, tkp, tvp, ttable, tln)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    for want in (jpda.paged_decode_attention(jq, jkp, jvp, jtable, jln, interpret=True),
                 jref.paged_decode_attention(jq, jkp, jvp, jtable, jln)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    # the port's own contiguous plain version on the cache the pages came from
    dense = tref.decode_attention(tq, tkc, tvc, tln)
    np.testing.assert_allclose(got.float().numpy(), dense.float().numpy(), atol=tol, rtol=tol)


def test_page_assignment_is_invisible():
    """The same logical cache under two page layouts: bit-identical output."""
    outs = []
    for seed in (None, 11):
        q, _, _, kp, vp, table, ln = _to_torch(_build_paged(
            2, 4, 4, 4, 4, 2, 8, "float32", lengths=[0, 5, 8, 16], shuffle_seed=seed),
            "float32")
        outs.append(_plain(q, kp, vp, table, ln))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_in_null_and_unmapped_pages_never_leaks(dtype):
    """NaN in the null page (and so in every unmapped table entry) and the
    Pallas kernel on a zero-filled pool agree; the JAX reference itself is not
    NaN-proof, which is why the port zeroes V under the mask (ROADMAP Queue C)."""
    lengths = [0, 3, 9, 16]
    build = lambda fill: _build_paged(3, 4, 4, 4, 4, 2, 8, dtype, lengths=lengths,
                                      null_fill=fill, map_dead=False)
    nan_arrs, zero_arrs = build(np.nan), build(0.0)
    q, _, _, kp, vp, table, ln = _to_torch(nan_arrs, dtype)
    got = _plain(q, kp, vp, table, ln)
    jq, jkp, jvp, jtable, jln = _to_jax([zero_arrs[i] for i in (0, 3, 4, 5, 6)], dtype)
    want = jpda.paged_decode_attention(jq, jkp, jvp, jtable, jln, interpret=True)
    assert bool(torch.isfinite(got).all())
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_length_zero_rows_emit_exact_zero():
    arrs = _build_paged(4, 3, 2, 8, 4, 2, 8, "float32", lengths=[0, 0, 16], shuffle_seed=5)
    q, _, _, kp, vp, table, ln = _to_torch(arrs, "float32")
    out = _plain(q, kp, vp, table, ln)
    assert bool(torch.isfinite(out).all())
    assert bool((out[:2] == 0).all()) and out[2].abs().sum() > 0


def test_scalar_length_broadcasts():
    q, _, _, kp, vp, table, _ = _to_torch(
        _build_paged(5, 2, 3, 4, 4, 2, 8, "float32", lengths=[7, 7]), "float32")
    assert torch.equal(_plain(q, kp, vp, table, 7),
                       _plain(q, kp, vp, table, torch.tensor([7, 7], dtype=torch.int32)))


# the CUDA kernels' split order (ref.*_splits): chunks of ref.DECODE_CHUNK
# logical keys, so a cache of 9 pages of 16 spans three splits
SPLIT_LENGTHS = [0, 1, tref.DECODE_CHUNK - 1, tref.DECODE_CHUNK, tref.DECODE_CHUNK + 1, 144]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (10, 2), (12, 2), (7, 1)],
                         ids=["mha", "g5", "g6", "mqa7"])
def test_split_order_through_shuffled_tables_equals_contiguous_exactly(Hq, Hkv, dtype):
    """The plain version in the kernels' split order gives the same bits
    through a shuffled page table (NaN in the null page behind every unmapped
    entry) as on the contiguous cache the pages came from, and the Pallas
    paged kernel's values within its tolerance."""
    build = lambda **kw: _build_paged(9, len(SPLIT_LENGTHS), 9, 16, Hq, Hkv, 16, dtype,
                                      lengths=SPLIT_LENGTHS, **kw)
    arrs = build(null_fill=np.nan, shuffle_seed=3, map_dead=False)
    tq, tkc, tvc, tkp, tvp, ttable, tln = _to_torch(arrs, dtype)
    got = tref.paged_decode_attention_splits(tq, tkp, tvp, ttable, tln)
    assert torch.equal(got, tref.decode_attention_splits(tq, tkc, tvc, tln))
    _, _, _, kp2, vp2, table2, _ = _to_torch(build(shuffle_seed=11), dtype)
    assert torch.equal(got, tref.paged_decode_attention_splits(tq, kp2, vp2, table2, tln))
    assert bool(torch.isfinite(got).all()) and bool((got[0] == 0).all())
    zero = build(null_fill=0.0, shuffle_seed=3, map_dead=False)
    jq, jkp, jvp, jtable, jln = _to_jax([zero[i] for i in (0, 3, 4, 5, 6)], dtype)
    want = jpda.paged_decode_attention(jq, jkp, jvp, jtable, jln, interpret=True)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    q, _, _, kp, vp, table, ln = _to_torch(
        _build_paged(6, 2, 2, 4, 4, 2, 32, "bfloat16", lengths=[3, 8]), "bfloat16")
    tpda.LAUNCHES.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpda.paged_decode_attention(q, kp, vp, table, ln)
    with ops.impl_scope("kernel"), pytest.raises(RuntimeError, match="CUDA"):
        ops.paged_decode_attention(q, kp, vp, table, ln)
    assert tpda.LAUNCHES.count == 0


# ------------------------------------------------------------------ the model

PAGE, MAX_PAGES, N_PAGES, SLOTS, PROMPT = 8, 3, 1 + 3 * 3, 3, 16


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    cap = PAGE * MAX_PAGES
    jm, tm = jax_build(jcfg, cap), build_model(tcfg, cap)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def admitted(models):
    """Two requests admitted into one pool by both packages' admit programs:
    row 0 into pages [4, 2] (+ null), row 1 into [7, 1, 9]."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 512, (2, 1, PROMPT), dtype=np.int32)
    ids = np.array([[4, 2, 0], [7, 1, 9]], np.int32)
    jadmit = jax.jit(jax_admit_fn(jm, MAX_PAGES, PAGE))
    tadmit = make_admit_fn(tm, MAX_PAGES, PAGE)
    jpool = jm.init_page_pool(N_PAGES, PAGE)
    jk, jv = jpool["k_pages"], jpool["v_pages"]
    tpool = tm.init_page_pool(N_PAGES, PAGE, "cpu")
    tk, tv = tpool["k_pages"], tpool["v_pages"]
    out = []
    for r in range(2):
        jl, jk, jv = jadmit(jp, jnp.asarray(prompts[r]), jk, jv, jnp.asarray(ids[r]))
        with torch.inference_mode():
            tl, tk2, tv2 = tadmit(tp, torch.from_numpy(prompts[r]), tk, tv,
                                  torch.from_numpy(ids[r]))
        assert tk2 is tk and tv2 is tv                       # written in place
        out.append((jl, tl))
    return prompts, ids, out, (jk, jv), (tk, tv)


def test_admit_program_logits_and_pools_match_jax(admitted):
    _, _, logits, (jk, jv), (tk, tv) = admitted
    for jl, tl in logits:
        assert tuple(tl.shape) == jl.shape
        _close(jl, tl)
    # page 0 takes rows past row 0's reservation from both packages in one
    # order here; every page is compared
    _close(jk, tk)
    _close(jv, tv)
    assert float(tk[:, 3].abs().sum()) == 0.0                   # no chain owns page 3


def test_decode_paged_logits_and_pools_match_jax(models, admitted):
    jm, jp, tm, tp = models
    prompts, ids, _, (jk, jv), (tk, tv) = admitted
    table = np.zeros((SLOTS, MAX_PAGES), np.int32)
    table[0], table[2] = ids[0], ids[1]                      # slot 1 is empty
    pos = np.array([PROMPT, 0, PROMPT], np.int32)
    tok = np.array([[5], [0], [77]], np.int32)
    tk, tv = tk.clone(), tv.clone()
    for step in range(3):                                     # crosses into a new page
        jl, jk, jv = jax.jit(jm.decode_paged)(jp, jk, jv, jnp.asarray(table),
                                               jnp.asarray(pos), jnp.asarray(tok))
        with torch.inference_mode():
            tl, tk2, tv2 = tm.decode_paged(tp, tk, tv, torch.from_numpy(table),
                                           torch.from_numpy(pos), torch.from_numpy(tok))
        assert tk2 is tk and tv2 is tv
        for r in (0, 2):                                      # live rows
            _close(jl[r], tl[r])
        # the empty slot writes to the null page 0 (in both packages); every
        # other page must match
        _close(jk[:, 1:], tk[:, 1:])
        _close(jv[:, 1:], tv[:, 1:])
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0, 1], np.int32)


def test_attention_decode_paged_writes_its_row_in_place(models):
    _, _, tm, tp = models
    cfg = tm.cfg
    L0 = {k: v[0] for k, v in tp["stack"]["layers"]["attn"].items()}
    kp = torch.zeros(N_PAGES, PAGE, cfg.n_kv_heads, cfg.resolved_head_dim)
    vp = torch.zeros_like(kp)
    table = torch.tensor([[3, 5, 0], [0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([9, 0], dtype=torch.int32)
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    rope = positional_tables(cfg, tattn.decode_positions(2, pos, pos.device))
    y, k2, v2 = tattn.attention_decode_paged(cfg, L0, x, kp, vp, table, pos, rope)
    assert k2 is kp and v2 is vp and tuple(y.shape) == (2, 1, cfg.d_model)
    written = (kp.abs().sum(dim=(2, 3)) > 0).nonzero().tolist()
    assert written == [[0, 0], [5, 1]]                        # null page 0 @0, page 5 @1


def test_exported_programs_write_the_pools_in_place(models):
    _, _, tm, tp = models
    admit, step = make_admit_fn(tm, MAX_PAGES, PAGE), make_step_fn(tm)
    pools = tm.init_page_pool(N_PAGES, PAGE, "cpu")
    kp, vp = pools["k_pages"], pools["v_pages"]
    ids = torch.arange(1, MAX_PAGES + 1, dtype=torch.int32)
    ax = torch.export.export(admit, (tp, torch.zeros(1, PROMPT, dtype=torch.int32), kp, vp,
                                     ids))
    sx = torch.export.export(step, (tp, kp, vp, torch.zeros(SLOTS, MAX_PAGES,
                                                              dtype=torch.int32),
                                    torch.zeros(SLOTS, dtype=torch.int32),
                                    torch.zeros(SLOTS, 1, dtype=torch.int32)))
    L = tm.cfg.n_layers
    for x, n_put, op in ((ax, 2, "flash_attention"), (sx, 2 * L, "paged_decode_attention")):
        targets = [str(n.target) for n in x.graph.nodes if n.op == "call_function"]
        assert not any("scatter" in t for t in targets)           # no functional pool copy
        assert not any(t.startswith("aten.index_put.") for t in targets)
        assert targets.count("aten.index_put_.default") == n_put
        assert targets.count(f"repro_torch.{op}.default") == L
    assert not any("decode_attention.default" in str(n.target) and "paged" not in
                   str(n.target) for n in sx.graph.nodes)


def test_paged_decode_is_uniform_stack_only(models):
    from repro_torch.models.transformer import stack_page_pool_specs
    encdec = dataclasses.replace(models[2].cfg, enc_dec=True)
    with pytest.raises(ValueError, match="uniform stack only"):
        stack_page_pool_specs(encdec, N_PAGES, PAGE)
