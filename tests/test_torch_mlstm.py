"""The port's mLSTM plain versions and its ``repro_torch::mlstm`` op vs the JAX package.

Inputs are made from a seed with numpy and handed to both packages. The JAX
side is the Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it (``mlstm(..., chunk=16, interpret=True)``), and the references
``repro.kernels.ref.mlstm_chunked`` / ``mlstm_step`` / ``mlstm_recurrent``.
The port's CUDA kernel does not run here (no card); on the CPU
``repro_torch.kernels.ops.mlstm`` routes to ``ref.mlstm_chunked``.
Tolerances (absolute): f32 1e-4; bf16 0.2, ten times the bf16 tolerance of
``tests/test_kernels.py``, as it holds the Pallas mlstm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mlstm import mlstm as pallas_mlstm
from repro_torch.kernels import mlstm as mk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# tests/test_kernels.py's MLSTM_CASES, plus an S that pads (100 -> 128 at chunk 64)
CASES = [(2, 96, 2, 32, 64), (1, 50, 4, 16, 16), (2, 64, 1, 64, 128), (2, 100, 2, 32, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 10 * 2e-2)}


def _inputs(seed, B, S, H, Dk, Dv, *, f_shift=1.0, i_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    i = (i_scale * rng.standard_normal((B, S, H))).astype(np.float32)
    f = (rng.standard_normal((B, S, H)) + f_shift).astype(np.float32)
    return q, k, v, i, f


def _to_jax(arrays, dtype):
    jdt = DTYPES[dtype][0]
    q, k, v, i, f = arrays
    return (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(i), jnp.asarray(f))


def _to_torch(arrays, dtype):
    tdt = DTYPES[dtype][1]
    q, k, v, i, f = (torch.from_numpy(a) for a in arrays)
    return q.to(tdt), k.to(tdt), v.to(tdt), i, f


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_plain_vs_pallas_and_ref(case, dtype):
    arrays = _inputs(sum(case), *case)
    tol = DTYPES[dtype][2]
    h, state = ops.mlstm(*_to_torch(arrays, dtype))
    B, S, H, Dk = case[:4]
    assert h.dtype == DTYPES[dtype][1] and tuple(h.shape) == (B, S, H, case[4])
    assert [tuple(t.shape) for t in state] == [(B, H, Dk, case[4]), (B, H, Dk), (B, H)]
    assert all(t.dtype == torch.float32 for t in state)
    for jh, jstate in (pallas_mlstm(*_to_jax(arrays, dtype), chunk=16, interpret=True),
                       jref.mlstm_chunked(*_to_jax(arrays, dtype))):
        _close(jh, h, tol)
        for a, b in zip(jstate, state):
            _close(a, b, tol)


def test_mlstm_chunked_vs_recurrent_oracles():
    arrays = _inputs(29, 2, 29, 2, 8, 12)
    tq = _to_torch(arrays, "float32")
    jq = _to_jax(arrays, "float32")
    h_chunk, st_chunk = tref.mlstm_chunked(*tq, block=8)
    h_rec, st_rec = tref.mlstm_recurrent(*tq)
    jh_rec, jst_rec = jref.mlstm_recurrent(*jq)
    _close(jh_rec, h_rec, 1e-4)
    _close(jh_rec, h_chunk, 1e-4)
    for a, b, c in zip(jst_rec, st_rec, st_chunk):
        _close(a, b, 1e-4)
        _close(a, c, 1e-4)


def test_mlstm_step_vs_jax():
    rng = np.random.default_rng(3)
    B, H, Dk, Dv = 2, 3, 16, 24
    q, k = (rng.standard_normal((B, H, Dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, Dv)).astype(np.float32)
    i, f = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    C = rng.standard_normal((B, H, Dk, Dv)).astype(np.float32)
    n = rng.standard_normal((B, H, Dk)).astype(np.float32)
    m = rng.standard_normal((B, H)).astype(np.float32)
    jh, jst = jref.mlstm_step(*(jnp.asarray(a) for a in (q, k, v, i, f)),
                              tuple(jnp.asarray(a) for a in (C, n, m)))
    th, tst = tref.mlstm_step(*(torch.from_numpy(a) for a in (q, k, v, i, f)),
                              tuple(torch.from_numpy(a) for a in (C, n, m)))
    _close(jh, th, 1e-5)
    for a, b in zip(jst, tst):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("split", [32, 50, 1])
def test_state_continuation_equals_one_long_pass(split):
    """A second call that starts from the first call's state gives the one
    long pass's outputs and final state; with that state the JAX reference
    agrees."""
    arrays = _inputs(11, 1, 100, 2, 16, 32, f_shift=3.0)
    tq = _to_torch(arrays, "float32")
    h_full, st_full = ops.mlstm(*tq)
    first = [t[:, :split] for t in tq]
    second = [t[:, split:] for t in tq]
    h1, st = ops.mlstm(*first)
    h2, st2 = ops.mlstm(*second, state=st)
    _close(h_full.numpy(), torch.cat([h1, h2], dim=1), 1e-4)
    for a, b in zip(st_full, st2):
        _close(a.numpy(), b, 1e-4)
    jh2, jst2 = jref.mlstm_chunked(*(jnp.asarray(t.numpy()) for t in second),
                                   state=tuple(jnp.asarray(t.numpy()) for t in st))
    _close(jh2, h2, 1e-4)
    for a, b in zip(jst2, st2):
        _close(a, b, 1e-4)


def test_short_sequences_and_large_gates_match_jax():
    """S shorter than a chunk (S = 1, S = 7) and input gates of +-60 (the
    stabiliser keeps every exponent finite)."""
    for S, i_scale in ((1, 1.0), (7, 1.0), (70, 30.0)):
        arrays = _inputs(S, 2, S, 2, 32, 64, f_shift=3.0, i_scale=i_scale)
        h, state = ops.mlstm(*_to_torch(arrays, "float32"))
        assert torch.isfinite(h).all() and all(torch.isfinite(t).all() for t in state)
        jh, jstate = jref.mlstm_chunked(*_to_jax(arrays, "float32"))
        scale = max(1.0, float(np.abs(np.asarray(jh)).max()))
        np.testing.assert_allclose(h.numpy() / scale, np.asarray(jh) / scale, atol=1e-4)
        for a, b in zip(jstate, state):
            _close(a, b, 1e-4)


class _MlstmModule(torch.nn.Module):
    def forward(self, q, k, v, i, f, C, n, m):
        h, fresh = ops.mlstm(q, k, v, i, f)
        h2, carried = ops.mlstm(q, k, v, i, f, state=(C, n, m))
        return h, fresh, h2, carried


def test_mlstm_op_exports_as_one_node_with_fake_shapes():
    B, S, H, Dk, Dv = 1, 20, 2, 32, 64
    arrays = _inputs(5, B, S, H, Dk, Dv)
    q, k, v, i, f = _to_torch(arrays, "bfloat16")
    _, (C, n, m) = ops.mlstm(q, k, v, i, f)
    args = (q, k, v, i, f, C, n, m)
    exported = torch.export.export(_MlstmModule(), args)
    nodes = [nd for nd in exported.graph.nodes
             if nd.op == "call_function" and str(nd.target) == "repro_torch.mlstm.default"]
    assert len(nodes) == 2
    for nd in nodes:
        h, C2, n2, m2 = nd.meta["val"]
        assert (tuple(h.shape), h.dtype) == ((B, S, H, Dv), torch.bfloat16)
        assert [(tuple(t.shape), t.dtype) for t in (C2, n2, m2)] == [
            ((B, H, Dk, Dv), torch.float32), ((B, H, Dk), torch.float32),
            ((B, H), torch.float32)]
    got = exported.module()(*args)
    want = _MlstmModule()(*args)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


def test_cpu_routing_takes_the_plain_version_and_kernel_impl_raises():
    arrays = _inputs(2, 1, 9, 2, 32, 64)
    tq = _to_torch(arrays, "float32")
    want_h, want_state = tref.mlstm_chunked(*tq)
    ops.reset_launch_counts()
    for impl in ("auto", "plain"):
        with ops.impl_scope(impl):
            h, state = ops.mlstm(*tq)
        assert torch.equal(h, want_h)
        assert all(torch.equal(a, b) for a, b in zip(state, want_state))
    assert ops.launch_counts()["mlstm"] == 0
    with ops.impl_scope("kernel"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.mlstm(*tq)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.mlstm(*tq)
    assert mk.LAUNCHES.count == 0
    assert mk.mlstm_plain is tref.mlstm_chunked


# --------------------------------------------- the bf16 kernel's operand rounding

def _hi_lo(x):
    """x (f32) as bf16 hi + lo, each widened back to f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16_operand(x, split):
    """The bf16 tensor-core operand(s) of an f32 value: hi and lo, or one rounding."""
    return _hi_lo(x) if split else (x.to(torch.bfloat16).float(),)


def _mlstm_tensor_core_emulation(q, k, v, i_raw, f_raw, state=None, *, split_kw=True):
    """The arithmetic of ``csrc/mlstm.cu``'s bf16 kernel in f32 torch on the
    CPU: q, k, v are bf16 and exact as operands; every product accumulates in
    f32; the 1/sqrt(Dk) scale is applied after q k^T and q C; the f32 operands
    (C in q C, k wk in the carry, D * s in the output product) are split into
    bf16 hi + lo and go through one product each. ``split_kw=False`` rounds
    k wk to bf16 once instead. Returns (h in f32, (C, n, m))."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    c = 64
    pad = (-S) % c
    qp, kp, vp = (tref._pad_steps(t.float(), pad) for t in (q, k, v))
    ip = tref._pad_steps(i_raw.float(), pad, tref.NEG_INF)
    fp = tref._pad_steps(f_raw.float(), pad, 60.0)
    scale = tref._scale(Dk)
    if state is None:
        C = torch.zeros(B, H, Dk, Dv)
        n = torch.zeros(B, H, Dk)
        m = torch.full((B, H), tref.NEG_INF)
    else:
        C, n, m = (t.float() for t in state)
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool))
    hs = []
    for t0 in range(0, S + pad, c):
        qb, kb, vb = (t[:, t0:t0 + c].transpose(1, 2) for t in (qp, kp, vp))  # [B,H,c,*]
        F = torch.cumsum(torch.nn.functional.logsigmoid(fp[:, t0:t0 + c]), dim=1).transpose(1, 2)
        logi = ip[:, t0:t0 + c].transpose(1, 2)                                # [B,H,c]
        gmax = torch.cummax(logi - F, dim=-1).values
        m_i = F + torch.maximum(m[..., None], gmax)
        w_in = torch.exp(F + m[..., None] - m_i)
        s = (qb @ kb.transpose(-1, -2)) * scale
        d = F[..., :, None] - F[..., None, :] + logi[..., None, :] - m_i[..., :, None]
        w = torch.where(causal, s * torch.exp(torch.where(causal, d, 0.0)), 0.0)
        inter = sum(qb @ part for part in _hi_lo(C)) * scale * w_in[..., None]
        intra = sum(part @ vb for part in _hi_lo(w))
        qn = (qb @ n[..., None])[..., 0] * scale
        den = torch.maximum(torch.abs(w_in * qn + w.sum(-1)), torch.exp(-m_i))
        hs.append(((inter + intra) / den[..., None]).transpose(1, 2))
        m_new = F[..., -1] + torch.maximum(m, gmax[..., -1])
        w_old = torch.exp(F[..., -1] + m - m_new)
        kw = kb * torch.exp(F[..., -1:] - F + logi - m_new[..., None])[..., None]
        C = C * w_old[..., None, None] + sum(part.transpose(-1, -2) @ vb
                                             for part in _bf16_operand(kw, split_kw))
        n = n * w_old[..., None] + kw.sum(-2)
        m = m_new
    return torch.cat(hs, dim=1)[:, :S], (C, n, m)


def _scaled_err(got, want):
    """max |got - want| / max(1, max |want|), as chip_smoke.py holds the kernel."""
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1.0)).item()


# B, S, H, Dk, Dv, split: xlstm-1.3b's head dims, then the reduced dims; with
# ``split`` the second part starts from the state the first part returned
EMULATION_CASES = [(1, 128, 1, 512, 1024, 0), (1, 512, 2, 512, 1024, 0),
                   (1, 200, 1, 512, 1024, 129), (2, 130, 4, 32, 64, 0),
                   (2, 150, 2, 32, 64, 65)]


@pytest.mark.parametrize("case", EMULATION_CASES)
def test_tensor_core_rounding_meets_the_kernel_tolerances(case):
    """The bf16 kernel's operand rounding (bf16 inputs exact, f32 operands
    split hi + lo, f32 accumulate) keeps h within 2e-2 and (C, n, m) within
    1e-4 of ``ref.mlstm_chunked``, scaled as chip_smoke.py's gate scales them."""
    B, S, H, Dk, Dv, split = case
    q, k, v, i, f = _to_torch(_inputs(S + Dk, B, S, H, Dk, Dv, f_shift=3.0), "bfloat16")
    want_h, want_state = tref.mlstm_chunked(q, k, v, i, f)
    if split:
        h1, st = _mlstm_tensor_core_emulation(q[:, :split], k[:, :split], v[:, :split],
                                              i[:, :split], f[:, :split])
        h2, state = _mlstm_tensor_core_emulation(q[:, split:], k[:, split:], v[:, split:],
                                                 i[:, split:], f[:, split:], st)
        h = torch.cat([h1, h2], dim=1)
    else:
        h, state = _mlstm_tensor_core_emulation(q, k, v, i, f)
    assert _scaled_err(h.to(torch.bfloat16), want_h) <= 2e-2
    for got, want in zip(state, want_state):
        assert _scaled_err(got, want) <= 1e-4


@pytest.mark.parametrize("S", [384, 512])
def test_one_bf16_rounding_of_k_wk_misses_the_state_tolerance(S):
    """Why the kernel splits k wk: rounded once to bf16, the carried C drifts
    past the 1e-4 state tolerance at xlstm-1.3b's head dims, where the split
    stays well inside it."""
    q, k, v, i, f = _to_torch(_inputs(S, 1, S, 2, 512, 1024, f_shift=3.0), "bfloat16")
    _, (want_C, _, _) = tref.mlstm_chunked(q, k, v, i, f)
    _, (C_once, _, _) = _mlstm_tensor_core_emulation(q, k, v, i, f, split_kw=False)
    _, (C_split, _, _) = _mlstm_tensor_core_emulation(q, k, v, i, f)
    assert _scaled_err(C_once, want_C) > 1e-4
    assert _scaled_err(C_split, want_C) < 1e-4 / 4
