"""Gradients of the port's custom ops against ``jax.grad`` of the JAX references.

``repro_torch::flash_attention``, ``mlstm``, ``selective_scan`` and
``slstm_scan`` register an autograd formula that recomputes the VJP of the
op's plain version. On the CPU, in float32 at small shapes, each op's input
gradients, for a seeded cotangent on every output, equal the JAX
reference's (``repro.kernels.ref.flash_attention``, ``mlstm_chunked``,
``selective_scan``; the sLSTM as the ``lax.scan`` of
``repro.models.ssm._slstm_cell`` that ``slstm_forward`` runs) on the same
seeded numpy inputs, within a relative error of 1e-4: max |port - JAX| over
max |JAX|, per input.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops

REL_TOL = 1e-4


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() /
                 max(np.abs(want).max(), 1e-30))


def _check(port_fn, jax_fn, inputs, seed):
    """``inputs``: numpy arrays. Differentiate every input of both functions
    under the same seeded cotangents on every output; compare per input."""
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = port_fn(*leaves)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    torch.autograd.backward(list(outs), [torch.from_numpy(c) for c in cots])
    j_outs, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
    for o, jo in zip(outs, j_outs):
        assert tuple(o.shape) == jo.shape
        assert _rel_err(o, jo) <= REL_TOL                      # the forward too
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        assert leaf.grad is not None, i
        err = _rel_err(leaf.grad, w)
        assert err <= REL_TOL, (i, err)


@pytest.mark.parametrize("causal,q_offset,sq,skv", [(True, 0, 24, 24), (True, 8, 16, 24),
                                                     (False, 0, 12, 40)])
def test_flash_attention_gradients_match_jax(causal, q_offset, sq, skv):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    _check(lambda q, k, v: (ops.attention(q, k, v, causal=causal, q_offset=q_offset),),
           lambda q, k, v: (jref.flash_attention(q, k, v, causal=causal, q_offset=q_offset),),
           [q, k, v], seed=1)


@pytest.mark.parametrize("S,with_state", [(12, False), (70, True)])
def test_mlstm_gradients_match_jax(S, with_state):
    rng = np.random.default_rng(2)
    B, H, Dk, Dv = 2, 2, 8, 6
    inputs = [rng.standard_normal((B, S, H, Dk)).astype(np.float32),
              rng.standard_normal((B, S, H, Dk)).astype(np.float32),
              rng.standard_normal((B, S, H, Dv)).astype(np.float32),
              rng.standard_normal((B, S, H)).astype(np.float32),
              (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)]
    if with_state:
        inputs += [0.1 * rng.standard_normal((B, H, Dk, Dv)).astype(np.float32),
                   rng.random((B, H, Dk)).astype(np.float32),
                   rng.standard_normal((B, H)).astype(np.float32)]

    def port(q, k, v, i, f, *state):
        h, (C, n, m) = ops.mlstm(q, k, v, i, f, tuple(state) or None)
        return h, C, n, m

    def ref(q, k, v, i, f, *state):
        h, (C, n, m) = jref.mlstm_chunked(q, k, v, i, f, tuple(state) or None)
        return h, C, n, m

    _check(port, ref, inputs, seed=3)


@pytest.mark.parametrize("S,with_h0", [(9, False), (20, True)])
def test_selective_scan_gradients_match_jax(S, with_h0):
    rng = np.random.default_rng(4)
    B, Di, Ds = 2, 6, 4
    inputs = [rng.standard_normal((B, S, Di)).astype(np.float32),
              (0.1 + 0.4 * rng.random((B, S, Di))).astype(np.float32),
              (0.5 * rng.standard_normal((Di, Ds))).astype(np.float32),
              rng.standard_normal((B, S, Ds)).astype(np.float32),
              rng.standard_normal((B, S, Ds)).astype(np.float32),
              rng.standard_normal((Di,)).astype(np.float32)]
    if with_h0:
        inputs.append(rng.standard_normal((B, Di, Ds)).astype(np.float32))
    _check(lambda *a: ops.selective_scan(*a), lambda *a: jref.selective_scan(*a),
           inputs, seed=5)


def _jax_slstm_scan(gates, r, b_in, c, n, h, m):
    """The JAX package's sLSTM recurrence: ``slstm_forward``'s ``lax.scan``
    of ``_slstm_cell`` over the gate pre-activations."""
    H, dh = r.shape[0], r.shape[1]
    cfg = types.SimpleNamespace(d_model=H * dh, n_heads=H)
    p = {"r": r, "b_in": b_in}

    def step(carry, g_t):
        new = jssm._slstm_cell(cfg, p, g_t, carry)
        return new, new[2]

    state, hs = jax.lax.scan(step, (c, n, h, m), jnp.moveaxis(gates, 1, 0))
    return (jnp.moveaxis(hs, 0, 1), *state)


@pytest.mark.parametrize("S,H,dh", [(7, 2, 4), (16, 4, 3)])
def test_slstm_scan_gradients_match_jax(S, H, dh):
    rng = np.random.default_rng(6)
    B, d = 2, H * dh
    inputs = [rng.standard_normal((B, S, 4 * d)).astype(np.float32),
              (0.3 * rng.standard_normal((H, dh, 4 * dh))).astype(np.float32),
              (0.1 * rng.standard_normal((4 * d,))).astype(np.float32),
              rng.standard_normal((B, d)).astype(np.float32),
              (1.0 + rng.random((B, d))).astype(np.float32),
              rng.standard_normal((B, d)).astype(np.float32),
              rng.standard_normal((B, d)).astype(np.float32)]
    _check(lambda *a: ops.slstm_scan(*a), _jax_slstm_scan, inputs, seed=7)
