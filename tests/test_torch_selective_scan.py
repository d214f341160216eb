"""The port's selective-scan plain versions and its ``repro_torch::selective_scan``
and ``repro_torch::mamba_step`` ops vs the JAX package.

Inputs are made from a seed with numpy and handed to both packages. The JAX
side is the Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it (``selective_scan(..., block_di=min(Di, 64), chunk=16,
interpret=True)``), and the references ``repro.kernels.ref.selective_scan``
/ ``mamba_step``. The port's CUDA kernel does not run here (no card); on the
CPU ``repro_torch.kernels.ops.selective_scan`` routes to
``ref.selective_scan``. Tolerances: f32 atol and rtol 1e-4 (the JAX
reference takes an associative scan over chunks, the port's loop the
recurrence in order); bf16 outputs atol 0.2, ten times the bf16 tolerance
of ``tests/test_kernels.py``, as it holds the Pallas scan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as ss

ATOL = RTOL = 1e-4
BF16_ATOL = 10 * 2e-2
# tests/test_kernels.py's SCAN_CASES, plus S = 1 and a ragged S with Ds 16
CASES = [(2, 96, 64, 16), (1, 33, 128, 8), (2, 128, 256, 4), (2, 1, 64, 16), (1, 21, 64, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, Di, Ds, *, dt_scale=1.0):
    """x, dt, a_log, b, c, d_skip, h0 as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, Di)))) * dt_scale).astype(np.float32)
    a_log = (0.5 * rng.standard_normal((Di, Ds))).astype(np.float32)
    b = rng.standard_normal((B, S, Ds)).astype(np.float32)
    c = rng.standard_normal((B, S, Ds)).astype(np.float32)
    d_skip = rng.standard_normal((Di,)).astype(np.float32)
    h0 = rng.standard_normal((B, Di, Ds)).astype(np.float32)
    return x, dt, a_log, b, c, d_skip, h0


def _cast(arrays, dtype):
    """x, dt, b, c in ``dtype``; a_log, d_skip, h0 f32 (the JAX tests' types)."""
    jdt, tdt = DTYPES[dtype]
    x, dt, a_log, b, c, d_skip, h0 = arrays
    j = tuple(jnp.asarray(a, jdt) for a in (x, dt)) + (jnp.asarray(a_log),) + \
        tuple(jnp.asarray(a, jdt) for a in (b, c)) + (jnp.asarray(d_skip), jnp.asarray(h0))
    t = tuple(torch.from_numpy(a).to(tdt) for a in (x, dt)) + (torch.from_numpy(a_log),) + \
        tuple(torch.from_numpy(a).to(tdt) for a in (b, c)) + \
        (torch.from_numpy(d_skip), torch.from_numpy(h0))
    return j, t


def _close(jax_out, torch_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_plain_vs_pallas_interpret_and_ref(case, dtype, with_h0):
    (jx, jdt, ja, jb, jc, jd, jh0), targs = _cast(_inputs(sum(case), *case), dtype)
    *tin, th0 = targs
    y, h = ops.selective_scan(*tin, h0=th0 if with_h0 else None)
    B, S, Di, Ds = case
    assert y.dtype == DTYPES[dtype][1] and tuple(y.shape) == (B, S, Di)
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, Di, Ds)
    h0 = jh0 if with_h0 else None
    atol = ATOL if dtype == "float32" else BF16_ATOL
    for jy, jh in (pallas_scan(jx, jdt, ja, jb, jc, jd, h0=h0, block_di=min(Di, 64),
                               chunk=16, interpret=True),
                   jref.selective_scan(jx, jdt, ja, jb, jc, jd, h0=h0)):
        _close(jy, y, atol=atol)
        _close(jh, h, atol=atol)


def test_mamba_step_vs_jax_and_scan_is_its_loop():
    arrays = _inputs(3, 2, 19, 8, 4)
    (jx, jdt, ja, jb, jc, jd, jh0), (x, dt, a, b, c, d, h0) = _cast(arrays, "float32")
    jy, jh = jref.mamba_step(jx[:, 0], jdt[:, 0], ja, jb[:, 0], jc[:, 0], jd, jh0)
    ty, th = tref.mamba_step(x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], d, h0)
    _close(jy, ty)
    _close(jh, th)
    y, hf = tref.selective_scan(x, dt, a, b, c, d, h0=h0)
    h = h0
    for t in range(x.shape[1]):
        yt, h = tref.mamba_step(x[:, t], dt[:, t], a, b[:, t], c[:, t], d, h)
        assert torch.equal(y[:, t], yt)
    assert torch.equal(hf, h)


@pytest.mark.parametrize("split", [1, 40, 99])
def test_state_continuation_equals_one_long_pass(split):
    """A second call from the first call's final state gives the long pass's
    outputs and state, and the JAX reference agrees from that state."""
    _, (x, dt, a, b, c, d, _) = _cast(_inputs(7, 2, 100, 32, 16), "float32")
    y_full, h_full = ops.selective_scan(x, dt, a, b, c, d)
    first = [t[:, :split] for t in (x, dt)] + [a] + [t[:, :split] for t in (b, c)] + [d]
    second = [t[:, split:] for t in (x, dt)] + [a] + [t[:, split:] for t in (b, c)] + [d]
    y1, h1 = ops.selective_scan(*first)
    y2, h2 = ops.selective_scan(*second, h0=h1)
    _close(y_full.numpy(), torch.cat([y1, y2], dim=1))
    _close(h_full.numpy(), h2)
    jy2, jh2 = jref.selective_scan(*(jnp.asarray(t.numpy()) for t in second),
                                   h0=jnp.asarray(h1.numpy()))
    _close(jy2, y2)
    _close(jh2, h2)


def test_decay_underflow_to_zero_matches_jax():
    """dt large enough that exp(dt * A) is 0: the state is the last input
    alone, finite, in both packages."""
    arrays = _inputs(9, 2, 40, 64, 16, dt_scale=1e4)
    (jx, jdt, ja, jb, jc, jd, _), (x, dt, a, b, c, d, _) = _cast(arrays, "float32")
    y, h = ops.selective_scan(x, dt, a, b, c, d)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want_h = (dt[:, -1] * x[:, -1])[..., None] * b[:, -1, None, :]
    _close(want_h.numpy(), h)
    jy, jh = jref.selective_scan(jx, jdt, ja, jb, jc, jd)
    scale = float(np.abs(np.asarray(jy)).max())
    _close(np.asarray(jy) / scale, y / scale)
    _close(np.asarray(jh) / scale, h / scale)


def test_cpu_routing_takes_the_plain_version_and_kernel_impl_raises():
    _, (x, dt, a, b, c, d, h0) = _cast(_inputs(2, 1, 9, 16, 8), "bfloat16")
    want_y, want_h = tref.selective_scan(x, dt, a, b, c, d, h0=h0)
    ops.reset_launch_counts()
    for impl in ("auto", "plain"):
        with ops.impl_scope(impl):
            y, h = ops.selective_scan(x, dt, a, b, c, d, h0=h0)
        assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ops.launch_counts()["selective_scan"] == 0
    with ops.impl_scope("kernel"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.selective_scan(x, dt, a, b, c, d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.selective_scan(x, dt, a, b, c, d)
    assert ss.LAUNCHES.count == 0
    assert ss.selective_scan_plain is tref.selective_scan


class _ScanModule(torch.nn.Module):
    def forward(self, x, dt, a, b, c, d, h0, x_t, dt_t, b_t, c_t, h):
        y, fresh = ops.selective_scan(x, dt, a, b, c, d)
        y2, carried = ops.selective_scan(x, dt, a, b, c, d, h0=h0)
        y_t = ops.mamba_step(x_t, dt_t, a, b_t, c_t, d, h)
        return y, fresh, y2, carried, y_t, h


def test_ops_export_as_one_node_each_with_fake_shapes():
    """One ``selective_scan`` node per call, with the fake implementation's
    shapes and dtypes; one ``mamba_step`` node that updates its state in
    place, also in the loaded program."""
    B, S, Di, Ds = 2, 12, 16, 8
    _, (x, dt, a, b, c, d, h0) = _cast(_inputs(5, B, S, Di, Ds), "bfloat16")
    dt = dt.float()
    step_in = (x[:, 0], dt[:, 0], b[:, 0], c[:, 0])
    exported = torch.export.export(_ScanModule(), (x, dt, a, b, c, d, h0, *step_in,
                                                   h0.clone()))
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("repro_torch.selective_scan.default") == 2
    assert targets.count("repro_torch.mamba_step.default") == 1
    for nd in exported.graph.nodes:
        if str(nd.target) == "repro_torch.selective_scan.default":
            y, h = nd.meta["val"]
            assert (tuple(y.shape), y.dtype) == ((B, S, Di), torch.bfloat16)
            assert (tuple(h.shape), h.dtype) == ((B, Di, Ds), torch.float32)
    h_a, h_b = h0.clone(), h0.clone()
    got = exported.module()(x, dt, a, b, c, d, h0, *step_in, h_a)
    want = _ScanModule()(x, dt, a, b, c, d, h0, *step_in, h_b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, want_h = tref.mamba_step(x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], d, h0)
    assert torch.equal(h_a, want_h) and torch.equal(h_b, want_h)   # updated in place
    assert ops.launch_counts()["selective_scan"] == 0
