"""The port's attention kernels' plain versions vs the JAX package.

Inputs are made from a seed with numpy and handed to both packages. The JAX
side is the Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs
it) and the chunked reference ``repro.kernels.ref``. The port's CUDA kernels
do not run here (no card); on the CPU ``repro_torch.kernels.ops`` routes to
these plain versions. Tolerances are the JAX tests' own: f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    """The same values in both packages (bf16 rounded from the same f32)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(jax_out, torch_out, atol):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=atol, rtol=0)


# ------------------------------------------------------------- flash attention

FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, q_offset — test_kernels.py's cases ...
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 64, 8, 8, 32, True, 0),
    (2, 64, 192, 4, 1, 128, True, 128),
    (1, 128, 128, 2, 2, 64, False, 0),
    (1, 96, 96, 6, 3, 64, True, 0),
    # ... plus ragged lengths
    (2, 37, 37, 6, 2, 32, True, 0),
    (1, 45, 77, 4, 2, 32, True, 32),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas_and_ref(case, dtype):
    B, Sq, Skv, Hq, Hkv, D, causal, qoff = case
    rng = np.random.default_rng(hash(case) % 2**32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    got = ops.attention(tq, tk, tv, causal=causal, q_offset=qoff)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    _close(pallas_flash(jq, jk, jv, causal=causal, q_offset=qoff, interpret=True), got, tol)
    _close(jref.flash_attention(jq, jk, jv, causal=causal, q_offset=qoff), got, tol)


def test_flash_plain_lse_and_small_blocks_vs_jax():
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "float32") for s in
                                    ((2, 37, 8, 16), (2, 37, 2, 16), (2, 37, 2, 16)))
    jo, jl = jref.flash_attention(jq, jk, jv, block_q=16, block_kv=8, return_lse=True)
    to, tl = tref.flash_attention(tq, tk, tv, block_q=16, block_kv=8, return_lse=True)
    _close(jo, to, 2e-5)
    _close(jl, tl, 2e-5)
    _close(jref.naive_attention(jq, jk, jv), tref.naive_attention(tq, tk, tv), 2e-5)


def test_flash_fully_masked_rows_are_zero():
    """A negative q_offset leaves the first rows no visible key: output 0."""
    rng = np.random.default_rng(3)
    (_, tq), (_, tk), (_, tv) = (_pair(rng, s, "float32") for s in
                                 ((1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    out = ops.attention(tq, tk, tv, causal=True, q_offset=-4)
    assert torch.all(out[:, :4] == 0)
    assert torch.isfinite(out).all()


# ------------------------------------------------------------ decode attention

DECODE_CASES = [
    # B, S, Hq, Hkv, D — test_kernels.py's cases; lengths drawn per row
    (2, 256, 8, 2, 64), (3, 100, 4, 4, 32), (1, 512, 16, 8, 128), (2, 64, 2, 1, 64),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_pallas_and_ref(case, dtype):
    B, S, Hq, Hkv, D = case
    rng = np.random.default_rng(hash(case) % 2**32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    length = rng.integers(1, S + 1, (B,)).astype(np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    tol = DTYPES[dtype][2]
    _close(pallas_decode(jq, jk, jv, jnp.asarray(length), block_kv=64, interpret=True),
           got, tol)
    _close(jref.decode_attention(jq, jk, jv, jnp.asarray(length)), got, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_lengths_zero_full_ragged_and_nan_past_length(dtype):
    """Per-row lengths 0, S, past S (clipped) and ragged, with NaN written in
    every cache slot past its row's length: the Pallas kernel's contract —
    no NaN leaks, a length-0 row is exactly 0."""
    B, S, Hq, Hkv, D = 5, 100, 6, 2, 32
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    length = np.array([0, S, 37, 1, S + 9], np.int32)
    for b, n in enumerate(length):
        k[b, n:] = np.nan
        v[b, n:] = np.nan
    jdt, tdt, tol = DTYPES[dtype]
    got = ops.decode_attention(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                               torch.from_numpy(v).to(tdt), torch.from_numpy(length))
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0)
    exp = pallas_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                        jnp.asarray(length), block_kv=64, interpret=True)
    _close(exp, got, tol)


def test_decode_scalar_length_and_stats_vs_jax():
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "float32") for s in
                                    ((2, 4, 16), (2, 50, 2, 16), (2, 50, 2, 16)))
    _close(jref.decode_attention(jq, jk, jv, jnp.int32(33), block_kv=16),
           ops.decode_attention(tq, tk, tv, 33), 2e-5)
    jstats = jref.decode_attention(jq, jk, jv, jnp.int32(50), block_kv=16, return_stats=True)
    tstats = tref.decode_attention(tq, tk, tv, 50, block_kv=16, return_stats=True)
    for a, b in zip(jstats, tstats):
        _close(a, b, 2e-5)
