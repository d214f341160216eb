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

from repro.configs import get_config as jax_config
from repro.configs.base import list_archs
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as tpda
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


# ------------------------------------------------ the decode kernels' split order
#
# ``ref.decode_attention_splits`` sums as the CUDA decode kernels do: f32
# partials per chunk of ``ref.DECODE_CHUNK`` logical keys, then a log-sum-exp
# merge in chunk order. It must agree with the Pallas kernel and the JAX
# reference as the plain version does, at every group size a registered
# config has.

CHUNK = tref.DECODE_CHUNK


def _decode_inputs(rng, B, S, Hq, Hkv, D, length, dtype, nan_past_length=True):
    """numpy f32 inputs in both packages, NaN past each row's length if asked."""
    jdt, tdt, _ = DTYPES[dtype]
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    for b, n in enumerate(length if nan_past_length else ()):
        k[b, n:] = np.nan
        v[b, n:] = np.nan
    return ([jnp.asarray(x, jdt) for x in (q, k, v)],
            [torch.from_numpy(x).to(tdt) for x in (q, k, v)])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_order_vs_pallas_and_ref(case, dtype):
    B, S, Hq, Hkv, D = case
    rng = np.random.default_rng(hash(case) % 2**32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    length = rng.integers(1, S + 1, (B,)).astype(np.int32)
    got = tref.decode_attention_splits(tq, tk, tv, torch.from_numpy(length))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    _close(pallas_decode(jq, jk, jv, jnp.asarray(length), block_kv=64, interpret=True),
           got, tol)
    _close(jref.decode_attention(jq, jk, jv, jnp.asarray(length)), got, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_order_at_the_split_edges_with_nan_past_length(dtype):
    """Lengths 0, 1, one chunk less one, one chunk, one chunk and one, S and
    past S, NaN in every slot past the length: finite, a length-0 row exactly
    0, and the Pallas kernel's values."""
    S = 3 * CHUNK - 5
    length = np.array([0, 1, CHUNK - 1, CHUNK, CHUNK + 1, S, S + 40], np.int32)
    B, Hq, Hkv, D = len(length), 6, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(np.random.default_rng(21), B, S, Hq, Hkv, D,
                                                length, dtype)
    got = tref.decode_attention_splits(tq, tk, tv, torch.from_numpy(length))
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0)
    _close(pallas_decode(jq, jk, jv, jnp.asarray(length), block_kv=64, interpret=True),
           got, DTYPES[dtype][2])
    # the port's plain version (one block) on the same inputs
    _close(np.asarray(ops.decode_attention(tq, tk, tv, torch.from_numpy(length)).float()),
           got, DTYPES[dtype][2])


# G = 5, 6, 7, 12 at D = 128 (qwen2.5-32b, qwen2-vl-2b, arctic-480b,
# starcoder2-3b), G = 17 (two row tiles of the kernel), G = 1 at D = 64 (whisper)
GROUP_CASES = [(40, 8, 128), (12, 2, 128), (56, 8, 128), (24, 2, 128), (17, 1, 64),
               (16, 16, 64)]


@pytest.mark.parametrize("heads", GROUP_CASES, ids=lambda h: f"{h[0]}q{h[1]}kv{h[2]}d")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_order_at_every_group_size(heads, dtype):
    Hq, Hkv, D = heads
    S = 2 * CHUNK + 2
    length = np.array([S, CHUNK + 1, 1], np.int32)
    # finite past the length: the JAX reference lets NaN there leak (ROADMAP
    # Queue C item 1), and the NaN case has its own test above
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(np.random.default_rng(Hq * 131 + Hkv),
                                                len(length), S, Hq, Hkv, D, length, dtype,
                                                nan_past_length=False)
    got = tref.decode_attention_splits(tq, tk, tv, torch.from_numpy(length))
    tol = DTYPES[dtype][2]
    _close(pallas_decode(jq, jk, jv, jnp.asarray(length), block_kv=64, interpret=True),
           got, tol)
    _close(jref.decode_attention(jq, jk, jv, jnp.asarray(length)), got, tol)


def test_decode_split_order_merges_partials_in_chunk_order():
    """With one chunk the merge is the identity on the plain version's stats;
    with several it is the LSE combine of the per-chunk stats."""
    rng = np.random.default_rng(8)
    B, S, Hq, Hkv, D = 2, 3 * CHUNK, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    length = torch.tensor([S, 2 * CHUNK + 3], dtype=torch.int32)
    one = tref.decode_attention_splits(q, k[:, :CHUNK], v[:, :CHUNK], CHUNK)
    assert torch.equal(one, tref.decode_attention(q, k[:, :CHUNK], v[:, :CHUNK], CHUNK))
    stats = [tref.decode_attention(q, k[:, s0:s0 + CHUNK], v[:, s0:s0 + CHUNK],
                                   torch.clamp(length - s0, min=0), return_stats=True)
             for s0 in range(0, S, CHUNK)]
    M = torch.stack([m for m, _, _ in stats]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in stats)
    A = sum(a * torch.exp(m - M)[..., None] for m, _, a in stats)
    want = (A / L[..., None]).reshape(B, Hq, D)
    np.testing.assert_allclose(tref.decode_attention_splits(q, k, v, length).numpy(),
                               want.numpy(), atol=1e-6, rtol=0)


# ------------------------------------------ the decode stats kernel's split order
#
# ``ref.decode_attention_stats_splits`` sums as the CUDA stats kernel does: f32
# partials per split of ``ref.stats_split_span`` keys (whole 64-key tiles, at
# most ``ref.STATS_MAX_SPLITS`` splits a row), merged in split order and left
# unnormalised. It must give JAX's ``ref.decode_attention(...,
# return_stats=True)``: m and l and acc of the live rows, (NEG_INF, 0, 0) for
# a row with no key, and nothing of what lies past a row's length.


def test_stats_split_rule():
    assert [tref.stats_split_span(S) for S in (0, 1, 64, 100, 1024, 1025, 16384, 32768)] == \
        [(64, 1), (64, 1), (64, 1), (64, 2), (64, 16), (128, 9), (1024, 16), (2048, 16)]
    for S in range(0, 5000, 37):
        span, n = tref.stats_split_span(S)
        assert span % CHUNK == 0 and 1 <= n <= tref.STATS_MAX_SPLITS
        assert (n - 1) * span < max(S, 1) <= n * span


STATS_CASES = [  # B, S, Hq, Hkv, D, lengths: splits of 128 keys (9 a row) ...
    (6, 1100, 6, 2, 32, [0, 1, 127, 128, 1000, 1100]),
    # ... lengths past S, one split, and G = 1
    (3, 1100, 4, 4, 16, [1101, 129, 0]),
    (2, 100, 8, 2, 16, [100, 65]),
]


@pytest.mark.parametrize("case", STATS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_split_order_vs_jax_with_empty_rows_and_nan_past_length(case, dtype):
    """The port's split-order stats, fed NaN in every slot past each row's
    length, against JAX's stats of the same cache with finite values there
    (the JAX reference lets NaN past the length leak, ROADMAP Queue C item 1):
    the stats may not depend on what lies past the length."""
    B, S, Hq, Hkv, D, lengths = case
    length = np.array(lengths, np.int32)
    rng = np.random.default_rng(S * 7 + B)
    (jq, jk, jv), _ = _decode_inputs(rng, B, S, Hq, Hkv, D, length, dtype,
                                     nan_past_length=False)
    _, (tq, tk, tv) = _decode_inputs(np.random.default_rng(S * 7 + B), B, S, Hq, Hkv, D,
                                     length, dtype)
    m, l, acc = tref.decode_attention_stats_splits(tq, tk, tv, torch.from_numpy(length))
    jm, jl, ja = (np.asarray(x) for x in jref.decode_attention(
        jq, jk, jv, jnp.asarray(length), return_stats=True))
    assert all(torch.isfinite(x).all() for x in (m, l, acc))
    assert m.shape == l.shape == (B, Hkv, Hq // Hkv) and acc.shape == (B, Hkv, Hq // Hkv, D)
    empty = length == 0
    assert torch.all(m[empty] == tref.NEG_INF) and torch.all(l[empty] == 0)
    assert torch.all(acc[empty] == 0)
    tol = DTYPES[dtype][2]
    live = ~empty
    np.testing.assert_allclose(m[live].numpy(), jm[live], atol=tol, rtol=0)
    np.testing.assert_allclose(l[live].numpy(), jl[live], atol=tol, rtol=tol)
    out = (acc / l[..., None].clamp_min(1e-30))[live].numpy()
    np.testing.assert_allclose(out, (ja / np.maximum(jl, 1e-30)[..., None])[live],
                               atol=tol, rtol=0)
    if dtype == "float32":
        np.testing.assert_allclose(acc.numpy(), ja, atol=tol, rtol=tol)


def test_stats_split_order_merges_partials_in_split_order():
    """One split: the plain version's stats themselves; several: the LSE
    combine of each split's stats, in split order."""
    rng = np.random.default_rng(9)
    B, S, Hq, Hkv, D = 2, 1100, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    length = torch.tensor([S, 300], dtype=torch.int32)
    one = tref.decode_attention_stats_splits(q, k[:, :CHUNK], v[:, :CHUNK], length)
    for a, b in zip(one, tref.decode_attention(q, k[:, :CHUNK], v[:, :CHUNK], length,
                                               return_stats=True)):
        assert torch.equal(a, b)
    span, n = tref.stats_split_span(S)
    stats = [tref.decode_attention(q, k[:, s0:s0 + span], v[:, s0:s0 + span],
                                   torch.clamp(length - s0, min=0), return_stats=True)
             for s0 in range(0, n * span, span)]
    M = torch.stack([m for m, _, _ in stats]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(stats[0][2])
    for m, l, a in stats:
        L = L + l * torch.exp(m - M)
        A = A + a * torch.exp(m - M)[..., None]
    for got, want in zip(tref.decode_attention_stats_splits(q, k, v, length), (M, L, A)):
        assert torch.equal(got, want)


# ------------------------------------- the decode kernels take every config's heads

ATTENTION_ARCHS = [a for a in list_archs() if not jax_config(a).attention_free]


def test_every_registered_config_is_walked():
    """Every registered JAX config either has attention heads (and is walked
    below) or is attention-free (no softmax attention layer at all)."""
    free = {a for a in list_archs() if jax_config(a).attention_free}
    assert set(ATTENTION_ARCHS) | free == set(list_archs())
    assert all(jax_config(a).family == "ssm" for a in free)
    assert len(ATTENTION_ARCHS) >= 9


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_decode_wrappers_take_the_configs_heads(arch):
    """The shape check both decode wrappers run before a launch accepts the
    config's (head dim, Hq, Hkv): the kernels take any Hq % Hkv == 0."""
    cfg = jax_config(arch)
    for name in ("decode_attention", "paged_decode_attention"):
        tda.check_heads(name, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert tpda.check_heads is tda.check_heads


def test_decode_wrapper_shape_check_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no multiple"):
        tda.check_heads("decode_attention", 6, 4, 128)
    with pytest.raises(ValueError, match="no multiple"):
        tda.check_heads("decode_attention", 8, 0, 128)
    with pytest.raises(ValueError, match="head dim 96"):
        tda.check_heads("decode_attention", 8, 2, 96)
    n_splits, scratch = tda.split_scratch(3, 40, 8, 128, 528, "cpu")
    assert n_splits == 9 and scratch.dtype == torch.float32
    assert scratch.numel() == 3 * 8 * 9 * 5 * (128 + 2)
    assert tda.split_scratch(1, 4, 4, 32, 0, "cpu")[0] == 1
    assert tda.split_scratch(1, 4, 4, 32, CHUNK, "cpu")[0] == 1
    assert tda.split_scratch(1, 4, 4, 32, CHUNK + 1, "cpu")[0] == 2
