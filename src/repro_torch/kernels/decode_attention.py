"""Decode attention: the hand-written Hopper kernel and its plain version.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_dec_kernel``). The kernel is ``csrc/decode_attention.cu`` over the shared
``csrc/decode_sweep.cuh``: the keys split into chunks of
``ref.DECODE_CHUNK`` across CTAs, the group's query heads on the tensor cores
(bf16), then a log-sum-exp merge of the f32 partials in chunk order.
:func:`decode_attention` is its wrapper (checks, output and scratch
allocation, launch on the current CUDA stream, launch count). The plain
version is ``ref.decode_attention``, re-exported as
:func:`decode_attention_plain`; ``ref.decode_attention_splits`` sums in the
kernel's order.

:func:`decode_attention_stats` is the kernel's second entry, for distributed
flash decoding over a sequence-sharded cache: the same split kernel, then a
merge that writes the online-softmax stats (m, l, acc) unnormalised instead
of the output, with its own launch count. Its plain version is
``ref.decode_attention(..., return_stats=True)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_cuda_operands
from repro_torch.kernels.ref import DECODE_CHUNK
from repro_torch.kernels.ref import decode_attention as decode_attention_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()
STATS_LAUNCHES = _cuda.LaunchCounter()


def check_heads(name: str, Hq: int, Hkv: int, D: int) -> None:
    """Raise unless the decode kernels take these heads: any ``Hq % Hkv == 0``
    (the group size is a run-time argument) at a head dim in ``HEAD_DIMS``."""
    if Hkv <= 0 or Hq <= 0 or Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads are no multiple of {Hkv} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not built (dims {HEAD_DIMS})")


def split_scratch(B: int, Hq: int, Hkv: int, D: int, cap: int, device):
    """(n_splits, f32 scratch) for the partials of a cache of ``cap``
    positions: (m, l, acc[D]) per (row, kv head, split, query head)."""
    n_splits = max(1, -(-cap // DECODE_CHUNK))
    scratch = torch.empty(B * Hkv * n_splits * (Hq // Hkv) * (D + 2), dtype=torch.float32,
                          device=device)
    return n_splits, scratch


def _check(name: str, q, k_cache, v_cache):
    check_cuda_operands(name, q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D:
        raise ValueError(f"{name}: q{tuple(q.shape)} does not match "
                         f"cache{tuple(k_cache.shape)}")
    check_heads(name, Hq, Hkv, D)
    return B, Hq, D, S, Hkv


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length) -> torch.Tensor:
    """q: [B,Hq,D]; k_cache, v_cache: [B,S,Hkv,D] on CUDA; length: int or
    int32 tensor [] / [B] -> [B,Hq,D] in q's dtype."""
    B, Hq, D, S, Hkv = _check("decode_attention", q, k_cache, v_cache)
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device).expand(B)
    lengths = lengths.contiguous()
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    n_splits, scratch = split_scratch(B, Hq, Hkv, D, S, q.device)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_decode_attention(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                    lengths.data_ptr(), o.data_ptr(), scratch.data_ptr(),
                                    DTYPES[q.dtype], B, S, Hq, Hkv, D, n_splits, stream)
    _cuda.check(rc, "decode_attention")
    LAUNCHES.add()
    return o


def decode_attention_stats(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length):
    """The online-softmax stats of :func:`decode_attention`, unnormalised:
    (m [B,Hkv,G], l [B,Hkv,G], acc [B,Hkv,G,D]) in f32, G = Hq // Hkv, m in
    natural-log units. A row of length 0 gives m = ``ref.NEG_INF``, l = 0 and
    acc = 0, so its weight in a log-sum-exp merge is 0."""
    B, Hq, D, S, Hkv = _check("decode_attention_stats", q, k_cache, v_cache)
    G = Hq // Hkv
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device).expand(B)
    lengths = lengths.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, G), **f32)
    l = torch.empty((B, Hkv, G), **f32)
    acc = torch.empty((B, Hkv, G, D), **f32)
    if q.numel() == 0:
        return m, l, acc
    n_splits, scratch = split_scratch(B, Hq, Hkv, D, S, q.device)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_decode_attention_stats(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), scratch.data_ptr(), DTYPES[q.dtype],
        B, S, Hq, Hkv, D, n_splits, stream)
    _cuda.check(rc, "decode_attention_stats")
    STATS_LAUNCHES.add()
    return m, l, acc
