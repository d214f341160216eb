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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_cuda_operands
from repro_torch.kernels.ref import DECODE_CHUNK
from repro_torch.kernels.ref import decode_attention as decode_attention_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length) -> torch.Tensor:
    """q: [B,Hq,D]; k_cache, v_cache: [B,S,Hkv,D] on CUDA; length: int or
    int32 tensor [] / [B] -> [B,Hq,D] in q's dtype."""
    check_cuda_operands("decode_attention", q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not match "
                         f"cache{tuple(k_cache.shape)}")
    check_heads("decode_attention", Hq, Hkv, D)
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
