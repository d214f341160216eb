"""Decode attention: the hand-written Hopper kernel and its plain version.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_dec_kernel``). The kernel is ``csrc/decode_attention.cu``;
:func:`decode_attention` is its wrapper (checks, output allocation, launch on
the current CUDA stream, launch count). The plain version is
``ref.decode_attention``, re-exported as :func:`decode_attention_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_cuda_operands
from repro_torch.kernels.ref import decode_attention as decode_attention_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()
GROUP_SIZES = (1, 2, 3, 4, 8)          # Hq / Hkv values the kernel is built for


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
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not match "
                         f"cache{tuple(k_cache.shape)}")
    if D not in HEAD_DIMS or Hq // Hkv not in GROUP_SIZES:
        raise ValueError(f"decode_attention: head dim {D} / group {Hq // Hkv} not built "
                         f"(dims {HEAD_DIMS}, groups {GROUP_SIZES})")
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device).expand(B)
    lengths = lengths.contiguous()
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = _cuda.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_decode_attention(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                    lengths.data_ptr(), o.data_ptr(), DTYPES[q.dtype],
                                    B, S, Hq, Hkv, D, stream)
    _cuda.check(rc, "decode_attention")
    LAUNCHES.add()
    return o
