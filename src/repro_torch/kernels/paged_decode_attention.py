"""Paged decode attention: the hand-written Hopper kernel and its plain version.

Port of ``repro.kernels.paged_decode_attention`` (the Pallas TPU kernel
``_paged_kernel``). The kernel is ``csrc/paged_decode_attention.cu``, which
shares its split-KV sweep and merge with the contiguous decode kernel
(``csrc/decode_sweep.cuh``), so the same logical cache gives the same bits
through either; :func:`paged_decode_attention` is its wrapper (checks, output
and scratch allocation, launch on the current CUDA stream, launch count). The
plain version is ``ref.paged_decode_attention``, re-exported as
:func:`paged_decode_attention_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.decode_attention import check_heads, split_scratch
from repro_torch.kernels.flash_attention import DTYPES, check_cuda_operands
from repro_torch.kernels.ref import paged_decode_attention as paged_decode_attention_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths) -> torch.Tensor:
    """q: [B,Hq,D]; k_pages, v_pages: [P,page_size,Hkv,D]; page_table: int32
    [B,max_pages]; lengths: int or int32 tensor [] / [B]; all on CUDA ->
    [B,Hq,D] in q's dtype. Unused table entries point at the null page 0."""
    check_cuda_operands("paged_decode_attention", q, k_pages, v_pages)
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k_pages.shape)} v{tuple(v_pages.shape)}")
    B, Hq, D = q.shape
    P, page_size, Hkv, Dk = k_pages.shape
    if Dk != D or P == 0 or page_size == 0:
        raise ValueError(f"paged_decode_attention: q{tuple(q.shape)} does not match "
                         f"pages{tuple(k_pages.shape)}")
    check_heads("paged_decode_attention", Hq, Hkv, D)
    if page_table.dim() != 2 or page_table.shape[0] != B or page_table.shape[1] == 0 \
            or page_table.dtype != torch.int32 or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError(f"paged_decode_attention: page_table must be a contiguous int32 "
                         f"[{B}, max_pages] tensor on {q.device}, got "
                         f"{page_table.dtype} {tuple(page_table.shape)} on {page_table.device}")
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device).expand(B)
    lengths = lengths.contiguous()
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    max_pages = page_table.shape[1]
    n_splits, scratch = split_scratch(B, Hq, Hkv, D, max_pages * page_size, q.device)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), scratch.data_ptr(), DTYPES[q.dtype], B, P,
        page_size, max_pages, Hq, Hkv, D, n_splits, stream)
    _cuda.check(rc, "paged_decode_attention")
    LAUNCHES.add()
    return o
