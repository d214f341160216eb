"""Prefill attention: the hand-written Hopper kernels and their plain version.

Port of ``repro.kernels.flash_attention``, the Pallas TPU kernel
``_fa_kernel``, which streams K/V blocks through VMEM for one query head and
block per grid step. The kernels are in ``csrc/flash_attention.cu``, whose
header says how they are laid out:

- bf16 at head dims 64 and 128 (the serve paths): a producer warp feeds K/V
  tiles by TMA into a two-stage ring; one warpgroup runs Q K^T and P V with
  ``wgmma`` (P from registers, V through the transpose bit), two CTAs per SM.
  At llama3.2-3b's prefill shape the call's bytes bound it on the H100
  (they take longer than its products at the tensor-core peak); PERF.md has
  the kernel's time against that bound and against the library call.
- bf16 at head dim 32: the first ``mma.sync`` kernel; f32: a SIMT kernel.

:func:`flash_attention` is their wrapper, which checks the inputs, allocates
the output, launches on the current CUDA stream and counts the launch. The
plain version is ``ref.flash_attention``, re-exported here as
:func:`flash_attention_plain`.

``repro_torch.kernels.ops`` chooses between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import flash_attention as flash_attention_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor
    of one supported dtype on one device (what the C interface assumes)."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {first.device}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
    if first.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {first.dtype} not in {list(DTYPES)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,Hq,D]; k, v: [B,Skv,Hkv,D] on CUDA -> [B,Sq,Hq,D] in q's dtype."""
    check_cuda_operands("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = _cuda.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   DTYPES[q.dtype], B, Sq, Skv, Hq, Hkv, D, int(causal),
                                   int(q_offset), stream)
    _cuda.check(rc, "flash_attention")
    LAUNCHES.add()
    return o
