"""Chunkwise mLSTM: the hand-written Hopper kernels and their plain version.

Port of ``repro.kernels.mlstm``, the Pallas TPU kernel ``_mlstm_kernel``,
which keeps a head's (C, n, m) in VMEM across a sequential grid of chunks.
The kernels are in ``csrc/mlstm.cu`` (its header says how they are laid out
and what bounds them). For bf16 inputs, the serve path's dtype, the three
chunk products run on the tensor cores; the f32 operands among them (the
state C, k scaled by its gate weight, the decay-weighted scores) are split
into bf16 hi + lo parts and go through two products each, so the f32 state
keeps its f32 tolerance. f32 inputs take a kernel on the f32 SIMT pipes.
:func:`mlstm` is their wrapper, which checks the inputs, allocates the
outputs, launches on the current CUDA stream and counts the launch. The
plain version is ``ref.mlstm_chunked``, re-exported as :func:`mlstm_plain`.

Unlike the Pallas entry, which sends a call that carries a state to the
reference, the kernel takes the state (C, n, m) as an optional input and
starts from it. It applies the reference's padding values (i = NEG_INF,
f = 60) to the steps of its last chunk past S itself, so the wrapper makes
no padded copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import DTYPES, check_cuda_operands
from repro_torch.kernels.ref import _scale
from repro_torch.kernels.ref import mlstm_chunked as mlstm_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()
KEY_DIM_STEP, MAX_KEY_DIM = 32, 512     # Dk: a multiple of 32, at most 512
VALUE_DIM_STEP = 64                     # Dv: a multiple of 64 (one CTA per 64 columns)


def _check_state(state, B: int, H: int, Dk: int, Dv: int, device) -> None:
    for t, shape in zip(state, ((B, H, Dk, Dv), (B, H, Dk), (B, H))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"mlstm: state must be contiguous, aligned float32 tensors "
                             f"shaped (B,H,Dk,Dv), (B,H,Dk), (B,H) = {(B, H, Dk, Dv)} on "
                             f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_raw: torch.Tensor,
          f_raw: torch.Tensor, state=None):
    """q, k: [B,S,H,Dk]; v: [B,S,H,Dv]; i_raw, f_raw: [B,S,H]; state: optional
    (C [B,H,Dk,Dv], n [B,H,Dk], m [B,H]) f32; all on CUDA -> (h [B,S,H,Dv] in
    q's dtype, (C, n, m) f32)."""
    check_cuda_operands("mlstm", q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"mlstm: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    if Dk % KEY_DIM_STEP or not 0 < Dk <= MAX_KEY_DIM or Dv % VALUE_DIM_STEP or Dv == 0:
        raise ValueError(f"mlstm: head dims Dk={Dk}, Dv={Dv} not built (Dk a multiple of "
                         f"{KEY_DIM_STEP} up to {MAX_KEY_DIM}, Dv a multiple of "
                         f"{VALUE_DIM_STEP})")
    for name, g in (("i_raw", i_raw), ("f_raw", f_raw)):
        if tuple(g.shape) != (B, S, H) or g.device != q.device:
            raise ValueError(f"mlstm: {name} must be [B,S,H] = {(B, S, H)} on {q.device}, "
                             f"got {tuple(g.shape)} on {g.device}")
    i_raw = i_raw.to(torch.float32).contiguous()
    f_raw = f_raw.to(torch.float32).contiguous()
    if state is not None:
        _check_state(state, B, H, Dk, Dv, q.device)
    if S == 0:
        raise ValueError("mlstm: an empty sequence has no final state to compute")
    f32 = dict(dtype=torch.float32, device=q.device)
    h = q.new_empty((B, S, H, Dv))
    C, n, m = (torch.empty((B, H, Dk, Dv), **f32), torch.empty((B, H, Dk), **f32),
               torch.empty((B, H), **f32))
    if B * H == 0:
        return h, (C, n, m)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    C0, n0, m0 = (None, None, None) if state is None else (t.data_ptr() for t in state)
    rc = lib.repro_mlstm(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(),
                         f_raw.data_ptr(), C0, n0, m0, h.data_ptr(), C.data_ptr(),
                         n.data_ptr(), m.data_ptr(), DTYPES[q.dtype], B, S, H, Dk, Dv,
                         _scale(Dk), stream)
    _cuda.check(rc, "mlstm")
    LAUNCHES.add()
    return h, (C, n, m)
