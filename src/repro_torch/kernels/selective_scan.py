"""Mamba selective scan: the hand-written Hopper kernel and its plain version.

Port of ``repro.kernels.selective_scan`` (the Pallas TPU kernel
``_scan_kernel``). The kernel is ``csrc/selective_scan.cu`` (its header says
how it is laid out and what bounds it); :func:`selective_scan` is its
wrapper, which checks the inputs, allocates the outputs, launches on the
current CUDA stream and counts the launch. The plain version is
``ref.selective_scan``, re-exported as :func:`selective_scan_plain`.

x and y are bf16 or f32; every other operand goes to the kernel in f32. The
wrapper casts b and c ([B, S, Ds], a few hundred KB at the serve path's
shape) and whatever else is not f32 already; in the model dt, a_log, d_skip
and the state are f32, so nothing else is copied. Unlike the Pallas entry, the
kernel needs Di to be no multiple of anything (it masks the last channel
block) and pads nothing (it stops at S).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.ref import selective_scan as selective_scan_plain  # noqa: F401

LAUNCHES = _cuda.LaunchCounter()
STATE_DIMS = (4, 8, 16)             # Ds the kernel is built for


def _f32(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"selective_scan: {name} must be {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, d_skip: torch.Tensor, h0=None):
    """x, dt: [B,S,Di]; a_log: [Di,Ds]; b, c: [B,S,Ds]; d_skip: [Di]; h0:
    optional [B,Di,Ds]; all on CUDA -> (y [B,S,Di] in x's dtype, h_final
    [B,Di,Ds] f32)."""
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"selective_scan: x dtype {x.dtype} not in {list(DTYPES)}")
    if x.dim() != 3 or a_log.dim() != 2:
        raise ValueError(f"selective_scan: shapes x{tuple(x.shape)} a_log{tuple(a_log.shape)}")
    B, S, Di = x.shape
    Ds = a_log.shape[1]
    if Ds not in STATE_DIMS:
        raise ValueError(f"selective_scan: state dim {Ds} not in {STATE_DIMS}")
    if S == 0:
        raise ValueError("selective_scan: an empty sequence has no final state to compute")
    dev = x.device
    dt = _f32("dt", dt, (B, S, Di), dev)
    a_log = _f32("a_log", a_log, (Di, Ds), dev)
    b = _f32("b", b, (B, S, Ds), dev)
    c = _f32("c", c, (B, S, Ds), dev)
    d_skip = _f32("d_skip", d_skip, (Di,), dev)
    if h0 is not None:
        h0 = _f32("h0", h0, (B, Di, Ds), dev)
    x = x.contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, Di, Ds), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_selective_scan(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                                  c.data_ptr(), d_skip.data_ptr(),
                                  None if h0 is None else h0.data_ptr(), y.data_ptr(),
                                  h.data_ptr(), DTYPES[x.dtype], B, S, Di, Ds, stream)
    _cuda.check(rc, "selective_scan")
    LAUNCHES.add()
    return y, h
