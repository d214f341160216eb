"""Compressed collectives: int8 wire codec, error feedback, all-reduce.

Port of ``repro.dist.collectives``. Cross-pod gradient traffic rides links
an order of magnitude slower than in-pod ones, so the ``pod`` axis
all-reduce goes over the wire in int8: each rank quantizes (symmetric,
per-tensor f32 scale), all-gathers the int8 payload and the scales, and
dequantizes and sums in f32 locally — 4x less wire than an f32 all-reduce
for a bounded (<= 1/127 of amax) elementwise error. :class:`ErrorFeedback`
keeps the quantization residual and folds it into the next step's
transmission (1-bit-Adam / EF-SGD style), so the *time-averaged* transmitted
value is unbiased even though each message is quantized.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, NamedTuple, Tuple

import torch

# ------------------------------------------------------------- the wire log

class WireLog:
    """Collective calls and bytes per op, over every group of the process:
    the functional collectives DTensor's redistributions make when they are
    staged through host memory (``repro_torch.launch.mesh``), and the
    ``torch.distributed`` calls of this package. Bytes are what one rank
    puts on the wire and takes off it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = collections.Counter()
        self._bytes: Dict[str, int] = collections.Counter()

    def add(self, op: str, nbytes: int) -> None:
        with self._lock:
            self._calls[op] += 1
            self._bytes[op] += int(nbytes)

    def reset(self) -> None:
        with self._lock:
            self._calls.clear()
            self._bytes.clear()

    def summary(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {op: {"calls": self._calls[op], "bytes": self._bytes[op]}
                    for op in sorted(self._calls)}


WIRE = WireLog()


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------------------ int8 codec


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32 0-d)."""
    xf = x.float()
    amax = xf.abs().amax() if xf.numel() else xf.new_zeros(())
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# -------------------------------------------------------------- error feedback

class ErrorFeedback(NamedTuple):
    """Carries the un-transmitted quantization residual between steps."""

    residual: torch.Tensor

    @classmethod
    def init(cls, like: torch.Tensor) -> "ErrorFeedback":
        return cls(torch.zeros(like.shape, dtype=torch.float32, device=like.device))


def ef_compress(x: torch.Tensor, ef: ErrorFeedback
                ) -> Tuple[torch.Tensor, torch.Tensor, ErrorFeedback]:
    """Quantize (x + residual); the new residual is what the wire dropped."""
    t = x.float() + ef.residual
    q, scale = quantize_int8(t)
    return q, scale, ErrorFeedback(t - dequantize_int8(q, scale))


# ----------------------------------------------------------------- all-reduce

def compressed_allreduce(x: torch.Tensor, group=None, *, mean: bool = True) -> torch.Tensor:
    """int8-wire all-reduce (mean by default) of ``x`` over the process group
    ``group`` (the default world when None). Only the int8 payload and the
    f32 scales cross the wire (two all-gathers); each rank dequantizes and
    sums the N payloads in f32, in rank order, so every rank gets the same
    bits. Returns a tensor of ``x``'s dtype."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    q, scale = quantize_int8(x)
    qs = q.new_empty((n * q.numel(),))                           # int8 wire
    ss = scale.new_empty((n,))                                   # [N] f32 scales
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    WIRE.add("all_gather", nbytes(qs) + nbytes(ss))
    vals = qs.reshape(n, *q.shape).float() * ss.reshape((-1,) + (1,) * q.dim())
    total = vals.sum(dim=0)
    if mean:
        total = total / n
    return total.to(x.dtype)
