"""Dispatch between the hand-written kernels and their plain versions.

Port of ``repro.kernels.ops``. The model calls :func:`attention` and
:func:`decode_attention`; each is a ``torch.library`` custom op
(``repro_torch::flash_attention``, ``repro_torch::decode_attention``) with a
fake implementation, so ``torch.export`` records it as one opaque node and the
exported serve program dispatches at run time.

The route depends on the tensors' device, never on probing the hardware:

* a CPU tensor runs the plain version;
* a CUDA tensor runs the hand-written kernel, whose wrapper raises if it
  cannot launch (no capability check, no fallback).

:func:`set_impl` / :func:`impl_scope` override that per thread:

* ``auto``   — by device, as above (the default);
* ``plain``  — the plain versions on any device (the tests, and the
  comparison phase of ``chip_smoke.py``);
* ``kernel`` — the kernels; a CPU tensor raises.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

_VALID = ("auto", "plain", "kernel")


class _State(threading.local):
    def __init__(self):
        self.impl = "auto"


_STATE = _State()


def set_impl(impl: str) -> None:
    if impl not in _VALID:
        raise ValueError(f"impl must be one of {_VALID}, got {impl!r}")
    _STATE.impl = impl


def get_impl() -> str:
    return _STATE.impl


@contextlib.contextmanager
def impl_scope(impl: str):
    prev = _STATE.impl
    set_impl(impl)
    try:
        yield
    finally:
        _STATE.impl = prev


def use_kernel(device: torch.device) -> bool:
    """True: launch the hand-written kernel; False: run the plain version."""
    impl = _STATE.impl
    if impl == "plain":
        return False
    if device.type == "cpu":
        if impl == "kernel":
            raise RuntimeError("impl 'kernel' needs CUDA tensors; got CPU tensors")
        return False
    return True


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {"flash_attention": fa.LAUNCHES.count,
            "decode_attention": da.LAUNCHES.count}


def reset_launch_counts() -> None:
    fa.LAUNCHES.reset()
    da.LAUNCHES.reset()


# ------------------------------------------------------------------ custom ops

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, q_offset: int) -> torch.Tensor:
    if use_kernel(q.device):
        return fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


@_flash_attention_op.register_fake
def _(q, k, v, causal, q_offset):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    if use_kernel(q.device):
        return da.decode_attention(q, k_cache, v_cache, length)
    return ref.decode_attention(q, k_cache, v_cache, length)


@_decode_attention_op.register_fake
def _(q, k_cache, v_cache, length):
    return torch.empty_like(q)


# ------------------------------------------------------------------ entry points

def attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """GQA attention. q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D] -> [B,Sq,Hq,D]."""
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, int(q_offset))


def decode_attention(q, k_cache, v_cache, length):
    """Single-token attention vs cache. q: [B,Hq,D]; caches [B,S,Hkv,D];
    length: int, or int32 tensor [] / [B]."""
    B = q.shape[0]
    length = torch.as_tensor(length, dtype=torch.int32, device=q.device).expand(B)
    return torch.ops.repro_torch.decode_attention(q, k_cache, v_cache, length.contiguous())
