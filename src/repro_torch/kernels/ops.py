"""Dispatch between the hand-written kernels and their plain versions.

Port of ``repro.kernels.ops``. The model calls :func:`attention`,
:func:`decode_attention`, :func:`paged_decode_attention`, :func:`mlstm` and
:func:`selective_scan`; each is a ``torch.library`` custom op
(``repro_torch::flash_attention``, ``repro_torch::decode_attention``,
``repro_torch::paged_decode_attention``, ``repro_torch::mlstm``,
``repro_torch::selective_scan``) with a fake implementation, so
``torch.export`` records it as one opaque node and the exported programs
dispatch at run time.

:func:`slstm_scan` (``repro_torch::slstm_scan``), :func:`mlstm_step`
(``repro_torch::mlstm_step``) and :func:`mamba_step`
(``repro_torch::mamba_step``) are custom ops of the same kind around code
that is not a kernel: the sLSTM time loop, which the JAX package runs as a
``lax.scan``, and the mLSTM and Mamba decode steps, which it runs as plain
``jnp`` (the ops update the state in place). They run the plain versions on
any device and count no launches; being one node each, they keep a prompt's
hundreds of sLSTM steps and each decode step's recurrent arithmetic out of
the exported graph, whose size sets the cold start's deserialize time.

``flash_attention``, ``mlstm``, ``selective_scan`` and ``slstm_scan`` have
an autograd formula: the backward recomputes the VJP of the op's plain
version (:mod:`repro_torch.kernels.ref`) on the saved inputs, as the JAX
package differentiates its flash kernel through the reference. Nothing on
the serve path runs a backward.

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
from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm as mk
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ss

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
            "decode_attention": da.LAUNCHES.count,
            "paged_decode_attention": pda.LAUNCHES.count,
            "mlstm": mk.LAUNCHES.count,
            "selective_scan": ss.LAUNCHES.count}


def reset_launch_counts() -> None:
    for kernel in (fa, da, pda, mk, ss):
        kernel.LAUNCHES.reset()


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


@torch.library.custom_op("repro_torch::paged_decode_attention", mutates_args=())
def _paged_decode_attention_op(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    if use_kernel(q.device):
        return pda.paged_decode_attention(q, k_pages, v_pages, page_table, lengths)
    return ref.paged_decode_attention(q, k_pages, v_pages, page_table, lengths)


@_paged_decode_attention_op.register_fake
def _(q, k_pages, v_pages, page_table, lengths):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::mlstm", mutates_args=())
def _mlstm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_raw: torch.Tensor,
              f_raw: torch.Tensor, C: Optional[torch.Tensor], n: Optional[torch.Tensor],
              m: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    state = None if C is None else (C, n, m)
    if use_kernel(q.device):
        h, (C, n, m) = mk.mlstm(q, k, v, i_raw, f_raw, state)
    else:
        h, (C, n, m) = ref.mlstm_chunked(q, k, v, i_raw, f_raw, state=state)
    return h, C, n, m


@_mlstm_op.register_fake
def _(q, k, v, i_raw, f_raw, C, n, m):
    B, S, H, Dk = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (q.new_empty((B, S, H, v.shape[-1])), torch.empty((B, H, Dk, v.shape[-1]), **f32),
            torch.empty((B, H, Dk), **f32), torch.empty((B, H), **f32))


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                       h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if use_kernel(x.device):
        return ss.selective_scan(x, dt, a_log, b, c, d_skip, h0)
    return ref.selective_scan(x, dt, a_log, b, c, d_skip, h0)


@_selective_scan_op.register_fake
def _(x, dt, a_log, b, c, d_skip, h0):
    B, _, Di = x.shape
    return torch.empty_like(x), x.new_empty((B, Di, a_log.shape[1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::mlstm_step", mutates_args=("C", "n", "m"))
def _mlstm_step_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i: torch.Tensor,
                   f: torch.Tensor, C: torch.Tensor, n: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    h, new = ref.mlstm_step(q, k, v, i, f, (C, n, m))
    for old, val in zip((C, n, m), new):
        old.copy_(val)
    return h


@_mlstm_step_op.register_fake
def _(q, k, v, i, f, C, n, m):
    return q.new_empty(v.shape)


@torch.library.custom_op("repro_torch::mamba_step", mutates_args=("h",))
def _mamba_step_op(x_t: torch.Tensor, dt_t: torch.Tensor, a_log: torch.Tensor,
                   b_t: torch.Tensor, c_t: torch.Tensor, d_skip: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    y, h_new = ref.mamba_step(x_t, dt_t, a_log, b_t, c_t, d_skip, h)
    h.copy_(h_new)
    return y


@_mamba_step_op.register_fake
def _(x_t, dt_t, a_log, b_t, c_t, d_skip, h):
    return torch.empty_like(x_t)


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan_op(gates: torch.Tensor, r: torch.Tensor, b_in: torch.Tensor,
                   c: torch.Tensor, n: torch.Tensor, h: torch.Tensor,
                   m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    return ref.slstm_scan(gates, r, b_in, c, n, h, m)


@_slstm_scan_op.register_fake
def _(gates, r, b_in, c, n, h, m):
    B, S = gates.shape[:2]
    return (c.new_empty((B, S, c.shape[-1])), torch.empty_like(c), torch.empty_like(n),
            torch.empty_like(h), torch.empty_like(m))


# ------------------------------------------------------------------ autograd

def _vjp_of(plain, n_tensors: int):
    """A ``register_autograd`` backward for a custom op whose first
    ``n_tensors`` arguments are tensors (or None): recompute ``plain`` on
    those inputs under autograd and return its vector-Jacobian product, as
    the JAX package's flash attention does (``_flash_bwd`` is the
    reference's VJP). ``plain`` maps the op's arguments to its outputs."""

    def setup_context(ctx, inputs, output):
        ctx.args = inputs[n_tensors:]
        ctx.save_for_backward(*[t if t is not None else torch.empty(0)
                                for t in inputs[:n_tensors]])
        ctx.present = [t is not None for t in inputs[:n_tensors]]

    def backward(ctx, *grads):
        leaves = [t.detach().requires_grad_(t.is_floating_point()) if here else None
                  for t, here in zip(ctx.saved_tensors, ctx.present)]
        with torch.enable_grad():
            outs = plain(*leaves, *ctx.args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs], allow_unused=True))
        dx = [next(got) if t is not None and t.requires_grad else None for t in leaves]
        return (*dx, *[None] * len(ctx.args))

    return backward, setup_context


def _flash_plain(q, k, v, causal, q_offset):
    return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def _mlstm_plain(q, k, v, i_raw, f_raw, C, n, m):
    h, (C, n, m) = ref.mlstm_chunked(q, k, v, i_raw, f_raw,
                                     state=None if C is None else (C, n, m))
    return h, C, n, m


for _op, _plain, _n in ((_flash_attention_op, _flash_plain, 3),
                        (_mlstm_op, _mlstm_plain, 8),
                        (_selective_scan_op, ref.selective_scan, 7),
                        (_slstm_scan_op, ref.slstm_scan, 7)):
    _bwd, _setup = _vjp_of(_plain, _n)
    _op.register_autograd(_bwd, setup_context=_setup)


# ------------------------------------------------------------------ entry points
#
# Every tensor an op reads but does not write is passed dense (``_dense``).
# An AOTInductor program hands a strided view (a column slice of a
# projection) to a Python custom op with the wrong layout: jamba's decode
# step read ``proj[:, dtr:dtr + ds]`` as garbage until its inputs were made
# contiguous. ``contiguous()`` of a dense tensor is the tensor itself.


def _dense(*tensors):
    return tuple(t.contiguous() for t in tensors)


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """GQA attention. q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D] -> [B,Sq,Hq,D]."""
    return torch.ops.repro_torch.flash_attention(*_dense(q, k, v), causal, int(q_offset))


def decode_attention(q, k_cache, v_cache, length):
    """Single-token attention vs cache. q: [B,Hq,D]; caches [B,S,Hkv,D];
    length: int, or int32 tensor [] / [B]."""
    B = q.shape[0]
    length = torch.as_tensor(length, dtype=torch.int32, device=q.device).expand(B)
    return torch.ops.repro_torch.decode_attention(*_dense(q, k_cache, v_cache, length))


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths):
    """Single-token attention through a page table. q: [B,Hq,D]; pools
    [P,page_size,Hkv,D]; page_table: int32 [B,max_pages]; lengths: int, or
    int32 tensor [] / [B]."""
    B = q.shape[0]
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device).expand(B)
    return torch.ops.repro_torch.paged_decode_attention(
        *_dense(q, k_pages, v_pages, page_table.to(torch.int32), lengths))


def mlstm(q, k, v, i_raw, f_raw, state=None):
    """Chunkwise mLSTM. q, k: [B,S,H,Dk]; v: [B,S,H,Dv]; i_raw, f_raw: [B,S,H];
    state: optional (C [B,H,Dk,Dv], n [B,H,Dk], m [B,H]) to start from.
    Returns (h [B,S,H,Dv] in q's dtype, (C, n, m) in f32)."""
    C, n, m = (None, None, None) if state is None else _dense(*state)
    h, C, n, m = torch.ops.repro_torch.mlstm(*_dense(q, k, v, i_raw, f_raw), C, n, m)
    return h, (C, n, m)


def selective_scan(x, dt, a_log, b, c, d_skip, h0=None):
    """Mamba selective scan. x, dt: [B,S,Di]; a_log: [Di,Ds]; b, c: [B,S,Ds];
    d_skip: [Di]; h0: optional [B,Di,Ds] -> (y [B,S,Di] in x's dtype,
    h_final [B,Di,Ds] f32)."""
    h0 = None if h0 is None else h0.contiguous()
    return torch.ops.repro_torch.selective_scan(*_dense(x, dt, a_log, b, c, d_skip), h0)


def slstm_scan(gates, r, b_in, c, n, h, m):
    """The sLSTM over a sequence. gates: [B,S,4d]; r: [H,dh,4dh]; b_in: [4d]
    f32; c, n, h, m: [B,d] f32 -> (hs [B,S,d] f32, c, n, h, m)."""
    return torch.ops.repro_torch.slstm_scan(*_dense(gates, r, b_in, c, n, h, m))


def mamba_step(x_t, dt_t, a_log, b_t, c_t, d_skip, h):
    """One Mamba decode step (``ref.mamba_step``), the state ``h`` [B,Di,Ds]
    f32 updated in place. x_t, dt_t: [B,Di]; b_t, c_t: [B,Ds] -> y [B,Di] in
    x_t's dtype."""
    return torch.ops.repro_torch.mamba_step(*_dense(x_t, dt_t, a_log, b_t, c_t, d_skip), h)


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """One mLSTM decode step (``ref.mlstm_step``), the state updated in place.
    q_t, k_t: [B,H,Dk]; v_t: [B,H,Dv]; i_t, f_t: [B,H]; state (C, n, m) f32
    -> h [B,H,Dv] in q_t's dtype."""
    return torch.ops.repro_torch.mlstm_step(*_dense(q_t, k_t, v_t, i_t, f_t), *state)
