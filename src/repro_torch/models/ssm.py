"""State-space and recurrent sequence mixers: Mamba (jamba), mLSTM and sLSTM
(xLSTM). Port of ``repro.models.ssm``.

Each exposes a full-sequence form (prefill, returns the final state) and a
single-step form (decode). The full-sequence Mamba goes through
``ops.selective_scan`` (the hand-written scan kernel on CUDA tensors); its
decode step runs the plain ``ref.mamba_step``, as the JAX package does, as
one ``ops.mamba_step`` node that updates the state in place. The
full-sequence mLSTM goes through ``ops.mlstm`` (the chunkwise kernel on CUDA
tensors); the decode step runs the plain ``ref.mlstm_step``, as the JAX
package does, as one ``ops.mlstm_step`` node that updates the state
(C, n, m) in place. The sLSTM time loop, prompt or single step, is one
``ops.slstm_scan`` node (the plain per-step cell, which the JAX package runs
as a ``lax.scan``), so an exported program holds one node per sLSTM block
and step instead of the unrolled cells.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dtypes import torch_dtype
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (
    ParamSpec, bias_spec, const_init, dense_spec, normal_init, ones_init, rms_norm,
    zeros_init,
)


def _causal_depthwise_conv(x, w, b, history=None):
    """x: [B,S,C]; w: [cw,C]; history: [B,cw-1,C] or None (zeros).
    Returns (out [B,S,C], new_history [B,cw-1,C]); the taps are summed in f32."""
    B, S, C = x.shape
    cw = w.shape[0]
    if history is None:
        history = x.new_zeros((B, cw - 1, C))
    xin = torch.cat([history.to(x.dtype), x], dim=1)                  # [B, S+cw-1, C]
    wf = w.float()
    out = xin[:, :S].float() * wf[0]
    for j in range(1, cw):
        out = out + xin[:, j:j + S].float() * wf[j]
    new_history = xin[:, -(cw - 1):] if cw > 1 else history
    return out.to(x.dtype) + b.to(x.dtype), new_history


# ============================================================================ Mamba

def mamba_dims(cfg):
    """(d_inner, dt_rank, d_state, d_conv)."""
    s = cfg.ssm
    return s.expand * cfg.d_model, max(cfg.d_model // 16, 8), s.d_state, s.d_conv


def mamba_specs(cfg, dtype, stack: Tuple[int, ...] = ()):
    d = cfg.d_model
    d_in, dtr, ds, cw = mamba_dims(cfg)
    sa = ("layers",) * len(stack)

    def a_init(gen, shape, dt):
        # S4D-real init: A_log = log(1..ds) per channel
        base = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=gen.device))
        return base.expand(shape).to(dt).contiguous()

    return {
        "in_proj": dense_spec(d, 2 * d_in, ("embed", "ffn"), dtype, stack=stack),
        "conv_w": ParamSpec((*stack, cw, d_in), dtype, (*sa, "conv", "ffn"),
                            normal_init(1.0, fan_in_axis=len(stack))),
        "conv_b": bias_spec(d_in, "ffn", dtype, stack=stack),
        "x_proj": dense_spec(d_in, dtr + 2 * ds, ("ffn", None), dtype, stack=stack),
        "dt_proj": dense_spec(dtr, d_in, (None, "ffn"), dtype, stack=stack),
        "dt_bias": ParamSpec((*stack, d_in), torch.float32, (*sa, "ffn"),
                             const_init(math.log(math.expm1(0.01)))),
        "a_log": ParamSpec((*stack, d_in, ds), torch.float32, (*sa, "ffn", None), a_init),
        "d_skip": ParamSpec((*stack, d_in), torch.float32, (*sa, "ffn"), ones_init()),
        "out_proj": dense_spec(d_in, d, ("ffn", "embed"), dtype, stack=stack),
    }


def _mamba_dt(p, dt_r):
    """softplus(dt_r @ dt_proj + dt_bias) in f32."""
    return F.softplus(torch.matmul(dt_r, p["dt_proj"]).float() + p["dt_bias"])


def mamba_forward(cfg, p: dict, x: torch.Tensor, state=None):
    """x: [B,S,d] -> (y [B,S,d], (conv_state [B,cw-1,di], ssm_state [B,di,ds] f32))."""
    d_in, dtr, ds, cw = mamba_dims(cfg)
    conv_state, ssm_state = state if state is not None else (None, None)
    xi, z = torch.matmul(x, p["in_proj"]).split(d_in, dim=-1)
    xc, new_conv = _causal_depthwise_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    proj = torch.matmul(xc, p["x_proj"])
    dt = _mamba_dt(p, proj[..., :dtr])
    y, h_final = ops.selective_scan(xc, dt, p["a_log"], proj[..., dtr:dtr + ds],
                                    proj[..., dtr + ds:], p["d_skip"], h0=ssm_state)
    y = y * F.silu(z)
    return torch.matmul(y, p["out_proj"]), (new_conv, h_final)


def mamba_step(cfg, p: dict, x_t: torch.Tensor, state):
    """x_t: [B,1,d]; state (conv [B,cw-1,di], ssm [B,di,ds] f32) -> (y [B,1,d],
    (conv', ssm)): the ssm state is the given tensor, updated in place; conv'
    is a new tensor."""
    d_in, dtr, ds, cw = mamba_dims(cfg)
    conv_state, ssm_state = state
    xi, z = torch.matmul(x_t, p["in_proj"]).split(d_in, dim=-1)      # [B,1,di]
    window = torch.cat([conv_state.to(xi.dtype), xi], dim=1)          # [B,cw,di]
    xc = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"].to(xi.dtype)) + p["conv_b"])
    proj = torch.matmul(xc, p["x_proj"])
    dt = _mamba_dt(p, proj[:, :dtr])
    y = ops.mamba_step(xc, dt, p["a_log"], proj[:, dtr:dtr + ds], proj[:, dtr + ds:],
                       p["d_skip"], ssm_state)
    y = y * F.silu(z[:, 0])
    return torch.matmul(y, p["out_proj"])[:, None], (window[:, 1:], ssm_state)


def mamba_state_specs(cfg, batch: int, stack: Tuple[int, ...] = ()):
    d_in, _, ds, cw = mamba_dims(cfg)
    sa = ("layers",) * len(stack)
    return {
        "conv": ParamSpec((*stack, batch, cw - 1, d_in), torch_dtype(cfg.dtype),
                          (*sa, "batch", None, "ffn"), zeros_init()),
        "ssm": ParamSpec((*stack, batch, d_in, ds), torch.float32,
                         (*sa, "batch", "ffn", None), zeros_init()),
    }


# ============================================================================ mLSTM

def mlstm_dims(cfg):
    d = cfg.d_model
    d_in = 2 * d           # pre-up-projection factor 2 (xLSTM)
    H = cfg.n_heads
    dk = d // H            # qk head dim
    dv = d_in // H         # value head dim
    return d_in, H, dk, dv


def mlstm_specs(cfg, dtype, stack: Tuple[int, ...] = ()):
    d = cfg.d_model
    d_in, H, dk, dv = mlstm_dims(cfg)
    cw = 4
    sa = ("layers",) * len(stack)
    return {
        "w_up": dense_spec(d, d_in, ("embed", "ffn"), dtype, stack=stack),
        "w_z": dense_spec(d, d_in, ("embed", "ffn"), dtype, stack=stack),
        "conv_w": ParamSpec((*stack, cw, d_in), dtype, (*sa, "conv", "ffn"),
                            normal_init(1.0, fan_in_axis=len(stack))),
        "conv_b": bias_spec(d_in, "ffn", dtype, stack=stack),
        "w_q": dense_spec(d_in, H * dk, ("ffn", "heads_flat"), dtype, stack=stack),
        "w_k": dense_spec(d_in, H * dk, ("ffn", "heads_flat"), dtype, stack=stack),
        "w_i": dense_spec(d_in, H, ("ffn", None), dtype, stack=stack),
        "w_f": ParamSpec((*stack, d_in, H), dtype, (*sa, "ffn", None),
                         normal_init(1.0, fan_in_axis=len(stack))),
        "f_bias": ParamSpec((*stack, H), torch.float32, (*sa, None), const_init(3.0)),
        "hn_scale": ParamSpec((*stack, d_in), dtype, (*sa, "ffn"), ones_init()),
        "w_down": dense_spec(d_in, d, ("ffn", "embed"), dtype, stack=stack),
    }


def _mlstm_qkvif(cfg, p, x):
    return torch.matmul(x, p["w_up"]), torch.matmul(x, p["w_z"])


def mlstm_forward(cfg, p: dict, x: torch.Tensor, state=None):
    """x: [B,S,d] -> (y [B,S,d], (C, n, m, conv_hist))."""
    d_in, H, dk, dv = mlstm_dims(cfg)
    B, S, _ = x.shape
    xi, z = _mlstm_qkvif(cfg, p, x)
    conv_hist = state[3] if state is not None else None
    xc, new_conv = _causal_depthwise_conv(xi, p["conv_w"], p["conv_b"], conv_hist)
    xc = F.silu(xc)
    q = torch.matmul(xc, p["w_q"]).reshape(B, S, H, dk)
    k = torch.matmul(xc, p["w_k"]).reshape(B, S, H, dk)
    v = xi.reshape(B, S, H, dv)                          # the pre-conv branch
    i_raw = torch.matmul(xc, p["w_i"])
    f_raw = torch.matmul(xc, p["w_f"]).float() + p["f_bias"]
    core_state = None if state is None else tuple(state[:3])
    h, (C, n, m) = ops.mlstm(q, k, v, i_raw, f_raw, state=core_state)
    h = rms_norm(h.reshape(B, S, d_in), p["hn_scale"]) * F.silu(z)
    return torch.matmul(h, p["w_down"]), (C, n, m, new_conv)


def mlstm_decode_step(cfg, p: dict, x_t: torch.Tensor, state):
    """x_t: [B,1,d]; state (C, n, m, conv_hist) -> (y [B,1,d], state'), where
    C, n, m are the given tensors, updated in place (f32)."""
    d_in, H, dk, dv = mlstm_dims(cfg)
    B = x_t.shape[0]
    xi, z = _mlstm_qkvif(cfg, p, x_t)                                  # [B,1,d_in]
    C0, n0, m0, conv_hist = state
    window = torch.cat([conv_hist, xi], dim=1)                        # [B,cw,d_in]
    xc = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"])
    q = torch.matmul(xc, p["w_q"]).reshape(B, H, dk)
    k = torch.matmul(xc, p["w_k"]).reshape(B, H, dk)
    v = xi[:, 0].reshape(B, H, dv)
    i_raw = torch.matmul(xc, p["w_i"])
    f_raw = torch.matmul(xc, p["w_f"]).float() + p["f_bias"]
    h = ops.mlstm_step(q, k, v, i_raw, f_raw, (C0, n0, m0))
    h = rms_norm(h.reshape(B, d_in), p["hn_scale"]) * F.silu(z[:, 0])
    return torch.matmul(h, p["w_down"])[:, None], (C0, n0, m0, window[:, 1:])


def mlstm_state_specs(cfg, batch: int, stack: Tuple[int, ...] = ()):
    d_in, H, dk, dv = mlstm_dims(cfg)
    sa = ("layers",) * len(stack)
    return {
        "C": ParamSpec((*stack, batch, H, dk, dv), torch.float32,
                       (*sa, "batch", "heads", "state", None), zeros_init()),
        "n": ParamSpec((*stack, batch, H, dk), torch.float32,
                       (*sa, "batch", "heads", "state"), zeros_init()),
        "m": ParamSpec((*stack, batch, H), torch.float32, (*sa, "batch", "heads"),
                       const_init(ref.NEG_INF)),
        "conv": ParamSpec((*stack, batch, 3, d_in), torch_dtype(cfg.dtype),
                          (*sa, "batch", None, "ffn"), zeros_init()),
    }


# ============================================================================ sLSTM

def slstm_specs(cfg, dtype, stack: Tuple[int, ...] = ()):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    sa = ("layers",) * len(stack)
    return {
        "w_in": dense_spec(d, 4 * d, ("embed", "ffn"), dtype, stack=stack),
        "b_in": ParamSpec((*stack, 4 * d), torch.float32, (*sa, None), zeros_init()),
        "r": ParamSpec((*stack, H, dh, 4 * dh), dtype, (*sa, "heads", None, None),
                       normal_init(1.0, fan_in_axis=len(stack) + 1)),
        "hn_scale": ParamSpec((*stack, d), dtype, (*sa, None), ones_init()),
        "w_out": dense_spec(d, d, ("embed", "embed"), dtype, stack=stack),
    }


def slstm_forward(cfg, p: dict, x: torch.Tensor, state=None):
    """x: [B,S,d] -> (y, (c,n,h,m)). Sequential (sLSTM is not parallelisable)."""
    B, S, d = x.shape
    if state is None:
        z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((B, d), ref.NEG_INF, dtype=torch.float32,
                                     device=x.device))
    gates = torch.matmul(x, p["w_in"])                                 # [B,S,4d]
    hs, *state = ops.slstm_scan(gates, p["r"], p["b_in"], *state)
    h = rms_norm(hs.to(x.dtype), p["hn_scale"])
    return torch.matmul(h, p["w_out"]), tuple(state)


def slstm_step(cfg, p: dict, x_t: torch.Tensor, state):
    """x_t: [B,1,d] -> (y [B,1,d], state'): the scan over one step."""
    _, *new = ops.slstm_scan(torch.matmul(x_t, p["w_in"]), p["r"], p["b_in"], *state)
    h = rms_norm(new[2].to(x_t.dtype), p["hn_scale"])
    return torch.matmul(h, p["w_out"])[:, None], tuple(new)


def slstm_state_specs(cfg, batch: int, stack: Tuple[int, ...] = ()):
    d = cfg.d_model
    sa = ("layers",) * len(stack)
    axes = (*sa, "batch", "embed")
    return {
        "c": ParamSpec((*stack, batch, d), torch.float32, axes, zeros_init()),
        "n": ParamSpec((*stack, batch, d), torch.float32, axes, zeros_init()),
        "h": ParamSpec((*stack, batch, d), torch.float32, axes, zeros_init()),
        "m": ParamSpec((*stack, batch, d), torch.float32, axes, const_init(ref.NEG_INF)),
    }
