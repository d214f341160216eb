"""Top-k routed mixture-of-experts (port of ``repro.models.moe``): sort-based
dispatch with GShard-style capacity.

Dispatch: flatten tokens -> top-k expert ids -> stable argsort by expert ->
position-in-expert via searchsorted -> a dense [E, C, d] buffer gathered
from the sorted entries (what capacity drops stays out) -> batched expert
GEMMs -> gather-combine
with the router gates, in the model dtype, summed per token in a fixed
order. The JAX package's second mode, the per-data-shard dispatch
``_moe_forward_local``, runs only under sharding rules that ask for it; the
port runs on one device and has the global dispatch alone (ROADMAP A10).

Shared experts and the dense residual MLP (Kimi, Arctic) are kept, as in the
JAX module; the stack-level variants (first-k-dense layers, MoE every Nth
layer) live in ``models.transformer``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, _gelu, apply_mlp, mlp_specs, normal_init


def expert_capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    c = int(math.ceil(c / 8.0) * 8)                   # lane-friendly
    return max(8, min(c, max(n_tokens, 8)))


def moe_specs(cfg, dtype, stack: Tuple[int, ...] = ()):
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.n_experts
    sa = ("layers",) * len(stack)
    s = {
        "router": ParamSpec((*stack, d, E), torch.float32, (*sa, "embed", None),
                            normal_init(1.0, fan_in_axis=len(stack))),
        "w_up": ParamSpec((*stack, E, d, ff), dtype, (*sa, "experts", "embed", "expert_ffn"),
                          normal_init(1.0, fan_in_axis=len(stack) + 1)),
        "w_down": ParamSpec((*stack, E, ff, d), dtype, (*sa, "experts", "expert_ffn", "embed"),
                            normal_init(1.0, fan_in_axis=len(stack) + 1)),
    }
    if cfg.act in ("swiglu", "geglu"):
        s["w_gate"] = ParamSpec((*stack, E, d, ff), dtype,
                                (*sa, "experts", "embed", "expert_ffn"),
                                normal_init(1.0, fan_in_axis=len(stack) + 1))
    if m.n_shared_experts:
        s["shared"] = mlp_specs(cfg, dtype, d_ff=ff * m.n_shared_experts, stack=stack)
    if m.dense_residual:
        s["dense"] = mlp_specs(cfg, dtype, d_ff=m.d_ff_dense or cfg.d_ff, stack=stack)
    return s


def _expert_gemms(cfg, p, xg):
    """xg: [E, C, d] -> [E, C, d] through the (gated) expert MLPs."""
    if "w_gate" in p:
        g = torch.matmul(xg, p["w_gate"])
        u = torch.matmul(xg, p["w_up"])
        h = (F.silu(g) if cfg.act == "swiglu" else _gelu(g)) * u
    else:
        h = _gelu(torch.matmul(xg, p["w_up"]))
    return torch.matmul(h, p["w_down"])


def moe_forward(cfg, p: dict, x: torch.Tensor, *, capacity_factor: float,
                with_aux: bool = True):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32): the JAX package's
    global dispatch (``_moe_forward_global``). With ``with_aux=False`` the
    aux loss is not computed and comes back as None: prefill and decode
    discard it (XLA drops the dead computation in the JAX package;
    ``torch.export`` would keep it in the serve program)."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    xt = x.reshape(T, d)

    # ---- routing (f32) ----
    logits = torch.matmul(xt.float(), p["router"])                    # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)               # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    aux = None
    if with_aux:        # load-balance aux (Switch/GShard) + router z-loss
        me = probs.mean(dim=0)                                         # [E]
        ce = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
        aux = E * torch.sum(me * ce) * m.router_aux_weight
        aux = aux + 1e-3 * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- sort-based dispatch ----
    C = expert_capacity(T, E, k, capacity_factor)
    fe = expert_idx.reshape(T * k)
    ftok = torch.arange(T, device=x.device).repeat_interleave(k)
    fgate = gate_vals.reshape(T * k)
    order = torch.argsort(fe, stable=True)                             # priority = position
    fe_s, ftok_s, fg_s = fe[order], ftok[order], fgate[order]
    starts = torch.searchsorted(fe_s, torch.arange(E, device=x.device, dtype=fe_s.dtype))
    pos_in_e = torch.arange(T * k, device=x.device) - starts[fe_s]
    keep = pos_in_e < C
    slot = torch.where(keep, fe_s * C + pos_in_e, E * C)               # E*C = trash row

    # The dispatch buffer, by gathers: row (e, c) holds expert e's c-th
    # sorted entry when it has one (the buffer the JAX package scatters
    # into). An ``index_add_`` here goes through AOTInductor's op fallback
    # on CUDA, which passes its arguments wrong; a gather compiles to
    # generated code.
    ends = torch.cat([starts[1:], starts.new_full((1,), T * k)])
    src = starts[:, None] + torch.arange(C, device=x.device)[None, :]  # [E, C]
    filled = src < ends[:, None]
    buf = torch.where(filled[..., None], xt[ftok_s[torch.clamp(src, max=T * k - 1)]], 0)
    out = _expert_gemms(cfg, p, buf)                                   # [E, C, d]

    # ---- combine, in the model dtype (gates sum to 1: <= top_k terms) ----
    # The JAX package scatter-adds the sorted terms into their tokens; here
    # they go back to (token, choice) order and each token's k terms are
    # summed, in an order fixed by the data: ``index_add_`` on CUDA adds with
    # atomics in any order, and past two terms the bf16 sum then varies run
    # to run (top-8 Kimi), where deploy checks tokens bit for bit.
    flat = out.reshape(E * C, d)
    contrib = torch.where(keep[:, None], flat[torch.clamp(slot, max=E * C - 1)], 0)
    contrib = (contrib * fg_s[:, None].to(contrib.dtype)).to(x.dtype)
    y = contrib[torch.argsort(order)].reshape(T, k, d).sum(dim=1)

    # ---- always-on paths ----
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x).reshape(T, d)
    if "dense" in p:
        y = y + apply_mlp(cfg, p["dense"], x).reshape(T, d)
    return y.reshape(B, S, d).to(x.dtype), aux
