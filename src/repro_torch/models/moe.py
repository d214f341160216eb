"""Top-k routed mixture-of-experts (port of ``repro.models.moe``): sort-based
dispatch with GShard-style capacity.

Dispatch: flatten tokens -> top-k expert ids -> stable argsort by expert ->
position-in-expert via searchsorted -> a dense [E, C, d] buffer gathered
from the sorted entries (what capacity drops stays out) -> batched expert
GEMMs -> gather-combine
with the router gates, in the model dtype, summed per token in a fixed
order. The [E, ...] axes carry the 'experts' logical axis, so expert
parallelism is a sharding-rule choice.

Two dispatch modes, as in the JAX package (selected by the sharding rules):
the global dispatch over all tokens, and under ``moe_dispatch: local`` the
per-data-shard dispatch (``_moe_forward_local``): tokens reshape to
[shards, T/shards, d], sort, capacity and combine run per shard (on a mesh,
on each rank's own shards: nothing crosses ranks), and the only resharding
is the dispatched [E, shards*C, d] buffer going to the experts' layout and
back. Without a mesh it runs the same per-shard math on one device.

Shared experts and the dense residual MLP (Kimi, Arctic) are kept, as in the
JAX module; the stack-level variants (first-k-dense layers, MoE every Nth
layer) live in ``models.transformer``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import active_rules, constrain, is_dtensor
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


def _dispatch_shards(batch: int) -> int:
    """How many ways the token stream is split for local dispatch (1 = global)."""
    rules = active_rules()
    if rules is None or rules.mapping.get("moe_dispatch") != "local":
        return 1
    part = rules.spec(("batch",), (batch,))[0]
    if part is None:
        return 1
    names = (part,) if isinstance(part, str) else part
    n = 1
    for name in names:
        n *= rules.mesh_axis_sizes.get(name, 1)
    return n


def _expert_gemms(cfg, p, xg):
    """xg: [E, C, d] -> [E, C, d] through the (gated) expert MLPs."""
    if "w_gate" in p:
        g = torch.matmul(xg, p["w_gate"])
        u = torch.matmul(xg, p["w_up"])
        g = constrain(g, "experts", None, "expert_ffn")
        h = (F.silu(g) if cfg.act == "swiglu" else _gelu(g)) * u
    else:
        h = constrain(torch.matmul(xg, p["w_up"]), "experts", None, "expert_ffn")
        h = _gelu(h)
    return constrain(torch.matmul(h, p["w_down"]), "experts", None, None)


def moe_forward(cfg, p: dict, x: torch.Tensor, *, capacity_factor: float,
                with_aux: bool = True):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32). With
    ``with_aux=False`` the aux loss is not computed and comes back as None:
    prefill and decode discard it (XLA drops the dead computation in the JAX
    package; ``torch.export`` would keep it in the serve program)."""
    shards = _dispatch_shards(x.shape[0])
    if shards > 1:
        return _moe_forward_local(cfg, p, x, capacity_factor, shards, with_aux=with_aux)
    return _moe_forward_global(cfg, p, x, capacity_factor, with_aux=with_aux)


def _moe_forward_global(cfg, p: dict, x: torch.Tensor, capacity_factor: float, *,
                        with_aux: bool = True):
    """One argsort and capacity over all tokens. On a mesh every rank
    routes all the tokens (the sort is global), and only the expert GEMMs
    run sharded."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    xt, wrap = _whole(x.reshape(T, d))
    router, _ = _whole(p["router"])

    # ---- routing (f32) ----
    logits = torch.matmul(xt.float(), router)                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)               # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    aux = None
    if with_aux:        # load-balance aux (Switch/GShard) + router z-loss
        me = probs.mean(dim=0)                                         # [E]
        ce = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
        aux = E * torch.sum(me * ce) * m.router_aux_weight
        aux = wrap(aux + 1e-3 * torch.mean(torch.square(torch.logsumexp(logits, dim=-1))))

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
    out = _expert_gemms(cfg, p, constrain(wrap(buf), "experts", None, None))  # [E, C, d]
    out, _ = _whole(out)

    # ---- combine, in the model dtype (gates sum to 1: <= top_k terms) ----
    # The JAX package scatter-adds the sorted terms into their tokens; here
    # they go back to (token, choice) order and each token's k terms are
    # summed, in an order fixed by the data: ``index_add_`` on CUDA adds with
    # atomics in any order, and past two terms the bf16 sum then varies run
    # to run (top-8 Kimi), where deploy checks tokens bit for bit.
    flat = out.reshape(E * C, d)
    contrib = torch.where(keep[:, None], flat[torch.clamp(slot, max=E * C - 1)], 0)
    contrib = (contrib * fg_s[:, None].to(contrib.dtype)).to(x.dtype)
    y = wrap(contrib[torch.argsort(order)].reshape(T, k, d).sum(dim=1))

    # ---- always-on paths ----
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x).reshape(T, d)
    if "dense" in p:
        y = y + apply_mlp(cfg, p["dense"], x).reshape(T, d)
    return constrain(y.reshape(B, S, d).to(x.dtype), "batch", "seq", "embed"), aux


def _whole(x):
    """(``x`` whole on this rank, a function that wraps a tensor every rank
    holds whole as a replicated DTensor on ``x``'s mesh); a plain tensor is
    whole already."""
    if not is_dtensor(x):
        return x, lambda t: t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    return (x.redistribute(mesh, rep).to_local(),
            lambda t: DTensor.from_local(t, mesh, rep, run_check=False))


def _on_local(x):
    """(``x``'s local tensor, a function that wraps a local tensor laid out
    as ``x``'s back); a plain tensor is its own local tensor."""
    if not is_dtensor(x):
        return x, lambda t: t
    from torch.distributed.tensor import DTensor
    mesh, pl = x.device_mesh, x.placements
    return x.to_local(), lambda t: DTensor.from_local(t, mesh, pl, run_check=False)


def _moe_forward_local(cfg, p: dict, x: torch.Tensor, capacity_factor: float, shards: int,
                       *, with_aux: bool = True):
    """Per-data-shard dispatch: sort, capacity and combine per shard of
    T/shards tokens; between them the dispatched buffer goes to the
    experts' layout and back. On a mesh each rank runs the per-shard steps
    on the shards it holds."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    if T % shards:
        raise ValueError(f"{T} tokens do not split into {shards} dispatch shards")
    Tl = T // shards
    C = expert_capacity(Tl, E, k, capacity_factor)
    xt = constrain(x.reshape(shards, Tl, d), "batch", None, None)   # leading dim = shards
    xl, wrap = _on_local(xt)
    G, dev = xl.shape[0], xl.device
    router, _ = _whole(p["router"])

    # ---- routing (f32, batched over the shards) ----
    logits = torch.matmul(xl.float(), router)                          # [G, Tl, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)               # [G, Tl, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    aux = None
    if with_aux:        # over all shards' tokens: means of the wrapped per-shard terms
        me = wrap(probs).mean(dim=(0, 1))
        ce = wrap(F.one_hot(expert_idx, E).float().sum(dim=2)).mean(dim=(0, 1))
        aux = E * torch.sum(me * ce) * m.router_aux_weight
        lse = torch.logsumexp(logits, dim=-1)
        aux = aux + 1e-3 * torch.mean(torch.square(wrap(lse)))

    # ---- per-shard sort-based dispatch (rows independent) ----
    fe = expert_idx.reshape(G, Tl * k)
    ftok = torch.arange(Tl, device=dev).repeat_interleave(k).expand(G, Tl * k)
    fgate = gate_vals.reshape(G, Tl * k)
    order = torch.argsort(fe, dim=1, stable=True)
    fe_s = torch.take_along_dim(fe, order, dim=1)
    ftok_s = torch.take_along_dim(ftok, order, dim=1)
    fg_s = torch.take_along_dim(fgate, order, dim=1)
    starts = torch.searchsorted(fe_s, torch.arange(E, device=dev, dtype=fe_s.dtype)
                                .expand(G, E).contiguous())            # [G, E]
    pos_in_e = torch.arange(Tl * k, device=dev) - torch.take_along_dim(starts, fe_s, dim=1)
    keep = pos_in_e < C
    slot = torch.where(keep, fe_s * C + pos_in_e, E * C)               # E*C = trash row

    # the dispatch buffer by gathers, as the global dispatch builds it
    ends = torch.cat([starts[:, 1:], starts.new_full((G, 1), Tl * k)], dim=1)
    src = starts[..., None] + torch.arange(C, device=dev)              # [G, E, C]
    filled = src < ends[..., None]
    tok = torch.take_along_dim(ftok_s, torch.clamp(src, max=Tl * k - 1).reshape(G, E * C),
                               dim=1)
    buf = torch.take_along_dim(xl, tok[..., None], dim=1).reshape(G, E, C, d)
    xg = wrap(torch.where(filled[..., None], buf, 0))                  # [shards, E, C, d]

    # ---- to the experts' layout and back ----
    xe = constrain(xg.transpose(0, 1).reshape(E, shards * C, d), "experts", None, None)
    out_e = _expert_gemms(cfg, p, xe)                                  # [E, shards*C, d]
    out = out_e.reshape(E, shards, C, d).transpose(0, 1).reshape(shards, E * C, d)
    out, _ = _on_local(constrain(out, "batch", None, None))

    # ---- per-shard combine, in the model dtype, each token's k terms in
    # (token, choice) order (no atomics) ----
    contrib = torch.take_along_dim(out, torch.clamp(slot, max=E * C - 1)[..., None], dim=1)
    contrib = torch.where(keep[..., None], contrib, 0)
    contrib = (contrib * fg_s[..., None].to(contrib.dtype)).to(x.dtype)
    inv = torch.argsort(order, dim=1)
    y = torch.take_along_dim(contrib, inv[..., None], dim=1).reshape(G, Tl, k, d).sum(dim=2)
    y = wrap(y)                                                         # [shards, Tl, d]

    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x).reshape(shards, Tl, d)
    if "dense" in p:
        y = y + apply_mlp(cfg, p["dense"], x).reshape(shards, Tl, d)
    return constrain(y.reshape(B, S, d).to(x.dtype), "batch", "seq", "embed"), aux
