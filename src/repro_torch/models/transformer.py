"""Layer stacks of the uniform dense, jamba and xLSTM families (port of
``repro.models.transformer``).

The JAX package scans over the stacked ``[L, ...]`` (jamba, xLSTM:
``[P, ...]`` periods) layer leaves; here a Python loop walks views of the
same leaves (``leaf[i]`` is a view, nothing is copied). The ``stack_*``
dispatchers pick the family; the other families (MoE on the uniform stack,
encoder-decoder, the vision frontend) are later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch import pytree
from repro_torch.dtypes import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    ParamSpec, apply_mlp, apply_norm, mlp_specs, norm_specs, positional_tables,
)


def _slice(tree, i: int):
    return pytree.tree_map(lambda a: a[i], tree)


def _split(tree) -> list:
    """A stacked tree cut along its leading axis into a list of views."""
    return [_slice(tree, i) for i in range(pytree.leaves(tree)[0].shape[0])]


def split_layers(sp) -> dict:
    """``sp`` with its stacked ``layers`` leaves cut into a list of per-layer
    views (no copy); for the jamba and xLSTM stacks also each period's
    blocks. The layer loops take either form; a traced program that runs many
    passes cuts once instead of once per pass."""
    layers = sp["layers"]
    if isinstance(layers, list):
        return sp
    per = _split(layers)
    if "mlstm" in layers or "mamba" in layers:      # periods: [P, n, ...] block leaves
        blocks = [key for key in _PERIOD_BLOCKS if key in layers]
        per = [{**pp, **{key: _split(pp[key]) for key in blocks}} for pp in per]
    return {**sp, "layers": per}


def _layer(sp, i: int):
    layers = sp["layers"]
    return layers[i] if isinstance(layers, list) else _slice(layers, i)


# the per-block leaves of a period stack, [P, n, ...]: xLSTM's, then jamba's
_PERIOD_BLOCKS = ("ln", "mlstm", "ln_mix", "ln_ffn", "mamba", "moe", "mlp")


def _block(tree, i: int):
    """Block ``i`` of a period's per-block leaves (stacked, or split)."""
    return tree[i] if isinstance(tree, list) else _slice(tree, i)


def _zeros_spec(shape, dtype, axes):
    return ParamSpec(tuple(shape), dtype, tuple(axes),
                     lambda gen, s, d: torch.zeros(s, dtype=d, device=gen.device))


def family_kind(cfg) -> str:
    if cfg.enc_dec:
        return "encdec"
    if cfg.ssm is not None:
        return "jamba" if cfg.ssm.kind == "mamba" else "xlstm"
    return "uniform"


def _require_uniform(cfg) -> None:
    kind = family_kind(cfg)
    if kind != "uniform" or cfg.moe is not None or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: {kind}{' moe' if cfg.moe else ''} stack not yet ported")


def make_positions(cfg, batch: int, seq: int, device=None):
    """Position ids for rope ([B,S] int32); None if cfg.rope == 'none'."""
    if cfg.rope == "none":
        return None
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope {cfg.rope!r} not yet ported")
    return torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)


# =============================================================== uniform stack

def uniform_specs(cfg, dtype):
    _require_uniform(cfg)
    L = cfg.n_layers
    return {"layers": {
        "ln1": norm_specs(cfg, dtype, stack=(L,)),
        "attn": attn.attention_specs(cfg, dtype, stack=(L,)),
        "ln2": norm_specs(cfg, dtype, stack=(L,)),
        "mlp": mlp_specs(cfg, dtype, stack=(L,)),
    }}


def _attn_block_full(cfg, p, x, rope):
    h = apply_norm(cfg, p["ln1"], x)
    a, kv = attn.attention_full(cfg, p["attn"], h, rope)
    x = x + a
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["mlp"], h2), kv


def uniform_forward(cfg, sp, x, positions, mode: str):
    """Returns (x, cache); cache = {"k", "v"} stacked [L,B,S,nkv,hd] when
    mode == "prefill", else None. (The JAX version also returns the MoE aux
    loss, which a dense stack does not have.)"""
    _require_uniform(cfg)
    rope = positional_tables(cfg, positions)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _attn_block_full(cfg, _layer(sp, i), x, rope)
        if mode == "prefill":
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if mode == "prefill" else None
    return x, cache


def uniform_decode(cfg, sp, x_t, cache, pos):
    """One decode step through every layer; ``cache`` ({"k", "v"} stacked
    [L,B,S,nkv,hd]) is updated in place and returned."""
    _require_uniform(cfg)
    rope = positional_tables(cfg, attn.decode_positions(x_t.shape[0], pos, x_t.device))
    for i in range(cfg.n_layers):
        p = _layer(sp, i)
        h = apply_norm(cfg, p["ln1"], x_t)
        a, _, _ = attn.attention_decode(cfg, p["attn"], h, cache["k"][i], cache["v"][i],
                                        pos, rope)
        x_t = x_t + a
        h2 = apply_norm(cfg, p["ln2"], x_t)
        x_t = x_t + apply_mlp(cfg, p["mlp"], h2)
    return x_t, cache


def uniform_cache_specs(cfg, batch: int, capacity: int):
    _require_uniform(cfg)
    L, hd, nkv = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": _zeros_spec((L, batch, capacity, nkv, hd), dt, kv_axes),
            "v": _zeros_spec((L, batch, capacity, nkv, hd), dt, kv_axes)}


def uniform_decode_paged(cfg, sp, x_t, k_pages, v_pages, page_table, pos):
    """Paged decode step for the uniform stack (continuous batching).

    k_pages/v_pages: [L, P, page_size, nkv, hd], one pool per layer sharing
    ONE page table (a logical page spans every layer, so the allocator
    accounts it once), written in place through the per-layer views
    ``k_pages[i]``; pos: int32 [B] per row. Returns (x_t, k_pages, v_pages).
    """
    _require_uniform(cfg)
    rope = positional_tables(cfg, attn.decode_positions(x_t.shape[0], pos, x_t.device))
    for i in range(cfg.n_layers):
        p = _layer(sp, i)
        h = apply_norm(cfg, p["ln1"], x_t)
        a, _, _ = attn.attention_decode_paged(cfg, p["attn"], h, k_pages[i], v_pages[i],
                                              page_table, pos, rope)
        x_t = x_t + a
        h2 = apply_norm(cfg, p["ln2"], x_t)
        x_t = x_t + apply_mlp(cfg, p["mlp"], h2)
    return x_t, k_pages, v_pages


def uniform_page_pool_specs(cfg, n_pages: int, page_size: int):
    """Zero-init page-pool specs for the uniform stack: K and V pools shaped
    [L, n_pages, page_size, nkv, hd] (page 0 is the reserved null page)."""
    _require_uniform(cfg)
    L, hd, nkv = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    axes = ("layers", None, "kv_seq", "kv_heads", "head_dim")
    return {"k_pages": _zeros_spec((L, n_pages, page_size, nkv, hd), dt, axes),
            "v_pages": _zeros_spec((L, n_pages, page_size, nkv, hd), dt, axes)}


def _require_paged(cfg) -> None:
    if family_kind(cfg) != "uniform":
        raise ValueError(
            f"paged decode supports the uniform stack only, not {family_kind(cfg)}")


def stack_decode_paged(cfg, sp, x_t, k_pages, v_pages, page_table, pos):
    _require_paged(cfg)
    return uniform_decode_paged(cfg, sp, x_t, k_pages, v_pages, page_table, pos)


def stack_page_pool_specs(cfg, n_pages: int, page_size: int):
    _require_paged(cfg)
    return uniform_page_pool_specs(cfg, n_pages, page_size)


# ================================================================= jamba stack

TRAIN_CF = 1.25   # MoE capacity factor (train)
EVAL_CF = 2.0     # MoE capacity factor (inference)


def _jamba_layout(cfg):
    """(period, P, moe_slots, mlp_slots): P periods of (period - 1) Mamba
    blocks and one attention block, MoE on every ``moe_every``-th slot."""
    period = cfg.ssm.attn_every
    P = cfg.n_layers // period
    me = cfg.moe.moe_every if cfg.moe else 0
    moe_slots = [i for i in range(period) if me and i % me == me - 1]
    mlp_slots = [i for i in range(period) if i not in moe_slots]
    return period, P, moe_slots, mlp_slots


def jamba_specs(cfg, dtype):
    period, P, moe_slots, mlp_slots = _jamba_layout(cfg)
    layer = {
        "ln_mix": norm_specs(cfg, dtype, stack=(P, period)),
        "ln_ffn": norm_specs(cfg, dtype, stack=(P, period)),
        "mamba": ssm.mamba_specs(cfg, dtype, stack=(P, period - 1)),
        "attn": attn.attention_specs(cfg, dtype, stack=(P,)),
    }
    if moe_slots:
        layer["moe"] = moe_mod.moe_specs(cfg, dtype, stack=(P, len(moe_slots)))
    if mlp_slots:
        layer["mlp"] = mlp_specs(cfg, dtype,
                                 d_ff=(cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff),
                                 stack=(P, len(mlp_slots)))
    return {"layers": layer}


def _jamba_ffn(cfg, pp, i, x, cf, moe_slots, mlp_slots, with_aux):
    """Slot ``i``'s feed-forward sublayer on the residual ``x`` -> (x', MoE
    aux loss or None)."""
    h = apply_norm(cfg, _block(pp["ln_ffn"], i), x)
    if i in moe_slots:
        y, aux = moe_mod.moe_forward(cfg, _block(pp["moe"], moe_slots.index(i)), h,
                                     capacity_factor=cf, with_aux=with_aux)
        return x + y, aux
    return x + apply_mlp(cfg, _block(pp["mlp"], mlp_slots.index(i)), h), None


def jamba_forward(cfg, sp, x, mode: str):
    """Returns (x, cache, aux); cache = {"conv", "ssm"} stacked [P, period-1,
    ...] and {"k", "v"} stacked [P, ...] when mode == "prefill", else None;
    aux is the MoE layers' summed auxiliary loss when mode == "train", else
    None (prefill discards it)."""
    period, P, moe_slots, mlp_slots = _jamba_layout(cfg)
    train = mode == "train"
    cf = TRAIN_CF if train else EVAL_CF
    aux = x.new_zeros((), dtype=torch.float32) if train else None
    convs, ssms, ks, vs = [], [], [], []
    for p_i in range(P):
        pp = _layer(sp, p_i)
        for i in range(period):
            h = apply_norm(cfg, _block(pp["ln_mix"], i), x)
            if i == period - 1:
                a, (k, v) = attn.attention_full(cfg, pp["attn"], h, None)
                ks.append(k)
                vs.append(v)
            else:
                a, (cs, hs) = ssm.mamba_forward(cfg, _block(pp["mamba"], i), h)
                convs.append(cs)
                ssms.append(hs)
            x, a_l = _jamba_ffn(cfg, pp, i, x + a, cf, moe_slots, mlp_slots, train)
            if a_l is not None:
                aux = aux + a_l
    if mode != "prefill":
        return x, None, aux
    n_mix = period - 1
    cache = {"conv": torch.stack(convs).unflatten(0, (P, n_mix)),
             "ssm": torch.stack(ssms).unflatten(0, (P, n_mix)),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache, aux


def jamba_decode(cfg, sp, x_t, cache, pos):
    """One decode step through every layer; ``cache`` (as prefill returns it,
    or as :func:`split_cache` cuts it) is updated in place and returned."""
    period, P, moe_slots, mlp_slots = _jamba_layout(cfg)
    for p_i in range(P):
        pp = _layer(sp, p_i)
        for i in range(period):
            h = apply_norm(cfg, _block(pp["ln_mix"], i), x_t)
            if i == period - 1:
                a, _, _ = attn.attention_decode(cfg, pp["attn"], h, cache["k"][p_i],
                                                cache["v"][p_i], pos, None)
            else:
                conv = cache["conv"][p_i][i]
                a, (conv2, _) = ssm.mamba_step(cfg, _block(pp["mamba"], i), h,
                                               (conv, cache["ssm"][p_i][i]))
                conv.copy_(conv2)                   # the ssm state was updated in place
            x_t, _ = _jamba_ffn(cfg, pp, i, x_t + a, EVAL_CF, moe_slots, mlp_slots, False)
    return x_t, cache


def jamba_cache_specs(cfg, batch: int, capacity: int):
    period, P, _, _ = _jamba_layout(cfg)
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {**ssm.mamba_state_specs(cfg, batch, stack=(P, period - 1)),
            "k": _zeros_spec((P, batch, capacity, nkv, hd), dt, kv_axes),
            "v": _zeros_spec((P, batch, capacity, nkv, hd), dt, kv_axes)}


# ================================================================= xlstm stack

def _xlstm_layout(cfg):
    """(period, P): P periods of (period - 1) mLSTM blocks and one sLSTM block."""
    period = min(cfg.ssm.slstm_every or cfg.n_layers, cfg.n_layers)
    return period, cfg.n_layers // period


def xlstm_specs(cfg, dtype):
    period, P = _xlstm_layout(cfg)
    return {"layers": {
        "ln": norm_specs(cfg, dtype, stack=(P, period)),
        "mlstm": ssm.mlstm_specs(cfg, dtype, stack=(P, period - 1)),
        "slstm": ssm.slstm_specs(cfg, dtype, stack=(P,)),
    }}


def xlstm_forward(cfg, sp, x, mode: str):
    """Returns (x, cache); cache = {"mlstm": {C, n, m, conv} stacked
    [P, period-1, ...], "slstm": {c, n, h, m} stacked [P, ...]} when mode ==
    "prefill", else None."""
    period, P = _xlstm_layout(cfg)
    periods = []
    for p_i in range(P):
        pp = _layer(sp, p_i)
        m_states, s_state = [], None
        for i in range(period):
            h = apply_norm(cfg, _block(pp["ln"], i), x)
            if i == period - 1:
                a, s_state = ssm.slstm_forward(cfg, pp["slstm"], h)
            else:
                a, m_st = ssm.mlstm_forward(cfg, _block(pp["mlstm"], i), h)
                m_states.append(m_st)
            x = x + a
        if mode == "prefill":
            periods.append((m_states, s_state))
    if mode != "prefill":
        return x, None
    cache = {
        "mlstm": {key: torch.stack([torch.stack([st[j] for st in m_states])
                                    for m_states, _ in periods])
                  for j, key in enumerate(("C", "n", "m", "conv"))},
        "slstm": {key: torch.stack([s_state[j] for _, s_state in periods])
                  for j, key in enumerate(("c", "n", "h", "m"))},
    }
    return x, cache


def xlstm_decode(cfg, sp, x_t, cache):
    """One decode step through every block; ``cache`` (as prefill returns it,
    or as :func:`split_cache` cuts it) is updated in place and returned."""
    period, P = _xlstm_layout(cfg)
    cm, cs = cache["mlstm"], cache["slstm"]
    for p_i in range(P):
        pp = _layer(sp, p_i)
        for i in range(period - 1):
            h = apply_norm(cfg, _block(pp["ln"], i), x_t)
            st = tuple(cm[key][p_i][i] for key in ("C", "n", "m", "conv"))
            a, st2 = ssm.mlstm_decode_step(cfg, _block(pp["mlstm"], i), h, st)
            st[3].copy_(st2[3])                     # C, n, m were updated in place
            x_t = x_t + a
        h = apply_norm(cfg, _block(pp["ln"], period - 1), x_t)
        st = tuple(cs[key][p_i] for key in ("c", "n", "h", "m"))
        a, st2 = ssm.slstm_step(cfg, pp["slstm"], h, st)
        for key, val in zip(("c", "n", "h", "m"), st2):
            cs[key][p_i].copy_(val)
        x_t = x_t + a
    return x_t, cache


def xlstm_cache_specs(cfg, batch: int, capacity: int):
    period, P = _xlstm_layout(cfg)
    return {
        "mlstm": ssm.mlstm_state_specs(cfg, batch, stack=(P, period - 1)),
        "slstm": ssm.slstm_state_specs(cfg, batch, stack=(P,)),
    }


# ================================================================== dispatchers

def stack_specs(cfg, dtype):
    kind = family_kind(cfg)
    if kind == "jamba":
        return jamba_specs(cfg, dtype)
    if kind == "xlstm":
        return xlstm_specs(cfg, dtype)
    return uniform_specs(cfg, dtype)


def stack_forward(cfg, sp, x, positions, mode: str):
    """Returns (x, cache); the jamba stack's MoE aux loss is dropped, as the
    JAX package's prefill drops it."""
    kind = family_kind(cfg)
    if kind == "jamba":
        return jamba_forward(cfg, sp, x, mode)[:2]
    if kind == "xlstm":
        return xlstm_forward(cfg, sp, x, mode)
    return uniform_forward(cfg, sp, x, positions, mode)


def stack_decode(cfg, sp, x_t, cache, pos):
    kind = family_kind(cfg)
    if kind == "jamba":
        return jamba_decode(cfg, sp, x_t, cache, pos)
    if kind == "xlstm":
        return xlstm_decode(cfg, sp, x_t, cache)
    return uniform_decode(cfg, sp, x_t, cache, pos)


def split_cache(cfg, inner):
    """The decode state ``inner`` with its stacked leaves cut into per-layer
    (jamba, xLSTM: per-block) views, no copy, so that a traced program of
    many decode steps cuts once instead of once per step; writes through the
    views land in the stacked tensors. A uniform K/V cache is returned as it
    is."""
    kind = family_kind(cfg)
    if kind == "jamba":
        return {"conv": [list(per) for per in inner["conv"]],
                "ssm": [list(per) for per in inner["ssm"]],
                "k": list(inner["k"]), "v": list(inner["v"])}
    if kind == "xlstm":
        return {"mlstm": {key: [list(per) for per in leaf]
                          for key, leaf in inner["mlstm"].items()},
                "slstm": {key: list(leaf) for key, leaf in inner["slstm"].items()}}
    return inner


def stack_cache_specs(cfg, batch: int, capacity: int):
    kind = family_kind(cfg)
    if kind == "jamba":
        return jamba_cache_specs(cfg, batch, capacity)
    if kind == "xlstm":
        return xlstm_cache_specs(cfg, batch, capacity)
    return uniform_cache_specs(cfg, batch, capacity)
