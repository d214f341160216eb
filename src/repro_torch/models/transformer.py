"""Layer stacks of the uniform dense and xLSTM families (port of
``repro.models.transformer``).

The JAX package scans over the stacked ``[L, ...]`` (xLSTM: ``[P, ...]``
periods) layer leaves; here a Python loop walks views of the same leaves
(``leaf[i]`` is a view, nothing is copied). The ``stack_*`` dispatchers pick
the family; the other families (MoE, jamba, encoder-decoder, the vision
frontend) are later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch import pytree
from repro_torch.dtypes import torch_dtype
from repro_torch.models import attention as attn
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
    views (no copy); for the xLSTM stack also each period's blocks. The layer
    loops take either form; a traced program that runs many passes cuts once
    instead of once per pass."""
    layers = sp["layers"]
    if isinstance(layers, list):
        return sp
    per = _split(layers)
    if "mlstm" in layers:                           # xLSTM periods: [P, period, ...]
        per = [{**pp, "ln": _split(pp["ln"]), "mlstm": _split(pp["mlstm"])} for pp in per]
    return {**sp, "layers": per}


def _layer(sp, i: int):
    layers = sp["layers"]
    return layers[i] if isinstance(layers, list) else _slice(layers, i)


def _block(tree, i: int):
    """Block ``i`` of a period's ``ln`` / ``mlstm`` (stacked, or split)."""
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
    if family_kind(cfg) == "xlstm":
        return xlstm_specs(cfg, dtype)
    return uniform_specs(cfg, dtype)


def stack_forward(cfg, sp, x, positions, mode: str):
    if family_kind(cfg) == "xlstm":
        return xlstm_forward(cfg, sp, x, mode)
    return uniform_forward(cfg, sp, x, positions, mode)


def stack_decode(cfg, sp, x_t, cache, pos):
    if family_kind(cfg) == "xlstm":
        return xlstm_decode(cfg, sp, x_t, cache)
    return uniform_decode(cfg, sp, x_t, cache, pos)


def split_cache(cfg, inner):
    """The decode state ``inner`` with its stacked leaves cut into per-layer
    (xLSTM: per-block) views, no copy, so that a traced program of many
    decode steps cuts once instead of once per step; writes through the views
    land in the stacked tensors. A K/V cache is returned as it is."""
    if family_kind(cfg) != "xlstm":
        return inner
    return {"mlstm": {key: [list(per) for per in leaf] for key, leaf in inner["mlstm"].items()},
            "slstm": {key: list(leaf) for key, leaf in inner["slstm"].items()}}


def stack_cache_specs(cfg, batch: int, capacity: int):
    if family_kind(cfg) == "xlstm":
        return xlstm_cache_specs(cfg, batch, capacity)
    return uniform_cache_specs(cfg, batch, capacity)
