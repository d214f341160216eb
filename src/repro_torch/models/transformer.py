"""Layer stack of the uniform dense family (port of ``repro.models.transformer``).

The JAX package scans over the stacked ``[L, ...]`` layer leaves; here a
Python loop walks views of the same leaves (``leaf[i]`` is a view, nothing is
copied). The other stack families (MoE, jamba, xlstm, encoder-decoder) are
later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch import pytree
from repro_torch.dtypes import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamSpec, apply_mlp, apply_norm, mlp_specs, norm_specs, positional_tables,
)


def _slice(tree, i: int):
    return pytree.tree_map(lambda a: a[i], tree)


def split_layers(sp) -> dict:
    """``sp`` with its stacked ``layers`` leaves cut into a list of per-layer
    views (no copy). The layer loops take either form; a traced program that
    runs many passes cuts once instead of once per pass."""
    layers = sp["layers"]
    if isinstance(layers, list):
        return sp
    n = pytree.leaves(layers)[0].shape[0]
    return {**sp, "layers": [_slice(layers, i) for i in range(n)]}


def _layer(sp, i: int):
    layers = sp["layers"]
    return layers[i] if isinstance(layers, list) else _slice(layers, i)


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

