"""GQA attention in two modes: full sequence (prefill, returns K/V) and cached decode.

Port of ``repro.models.attention`` (``attention_full`` and
``attention_decode``). The sequence-sharded decode branch and the paged
decode come with later slices.

``attention_decode`` writes the new K/V into the cache **in place** and
returns the same tensors (the JAX version returns updated copies): a
per-step copy of the cache would be bandwidth the decode step does not need.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import bias_spec, dense_spec, rotate


def attention_specs(cfg, dtype, stack: Tuple[int, ...] = ()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": dense_spec(d, nq * hd, ("embed", "heads_flat"), dtype, stack=stack),
        "wk": dense_spec(d, nkv * hd, ("embed", "kv_flat"), dtype, stack=stack),
        "wv": dense_spec(d, nkv * hd, ("embed", "kv_flat"), dtype, stack=stack),
        "wo": dense_spec(nq * hd, d, ("heads_flat", "embed"), dtype, stack=stack),
    }
    if cfg.qkv_bias:
        s["bq"] = bias_spec(nq * hd, "heads_flat", dtype, stack=stack)
        s["bk"] = bias_spec(nkv * hd, "kv_flat", dtype, stack=stack)
        s["bv"] = bias_spec(nkv * hd, "kv_flat", dtype, stack=stack)
    if cfg.mlp_bias:
        s["bo"] = bias_spec(d, None, dtype, stack=stack)
    return s


def _proj_q(cfg, p, x):
    B, S, _ = x.shape
    q = torch.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)


def _proj_kv(cfg, p, x):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k.reshape(B, S, cfg.n_kv_heads, hd), v.reshape(B, S, cfg.n_kv_heads, hd)


def _out(cfg, p, o):
    B, S = o.shape[:2]
    y = torch.matmul(o.reshape(B, S, -1), p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    return y


def attention_full(cfg, p: dict, x: torch.Tensor, rope, *, causal: bool = True,
                   q_offset: int = 0):
    """Full-sequence self-attention; ``rope`` is the pass's
    ``positional_tables`` (or None). Returns (y [B,S,d], (k, v)) — k/v handed
    back so prefill can fill the cache."""
    q = _proj_q(cfg, p, x)
    k, v = _proj_kv(cfg, p, x)
    if rope is not None:
        q, k = rotate(q, rope), rotate(k, rope)
    o = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, q_offset=q_offset)
    return _out(cfg, p, o), (k, v)


def attention_decode(cfg, p: dict, x_t: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, rope):
    """One-token attention against a cache, writing the token's K/V at ``pos``.

    x_t: [B,1,d]; k_cache/v_cache: [B,S,nkv,hd] (contiguous, updated in
    place); pos: int (next position, lock-step batch) or int32 tensor [B]
    (per-row positions); rope: ``positional_tables`` of ``decode_positions``
    (or None). Returns (y [B,1,d], k_cache, v_cache).
    """
    B = x_t.shape[0]
    q = _proj_q(cfg, p, x_t)                                          # [B,1,nq,hd]
    k_t, v_t = _proj_kv(cfg, p, x_t)                                  # [B,1,nkv,hd]
    if rope is not None:
        q, k_t = rotate(q, rope), rotate(k_t, rope)
    if isinstance(pos, int):
        k_cache[:, pos:pos + 1] = k_t                 # copy_ casts to the cache dtype
        v_cache[:, pos:pos + 1] = v_t
        length = torch.full((B,), pos + 1, dtype=torch.int32, device=x_t.device)
    else:
        rows = torch.arange(B, device=x_t.device)
        k_cache[rows, pos] = k_t[:, 0]
        v_cache[rows, pos] = v_t[:, 0]
        length = (pos + 1).to(torch.int32)
    o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, length)  # [B,nq,hd]
    return _out(cfg, p, o[:, None]), k_cache, v_cache


def decode_positions(batch: int, pos, device) -> torch.Tensor:
    """[B, 1] int32 positions of a decode step at ``pos`` (int or [B])."""
    if isinstance(pos, int):
        return torch.full((batch, 1), pos, dtype=torch.int32, device=device)
    return pos.to(torch.int32).reshape(batch, 1)
