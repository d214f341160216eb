"""GQA attention in two modes: full sequence (prefill, returns K/V) and cached decode.

Port of ``repro.models.attention`` (``attention_full`` with cross-attention,
``attention_decode`` with cross decode and the sequence-sharded branch, and
``attention_decode_paged``), with the JAX package's ``constrain`` annotations.
Under sharding rules whose ``kv_seq`` shards the cache (``serve_seqkv``),
``attention_decode`` runs distributed flash decoding
(``repro_torch.dist.flash_decode``).

``attention_decode`` and ``attention_decode_paged`` write the new K/V into
the cache or the page pool **in place** and return the same tensors (the JAX
versions return updated copies): a per-step copy of the cache, or of a
layer's page pool, would be bandwidth the decode step does not need. A cache
that is a DTensor is written through each rank's local shard (DTensor has no
rule for writing a slice of a sharded dim): the token's K/V land at
``pos - offset`` on the rank whose slice of the sequence holds ``pos``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist.flash_decode import decode_attention_seqsharded, seq_shard_axis
from repro_torch.dist.sharding import (
    active_rules, constrain, current_mesh, flatten_last, is_dtensor, replicated,
    unflatten_last,
)
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
    q = torch.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return unflatten_last(q, cfg.n_heads, cfg.resolved_head_dim)


def _proj_kv(cfg, p, x):
    hd = cfg.resolved_head_dim
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return unflatten_last(k, cfg.n_kv_heads, hd), unflatten_last(v, cfg.n_kv_heads, hd)


def _out(cfg, p, o):
    y = torch.matmul(flatten_last(o), p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    return constrain(y, "batch", "seq", "embed")


def attention_full(cfg, p: dict, x: torch.Tensor, rope, *, causal: bool = True,
                   q_offset: int = 0, kv_from: Optional[torch.Tensor] = None):
    """Full-sequence attention; ``rope`` is the pass's ``positional_tables``
    (or None). ``kv_from``: the encoder output [B,Se,d] for cross-attention,
    whose K/V take no rotary and are attended bidirectionally. Returns
    (y [B,S,d], (k, v)) — k/v handed back so prefill can fill the cache."""
    q = _proj_q(cfg, p, x)
    k, v = _proj_kv(cfg, p, x if kv_from is None else kv_from)
    if kv_from is None and rope is not None:
        q, k = rotate(q, rope), rotate(k, rope)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "kv_seq", "kv_heads", "head_dim")
    o = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal and kv_from is None, q_offset=q_offset)
    return _out(cfg, p, o), (k, v)


def attention_decode(cfg, p: dict, x_t: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, rope, *, cross: bool = False):
    """One-token attention against a cache, writing the token's K/V at ``pos``.

    x_t: [B,1,d]; k_cache/v_cache: [B,S,nkv,hd] (contiguous, updated in
    place); pos: int (next position, lock-step batch) or int32 tensor [B]
    (per-row positions); rope: ``positional_tables`` of ``decode_positions``
    (or None). With ``cross`` the caches hold the encoder's K/V: nothing is
    written, and the token attends to all S positions. Returns
    (y [B,1,d], k_cache, v_cache).
    """
    B = x_t.shape[0]
    q = _proj_q(cfg, p, x_t)                                          # [B,1,nq,hd]
    if cross:
        length = k_cache.shape[1]
    else:
        k_t, v_t = _proj_kv(cfg, p, x_t)                              # [B,1,nkv,hd]
        if rope is not None:
            q, k_t = rotate(q, rope), rotate(k_t, rope)
        if is_dtensor(k_cache):
            _write_local(k_cache, pos, k_t)
            _write_local(v_cache, pos, v_t)
            length = pos + 1
        elif isinstance(pos, int):
            k_cache[:, pos:pos + 1] = k_t             # copy_ casts to the cache dtype
            v_cache[:, pos:pos + 1] = v_t
            length = torch.full((B,), pos + 1, dtype=torch.int32, device=x_t.device)
        else:
            rows = torch.arange(B, device=x_t.device)
            k_cache[rows, pos] = k_t[:, 0]
            v_cache[rows, pos] = v_t[:, 0]
            length = (pos + 1).to(torch.int32)
    k_cache = constrain(k_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    v_cache = constrain(v_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    # distributed flash decoding when the cache sequence dim is mesh-sharded
    mesh = current_mesh()
    axis = seq_shard_axis(active_rules(), mesh, k_cache.shape[1])
    if axis is not None:
        o = decode_attention_seqsharded(q[:, 0], k_cache, v_cache, length, mesh, axis)
    else:
        o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, length)  # [B,nq,hd]
    return _out(cfg, p, o[:, None]), k_cache, v_cache


def _write_local(cache, pos, tok) -> None:
    """Write ``tok`` [B,1,nkv,hd] at position ``pos`` (an int) of a DTensor
    cache [B,S,nkv,hd], through the local shard of each rank: the token is
    laid out as the cache but whole along the sequence, and the rank whose
    slice of the sequence holds ``pos`` writes it at ``pos - offset``."""
    from torch.distributed.tensor import Replicate

    if not isinstance(pos, int):
        raise NotImplementedError("a DTensor cache takes one position for every row")
    mesh, pl = cache.device_mesh, cache.placements
    local = cache.to_local()
    offset = 0
    for i, p in enumerate(pl):
        if p.is_shard(1):
            offset += mesh.get_local_rank(i) * local.shape[1]
    tok_pl = [Replicate() if p.is_shard(1) else p for p in pl]
    tok = replicated(tok, mesh).redistribute(mesh, tok_pl).to_local()
    if offset <= pos < offset + local.shape[1]:
        local[:, pos - offset:pos - offset + 1] = tok


def attention_decode_paged(cfg, p: dict, x_t: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, rope):
    """One-token attention through a page table (continuous batching).

    x_t: [B,1,d]; k_pages/v_pages: [P,page_size,nkv,hd], one layer's view of
    the shared pool (contiguous, updated in place); page_table: int32
    [B,max_pages]; pos: int32 [B] per-row positions; rope:
    ``positional_tables`` of ``decode_positions`` (or None). Writes each row's
    new K/V at ``page_table[row, pos // page_size]``, offset
    ``pos % page_size`` (an empty slot's all-zero table row sends its write to
    the null page 0), then attends through the table up to ``pos + 1``.
    Returns (y [B,1,d], k_pages, v_pages).
    """
    B = x_t.shape[0]
    page_size = k_pages.shape[1]
    q = _proj_q(cfg, p, x_t)                                          # [B,1,nq,hd]
    k_t, v_t = _proj_kv(cfg, p, x_t)                                  # [B,1,nkv,hd]
    if rope is not None:
        q, k_t = rotate(q, rope), rotate(k_t, rope)
    pos = pos.long()
    page = page_table[torch.arange(B, device=x_t.device), pos // page_size].long()
    off = pos % page_size
    k_pages[page, off] = k_t[:, 0].to(k_pages.dtype)
    v_pages[page, off] = v_t[:, 0].to(v_pages.dtype)
    o = ops.paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages, page_table,
                                   pos + 1)                           # [B,nq,hd]
    return _out(cfg, p, o[:, None]), k_pages, v_pages


def decode_positions(batch: int, pos, device, mrope: bool = False) -> torch.Tensor:
    """[B, 1] int32 positions of a decode step at ``pos`` (int or [B]); with
    ``mrope`` the same ids on all three M-RoPE axes, [3, B, 1]."""
    if isinstance(pos, int):
        base = torch.full((batch, 1), pos, dtype=torch.int32, device=device)
    else:
        base = pos.to(torch.int32).reshape(batch, 1)
    return base.expand(3, batch, 1) if mrope else base
