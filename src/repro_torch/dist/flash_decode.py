"""Distributed flash decoding: LSE-merge over a sequence-sharded KV cache.

Port of ``repro.dist.flash_decode``. For long-context decode the KV cache is
the dominant tensor; the ``serve_seqkv`` preset shards its *sequence* dim
across a mesh axis so every rank holds a contiguous S/N slice. Each rank
runs the decode kernel's stats entry (``ops.decode_attention_stats``: the
kernel's splits merged on the card, left unnormalised) over its local slice,
producing online-softmax partials (m, l, acc); the ranks then merge with the
standard log-sum-exp combine

    M = max_i m_i;   l = sum_i l_i e^{m_i - M};   acc = sum_i acc_i e^{m_i - M}

(an all-reduce MAX and two SUMs over the axis's process group), which
reconstructs the exact single-device softmax. A rank whose slice holds no
key of a row has m = NEG_INF there, so its weight is 0; a row with no key on
any rank comes out 0.

The JAX package runs the shard body under ``shard_map``; here it runs on
each rank's local tensors (``DTensor.to_local``) and wraps the output back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.collectives import WIRE, nbytes
from repro_torch.dist.sharding import Rules, replicated


def seq_shard_axis(rules: Optional[Rules], mesh, seq_len: int) -> Optional[str]:
    """The mesh axis the active rules shard a ``kv_seq`` dim of ``seq_len``
    over, or None (replicated cache -> ordinary single-device decode path)."""
    if rules is None or mesh is None:
        return None
    part = rules.spec(("kv_seq",), (int(seq_len),))[0]
    if part is None:
        return None
    names = (part,) if isinstance(part, str) else tuple(part)
    if len(names) != 1:
        return None         # only single-axis sequence sharding is supported
    return names[0]


def decode_attention_seqsharded(q, k_cache, v_cache, length, mesh=None,
                                axis: Optional[str] = None):
    """Decode attention over a cache whose seq dim is sharded along ``axis``.

    q: [B, Hq, D]; k_cache, v_cache: [B, S, Hkv, D] (S divisible by the axis
    size), DTensors or plain tensors every rank holds whole (laid out here);
    the cache may also be sharded over the batch on other mesh axes, never
    over heads. length: int, or int32 [] / [B]. Returns [B, Hq, D] as a
    DTensor laid out as the cache's batch, matching
    ``kernels.ref.decode_attention`` on the unsharded cache.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import ops

    if mesh is None or axis is None:
        raise ValueError("decode_attention_seqsharded needs a mesh and an axis")
    ax = tuple(mesh.mesh_dim_names).index(axis)
    n_shards = mesh.size(ax)
    B, S = k_cache.shape[0], k_cache.shape[1]
    if S % n_shards != 0:
        raise ValueError(f"cache seq {S} not divisible by {axis}={n_shards}")
    if isinstance(k_cache, DTensor):
        cache_pl = list(k_cache.placements)
    else:
        cache_pl = [Replicate()] * mesh.ndim
    cache_pl[ax] = Shard(1)
    if any(p.is_shard() and p.dim not in (0, 1) for p in cache_pl):
        raise ValueError(f"a seq-sharded cache shards batch and seq only: {cache_pl}")
    # q and the lengths: the cache's batch layout, whole over the seq axis
    row_pl = [Replicate() if i == ax else p for i, p in enumerate(cache_pl)]
    k = replicated(k_cache, mesh).redistribute(mesh, cache_pl).to_local()
    v = replicated(v_cache, mesh).redistribute(mesh, cache_pl).to_local()
    qd = replicated(q, mesh).redistribute(mesh, row_pl)
    lengths = torch.as_tensor(length, dtype=torch.int32, device=k.device).expand(B)
    lengths = replicated(lengths.contiguous(), mesh).redistribute(mesh, row_pl).to_local()

    s_local = k.shape[1]
    offset = mesh.get_local_rank(ax) * s_local
    local_len = torch.clamp(lengths - offset, 0, s_local).to(torch.int32)
    m, l, acc = ops.decode_attention_stats(qd.to_local(), k, v, local_len)
    group = mesh.get_group(ax)
    g_m = m.clone()
    dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - g_m)                       # 0 for empty shards (m = NEG_INF)
    l_g = l * w
    acc_g = acc * w[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(acc_g, group=group)
    WIRE.add("all_reduce", 2 * (nbytes(g_m) + nbytes(l_g) + nbytes(acc_g)))
    l_safe = torch.where(l_g == 0, 1.0, l_g)
    ql = qd.to_local()
    out = (acc_g / l_safe[..., None]).reshape(ql.shape).to(ql.dtype)   # [B, Hq, D]
    return DTensor.from_local(out, mesh, row_pl, run_check=False)
