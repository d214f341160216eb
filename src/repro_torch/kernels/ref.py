"""Plain PyTorch versions of the attention kernels (port of ``repro.kernels.ref``).

The same chunked online-softmax math as the JAX references, with f32
accumulation. They are the port's oracle: the CPU path of the model runs them,
the tests hold them against the JAX package, and ``chip_smoke.py`` holds each
hand-written kernel against them on the card. The scans over blocks become
Python loops.

One deliberate difference from ``repro.kernels.ref.decode_attention`` (and
so from its ``paged_decode_attention``, which gathers and then applies it): V
is zeroed under the length mask before the PV product, as the Pallas kernels
do (``repro/kernels/decode_attention.py:59``,
``repro/kernels/paged_decode_attention.py:60-64``), so NaN in cache slots or
pages past ``length`` never leaks (the JAX reference turns ``0 * NaN`` into
NaN).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _scale(d: int) -> float:
    # 1 / sqrt(D) rounded in f32, as the JAX package computes it
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def naive_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Small-shape oracle. q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D]; Hq % Hkv == 0."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float()) * _scale(D)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = (kpos <= qpos)[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    block_q: int = 512, block_kv: int = 512,
                    return_lse: bool = False):
    """Chunked online-softmax attention (GQA-aware).

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]. ``q_offset`` is the absolute
    position of q[0]. Returns [B, Sq, Hq, D] (and LSE [B, Sq, Hq] if asked).
    The ragged last block is a shorter slice, which contributes exactly what
    the JAX reference's zero padding does (nothing).
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    block_q = min(block_q, max(Sq, 16))
    block_kv = min(block_kv, max(Skv, 16))
    scale = _scale(D)
    dev = q.device
    qr = q.reshape(B, Sq, Hkv, G, D).float()
    outs, lses = [], []
    for q0 in range(0, Sq, block_q):
        qb = qr[:, q0:q0 + block_q]                                    # [B,bq,Hkv,G,D]
        bq = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(bq, device=dev)
        m = torch.full((B, bq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, bq, Hkv, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, bq, Hkv, G, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, block_kv):
            kb = k[:, k0:k0 + block_kv]
            vb = v[:, k0:k0 + block_kv]
            kv_pos = k0 + torch.arange(kb.shape[1], device=dev)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb.float()) * scale
            valid = torch.ones((bq, kb.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                valid = kv_pos[None, :] <= q_pos[:, None]
            maskv = valid[None, :, None, None, :]
            s = torch.where(maskv, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * maskv
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), vb.float())
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    out = torch.cat(outs, dim=1).reshape(B, Sq, Hq, D).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=1).reshape(B, Sq, Hq)
    return out


def decode_attention(q, k_cache, v_cache, length, *, block_kv: int = 1024,
                     return_stats: bool = False):
    """Single-token attention against a KV cache (flash-decoding math).

    q: [B, Hq, D]; k_cache, v_cache: [B, S, Hkv, D]; length: int or int32
    tensor [] / [B] — positions >= length are masked out, length is clipped
    to S. Returns [B, Hq, D], or the raw online-softmax stats (m, l, acc)
    shaped [B,Hkv,G(,D)] for an LSE merge across splits.
    """
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    block_kv = min(block_kv, max(S, 16))
    scale = _scale(D)
    dev = q.device
    lengths = torch.as_tensor(length, dtype=torch.int32, device=dev).expand(B)
    live = torch.clamp(lengths, max=S)[:, None]                        # [B,1]
    qr = q.reshape(B, Hkv, G, D).float()
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=dev)
    for start in range(0, S, block_kv):
        kb = k_cache[:, start:start + block_kv]
        vb = v_cache[:, start:start + block_kv]
        kv_pos = start + torch.arange(kb.shape[1], device=dev)
        valid = kv_pos[None, :] < live                                  # [B,bk]
        s = torch.einsum("bhgd,bkhd->bhgk", qr, kb.float()) * scale
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * valid[:, None, None, :]
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        vb = torch.where(valid[:, :, None, None], vb, 0)                 # NaN past length
        acc = acc * corr[..., None] + torch.einsum(
            "bhgk,bkhd->bhgd", p.to(k_cache.dtype).float(), vb.float())
        m = m_new
    if return_stats:
        return m, l, acc
    l_safe = torch.where(l == 0, 1.0, l)
    return (acc / l_safe[..., None]).reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           block_kv: int = 1024):
    """Single-token attention against a paged KV cache (gather, then the
    contiguous math of :func:`decode_attention`).

    q: [B, Hq, D]; k_pages, v_pages: [P, page_size, Hkv, D]; page_table:
    int [B, max_pages] (page ids per sequence; unused entries point at the
    null page 0); lengths: int or int32 tensor [] / [B]. Positions >= length,
    including all a null-page entry contributes, are masked, and V is zeroed
    under the mask, so NaN in the null page or in unmapped pages never leaks.
    """
    B = q.shape[0]
    _, page_size, Hkv, D = k_pages.shape
    max_pages = page_table.shape[1]
    table = page_table.long()
    k = k_pages[table].reshape(B, max_pages * page_size, Hkv, D)
    v = v_pages[table].reshape(B, max_pages * page_size, Hkv, D)
    return decode_attention(q, k, v, lengths, block_kv=block_kv)
