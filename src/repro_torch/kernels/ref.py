"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

The same chunked online-softmax and chunkwise-mLSTM math as the JAX
references, with f32 accumulation, the Mamba selective scan as a loop over
time steps, and the sLSTM cell the JAX package scans with ``lax.scan``.
They are the port's oracle: the CPU path of the model runs them, the tests
hold them against the JAX package, and ``chip_smoke.py`` holds each
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
import torch.nn.functional as F

NEG_INF = -1e30
# logical keys per split of the decode kernels (CHUNK in csrc/decode_sweep.cuh)
DECODE_CHUNK = 64


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


def decode_attention_splits(q, k_cache, v_cache, length, *, chunk: int = DECODE_CHUNK):
    """:func:`decode_attention` in the order of the decode kernels: the f32
    partials (m, l, acc) of each chunk of ``chunk`` logical keys, then their
    log-sum-exp merge in chunk order,
    ``M = max m_s; L = sum l_s e^(m_s - M); A = sum acc_s e^(m_s - M)``,
    ``out = A / (L == 0 ? 1 : L)``. A chunk at or past a row's length adds
    exactly nothing. Used by the tests and ``chip_smoke.py``."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device).expand(B)
    live = torch.clamp(lengths, min=0, max=S)
    parts = [decode_attention(q, k_cache[:, s0:s0 + chunk], v_cache[:, s0:s0 + chunk],
                              torch.clamp(live - s0, min=0), return_stats=True)
             for s0 in range(0, max(S, 1), chunk)]
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        e = torch.exp(m - M)
        L = L + l * e
        A = A + acc * e[..., None]
    L = torch.where(L == 0, 1.0, L)
    return (A / L[..., None]).reshape(B, Hq, D).to(q.dtype)


def _gather_pages(k_pages, v_pages, page_table):
    """The logical caches [B, max_pages * page_size, Hkv, D] a page table maps."""
    B, max_pages = page_table.shape
    _, page_size, Hkv, D = k_pages.shape
    table = page_table.long()
    return (k_pages[table].reshape(B, max_pages * page_size, Hkv, D),
            v_pages[table].reshape(B, max_pages * page_size, Hkv, D))


def paged_decode_attention_splits(q, k_pages, v_pages, page_table, lengths, *,
                                  chunk: int = DECODE_CHUNK):
    """:func:`paged_decode_attention` in the decode kernels' order: the pages
    gathered, then :func:`decode_attention_splits`."""
    k, v = _gather_pages(k_pages, v_pages, page_table)
    return decode_attention_splits(q, k, v, lengths, chunk=chunk)


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
    k, v = _gather_pages(k_pages, v_pages, page_table)
    return decode_attention(q, k, v, lengths, block_kv=block_kv)


# ================================================================== selective scan

def _mamba_update(x_t, dt_t, a, b_t, c_t, d_skip, h):
    """One step of the Mamba recurrence in f32. x_t, dt_t: [B, Di]; a: [Di, Ds]
    (= -exp(a_log)); b_t, c_t: [B, Ds]; d_skip: [Di]; h: [B, Di, Ds].
    Returns (y_t [B, Di] f32, h_t)."""
    decay = torch.exp(dt_t[..., None] * a)                             # [B,Di,Ds]
    h = decay * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, c_t) + x_t * d_skip
    return y, h


def selective_scan(x, dt, a_log, b, c, d_skip, h0=None):
    """Mamba selective scan, one step at a time.

    x, dt: [B, S, Di]; a_log: [Di, Ds]; b, c: [B, S, Ds]; d_skip: [Di];
    h0: optional [B, Di, Ds]. Returns (y [B, S, Di] in x's dtype, h_final
    [B, Di, Ds] f32). Recurrence, in f32:
    h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t ; y_t = C_t . h_t + D x_t,
    A = -exp(a_log). The JAX reference takes chunks of an associative scan;
    this loop is the same sum in the order the recurrence states, and it
    stays finite where the decay underflows to 0.
    """
    B, S, Di = x.shape
    Ds = a_log.shape[1]
    a = -torch.exp(a_log.float())
    d = d_skip.float()
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    h = (torch.zeros((B, Di, Ds), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        y_t, h = _mamba_update(xf[:, t], dtf[:, t], a, bf[:, t], cf[:, t], d, h)
        ys.append(y_t)
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba_step(x_t, dt_t, a_log, b_t, c_t, d_skip, h):
    """One decode step. x_t, dt_t: [B, Di]; b_t, c_t: [B, Ds]; h: [B, Di, Ds].
    Returns (y [B, Di] in x_t's dtype, h_new [B, Di, Ds] f32)."""
    y, h_new = _mamba_update(x_t.float(), dt_t.float(), -torch.exp(a_log.float()),
                             b_t.float(), c_t.float(), d_skip.float(), h.float())
    return y.to(x_t.dtype), h_new


# ========================================================================== mLSTM

def _pad_steps(x, pad: int, value: float = 0.0):
    """x [B, S, ...] with ``pad`` steps of ``value`` (in x's dtype) appended."""
    if not pad:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad, *x.shape[2:]), value)], dim=1)


def mlstm_chunked(q, k, v, i_raw, f_raw, state=None, *, block: int = 64):
    """Chunkwise-parallel stabilised mLSTM (xLSTM [arXiv:2405.04517] parallel form).

    q, k: [B, S, H, Dk]; v: [B, S, H, Dv]; i_raw, f_raw: [B, S, H].
    state: optional (C [B,H,Dk,Dv], n [B,H,Dk], m [B,H]).
    Returns (h [B,S,H,Dv] in q's dtype, (C, n, m) in f32).
    Gates: log f = logsigmoid(f_raw) (per step), log i = i_raw. Padded steps
    take i = NEG_INF (no input) and f = 60 (logsigmoid(60) ~ 0: keep the
    state), as in the JAX reference.
    """
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    block = min(block, S)
    scale = _scale(Dk)
    pad = (-S) % block
    qp, kp, vp = (_pad_steps(t, pad) for t in (q, k, v))
    ip = _pad_steps(i_raw, pad, NEG_INF)
    fp = _pad_steps(f_raw, pad, 60.0)
    dev = q.device
    if state is None:
        C = torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, Dk), dtype=torch.float32, device=dev)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    else:
        C, n, m = (s.float() for s in state)
    causal = torch.tril(torch.ones((block, block), dtype=torch.bool, device=dev))
    hs = []
    for start in range(0, qp.shape[1], block):
        sl = slice(start, start + block)
        qb, kb, vb = qp[:, sl].float(), kp[:, sl].float(), vp[:, sl].float()
        cum = torch.cumsum(F.logsigmoid(fp[:, sl].float()), dim=1)       # [B,blk,H]
        logi = ip[:, sl].float()
        # per-position stabiliser: m_i = max(F_i + m, F_i + max_{j<=i}(logi_j - F_j))
        gmax = torch.cummax(logi - cum, dim=1).values
        m_i = cum + torch.maximum(m[:, None], gmax)
        qf = qb * scale
        # inter-chunk: q_i . C * exp(F_i + m - m_i)
        w_inter = torch.exp(cum + m[:, None] - m_i)                      # [B,blk,H] <= 1
        inter = torch.einsum("bthk,bhkv->bthv", qf, C) * w_inter[..., None]
        n_inter = n[:, None] * w_inter[..., None]                        # [B,blk,H,Dk]
        # intra-chunk: decay(i,j) = exp(F_i - F_j + logi_j - m_i), j <= i
        dmat = cum[:, :, None] - cum[:, None, :] + logi[:, None, :, :] - m_i[:, :, None]
        w = torch.exp(torch.where(causal[None, :, :, None], dmat, NEG_INF))
        sw = torch.einsum("bihk,bjhk->bijh", qf, kb) * w
        intra = torch.einsum("bijh,bjhv->bihv", sw, vb)
        n_intra = torch.einsum("bijh,bjhk->bihk", w, kb)
        denom = torch.abs(torch.einsum("bthk,bthk->bth", n_inter + n_intra, qf))
        denom = torch.maximum(denom, torch.exp(-m_i))
        hs.append((inter + intra) / denom[..., None])
        # carry to the end of the chunk
        cum_c = cum[:, -1]                                               # [B,H]
        m_new = cum_c + torch.maximum(m, gmax[:, -1])
        w_old = torch.exp(cum_c + m - m_new)
        kw = kb * torch.exp(cum_c[:, None] - cum + logi - m_new[:, None])[..., None]
        C = C * w_old[..., None, None] + torch.einsum("bjhk,bjhv->bhkv", kw, vb)
        n = n * w_old[..., None] + kw.sum(dim=1)
        m = m_new
    h = torch.cat(hs, dim=1)[:, :S].to(q.dtype)
    return h.contiguous(), (C.contiguous(), n.contiguous(), m.contiguous())


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """One decode step. q_t, k_t: [B,H,Dk]; v_t: [B,H,Dv]; i_t, f_t: [B,H];
    state (C, n, m) -> (h [B,H,Dv] in q_t's dtype, (C, n, m) in f32)."""
    C, n, m = (s.float() for s in state)
    Dk = q_t.shape[-1]
    logf = F.logsigmoid(f_t.float())
    logi = i_t.float()
    m_new = torch.maximum(logf + m, logi)
    wf = torch.exp(logf + m - m_new)
    wi = torch.exp(logi - m_new)
    kf = k_t.float()
    C_new = wf[..., None, None] * C + wi[..., None, None] * (
        kf[..., :, None] * v_t.float()[..., None, :])
    n_new = wf[..., None] * n + wi[..., None] * kf
    qf = q_t.float() / float(np.sqrt(np.float32(Dk)))
    num = torch.einsum("bhkv,bhk->bhv", C_new, qf)
    denom = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, qf)),
                          torch.exp(-m_new))
    return (num / denom[..., None]).to(q_t.dtype), (C_new, n_new, m_new)


def mlstm_recurrent(q, k, v, i_raw, f_raw, state=None):
    """Sequential oracle for :func:`mlstm_chunked`: one :func:`mlstm_step` per step."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    if state is None:
        state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=q.device),
                 torch.zeros((B, H, Dk), dtype=torch.float32, device=q.device),
                 torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device))
    hs = []
    for t in range(S):
        h, state = mlstm_step(q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


# ========================================================================== sLSTM

def slstm_cell(g_t, r, b_in, carry):
    """One sLSTM step. g_t: [B,4d] input pre-activations; r: [H,dh,4dh]
    recurrent weights; b_in: [4d] f32; carry (c, n, h, m): [B,d] f32."""
    c, n, h, m = carry
    B = g_t.shape[0]
    H, dh = r.shape[0], r.shape[1]
    d = H * dh
    rec = torch.einsum("bhd,hdf->bhf", h.reshape(B, H, dh).to(r.dtype), r)
    g = g_t.float() + rec.reshape(B, 4 * d).float() + b_in
    zt, it, ft, ot = torch.split(g, d, dim=-1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(zt)
    n_new = torch.clamp(f * n + i, min=1e-6)
    h_new = torch.sigmoid(ot) * (c_new / n_new)
    return c_new, n_new, h_new, m_new


def slstm_scan(gates, r, b_in, c, n, h, m):
    """The sLSTM over a sequence, one :func:`slstm_cell` per step.
    gates: [B,S,4d] -> (hs [B,S,d] f32, c, n, h, m)."""
    carry = (c, n, h, m)
    hs = []
    for t in range(gates.shape[1]):
        carry = slstm_cell(gates[:, t], r, b_in, carry)
        hs.append(carry[2])
    return (torch.stack(hs, dim=1), *carry)
