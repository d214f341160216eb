"""Roofline cost extraction: analytic FLOPs, probe extrapolation, and the FLOP
formulas of the port's custom ops (port of ``repro.launch.costmodel``).

1. **Analytic FLOPs** (`analytic_flops`): closed-form counts per architecture
   (projections, attention cores with causal halving, MoE capacity GEMMs,
   Mamba/mLSTM/sLSTM recurrences, logits), copied from the JAX package.

2. **Probe extrapolation** (`probe_costs`): trace 1- and 2-layer (or 1-/2-
   period) variants of the same cell on the same mesh and rules under
   ``repro_torch.util.probe_mode`` (coarse blocks), then solve the linear model

       cost(L, a) = a * (head + L * per_layer) + opt        (train)
       cost(L)    =      head + L * per_layer               (serve)

   for FLOPs, bytes accessed and per-collective wire bytes, as the JAX package
   does. The port traces Python loops, so its full trace already sees every
   layer; the probes are kept so that a cell's extrapolation can be held
   against its full trace. The sLSTM time loop's body is added analytically
   (`slstm_corrections`), as in the JAX package, whose probes cannot unroll
   it; in the port it is one custom op whose formula counts the same matmul.

3. **FLOP formulas of the custom ops** (`register_flop_formulas`): the
   ``repro_torch::`` ops are opaque nodes, which
   ``torch.utils.flop_counter`` counts as 0 unless each has a formula. Each
   formula below counts from the op's shapes alone (no tensor data), with the
   convention its docstring states. A backward needs none: each op's backward
   is the VJP of its plain version, which runs as counted aten ops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.transformer import family_kind
from repro_torch.util import probe_mode

METRIC_KEYS = ("flops", "bytes", "all-gather", "all-reduce", "reduce-scatter",
               "all-to-all", "collective-permute", "coll_total")


# ================================================================ analytic flops

def analytic_flops(cfg: ArchConfig, shape: ShapeSpec, *, grad_accum: int = 1) -> Dict:
    """Global executed FLOPs per step (fwd; train = fwd * (3 + 1 if remat)).

    Returns dict with 'fwd', 'executed', 'model_6nd'.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    T = B * (1 if decode else S)                       # tokens processed this step
    gated = cfg.act in ("swiglu", "geglu")
    mlpx = 3 if gated else 2

    def attn_layer(T_, ctx_pairs) -> float:
        proj = 2 * T_ * d * (nq + 2 * nkv) * hd + 2 * T_ * (nq * hd) * d
        core = 4 * nq * hd * ctx_pairs                 # QK^T + PV, both 2*flops
        return proj + core

    # context pairs: sum over query tokens of attended positions
    if decode:
        pairs_causal = B * S                            # 1 new token vs S-deep cache
    else:
        pairs_causal = B * S * (S + 1) // 2

    def mlp_flops(T_, width) -> float:
        return 2 * T_ * d * width * mlpx

    def moe_flops(T_) -> float:
        m = cfg.moe
        cf = 1.25 if shape.kind == "train" else 2.0
        slots = T_ * m.top_k * cf                       # executed capacity GEMM rows
        f = 2 * T_ * d * m.n_experts                    # router
        f += 2 * slots * d * m.d_ff_expert * mlpx
        if m.n_shared_experts:
            f += mlp_flops(T_, m.d_ff_expert * m.n_shared_experts)
        if m.dense_residual:
            f += mlp_flops(T_, m.d_ff_dense or cfg.d_ff)
        return f

    def mamba_layer(T_) -> float:
        s = cfg.ssm
        di = s.expand * d
        dtr = max(d // 16, 8)
        f = 2 * T_ * d * 2 * di                         # in_proj
        f += 2 * T_ * s.d_conv * di                     # depthwise conv
        f += 2 * T_ * di * (dtr + 2 * s.d_state)        # x_proj
        f += 2 * T_ * dtr * di                          # dt_proj
        f += 10 * T_ * di * s.d_state                   # selective scan core
        f += 2 * T_ * di * d                            # out_proj
        return f

    def mlstm_layer(T_) -> float:
        di = 2 * d
        H = cfg.n_heads
        dk, dv = d // H, di // H
        c = 64                                          # chunk
        f = 2 * T_ * d * di * 2                         # up + z
        f += 2 * T_ * 4 * di                            # conv
        f += 2 * T_ * di * (2 * H * dk + 2 * H)         # q, k, gates
        f += T_ * H * (c * (dk + dv) + 4 * dk * dv)     # chunked core
        f += 2 * T_ * di * d                            # down
        return f

    def slstm_layer(T_) -> float:
        H = cfg.n_heads
        dh = d // H
        return T_ * (2 * d * 4 * d + 8 * d * dh + 2 * d * d)

    total = 0.0
    for layer in range(cfg.n_layers):
        lt = cfg.layer_type(layer)
        if lt == "attn":
            total += attn_layer(T, pairs_causal)
        elif lt == "mamba":
            total += mamba_layer(T)
        elif lt == "mlstm":
            total += mlstm_layer(T)
        elif lt == "slstm":
            total += slstm_layer(T)
        m = cfg.moe
        if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
            continue                                    # xLSTM blocks have no FFN
        if m is None:
            if cfg.d_ff:
                total += mlp_flops(T, cfg.d_ff)
        elif layer < m.first_k_dense or (m.moe_every > 1 and layer % m.moe_every != m.moe_every - 1):
            total += mlp_flops(T, m.d_ff_dense or cfg.d_ff)
        else:
            total += moe_flops(T)

    if cfg.enc_dec and not decode:
        enc_T = B * cfg.encoder_seq
        enc_pairs = B * cfg.encoder_seq ** 2            # bidirectional
        for _ in range(cfg.n_encoder_layers):
            total += attn_layer(enc_T, enc_pairs) + mlp_flops(enc_T, cfg.d_ff)
        # decoder cross-attention
        x_pairs = (B * S * cfg.encoder_seq) if not decode else (B * cfg.encoder_seq)
        for _ in range(cfg.n_layers):
            total += 2 * T * d * nq * hd + 2 * T * nq * hd * d + 4 * nq * hd * x_pairs
            total += 2 * 2 * enc_T * d * nkv * hd       # cross K/V projections
    if cfg.enc_dec and decode:
        x_pairs = B * cfg.encoder_seq
        for _ in range(cfg.n_layers):
            total += 2 * T * d * nq * hd + 2 * T * nq * hd * d + 4 * nq * hd * x_pairs

    # logits head: train computes all positions; prefill/decode only the last
    head_T = T if shape.kind == "train" else B
    total += 2 * head_T * d * cfg.vocab_size

    fwd = float(total)
    if shape.kind == "train":
        factor = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
        executed = fwd * factor + 20.0 * cfg.param_counts()["total"]   # + optimizer
    else:
        executed = fwd
    model = (6.0 if shape.kind == "train" else 2.0) * cfg.param_counts()["active"] * T
    return {"fwd": fwd, "executed": executed, "model_6nd": float(model)}


# ============================================================ probe extrapolation

def _reduce_cfg(cfg: ArchConfig, **kw) -> ArchConfig:
    return dataclasses.replace(cfg, **kw)


def probe_variants(cfg: ArchConfig, shape: ShapeSpec, grad_accum: int):
    """Returns (probes, combine) — probes: list of (tag, cfg, ga, micro_batch);
    combine: {tag: metrics} -> full-step metrics."""
    kind = family_kind(cfg)
    train = shape.kind == "train"
    micro = max(shape.global_batch // grad_accum, 1) if train else shape.global_batch

    if kind == "encdec":
        p1 = ("p1", _reduce_cfg(cfg, n_layers=1, n_encoder_layers=1), 1, micro)
        p2 = ("p2", _reduce_cfg(cfg, n_layers=1, n_encoder_layers=2), 1, micro)
        p3 = ("p3", _reduce_cfg(cfg, n_layers=2, n_encoder_layers=1), 1, micro)
        probes = [p1, p2, p3]
        if train:
            probes.append(("pa", p1[1], 2, micro))

        def combine(m):
            le = _sub(m["p2"], m["p1"])
            ld = _sub(m["p3"], m["p1"])
            if train:
                half = _sub(m["pa"], m["p1"])           # = h + le + ld
                h = _sub(half, _add(le, ld))
                o = _sub(m["p1"], half)
                per_step = _add(h, _add(_scale(le, cfg.n_encoder_layers),
                                        _scale(ld, cfg.n_layers)))
                return _add(_scale(per_step, grad_accum), o)
            h = _sub(m["p1"], _add(le, ld))
            return _add(h, _add(_scale(le, cfg.n_encoder_layers),
                                _scale(ld, cfg.n_layers)))

        return probes, combine

    if kind == "uniform":
        fk = cfg.moe.first_k_dense if cfg.moe else 0
        unit = 1
        n_units = cfg.n_layers - fk
        mk = lambda u: _reduce_cfg(cfg, n_layers=fk + u)
    else:  # jamba / xlstm periods
        unit = cfg.ssm.attn_every if kind == "jamba" else (cfg.ssm.slstm_every or cfg.n_layers)
        n_units = cfg.n_layers // unit
        mk = lambda u: _reduce_cfg(cfg, n_layers=u * unit)

    probes = [("p1", mk(1), 1, micro), ("p2", mk(2), 1, micro)]
    if train:
        probes.append(("pa", mk(1), 2, micro))

    def combine(m):
        l = _sub(m["p2"], m["p1"])
        if train:
            h = _sub(m["pa"], m["p2"])                  # = head (see derivation)
            o = _sub(m["p1"], _add(h, l))
            per_step = _add(h, _scale(l, n_units))
            return _add(_scale(per_step, grad_accum), o)
        h = _sub(m["p1"], l)
        return _add(h, _scale(l, n_units))

    return probes, combine


def _sub(a, b):
    return {k: a[k] - b[k] for k in a}


def _add(a, b):
    return {k: a[k] + b[k] for k in a}


def _scale(a, s):
    return {k: a[k] * s for k in a}


def _clamp(a):
    return {k: max(v, 0.0) for k, v in a.items()}


def slstm_corrections(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, float]:
    """Per-device cost the rolled sLSTM time scan hides from the probes (analytic).

    Assumes R (block-diag recurrent weights) stays VMEM-resident across steps, as a
    fused kernel would hold it; state traffic is the irreducible HBM cost.
    """
    zero = {k: 0.0 for k in METRIC_KEYS}
    if cfg.ssm is None or cfg.ssm.kind != "xlstm" or not cfg.ssm.slstm_every:
        return zero
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    B, S = shape.global_batch, shape.seq_len
    steps = 1 if shape.kind == "decode" else S
    n_sl = cfg.n_layers // cfg.ssm.slstm_every
    flops = steps * B * 8 * d * dh * n_sl               # recurrent block-diag matmul
    if shape.kind == "train":
        flops *= 4 if cfg.remat == "full" else 3
    state_bytes = steps * B * (4 * d * 4 * 2 + 4 * d * 4) * n_sl   # (c,n,h,m) rw + gates
    return dict(zero, flops=float(flops), bytes=float(state_bytes))


def probe_costs(build_and_lower: Callable, cfg: ArchConfig, shape: ShapeSpec,
                grad_accum: int) -> Dict:
    """Run the probe plan. ``build_and_lower(cfg_variant, ga, micro_batch)`` must
    return (flops, bytes, collectives_dict) for one compiled probe."""
    probes, combine = probe_variants(cfg, shape, grad_accum)
    measured: Dict[str, Dict[str, float]] = {}
    details = {}
    for tag, pcfg, ga, micro in probes:
        with probe_mode():
            flops, nbytes, coll = build_and_lower(pcfg, ga, micro)
        measured[tag] = {
            "flops": flops, "bytes": nbytes,
            "all-gather": float(coll.get("all-gather", 0)),
            "all-reduce": float(coll.get("all-reduce", 0)),
            "reduce-scatter": float(coll.get("reduce-scatter", 0)),
            "all-to-all": float(coll.get("all-to-all", 0)),
            "collective-permute": float(coll.get("collective-permute", 0)),
            "coll_total": float(coll.get("total", 0)),
        }
        details[tag] = measured[tag]
    full = _clamp(combine(measured))
    corr = slstm_corrections(cfg, shape)
    # corrections are global; probes report per-device — divide by device count later
    return {"extrapolated": full, "probes": details, "slstm_correction": corr}


# ===================================================== custom-op FLOP formulas

MLSTM_CHUNK = 64                       # the mLSTM kernel's chunk (analytic_flops' c)


def flash_attention_flops(q, k, v, causal, q_offset, *args, out_shape=None, **kwargs) -> int:
    """``repro_torch::flash_attention``, q [B,Sq,Hq,D], k [B,Skv,Hkv,D]:
    4 B Hq D per (query, key) pair the mask keeps (QK^T and PV, 2 FLOPs a
    multiply-add each). Causal: query i at position ``q_offset + i`` keeps
    keys 0..q_offset+i (at most Skv), the exact pair count, which is
    ``analytic_flops``' halving S(S+1)/2 at q_offset 0; the key blocks the
    kernel visits past the diagonal are not counted. Otherwise Sq Skv."""
    B, Sq, Hq, D = q
    Skv = k[1]
    if causal:
        pairs = sum(min(Skv, q_offset + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    return 4 * B * Hq * D * pairs


def decode_attention_flops(q, k_cache, v_cache, length, *args, out_shape=None, **kwargs) -> int:
    """``repro_torch::decode_attention`` (and ``decode_attention_stats``),
    q [B,Hq,D] against a [B,S,Hkv,D] cache: 4 B Hq D S, every position of
    the cache's capacity, as ``analytic_flops`` counts a decode step; the
    lengths are data, which a count from shapes cannot read (the kernel skips
    the splits past each row's length)."""
    B, Hq, D = q
    return 4 * B * Hq * D * k_cache[1]


def paged_decode_attention_flops(q, k_pages, v_pages, page_table, lengths, *args,
                                 out_shape=None, **kwargs) -> int:
    """``repro_torch::paged_decode_attention``: as the contiguous decode over
    each row's whole table, ``max_pages x page_size`` positions."""
    B, Hq, D = q
    return 4 * B * Hq * D * page_table[1] * k_pages[1]


def mlstm_flops(q, k, v, i_raw, f_raw, C, n, m, *args, out_shape=None, **kwargs) -> int:
    """``repro_torch::mlstm``, q, k [B,S,H,Dk], v [B,S,H,Dv]: per step and
    head, ``analytic_flops``' chunked core: c (Dk + Dv) for the causal half of
    the intra-chunk products at the kernel's chunk c = 64, and 4 Dk Dv for the
    inter-chunk q C product and the state update."""
    B, S, H, Dk = q
    Dv = v[-1]
    return B * S * H * (MLSTM_CHUNK * (Dk + Dv) + 4 * Dk * Dv)


def selective_scan_flops(x, dt, a_log, b, c, d_skip, h0, *args, out_shape=None,
                         **kwargs) -> int:
    """``repro_torch::selective_scan``, x [B,S,Di], a_log [Di,Ds]: 10 FLOPs
    per step, channel and state (the decay, the input term, the update and
    the C readout), ``analytic_flops``' scan core."""
    B, S, Di = x
    return 10 * B * S * Di * a_log[1]


def slstm_scan_flops(gates, r, b_in, c, n, h, m, *args, out_shape=None, **kwargs) -> int:
    """``repro_torch::slstm_scan``, gates [B,S,4d], r [H,dh,4dh]: the
    block-diagonal recurrent matmul, 2 x 4 d dh a step and row
    (``slstm_corrections``' count); the gate arithmetic is not counted."""
    B, S = gates[:2]
    H, dh, four_dh = r
    return 2 * B * S * H * dh * four_dh


def mlstm_step_flops(q, k, v, i, f, C, n, m, *args, out_shape=None, **kwargs) -> int:
    """``repro_torch::mlstm_step``, q [B,H,Dk], v [B,H,Dv]: 4 Dk Dv per row
    and head, the state update and the q C readout (``analytic_flops``'
    per-token inter-chunk count)."""
    B, H, Dk = q
    return 4 * B * H * Dk * v[-1]


def mamba_step_flops(x_t, dt_t, a_log, b_t, c_t, d_skip, h, *args, out_shape=None,
                     **kwargs) -> int:
    """``repro_torch::mamba_step``, x_t [B,Di], a_log [Di,Ds]: the scan's 10
    FLOPs per channel and state for one step."""
    B, Di = x_t
    return 10 * B * Di * a_log[1]


FLOP_FORMULAS = {
    "flash_attention": flash_attention_flops,
    "decode_attention": decode_attention_flops,
    "decode_attention_stats": decode_attention_flops,
    "paged_decode_attention": paged_decode_attention_flops,
    "mlstm": mlstm_flops,
    "selective_scan": selective_scan_flops,
    "slstm_scan": slstm_scan_flops,
    "mlstm_step": mlstm_step_flops,
    "mamba_step": mamba_step_flops,
}


def register_flop_formulas() -> None:
    """Add each custom op's formula to ``torch.utils.flop_counter``'s registry
    (once per process), so that ``FlopCounterMode`` and the dry run's counter
    count the ops."""
    import torch
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    import repro_torch.kernels.ops  # noqa: F401  (defines the ops)
    for name, formula in FLOP_FORMULAS.items():
        packet = getattr(torch.ops.repro_torch, name)
        if packet not in flop_registry:
            register_flop_formula(packet)(formula)
