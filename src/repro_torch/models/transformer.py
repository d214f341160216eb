"""Layer stacks of every family (port of ``repro.models.transformer``).

Four stack shapes cover the ten architectures:

* ``uniform`` — attention + (MLP | MoE) every layer, with Kimi's unstacked
  first-k-dense ``head`` layers; the dense, MoE and vision archs;
* ``jamba`` — periods of (N-1 Mamba + 1 attention), MoE every
  ``moe_every``-th layer;
* ``xlstm`` — periods of (N-1 mLSTM + 1 sLSTM) blocks;
* ``encdec`` — whisper: a bidirectional encoder and a causal decoder with
  cross-attention.

The JAX package scans over the stacked ``[L, ...]`` (jamba, xLSTM:
``[P, ...]`` periods) layer leaves; here a Python loop walks views of the
same leaves (``leaf[i]`` is a view, nothing is copied). The ``stack_*``
dispatchers pick the family. In ``"train"`` mode each scanned body (a
layer; a jamba or xLSTM period) runs under :func:`maybe_remat`, as in the
JAX package.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch import pytree
from repro_torch.dist.sharding import active_rules, constrain, current_mesh, use_rules
from repro_torch.dtypes import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    ParamSpec, apply_mlp, apply_norm, mlp_specs, norm_specs, normal_init, positional_tables,
)

TRAIN_CF = 1.25   # MoE capacity factor (train)
EVAL_CF = 2.0     # MoE capacity factor (inference)


def _slice(tree, i: int):
    return pytree.tree_map(lambda a: a[i], tree)


def _split(tree) -> list:
    """A stacked tree cut along its leading axis into a list of views."""
    return [_slice(tree, i) for i in range(pytree.leaves(tree)[0].shape[0])]


def split_layers(sp) -> dict:
    """``sp`` with its stacked ``layers`` leaves cut into a list of per-layer
    views (no copy); for the jamba and xLSTM stacks also each period's
    blocks. Kimi's ``head`` is a list of unstacked layers already and passes
    as it is. The layer loops take either form; a traced program that runs
    many passes cuts once instead of once per pass."""
    layers = sp["layers"]
    if isinstance(layers, list):
        return sp
    per = _split(layers)
    if "mlstm" in layers or "mamba" in layers:      # periods: [P, n, ...] block leaves
        blocks = [key for key in _PERIOD_BLOCKS if key in layers]
        per = [{**pp, **{key: _split(pp[key]) for key in blocks}} for pp in per]
    return {**sp, "layers": per}


def _layer(sp, i: int, key: str = "layers"):
    layers = sp[key]
    return layers[i] if isinstance(layers, list) else _slice(layers, i)


# the per-block leaves of a period stack, [P, n, ...]: xLSTM's, then jamba's
_PERIOD_BLOCKS = ("ln", "mlstm", "ln_mix", "ln_ffn", "mamba", "moe", "mlp")


def _block(tree, i: int):
    """Block ``i`` of a period's per-block leaves (stacked, or split)."""
    return tree[i] if isinstance(tree, list) else _slice(tree, i)


# the ops whose outputs remat "dots" keeps: 2-D matmuls, as JAX's
# ``dots_with_no_batch_dims_saveable`` keeps dot_generals with no batch dims
# (``x @ w`` of a [B, S, d] activation reaches autograd as ``aten.mm``)
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def maybe_remat(cfg, fn):
    """``fn`` (one scanned body: a layer, or a jamba or xLSTM period) under
    the config's activation rematerialisation, as the JAX package's
    ``maybe_remat``:

    * ``"none"``: ``fn`` itself;
    * ``"full"``: ``torch.utils.checkpoint`` keeps the body's inputs and
      recomputes the rest of its forward in the backward;
    * ``"dots"``: selective checkpointing that keeps the outputs of the 2-D
      matmuls and recomputes everything else.

    It applies only while grad is enabled: a forward with no backward (a
    prefill, an export) runs ``fn`` with nothing added to its graph. Under
    sharding rules the recompute runs under the rules of the forward: the
    autograd engine runs a CUDA backward on a thread of its own, where the
    thread-local rules of ``use_rules`` are not active."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots, not {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_DOTS_SAVED)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        rules, mesh = active_rules(), current_mesh()
        if rules is None:
            return checkpoint(fn, *args, use_reentrant=False, **kw)

        def under_rules(*a):
            with use_rules(rules, mesh):
                return fn(*a)
        return checkpoint(under_rules, *args, use_reentrant=False, **kw)

    return remat


def _zeros_spec(shape, dtype, axes):
    return ParamSpec(tuple(shape), dtype, tuple(axes),
                     lambda gen, s, d: torch.zeros(s, dtype=d, device=gen.device))


def family_kind(cfg) -> str:
    if cfg.enc_dec:
        return "encdec"
    if cfg.ssm is not None:
        return "jamba" if cfg.ssm.kind == "mamba" else "xlstm"
    return "uniform"


def make_positions(cfg, batch: int, seq: int, n_patches: int = 0, device=None):
    """Position ids for rope ([B,S] int32) or M-RoPE ([3,B,S]: text ids on
    all three axes, or for the first ``n_patches`` positions (t 0, h, w) on
    the square patch grid); None if cfg.rope == 'none'."""
    if cfg.rope == "none":
        return None
    s = torch.arange(seq, dtype=torch.int32, device=device)
    if cfg.rope != "mrope":
        return s.expand(batch, seq)
    if n_patches == 0:
        return s.expand(3, batch, seq)
    g = max(math.isqrt(n_patches), 1)
    in_img = s < n_patches
    pos = torch.stack([torch.where(in_img, 0, s), torch.where(in_img, s // g, s),
                       torch.where(in_img, s % g, s)])                   # [3, S]
    return pos[:, None, :].expand(3, batch, seq)


def _decode_tables(cfg, x_t, pos):
    """The positional tables of a decode step at ``pos`` (int or [B])."""
    return positional_tables(cfg, attn.decode_positions(x_t.shape[0], pos, x_t.device,
                                                        mrope=cfg.rope == "mrope"))


# =============================================================== uniform stack

def _first_k(cfg) -> int:
    """Kimi's unstacked first-k-dense layers (0 for every other family)."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def uniform_specs(cfg, dtype):
    m = cfg.moe
    first_k = _first_k(cfg)
    Ls = cfg.n_layers - first_k
    layer = {
        "ln1": norm_specs(cfg, dtype, stack=(Ls,)),
        "attn": attn.attention_specs(cfg, dtype, stack=(Ls,)),
        "ln2": norm_specs(cfg, dtype, stack=(Ls,)),
    }
    if m is not None:
        layer["moe"] = moe_mod.moe_specs(cfg, dtype, stack=(Ls,))
    else:
        layer["mlp"] = mlp_specs(cfg, dtype, stack=(Ls,))
    specs = {"layers": layer}
    if first_k:
        specs["head"] = [{
            "ln1": norm_specs(cfg, dtype),
            "attn": attn.attention_specs(cfg, dtype),
            "ln2": norm_specs(cfg, dtype),
            "mlp": mlp_specs(cfg, dtype, d_ff=m.d_ff_dense or cfg.d_ff),
        } for _ in range(first_k)]
    return specs


def _ffn(cfg, p, x, cf, with_aux):
    """The feed-forward sublayer of a uniform block on the residual ``x`` ->
    (x', MoE aux loss or None)."""
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        y, aux = moe_mod.moe_forward(cfg, p["moe"], h, capacity_factor=cf, with_aux=with_aux)
        return x + y, aux
    return x + apply_mlp(cfg, p["mlp"], h), None


def uniform_forward(cfg, sp, x, positions, mode: str):
    """Returns (x, cache, aux); cache = {"k", "v"} stacked [Ls,B,S,nkv,hd]
    (and Kimi's ``head``: a list of {"k", "v"} [B,S,nkv,hd]) when mode ==
    "prefill", else None; aux is the MoE layers' summed auxiliary loss when
    mode == "train" and the stack has MoE, else None (prefill discards it).
    In train mode each stacked layer runs under :func:`maybe_remat` (Kimi's
    head layers do not, as in the JAX package)."""
    rope = positional_tables(cfg, positions)
    train = mode == "train"
    cf = TRAIN_CF if train else EVAL_CF
    aux = x.new_zeros((), dtype=torch.float32) if train and cfg.moe else None
    first_k = _first_k(cfg)
    head, ks, vs = [], [], []

    def block(p, x):
        a, kv = attn.attention_full(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), rope)
        x, a_l = _ffn(cfg, p, x + a, cf, train)
        return x, kv, a_l

    def train_block(p, x):
        x, _, a_l = block(p, x)
        return x, a_l

    layer_body = maybe_remat(cfg, train_block)
    layers = list(sp.get("head", [])) + [_layer(sp, i) for i in range(cfg.n_layers - first_k)]
    for i, p in enumerate(layers):
        if train:
            x, a_l = (train_block if i < first_k else layer_body)(p, x)
        else:
            x, (k, v), a_l = block(p, x)
        if a_l is not None:
            aux = aux + a_l
        if mode == "prefill":
            if i < first_k:
                head.append({"k": k, "v": v})
            else:
                ks.append(k)
                vs.append(v)
    if mode != "prefill":
        return x, None, aux
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if head:
        cache["head"] = head
    return x, cache, aux


def _attn_block_decode(cfg, p, x_t, k_c, v_c, pos, rope):
    a, _, _ = attn.attention_decode(cfg, p["attn"], apply_norm(cfg, p["ln1"], x_t), k_c, v_c,
                                    pos, rope)
    return _ffn(cfg, p, x_t + a, EVAL_CF, False)[0]


def uniform_decode(cfg, sp, x_t, cache, pos):
    """One decode step through every layer, Kimi's head layers first;
    ``cache`` ({"k", "v"} stacked [Ls,B,S,nkv,hd], and ``head``) is updated in
    place and returned."""
    rope = _decode_tables(cfg, x_t, pos)
    for p, c in zip(sp.get("head", []), cache.get("head", [])):
        x_t = _attn_block_decode(cfg, p, x_t, c["k"], c["v"], pos, rope)
    for i in range(cfg.n_layers - _first_k(cfg)):
        x_t = _attn_block_decode(cfg, _layer(sp, i), x_t, cache["k"][i], cache["v"][i], pos,
                                 rope)
    return x_t, cache


def uniform_cache_specs(cfg, batch: int, capacity: int):
    first_k = _first_k(cfg)
    Ls, hd, nkv = cfg.n_layers - first_k, cfg.resolved_head_dim, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    specs = {"k": _zeros_spec((Ls, batch, capacity, nkv, hd), dt, kv_axes),
             "v": _zeros_spec((Ls, batch, capacity, nkv, hd), dt, kv_axes)}
    if first_k:
        specs["head"] = [{"k": _zeros_spec((batch, capacity, nkv, hd), dt, kv_axes[1:]),
                          "v": _zeros_spec((batch, capacity, nkv, hd), dt, kv_axes[1:])}
                         for _ in range(first_k)]
    return specs


_NO_PAGED_HEAD = "paged decode does not support unstacked head layers"


def uniform_decode_paged(cfg, sp, x_t, k_pages, v_pages, page_table, pos):
    """Paged decode step for the uniform stack (continuous batching).

    k_pages/v_pages: [L, P, page_size, nkv, hd], one pool per layer sharing
    ONE page table (a logical page spans every layer, so the allocator
    accounts it once), written in place at each layer's index; pos: int32
    [B] per row. Returns (x_t, k_pages, v_pages).
    Unstacked head layers (Kimi's first-k-dense) keep per-request caches and
    are refused, as in the JAX package.
    """
    if "head" in sp:
        raise ValueError(_NO_PAGED_HEAD)
    rope = _decode_tables(cfg, x_t, pos)
    for i in range(cfg.n_layers):
        p = _layer(sp, i)
        h = apply_norm(cfg, p["ln1"], x_t)
        a, _, _ = attn.attention_decode_paged(cfg, p["attn"], h, k_pages, v_pages,
                                              page_table, pos, rope, layer=i)
        x_t = _ffn(cfg, p, x_t + a, EVAL_CF, False)[0]
    return x_t, k_pages, v_pages


def uniform_page_pool_specs(cfg, n_pages: int, page_size: int):
    """Zero-init page-pool specs for the uniform stack: K and V pools shaped
    [L, n_pages, page_size, nkv, hd] (page 0 is the reserved null page)."""
    if _first_k(cfg):
        raise ValueError(_NO_PAGED_HEAD)
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
    None (prefill discards it). In train mode each period runs under
    :func:`maybe_remat`."""
    period, P, moe_slots, mlp_slots = _jamba_layout(cfg)
    train = mode == "train"
    cf = TRAIN_CF if train else EVAL_CF

    def period_body(pp, x):
        """One period -> (x, its summed aux loss, conv states, ssm states, (k, v))."""
        aux_p = x.new_zeros((), dtype=torch.float32) if train else None
        convs, ssms, kv = [], [], None
        for i in range(period):
            h = apply_norm(cfg, _block(pp["ln_mix"], i), x)
            if i == period - 1:
                a, kv = attn.attention_full(cfg, pp["attn"], h, None)
            else:
                a, (cs, hs) = ssm.mamba_forward(cfg, _block(pp["mamba"], i), h)
                convs.append(cs)
                ssms.append(hs)
            x, a_l = _jamba_ffn(cfg, pp, i, x + a, cf, moe_slots, mlp_slots, train)
            if a_l is not None:
                aux_p = aux_p + a_l
        return x, aux_p, convs, ssms, kv

    if train:
        body = maybe_remat(cfg, lambda pp, x: period_body(pp, x)[:2])
        aux = x.new_zeros((), dtype=torch.float32)
        for p_i in range(P):
            x, aux_p = body(_layer(sp, p_i), x)
            aux = aux + aux_p
        return x, None, aux
    convs, ssms, ks, vs = [], [], [], []
    for p_i in range(P):
        x, _, cs, hs, (k, v) = period_body(_layer(sp, p_i), x)
        convs += cs
        ssms += hs
        ks.append(k)
        vs.append(v)
    if mode != "prefill":
        return x, None, None
    n_mix = period - 1
    cache = {"conv": torch.stack(convs).unflatten(0, (P, n_mix)),
             "ssm": torch.stack(ssms).unflatten(0, (P, n_mix)),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache, None


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
    "prefill", else None. In train mode each period runs under
    :func:`maybe_remat`."""
    period, P = _xlstm_layout(cfg)

    def period_body(pp, x):
        """One period -> (x, its mLSTM states, its sLSTM state)."""
        m_states, s_state = [], None
        for i in range(period):
            h = apply_norm(cfg, _block(pp["ln"], i), x)
            if i == period - 1:
                a, s_state = ssm.slstm_forward(cfg, pp["slstm"], h)
            else:
                a, m_st = ssm.mlstm_forward(cfg, _block(pp["mlstm"], i), h)
                m_states.append(m_st)
            x = x + a
        return x, m_states, s_state

    if mode == "train":
        body = maybe_remat(cfg, lambda pp, x: period_body(pp, x)[0])
        for p_i in range(P):
            x = body(_layer(sp, p_i), x)
        return x, None
    periods = []
    for p_i in range(P):
        x, m_states, s_state = period_body(_layer(sp, p_i), x)
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


# ================================================================ encdec stack

def encdec_specs(cfg, dtype):
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    return {
        "enc_pos": ParamSpec((cfg.encoder_seq, cfg.d_model), dtype, (None, "embed"),
                             normal_init(0.02)),
        "enc_layers": {
            "ln1": norm_specs(cfg, dtype, stack=(Le,)),
            "attn": attn.attention_specs(cfg, dtype, stack=(Le,)),
            "ln2": norm_specs(cfg, dtype, stack=(Le,)),
            "mlp": mlp_specs(cfg, dtype, stack=(Le,)),
        },
        "enc_final": norm_specs(cfg, dtype),
        "layers": {
            "ln1": norm_specs(cfg, dtype, stack=(Ld,)),
            "attn": attn.attention_specs(cfg, dtype, stack=(Ld,)),
            "lnx": norm_specs(cfg, dtype, stack=(Ld,)),
            "xattn": attn.attention_specs(cfg, dtype, stack=(Ld,)),
            "ln2": norm_specs(cfg, dtype, stack=(Ld,)),
            "mlp": mlp_specs(cfg, dtype, stack=(Ld,)),
        },
    }


def encoder_forward(cfg, sp, frames, train: bool = False):
    """frames: [B, encoder_seq, d] (the frontend stub's embeddings) ->
    [B, encoder_seq, d], through the bidirectional encoder; with ``train``
    each layer runs under :func:`maybe_remat`."""
    x = constrain(frames.to(torch_dtype(cfg.dtype)) + sp["enc_pos"][None], "batch", "seq", "embed")

    def layer(p, x):
        a, _ = attn.attention_full(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), None,
                                   causal=False)
        x = x + a
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))

    body = maybe_remat(cfg, layer) if train else layer
    for i in range(cfg.n_encoder_layers):
        x = body(_layer(sp, i, "enc_layers"), x)
    return apply_norm(cfg, sp["enc_final"], x)


def encdec_forward(cfg, sp, x, positions, mode: str, enc_out):
    """The decoder over the encoder's output ``enc_out``. Returns (x, cache);
    cache = {"k", "v"} (self-attention) and {"xk", "xv"} (the encoder's
    projected K/V) stacked [Ld, ...] when mode == "prefill", else None. In
    train mode each layer runs under :func:`maybe_remat`."""
    rope = positional_tables(cfg, positions)
    names = ("k", "v", "xk", "xv")
    kvs = {key: [] for key in names}

    def layer(p, x):
        a, kv = attn.attention_full(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), rope)
        x = x + a
        ax, xkv = attn.attention_full(cfg, p["xattn"], apply_norm(cfg, p["lnx"], x), None,
                                      kv_from=enc_out)
        x = x + ax
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x)), kv + xkv

    if mode == "train":
        body = maybe_remat(cfg, lambda p, x: layer(p, x)[0])
        for i in range(cfg.n_layers):
            x = body(_layer(sp, i), x)
        return x, None
    for i in range(cfg.n_layers):
        x, kv = layer(_layer(sp, i), x)
        for key, val in zip(names, kv):
            kvs[key].append(val)
    if mode != "prefill":
        return x, None
    return x, {key: torch.stack(vals) for key, vals in kvs.items()}


def encdec_decode(cfg, sp, x_t, cache, pos):
    """One decode step through every decoder layer: self-attention writes its
    K/V into ``cache`` in place; cross-attention reads all of ``xk``/``xv``."""
    rope = _decode_tables(cfg, x_t, pos)
    for i in range(cfg.n_layers):
        p = _layer(sp, i)
        a, _, _ = attn.attention_decode(cfg, p["attn"], apply_norm(cfg, p["ln1"], x_t),
                                        cache["k"][i], cache["v"][i], pos, rope)
        x_t = x_t + a
        ax, _, _ = attn.attention_decode(cfg, p["xattn"], apply_norm(cfg, p["lnx"], x_t),
                                         cache["xk"][i], cache["xv"][i], pos, None, cross=True)
        x_t = x_t + ax
        x_t = x_t + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x_t))
    return x_t, cache


def encdec_cache_specs(cfg, batch: int, capacity: int):
    Ld, hd, nkv = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": _zeros_spec((Ld, batch, capacity, nkv, hd), dt, kv_axes),
            "v": _zeros_spec((Ld, batch, capacity, nkv, hd), dt, kv_axes),
            "xk": _zeros_spec((Ld, batch, cfg.encoder_seq, nkv, hd), dt, kv_axes),
            "xv": _zeros_spec((Ld, batch, cfg.encoder_seq, nkv, hd), dt, kv_axes)}


# ================================================================== dispatchers

def stack_specs(cfg, dtype):
    return {"uniform": uniform_specs, "jamba": jamba_specs, "xlstm": xlstm_specs,
            "encdec": encdec_specs}[family_kind(cfg)](cfg, dtype)


def stack_forward(cfg, sp, x, positions, mode: str, enc_out=None):
    """Returns (x, cache, aux), as the JAX package's: aux is the summed MoE
    auxiliary loss in "train" mode (a float32 0 where the stack has no MoE),
    and None in "prefill" mode, which discards it."""
    kind = family_kind(cfg)
    if kind == "jamba":
        x, cache, aux = jamba_forward(cfg, sp, x, mode)
    elif kind == "xlstm":
        (x, cache), aux = xlstm_forward(cfg, sp, x, mode), None
    elif kind == "encdec":
        (x, cache), aux = encdec_forward(cfg, sp, x, positions, mode, enc_out), None
    else:
        x, cache, aux = uniform_forward(cfg, sp, x, positions, mode)
    if mode == "train" and aux is None:
        aux = x.new_zeros((), dtype=torch.float32)
    return x, cache, aux


def stack_decode(cfg, sp, x_t, cache, pos):
    kind = family_kind(cfg)
    if kind == "jamba":
        return jamba_decode(cfg, sp, x_t, cache, pos)
    if kind == "xlstm":
        return xlstm_decode(cfg, sp, x_t, cache)
    if kind == "encdec":
        return encdec_decode(cfg, sp, x_t, cache, pos)
    return uniform_decode(cfg, sp, x_t, cache, pos)


def split_cache(cfg, inner):
    """The decode state ``inner`` with its stacked leaves cut into per-layer
    (jamba, xLSTM: per-block) views, no copy, so that a traced program of
    many decode steps cuts once instead of once per step; writes through the
    views land in the stacked tensors. A uniform K/V cache (with Kimi's
    ``head`` list, already per layer) and an encoder-decoder cache are
    returned as they are."""
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
    return {"uniform": uniform_cache_specs, "jamba": jamba_cache_specs,
            "xlstm": xlstm_cache_specs,
            "encdec": encdec_cache_specs}[family_kind(cfg)](cfg, batch, capacity)
