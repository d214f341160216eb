"""Shared building blocks: ParamSpec machinery, norms, RoPE, MLP, embeddings.

Port of ``repro.models.layers``. Parameters are described once as a tree of
:class:`ParamSpec`; :func:`init_tree` materialises it from a
``torch.Generator`` on that generator's device. Apply functions take the
plain tensor tree, keyed and laid out as in the JAX package (weights are
``[d_in, d_out]``, stacked layers lead with ``[L, ...]``), so a JAX parameter
tree or snapshot carries over with no transform.

The JAX package's ``constrain`` sharding annotations sit at its sites
(``repro_torch.dist.sharding.constrain``: the identity outside a
``use_rules`` context).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.dist.sharding import (
    constrain, grad_laid_out, is_dtensor, local_shape_and_offset,
)
from repro_torch.dtypes import torch_dtype

# (generator, shape, dtype) -> tensor on the generator's device
Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.dtype], torch.Tensor]


# ------------------------------------------------------------------ param specs

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...]
    init: Initializer

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec rank mismatch: {self.shape} vs {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def normal_init(stddev: float, fan_in_axis: Optional[int] = None) -> Initializer:
    """Normal init; if fan_in_axis is given, stddev = scale / sqrt(fan_in)."""

    def init(gen, shape, dtype):
        std = stddev / math.sqrt(shape[fan_in_axis]) if fan_in_axis is not None else stddev
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * std).to(dtype)

    return init


def zeros_init() -> Initializer:
    return lambda gen, shape, dtype: torch.zeros(shape, dtype=dtype, device=gen.device)


def ones_init() -> Initializer:
    return lambda gen, shape, dtype: torch.ones(shape, dtype=dtype, device=gen.device)


def const_init(value: float) -> Initializer:
    return lambda gen, shape, dtype: torch.full(shape, value, dtype=dtype, device=gen.device)


def dense_spec(d_in: int, d_out: int, axes: Tuple[Optional[str], ...],
               dtype, *, stack: Tuple[int, ...] = (), scale: float = 1.0) -> ParamSpec:
    """Weight [*, d_in, d_out] with 1/sqrt(d_in) init (stack axes lead)."""
    stack_axes = ("layers",) * len(stack)
    return ParamSpec(shape=(*stack, d_in, d_out), dtype=dtype, axes=(*stack_axes, *axes),
                     init=normal_init(scale, fan_in_axis=len(stack)))


def bias_spec(d: int, axis: Optional[str], dtype, *, stack: Tuple[int, ...] = ()) -> ParamSpec:
    return ParamSpec((*stack, d), dtype, (*("layers",) * len(stack), axis), zeros_init())


def init_tree(specs, gen: torch.Generator):
    """Materialise a ParamSpec tree, leaf by leaf in flattening order, from one
    generator (deterministic per seed; not the numbers JAX draws)."""
    return pytree.tree_map(lambda s: s.init(gen, s.shape, s.dtype), specs, is_leaf=is_spec)


# ------------------------------------------------------------------------ norms

def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=xf.dim() - 1, keepdim=True)   # dims >= 0: DTensor, torch 2.11
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight                  # promotes a bf16 weight to f32 exactly
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's f32 layer norm (biased variance), as one op."""
    y = F.layer_norm(x.float(), (x.shape[-1],), None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps)
    return y.to(x.dtype)


def norm_specs(cfg, dtype, stack: Tuple[int, ...] = ()):
    if cfg.norm == "layernorm_np":
        return {}
    stack_axes = ("layers",) * len(stack)
    out = {"scale": ParamSpec((*stack, cfg.d_model), dtype, (*stack_axes, None), ones_init())}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec((*stack, cfg.d_model), dtype, (*stack_axes, None), zeros_init())
    return out


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The config's norm of ``x``; on a mesh its gradient comes back laid out
    as the output is (``grad_laid_out``): the partial sums the projections
    behind a norm send back are reduced at the norm."""
    if cfg.norm == "rmsnorm":
        return grad_laid_out(rms_norm(x, p["scale"]))
    if cfg.norm == "layernorm":
        return grad_laid_out(layer_norm(x, p["scale"], p["bias"]))
    if cfg.norm == "layernorm_np":
        return grad_laid_out(layer_norm(x, None, None))
    raise ValueError(cfg.norm)


# ------------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, computed in f64 as the JAX package does (f64 numpy)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """Rotary tables for positions [B, S]: (cos, sin) as [B, S, 1, hd] f32, with
    cos repeated over both halves and sin signed (-sin | +sin), so that
    :func:`rotate` is two products and a roll. A forward pass computes them
    once and every layer's q and k reuse them."""
    inv = rope_freqs(head_dim, theta, device=positions.device).float()    # [hd/2]
    return _angle_tables(positions.float()[..., None] * inv)              # [B, S, hd/2]


# M-RoPE (Qwen2-VL): rotary sections over (temporal, height, width) position ids.
MROPE_SECTION_FRACS = (0.25, 0.375, 0.375)  # qwen2-vl uses [16, 24, 24] of 64 pairs


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    half = head_dim // 2
    t = int(half * MROPE_SECTION_FRACS[0])
    h = int(half * MROPE_SECTION_FRACS[1])
    return (t, h, half - t - h)


def mrope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """:func:`rope_tables` for M-RoPE positions [3, B, S] (t/h/w ids): the
    frequencies fall in three contiguous sections, each turned by its own
    axis's positions; the tables keep the [B, S, 1, hd] form, so
    :func:`rotate` is unchanged."""
    inv = rope_freqs(head_dim, theta, device=positions.device).float()    # [hd/2]
    parts, start = [], 0
    for axis, sec in enumerate(mrope_sections(head_dim)):
        parts.append(positions[axis].float()[..., None] * inv[start:start + sec])
        start += sec
    return _angle_tables(torch.cat(parts, dim=-1))                        # [B, S, hd/2]


def _angle_tables(ang: torch.Tensor):
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Split-halves rotary rotation of x [B, S, H, hd] in f32, cast back:
    [x1 cos - x2 sin | x2 cos + x1 sin], the JAX package's form, bit for bit
    (a - b and a + (-b) round the same). Written with a roll, it is 6 graph
    nodes instead of 12, which the exported serve program repeats ~1000 times."""
    cos, sin = tables
    xf = x.float()
    half = x.shape[-1] // 2
    if is_dtensor(xf):          # the same values; DTensor has no rule for roll on torch 2.11
        last = xf.dim() - 1
        turned = torch.cat([xf.narrow(last, half, half), xf.narrow(last, 0, half)], dim=last)
    else:
        turned = torch.roll(xf, half, dims=-1)
    return (xf * cos + turned * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int32."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [3, B, S] int32 (t/h/w position ids)."""
    return rotate(x, mrope_tables(positions, x.shape[-1], theta))


def positional_tables(cfg, positions: Optional[torch.Tensor]):
    """Per-pass positional state for ``attention_*``: rope or M-RoPE tables
    (positions [B, S] or [3, B, S]), or None."""
    if positions is None or cfg.rope == "none":
        return None
    if cfg.rope == "mrope":
        return mrope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if cfg.rope == "rope":
        return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    raise ValueError(cfg.rope)


# -------------------------------------------------------------------------- MLP

def mlp_specs(cfg, dtype, d_ff: Optional[int] = None, stack: Tuple[int, ...] = ()):
    ff = cfg.d_ff if d_ff is None else d_ff
    if ff == 0:
        return {}
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": dense_spec(cfg.d_model, ff, ("embed", "ffn"), dtype, stack=stack),
            "w_up": dense_spec(cfg.d_model, ff, ("embed", "ffn"), dtype, stack=stack),
            "w_down": dense_spec(ff, cfg.d_model, ("ffn", "embed"), dtype, stack=stack),
        }
    out = {
        "w_up": dense_spec(cfg.d_model, ff, ("embed", "ffn"), dtype, stack=stack),
        "w_down": dense_spec(ff, cfg.d_model, ("ffn", "embed"), dtype, stack=stack),
    }
    if cfg.mlp_bias:
        out["b_up"] = bias_spec(ff, "ffn", dtype, stack=stack)
        out["b_down"] = bias_spec(cfg.d_model, None, dtype, stack=stack)
    return out


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default form


def apply_mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]."""
    if not p:
        return torch.zeros_like(x)
    if cfg.act in ("swiglu", "geglu"):
        g = torch.matmul(x, p["w_gate"])
        u = torch.matmul(x, p["w_up"])
        g = constrain(g, "batch", "seq", "ffn")
        act = F.silu(g) if cfg.act == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = torch.matmul(x, p["w_up"])
        if "b_up" in p:
            h = h + p["b_up"]
        h = constrain(h, "batch", "seq", "ffn")
        h = _gelu(h)
    y = torch.matmul(h, p["w_down"])
    if "b_down" in p:
        y = y + p["b_down"]
    return constrain(y, "batch", "seq", "embed")


# -------------------------------------------------------------------- embedding

def embedding_specs(cfg, dtype, max_seq: int):
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), dtype, ("vocab", "embed"),
                            normal_init(1.0, fan_in_axis=1))}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype, ("embed", "vocab"),
                                   normal_init(1.0, fan_in_axis=0))
    if cfg.rope == "none" and cfg.ssm is None:
        out["pos"] = ParamSpec((max_seq, cfg.d_model), dtype, (None, "embed"),
                               normal_init(0.02))
    return out


def embed_tokens(cfg, p: dict, tokens: torch.Tensor, pos_offset=0) -> torch.Tensor:
    """pos_offset: int or 0-d tensor, or [B] tensor of per-row offsets."""
    x = _lookup(p["tok"], tokens) if is_dtensor(p["tok"]) else p["tok"][tokens]
    if "pos" in p:
        S = tokens.shape[1]
        ar = torch.arange(S, device=tokens.device)
        if isinstance(pos_offset, int) or pos_offset.dim() == 0:
            x = x + p["pos"][pos_offset + ar][None]
        else:
            x = x + p["pos"][pos_offset[:, None] + ar[None]]
    return constrain(x.to(torch_dtype(cfg.dtype)), "batch", "seq", "embed")


def _lookup(table, tokens):
    """``table[tokens]`` for a DTensor table [V, d], on each rank's own token
    rows and its own slice of the vocabulary: a token outside the slice gives
    zeros, and over the mesh dims that split the vocabulary the rows are a
    ``Partial`` sum; the gradient of the slice is each rank's partial sum
    over the mesh dims that split the tokens. (DTensor's rules for this
    gather and its scatter-add fail on torch 2.11 and leave a mask the wrong
    shape on 2.13.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, tab_pl = table.device_mesh, list(table.placements)
    if not all(p.is_replicate() or (type(p) is Shard and p.dim == 0) for p in tab_pl):
        tab_pl = [Replicate()] * mesh.ndim          # not contiguous row blocks: whole
        table = table.redistribute(mesh, tab_pl)
    tok_pl = list(tokens.placements) if is_dtensor(tokens) else [Replicate()] * mesh.ndim
    if any(t.is_shard() and p.is_shard() for t, p in zip(tok_pl, tab_pl)):
        raise NotImplementedError(f"tokens {tok_pl} and their table {tab_pl} split one mesh dim")
    local = table.to_local(grad_placements=[
        Partial() if t.is_shard() else (Shard(0) if p.is_shard() else Replicate())
        for t, p in zip(tok_pl, tab_pl)])
    (rows_here, _), (start, _) = local_shape_and_offset(table.shape, mesh, tab_pl)
    idx = (tokens.to_local() if is_dtensor(tokens) else tokens) - start
    inside = (idx >= 0) & (idx < rows_here)
    rows = local[idx.clamp(0, rows_here - 1)] * inside[..., None].to(local.dtype)
    return DTensor.from_local(rows, mesh, [Partial() if p.is_shard() else t
                                           for t, p in zip(tok_pl, tab_pl)], run_check=False)


def logits_head(cfg, emb_params: dict, x: torch.Tensor) -> torch.Tensor:
    w = emb_params["tok"].T if cfg.tie_embeddings else emb_params["unembed"]
    return constrain(torch.matmul(x, w), "batch", "seq", "vocab")
