"""Shared building blocks: ParamSpec machinery, norms, RoPE, MLP, embeddings.

Port of ``repro.models.layers``. Parameters are described once as a tree of
:class:`ParamSpec`; :func:`init_tree` materialises it from a
``torch.Generator`` on that generator's device. Apply functions take the
plain tensor tree, keyed and laid out as in the JAX package (weights are
``[d_in, d_out]``, stacked layers lead with ``[L, ...]``), so a JAX parameter
tree or snapshot carries over with no transform.

The JAX package's ``constrain`` (sharding hints) is dropped: the port runs on
one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree
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
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight                  # promotes a bf16 weight to f32 exactly
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
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
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    if cfg.norm == "layernorm_np":
        return layer_norm(x, None, None)
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
    ang = positions.float()[..., None] * inv                              # [B, S, hd/2]
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
    out = xf * cos + torch.roll(xf, x.shape[-1] // 2, dims=-1) * sin
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int32."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def positional_tables(cfg, positions: Optional[torch.Tensor]):
    """Per-pass positional state for ``attention_*``: rope tables, or None."""
    if positions is None or cfg.rope == "none":
        return None
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope {cfg.rope!r} not yet ported")
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


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
        act = F.silu(g) if cfg.act == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = torch.matmul(x, p["w_up"])
        if "b_up" in p:
            h = h + p["b_up"]
        h = _gelu(h)
    y = torch.matmul(h, p["w_down"])
    if "b_down" in p:
        y = y + p["b_down"]
    return y


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
    x = p["tok"][tokens]
    if "pos" in p:
        S = tokens.shape[1]
        ar = torch.arange(S, device=tokens.device)
        if isinstance(pos_offset, int) or pos_offset.dim() == 0:
            x = x + p["pos"][pos_offset + ar][None]
        else:
            x = x + p["pos"][pos_offset[:, None] + ar[None]]
    return x.to(torch_dtype(cfg.dtype))


def logits_head(cfg, emb_params: dict, x: torch.Tensor) -> torch.Tensor:
    w = emb_params["tok"].T if cfg.tie_embeddings else emb_params["unembed"]
    return torch.matmul(x, w)
