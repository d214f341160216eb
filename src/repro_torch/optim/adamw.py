"""AdamW with a cosine schedule, global-norm clipping and quantized moments
(port of ``repro.optim.adamw``).

``state_dtype`` options:
  * ``float32``  — standard.
  * ``bfloat16`` — halves optimizer memory.
  * ``int8``     — 8-bit blockwise-quantized moments: m and v are stored as
    int8 with one float32 scale per row (last axis), dequantized for the
    update and requantized after (rounding half to even, as ``jnp.round``).

The optimizer is functional, as the JAX package's: ``init`` -> state tree
(``{"m", "v", "step"}``, the same key paths, shapes and dtypes, so a
checkpoint of either package restores in the other); ``update`` -> (params,
state, stats) as new tensors, under ``torch.no_grad()``. The rules are
JAX's: the clip's global norm is summed in float32 over the leaves in JAX's
flattening order, and decoupled weight decay applies to every leaf with
``ndim >= 2`` — the stacked ``[L, d]`` norm scales among them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import pytree
from repro_torch.dtypes import torch_dtype
from repro_torch.models.layers import ParamSpec, is_spec


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    end_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine down
    to ``end_frac * peak_lr`` at ``total``; float32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (end_frac + (1 - end_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # float32 | bfloat16 | int8


# ------------------------------------------------------------- int8 moment codec

def _q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise (per-last-axis-row) symmetric int8 -> (q, float32 scale)."""
    xf = x.float()
    if xf.dim() == 0:
        scale = xf.abs().clamp_min(1e-30) / 127.0
    else:
        scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _q8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _is_mom_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _zeros(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


class AdamW:
    def __init__(self, cfg: AdamWConfig) -> None:
        self.cfg = cfg

    # ------------------------------------------------------------------- state
    def _moment_init(self, leaf: torch.Tensor):
        if self.cfg.state_dtype == "int8":
            q, s = _q8_encode(torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device))
            return {"q": q, "scale": s}
        return torch.zeros(leaf.shape, dtype=torch_dtype(self.cfg.state_dtype),
                           device=leaf.device)

    def init(self, params) -> Dict:
        """Zero moments beside each leaf of ``params`` (on its device) and a
        0-d int32 ``step``."""
        device = pytree.leaves(params)[0].device
        return {"m": pytree.tree_map(self._moment_init, params),
                "v": pytree.tree_map(self._moment_init, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def state_specs(self, param_specs) -> Dict:
        """ParamSpec tree of the optimizer state (mirrors the parameter axes)."""
        def mom(spec: ParamSpec):
            if self.cfg.state_dtype == "int8":
                scale_shape = (*spec.shape[:-1], 1) if spec.shape else ()
                return {
                    "q": ParamSpec(spec.shape, torch.int8, spec.axes, _zeros),
                    "scale": ParamSpec(scale_shape, torch.float32,
                                       spec.axes if spec.shape else (),
                                       lambda gen, s, d: torch.full(s, 1e-30 / 127.0, dtype=d,
                                                                    device=gen.device)),
                }
            return ParamSpec(spec.shape, torch_dtype(self.cfg.state_dtype), spec.axes, _zeros)

        return {"m": pytree.tree_map(mom, param_specs, is_leaf=is_spec),
                "v": pytree.tree_map(mom, param_specs, is_leaf=is_spec),
                "step": ParamSpec((), torch.int32, (), _zeros)}

    # ------------------------------------------------------------------ update
    def _decode(self, mom) -> torch.Tensor:
        if self.cfg.state_dtype == "int8":
            return _q8_decode(mom["q"], mom["scale"])
        return mom.float()

    def _encode(self, x: torch.Tensor):
        if self.cfg.state_dtype == "int8":
            q, s = _q8_encode(x)
            return {"q": q, "scale": s}
        return x.to(torch_dtype(self.cfg.state_dtype))

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict, Dict]:
        """One AdamW step -> (new params, new state, {"lr", "grad_norm",
        "clip"}); ``grads`` has the tree of ``params``."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = cosine_schedule(step, peak_lr=cfg.peak_lr, warmup=cfg.warmup,
                             total=cfg.total_steps)

        # global-norm clip (float32), summed leaf by leaf in JAX's order
        flat_g = [g.float() for g in pytree.leaves(grads)]
        gnorm = torch.sqrt(sum(g.square().sum() for g in flat_g))
        clip = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12), max=1.0)

        stepf = step.float()
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)

        def upd(g, m_enc, v_enc, p):
            g = g * clip
            m = cfg.b1 * self._decode(m_enc) + (1 - cfg.b1) * g
            v = cfg.b2 * self._decode(v_enc) + (1 - cfg.b2) * g.square()
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            # decoupled weight decay on matrix-like params only
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.float()
            new_p = (p.float() - lr * delta).to(p.dtype)
            return new_p, self._encode(m), self._encode(v)

        struct = pytree.structure(params)
        flat_m = pytree.leaves(state["m"], is_leaf=_is_mom_leaf)
        flat_v = pytree.leaves(state["v"], is_leaf=_is_mom_leaf)
        flat_p = pytree.leaves(params)
        outs = []
        for i in range(len(flat_p)):
            outs.append(upd(flat_g[i], flat_m[i], flat_v[i], flat_p[i]))
            flat_g[i] = None                 # drop each f32 grad once it is used
        new_params = pytree.unflatten(struct, [o[0] for o in outs])
        new_m = pytree.unflatten(struct, [o[1] for o in outs])
        new_v = pytree.unflatten(struct, [o[2] for o in outs])
        stats = {"lr": lr, "grad_norm": gnorm, "clip": clip}
        return new_params, {"m": new_m, "v": new_v, "step": step}, stats
