"""The weights ``deploy`` makes from ``FunctionSpec.seed``, made again.

A frozen copy of the port's init recipe for a dense stack
(``repro_torch.models.layers.init_tree`` over ``Model.param_specs``): one
``torch.Generator`` on the device, seeded with the run's seed, walks the
parameter tree in sorted-key order; a weight ``[*stack, d_in, d_out]`` (and
the embedding ``[V, d]``) is ``(randn(shape, float32) * (1 / sqrt(fan_in)))``
cast to bfloat16, with ``fan_in`` its first axis after the stack (the
embedding's: ``d``); biases are zeros and norm scales ones, which draw
nothing. Layers are stacked along a leading axis of ``L``. The benchmark's
tests hold this copy to the port's own tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference.arch import Arch

NORMAL, ZEROS, ONES = "normal", "zeros", "ones"


def leaves(a: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, init) of every parameter, in the order the recipe draws."""
    L, d, ff = a.layers, a.d, a.ff
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    out = [("embed.tok", (a.vocab, d), NORMAL)]
    if not a.tied:
        out.append(("embed.unembed", (d, a.vocab), NORMAL))
    if a.norm_affine:
        out += [("final.bias", (d,), ZEROS), ("final.scale", (d,), ONES)]
    attn = {"wk": (L, d, kv), "wo": (L, q, d), "wq": (L, d, q), "wv": (L, d, kv)}
    if a.bias:
        attn.update(bk=(L, kv), bo=(L, d), bq=(L, q), bv=(L, kv))
    for k in sorted(attn):
        out.append((f"layers.attn.{k}", attn[k], NORMAL if k.startswith("w") else ZEROS))
    for ln in ("ln1", "ln2"):
        if a.norm_affine:
            out += [(f"layers.{ln}.bias", (L, d), ZEROS), (f"layers.{ln}.scale", (L, d), ONES)]
    mlp = {"w_down": (L, ff, d), "w_up": (L, d, ff)}
    if a.gated:
        mlp["w_gate"] = (L, d, ff)
    if a.bias:
        mlp.update(b_down=(L, d), b_up=(L, ff))
    for k in sorted(mlp):
        out.append((f"layers.mlp.{k}", mlp[k], NORMAL if k.startswith("w") else ZEROS))
    return out


def make(a: Arch, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The parameters by path, in ``dtype`` (bfloat16, as served)."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    out = {}
    for path, shape, init in leaves(a):
        if init == NORMAL:
            fan_in = shape[1] if path == "embed.tok" else shape[-2]
            x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
            out[path] = (x * (1.0 / math.sqrt(fan_in))).to(dtype)
        elif init == ZEROS:
            out[path] = torch.zeros(shape, dtype=dtype, device=gen.device)
        else:
            out[path] = torch.ones(shape, dtype=dtype, device=gen.device)
    return out
