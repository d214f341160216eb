"""Carry a JAX parameter tree over into the port.

``params_from_numpy`` takes the JAX package's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``; bf16 leaves are ``ml_dtypes`` arrays)
and returns the port's tree: the same nested-dict key paths, the same shapes,
the same ``[d_in, d_out]`` layout and stacked ``[L, ...]`` layer leaves — no
transposes, no reshapes.

``mlp_from_numpy`` does the same for the learned arrival forecaster's MLP
(``repro_torch.core.forecast.ForecastMLP``), whose ``nn.Linear`` layers keep
their weights transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.dtypes import from_storable


def params_from_numpy(tree, device="cuda"):
    """numpy tree (any nesting of dicts/lists) -> tensor tree on ``device``."""
    def leaf(a):
        a = np.array(a)                     # a writable, contiguous copy
        return from_storable(a, a.dtype.name).to(device)
    return pytree.tree_map(leaf, tree)


def mlp_from_numpy(mlp, params):
    """Load a JAX ``LearnedForecaster``'s ``params`` — a list of numpy
    ``(w [in, out], b [out])`` pairs, one per layer — into ``mlp`` (a
    ``ForecastMLP`` of the same sizes), in place, on its device; returns it.
    ``nn.Linear`` stores ``w`` as ``[out, in]``."""
    if len(params) != len(mlp.layers):
        raise ValueError(f"{len(params)} layers of params for a {len(mlp.layers)}-layer MLP")
    with torch.no_grad():
        for layer, (w, b) in zip(mlp.layers, params):
            w, b = np.array(w, np.float32), np.array(b, np.float32)    # writable copies
            if w.T.shape != tuple(layer.weight.shape) or b.shape != tuple(layer.bias.shape):
                raise ValueError(f"layer shapes {w.shape}, {b.shape} do not fit {layer}")
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            layer.bias.copy_(torch.from_numpy(b))
    return mlp
