"""Carry a JAX parameter tree over into the port.

``params_from_numpy`` takes the JAX package's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``; bf16 leaves are ``ml_dtypes`` arrays)
and returns the port's tree: the same nested-dict key paths, the same shapes,
the same ``[d_in, d_out]`` layout and stacked ``[L, ...]`` layer leaves — no
transposes, no reshapes.
"""
from __future__ import annotations

import numpy as np

from repro_torch import pytree
from repro_torch.dtypes import from_storable


def params_from_numpy(tree, device="cuda"):
    """numpy tree (any nesting of dicts/lists) -> tensor tree on ``device``."""
    def leaf(a):
        a = np.array(a)                     # a writable, contiguous copy
        return from_storable(a, a.dtype.name).to(device)
    return pytree.tree_map(leaf, tree)
