"""Dtype names shared with the JAX package's on-disk formats.

numpy has no bfloat16 or float8 without ``ml_dtypes``, which the port does not
import. Such leaves travel as a same-width unsigned view plus the logical
dtype's name, exactly as ``repro.core.snapshot`` stores them, and become
tensors through ``Tensor.view(torch.bfloat16)``.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

# logical names numpy cannot represent natively -> torch dtype
_NON_NATIVE = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_NATIVE = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
# same-width signed views (torch.from_numpy takes these on every version)
_INT_VIEWS = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16),
              4: (np.int32, torch.int32), 8: (np.int64, torch.int64)}
_UINT_VIEWS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype of a logical dtype name (``"bfloat16"``, ``"float32"``...)."""
    if name in _NON_NATIVE:
        return _NON_NATIVE[name]
    if name in _NATIVE:
        return _NATIVE[name]
    raise TypeError(f"unsupported dtype {name!r}")


def dtype_name(dtype: torch.dtype) -> str:
    """Logical name of a torch dtype, as numpy/ml_dtypes spell it."""
    return str(dtype).removeprefix("torch.")


def to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """CPU numpy array to write, and the logical dtype name to record.

    Non-native dtypes become the same-width unsigned view the JAX package
    writes (bf16 -> uint16), so the two packages write identical bytes."""
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name in _NATIVE:
        return t.numpy(), name
    np_view, t_view = _INT_VIEWS[t.element_size()]
    raw = t.view(t_view).numpy().view(np_view)
    return raw.view(_UINT_VIEWS[t.element_size()]), name


def from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    """CPU tensor over ``arr``'s memory (no copy) with the logical dtype.

    ``arr`` is either already of the logical dtype (native names) or a
    same-width unsigned view, or an ``ml_dtypes`` array whose dtype name is
    the logical name (the JAX package's in-memory bf16)."""
    dt = torch_dtype(logical)
    if logical in _NATIVE:
        return _from_numpy(arr.astype(logical, copy=False))
    np_view, t_view = _INT_VIEWS[arr.dtype.itemsize]
    return _from_numpy(arr.view(np_view)).view(t_view).view(dt)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    # read-only mmap: torch warns that writes would be undefined; the
    # snapshot path only reads these buffers (copying them to the device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(arr)
