"""Weight snapshot store, v1 format (port of ``repro.core.snapshot``).

A snapshot is written at deploy time in exactly the layout the executor
consumes, so a cold start moves bytes and does nothing else:

    <root>/<name>/index.json         tree structure + per-leaf path/shape/dtype
    <root>/<name>/leaf_00000.npy ... one file per leaf, in flattening order

The on-disk layout is the JAX package's, byte for byte: leaves are numbered
in JAX's flattening order (sorted dict keys), named by ``keystr`` paths
(``['embed']['tok']``), and a bf16 leaf is stored as a uint16 view with the
logical dtype in the index. A snapshot written by either package restores
into the other with no transform.

Host leaves come back as CPU tensors over ``np.load(mmap_mode='r')`` memory:
bytes page in lazily while ``DevicePut`` copies them to the device. The
chunked v2 format (content-addressed chunks, delta restore) comes with the
control-plane slice; a v2 index is refused here.

Invariants: ``save`` publishes atomically (a reader never sees a partial
snapshot); the index records the logical dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict

import numpy as np

from repro_torch import pytree
from repro_torch.dtypes import from_storable, to_storable


class SnapshotStore:
    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        # parsed index.json memo, replaced on save
        self._index_cache: Dict[str, Dict[str, Any]] = {}

    def _dir(self, name: str) -> Path:
        return self.root / name

    def has(self, name: str) -> bool:
        return (self._dir(name) / "index.json").exists()

    # ------------------------------------------------------------------- save
    def save(self, name: str, params) -> int:
        """Write a v1 snapshot of a tensor tree atomically; returns stored bytes."""
        items = pytree.flatten_with_paths(params)
        d = self._dir(name)
        tmp = d.with_name(d.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        index: Dict[str, Any] = {"leaves": [], "treedef": None}
        total = 0
        for i, (path, leaf) in enumerate(items):
            stored, logical = to_storable(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, stored, allow_pickle=False)
            total += (tmp / fname).stat().st_size
            index["leaves"].append({"path": path, "file": fname,
                                    "shape": list(leaf.shape), "dtype": logical})
        index["treedef"] = _encode_structure(pytree.structure(params))
        (tmp / "index.json").write_text(json.dumps(index))
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)                                   # atomic publish
        with self._lock:
            self._index_cache[name] = index
        return total

    # ------------------------------------------------------------------- load
    def read_index(self, name: str) -> Dict[str, Any]:
        """Parsed index.json; memoized until the snapshot is overwritten."""
        with self._lock:
            index = self._index_cache.get(name)
            if index is None:
                index = json.loads((self._dir(name) / "index.json").read_text())
                if index.get("format") == 2:
                    raise NotImplementedError(
                        f"snapshot {name!r} is in the chunked v2 format, not yet ported")
                self._index_cache[name] = index
            return index

    def iter_host_leaves(self, name: str):
        """Yield host leaves (CPU tensors over mmap'd files) in ordinal order."""
        d = self._dir(name)
        for e in self.read_index(name)["leaves"]:
            arr = np.load(d / e["file"], mmap_mode="r")
            yield from_storable(arr, e["dtype"]).reshape(e["shape"])

    def load_host(self, name: str) -> Any:
        """Load as a tree of CPU tensors over mmap'd files. No device transfer."""
        index = self.read_index(name)
        return _rebuild_structure(index["treedef"], list(self.iter_host_leaves(name)))

    def nbytes(self, name: str) -> int:
        return sum(f.stat().st_size for f in self._dir(name).glob("leaf_*.npy"))


# --------------------------------------------- structure (de)serialization

def _encode_structure(obj):
    """Encode a tree whose leaves are ints (ordinals) into JSON."""
    if isinstance(obj, dict):
        return {"__kind__": "dict", "items": {k: _encode_structure(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__kind__": type(obj).__name__,
                "items": [_encode_structure(v) for v in obj]}
    if isinstance(obj, int):
        return {"__kind__": "leaf", "ordinal": obj}
    if obj is None:
        return {"__kind__": "none"}
    raise TypeError(f"unsupported structure node: {type(obj)}")


def _rebuild_structure(enc, leaves):
    kind = enc["__kind__"]
    if kind == "dict":
        return {k: _rebuild_structure(v, leaves) for k, v in enc["items"].items()}
    if kind == "list":
        return [_rebuild_structure(v, leaves) for v in enc["items"]]
    if kind == "tuple":
        return tuple(_rebuild_structure(v, leaves) for v in enc["items"])
    if kind == "leaf":
        return leaves[enc["ordinal"]]
    if kind == "none":
        return None
    raise TypeError(kind)
