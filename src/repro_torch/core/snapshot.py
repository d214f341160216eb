"""Weight snapshot store (port of ``repro.core.snapshot``).

A snapshot is written at deploy time in exactly the layout the executor
consumes, so a cold start moves bytes and does nothing else. Two on-disk
formats, both the JAX package's byte for byte:

v1 (a store without a blob store):
    <root>/<name>/index.json         tree structure + per-leaf path/shape/dtype
    <root>/<name>/leaf_00000.npy ... one file per leaf, in flattening order
    Host leaves come back as CPU tensors over ``np.load(mmap_mode='r')``
    memory: bytes page in lazily while ``DevicePut`` copies them.

v2 (chunked; whenever a ``blobs`` ChunkStore is attached — the Gateway always
attaches one):
    <root>/<name>/index.json         tree structure + per-leaf CHUNK MANIFEST
    <blobs>/<id[:2]>/<id>.chunk      content-addressed chunks, shared across
                                     snapshots (refcounted in the ChunkStore)
    ``save`` splits each leaf's raw bytes into fixed-size BLAKE2-addressed
    chunks; a restore with a host chunk tier is a delta restore
    (:func:`repro_torch.core.blobstore.delta_restore`): only the chunks the
    host does not hold move.

Leaves are numbered in JAX's flattening order (sorted dict keys) and named by
``keystr`` paths (``['embed']['tok']``); a bf16 leaf is stored as a uint16
view with the logical dtype in the index and read back with
``Tensor.view(torch.bfloat16)``. A snapshot written by either package
restores into the other with no transform. ``save`` persists the deploy-time
``first_use_order`` (leaf paths in the order execution first needs them,
:func:`repro_torch.core.deploy.first_use_order`) into the index of either
format, as the JAX package's v2.1 manifest does; ``leaf_order`` and
``iter_restore`` stream leaves in that order.

The generic checkpoint (``save_generic_checkpoint`` / ``load_generic_host``)
is the cold_jit drivers' slow path: one ``.npz`` holding every leaf as
float32 under ``a{i}`` in JAX's flattening order, parsed in full and cast
back on load — the JAX package's file, array for array.

Invariants: ``save`` publishes atomically (a reader never sees a partial
snapshot); v2 chunk refcounts are balanced — one incref per unique chunk per
save, one decref per evict/overwrite; the index records the logical dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.blobstore import split_chunks
from repro_torch.dtypes import from_storable, to_storable


class SnapshotStore:
    def __init__(self, root: str | Path, blobs=None) -> None:
        """``blobs`` is a :class:`repro_torch.core.blobstore.ChunkStore`; when
        attached, ``save`` writes the v2 chunked format instead of per-leaf
        .npy files."""
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.blobs = blobs
        self._lock = threading.Lock()
        # parsed index.json memo (every boot probes is_chunked and reads the
        # manifest); replaced on save, dropped on evict
        self._index_cache: Dict[str, Dict[str, Any]] = {}

    def _dir(self, name: str) -> Path:
        return self.root / name

    def has(self, name: str) -> bool:
        return (self._dir(name) / "index.json").exists()

    def is_chunked(self, name: str) -> bool:
        """True when this snapshot is stored in the v2 chunk-manifest format."""
        return self.has(name) and self.read_index(name).get("format") == 2

    # ------------------------------------------------------------------- save
    def save(self, name: str, params,
             first_use_order: Optional[List[str]] = None) -> int:
        """Write a snapshot of a tensor tree atomically; returns stored bytes
        (v2: the leaves' logical bytes). ``first_use_order`` (leaf paths in
        execution first-touch order) goes into the index, where restores read
        it as their streaming order; it is advisory, and an index without it
        restores in ordinal order."""
        if self.blobs is not None:
            return self._save_v2(name, params, first_use_order)
        items = pytree.flatten_with_paths(params)
        d = self._dir(name)
        tmp = d.with_name(d.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        index: Dict[str, Any] = {"leaves": [], "treedef": None}
        if first_use_order:
            index["first_use_order"] = list(first_use_order)
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

    def _save_v2(self, name: str, params,
                 first_use_order: Optional[List[str]] = None) -> int:
        items = pytree.flatten_with_paths(params)
        chunk_bytes = self.blobs.chunk_bytes
        index: Dict[str, Any] = {"format": 2, "chunk_bytes": chunk_bytes,
                                 "leaves": [], "treedef": None}
        if first_use_order:
            index["version"] = "2.1"
            index["first_use_order"] = list(first_use_order)
        raws = []
        for path, leaf in items:
            stored, logical = to_storable(leaf)
            raws.append((path, list(leaf.shape), logical, str(stored.dtype),
                         np.ascontiguousarray(stored).tobytes()))
        # put_all writes the chunks and takes the snapshot's references inside
        # the ChunkStore's own lock, outside this store's: read_index (every
        # boot) must not wait behind a multi-second write
        leaf_cid_lists = self.blobs.put_all(
            [split_chunks(raw, chunk_bytes) for *_meta, raw in raws])
        total = 0
        for (path, shape, logical, stored_dtype, raw), cids in zip(raws, leaf_cid_lists):
            total += len(raw)
            index["leaves"].append({"path": path, "chunks": cids, "nbytes": len(raw),
                                    "shape": shape, "dtype": logical,
                                    "stored_dtype": stored_dtype})
        index["treedef"] = _encode_structure(pytree.structure(params))
        with self._lock:
            old_cids: List[str] = []
            if self.has(name):                   # overwrite: release old chunks
                old = self._read_index_locked(name)
                if old.get("format") == 2:
                    old_cids = [c for e in old["leaves"] for c in e["chunks"]]
            d = self._dir(name)
            tmp = d.with_name(d.name + ".tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            (tmp / "index.json").write_text(json.dumps(index))
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)                               # atomic publish
            self._index_cache[name] = index
            if old_cids:
                self.blobs.decref(old_cids)
        return total

    # ------------------------------------------------------------------- load
    def read_index(self, name: str) -> Dict[str, Any]:
        """Parsed index.json (v1 file names or a v2 chunk manifest); memoized
        until the snapshot is overwritten or evicted. Callers never mutate it."""
        with self._lock:
            return self._read_index_locked(name)

    def _read_index_locked(self, name: str) -> Dict[str, Any]:
        index = self._index_cache.get(name)
        if index is None:
            index = json.loads((self._dir(name) / "index.json").read_text())
            self._index_cache[name] = index
        return index

    @staticmethod
    def index_nbytes(index: Dict[str, Any]) -> int:
        """Logical stored bytes of a v2 index (sum of leaf byte lengths)."""
        return sum(int(e["nbytes"]) for e in index["leaves"])

    def chunk_ids(self, name: str) -> List[str]:
        """Every chunk id of a v2 snapshot, in manifest order (with repeats)."""
        return [c for e in self.read_index(name)["leaves"] for c in e["chunks"]]

    @staticmethod
    def leaf_order(index: Dict[str, Any]) -> List[int]:
        """Leaf ordinals in restore order: the manifest's ``first_use_order``
        where present (unknown paths skipped, uncovered leaves appended in
        ordinal order), else identity. Always a permutation."""
        order = index.get("first_use_order")
        n = len(index["leaves"])
        if not order:
            return list(range(n))
        by_path = {e["path"]: i for i, e in enumerate(index["leaves"])}
        out = [by_path[p] for p in order if p in by_path]
        covered = set(out)
        out.extend(i for i in range(n) if i not in covered)
        return out

    @staticmethod
    def _leaf_from_chunks(entry: Dict[str, Any], chunk_bytes: Callable[[str], bytes]):
        # joined into a bytearray (one copy, as b"".join would make) so the
        # buffer is writable and torch.from_numpy takes it without its
        # non-writable warning; the assembled tree is memoized on the host
        # tier and every later boot only reads it (DevicePut copies it out)
        raw = bytearray().join(chunk_bytes(cid) for cid in entry["chunks"])
        stored = np.frombuffer(raw, dtype=np.dtype(entry["stored_dtype"]))
        return from_storable(stored, entry["dtype"]).reshape(entry["shape"])

    def assemble_tree(self, index: Dict[str, Any], chunk_bytes: Callable[[str], bytes],
                      order: Optional[List[int]] = None) -> Any:
        """Rebuild the host tree of a v2 index from a chunk-byte source (any
        mix of tier-resident, peer-fetched and store-fetched chunks). ``order``
        sets the fetch order only; leaves land at their ordinals."""
        entries = index["leaves"]
        if order is None:
            order = self.leaf_order(index)
        leaves: List[Any] = [None] * len(entries)
        for i in order:
            leaves[i] = self._leaf_from_chunks(entries[i], chunk_bytes)
        return _rebuild_structure(index["treedef"], leaves)

    def iter_restore(self, name: str):
        """Yield ``(ordinal, path, host_leaf)`` in first-use order, both
        formats — the streamed restore's producer over the global store: v2
        assembles each leaf from the chunk store as it is reached, v1 opens
        one mmap'd .npy at a time."""
        d = self._dir(name)
        index = self.read_index(name)
        entries = index["leaves"]
        for i in self.leaf_order(index):
            e = entries[i]
            if index.get("format") == 2:
                leaf = self._leaf_from_chunks(e, self.blobs.get)
            else:
                arr = np.load(d / e["file"], mmap_mode="r")
                leaf = from_storable(arr, e["dtype"]).reshape(e["shape"])
            yield i, e["path"], leaf

    def iter_host_leaves(self, name: str):
        """Yield host leaves (CPU tensors) in ordinal order: v1 over mmap'd
        files, v2 assembled from the global chunk store."""
        d = self._dir(name)
        index = self.read_index(name)
        for e in index["leaves"]:
            if index.get("format") == 2:
                yield self._leaf_from_chunks(e, self.blobs.get)
            else:
                arr = np.load(d / e["file"], mmap_mode="r")
                yield from_storable(arr, e["dtype"]).reshape(e["shape"])

    def load_host(self, name: str) -> Any:
        """Load as a tree of CPU tensors. No device transfer."""
        index = self.read_index(name)
        return _rebuild_structure(index["treedef"], list(self.iter_host_leaves(name)))

    def nbytes(self, name: str) -> int:
        if self.has(name):
            index = self.read_index(name)
            if index.get("format") == 2:
                return self.index_nbytes(index)
        return sum(f.stat().st_size for f in self._dir(name).glob("leaf_*.npy"))

    def evict(self, name: str) -> None:
        """Remove a snapshot; v2 releases its chunk references (shared chunks
        survive while another snapshot references them)."""
        with self._lock:
            if self.blobs is not None and self.has(name):
                index = self._read_index_locked(name)
                if index.get("format") == 2:
                    self.blobs.decref(c for e in index["leaves"] for c in e["chunks"])
            self._index_cache.pop(name, None)
            shutil.rmtree(self._dir(name), ignore_errors=True)


# --------------------------------------------------------------- generic ckpt

def save_generic_checkpoint(path: str | Path, params) -> int:
    """The 'interpreted-language' comparison path: one uncompressed ``.npz``,
    every leaf as float32 under ``a{i}`` in JAX's flattening order, no layout
    guarantee — loading pays a full parse and a cast. ``params`` is a tree of
    tensors or numpy arrays, or an iterable of leaves already in that order;
    leaves are converted and written one at a time, so the file never sits
    whole in host memory (``np.savez`` holds every array at once). Returns
    the file's size in bytes."""
    path = Path(path if str(path).endswith(".npz") else f"{path}.npz")
    leaves = pytree.leaves(params) if isinstance(params, (dict, list, tuple)) else params
    tmp = path.with_name(path.name + ".tmp")
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                arr = leaf.detach().to("cpu", torch.float32).numpy()
            else:
                arr = np.asarray(leaf, dtype=np.float32)
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr), allow_pickle=False)
    os.replace(tmp, path)                                    # atomic publish
    return path.stat().st_size


def load_generic_host(path: str | Path, like) -> Any:
    """Host half of the generic load: full parse + cast back to the dtypes of
    ``like`` (a tree of tensors or :class:`ParamSpec`-like leaves with
    ``dtype``), as CPU tensors. No device transfer."""
    with np.load(path) as z:
        arrays = [z[f"a{i}"] for i in range(len(z.files))]
    struct = pytree.structure(like, is_leaf=_has_dtype)
    targets = pytree.leaves(like, is_leaf=_has_dtype)
    if len(arrays) != len(targets):
        raise ValueError(f"generic checkpoint {path}: {len(arrays)} arrays for "
                         f"{len(targets)} leaves")
    return pytree.unflatten(struct, [torch.from_numpy(a).to(t.dtype).reshape(t.shape)
                                     for a, t in zip(arrays, targets)])


def load_generic_checkpoint(path: str | Path, like, device="cuda") -> Any:
    """Load + cast back to the target dtypes on ``device`` (pays the
    transform in the start path)."""
    return pytree.tree_map(lambda t: t.to(device), load_generic_host(path, like))


def _has_dtype(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) and hasattr(x, "dtype")


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
