"""The port's chunk store, host chunk tier, v2 snapshots and delta restore on
the CPU, held against the JAX package (``repro.core.blobstore``,
``repro.core.snapshot``, ``repro.core.scheduler``).

* v2 snapshots interchange byte for byte in both directions: the same chunk
  ids and the same ``index.json`` leaves for the same weights;
* ``HostChunkTier`` register, evict and dedup give the JAX tier's counters
  under one operation sequence;
* ``delta_restore`` gives the JAX stats (cached, peer or store bytes) under
  one sequence over two hosts of each package's ``Cluster``;
* a corrupt peer chunk is re-fetched from the store, and a corrupt store
  chunk raises ``ChunkIntegrityError``;
* a snapshot larger than the tier is refused, and restores without a memo.
"""
import json
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import blobstore as jax_blobstore
from repro.core.cluster import Cluster as JaxCluster
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
from repro_torch import pytree
from repro_torch.core import blobstore
from repro_torch.core.blobstore import ChunkIntegrityError, ChunkStore, HostChunkTier, delta_restore
from repro_torch.core.cluster import Cluster
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.snapshot import SnapshotStore

CHUNK = 64                               # bytes per chunk: several per leaf


def _np_tree(seed=0):
    """A mixed tree as the JAX package holds it: f32, bf16, int32, a scalar,
    an empty leaf and an empty dict."""
    rng = np.random.default_rng(seed)
    return {"layers": {"w": rng.standard_normal((3, 40)).astype(np.float32),
                       "b": rng.standard_normal((4, 50)).astype(ml_dtypes.bfloat16)},
            "emb": {"tok": rng.standard_normal((6, 4)).astype(ml_dtypes.bfloat16)},
            "list": [np.arange(70, dtype=np.int32), np.zeros((), np.float32),
                     np.zeros((0, 3), np.float32)],
            "final": {}}


def _to_torch(tree):
    def conv(x):
        if x.dtype == np.dtype(ml_dtypes.bfloat16):
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return pytree.tree_map(conv, tree)


def _raw(x):
    """Bytes of a numpy array or a tensor, bf16 as its uint16 view."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _stores(root, pkg):
    if pkg == "jax":
        blobs = jax_blobstore.ChunkStore(root / "blobs", chunk_bytes=CHUNK)
        return blobs, JaxSnapshotStore(root / "snaps", blobs=blobs)
    blobs = ChunkStore(root / "blobs", chunk_bytes=CHUNK)
    return blobs, SnapshotStore(root / "snaps", blobs=blobs)


# --------------------------------------------------------- v2 interchange

def test_v2_snapshots_write_the_same_chunks_and_index_leaves(tmp_path):
    tree = _np_tree()
    jblobs, jstore = _stores(tmp_path / "j", "jax")
    pblobs, pstore = _stores(tmp_path / "p", "torch")
    jbytes = jstore.save("img", tree)
    pbytes = pstore.save("img", _to_torch(tree))
    assert jbytes == pbytes
    jindex = json.loads((tmp_path / "j" / "snaps" / "img" / "index.json").read_text())
    pindex = json.loads((tmp_path / "p" / "snaps" / "img" / "index.json").read_text())
    assert pindex["leaves"] == jindex["leaves"]
    assert pindex["treedef"] == jindex["treedef"]
    assert (pindex["format"], pindex["chunk_bytes"]) == (2, CHUNK)
    assert pstore.chunk_ids("img") == jstore.chunk_ids("img")
    assert pblobs.stats() == jblobs.stats()
    for cid in set(pstore.chunk_ids("img")):            # same files, same bytes
        assert pblobs._path(cid).read_bytes() == jblobs._path(cid).read_bytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_v2_snapshot_restores_into_the_other_package_byte_for_byte(tmp_path, writer):
    tree = _np_tree(1)
    _, store = _stores(tmp_path, writer)
    store.save("img", tree if writer == "jax" else _to_torch(tree))
    want = dict(pytree.flatten_with_paths(tree))
    if writer == "jax":                                 # the port reads JAX's files
        back = SnapshotStore(tmp_path / "snaps", blobs=ChunkStore(tmp_path / "blobs",
                                                                  chunk_bytes=CHUNK))
        got = dict(pytree.flatten_with_paths(back.load_host("img")))
        for path, x in want.items():
            t = got[path]
            assert tuple(t.shape) == x.shape and _raw(t) == _raw(x), path
            assert t.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32,
                               "int32": torch.int32}[x.dtype.name]
    else:                                               # JAX reads the port's files
        back = JaxSnapshotStore(tmp_path / "snaps",
                                blobs=jax_blobstore.ChunkStore(tmp_path / "blobs",
                                                               chunk_bytes=CHUNK))
        got = dict(pytree.flatten_with_paths(back.load_host("img")))
        for path, x in want.items():
            assert got[path].dtype == x.dtype and got[path].shape == x.shape
            assert _raw(got[path]) == _raw(x), path


def test_v2_leaves_are_writable_tensors_without_a_warning(tmp_path):
    _, store = _stores(tmp_path, "torch")
    store.save("img", _to_torch(_np_tree()))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tree = store.load_host("img")
    leaf = tree["layers"]["w"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
    assert tree["emb"]["tok"].dtype == torch.bfloat16
    assert tree["list"][2].shape == (0, 3) and tree["final"] == {}


def test_v2_overwrite_and_evict_balance_refcounts_like_jax(tmp_path):
    out = []
    for pkg in ("jax", "torch"):
        blobs, store = _stores(tmp_path / pkg, pkg)
        conv = (lambda t: t) if pkg == "jax" else _to_torch
        a, b = _np_tree(2), _np_tree(3)
        store.save("a", conv(a))
        store.save("b", conv(a))                         # identical content: dedup
        store.save("a", conv(b))                         # overwrite releases old refs
        steps = [blobs.stats(), sorted((c, blobs.refcount(c)) for c in store.chunk_ids("b"))]
        store.evict("b")
        steps.append(blobs.stats())
        steps.append(store.nbytes("a"))
        store.evict("a")
        steps.append(blobs.stats())
        out.append(steps)
    assert out[0] == out[1]


# ------------------------------------------------------------ host tier

def _tier_ops(tier_cls):
    """One random operation sequence on a tier; every observable after each op."""
    rng = np.random.default_rng(0)
    pool = [bytes([i]) * int(rng.integers(8, 40)) for i in range(24)]
    evicted = []
    tier = tier_cls(400, on_evict=evicted.append)
    seen = []
    for step in range(200):
        op = int(rng.integers(0, 5))
        key = f"s{int(rng.integers(0, 8))}"
        if op <= 1:
            picks = rng.choice(len(pool), size=int(rng.integers(1, 12)), replace=True)
            chunks = {jax_blobstore.chunk_id(pool[i]): pool[i] for i in picks}
            got = tier.register(key, chunks, sum(len(v) for v in chunks.values()),
                                tree=("tree", step) if op == 0 else None)
        elif op == 2:
            got = tier.tree(key)
        elif op == 3:
            got = tier.drop(key)
        else:
            cids = [jax_blobstore.chunk_id(pool[i]) for i in rng.integers(0, len(pool), 6)]
            got = (tier.missing(cids), sorted(tier.chunks_for(cids)), tier.contains(key))
        seen.append((got, tier.stats(), tier.keys(), list(evicted)))
    return seen


def test_host_chunk_tier_counters_match_jax_under_one_sequence():
    assert _tier_ops(HostChunkTier) == _tier_ops(jax_blobstore.HostChunkTier)


def test_chunk_id_split_and_manifest_sizes_match_jax(tmp_path):
    data = bytes(range(256)) * 3
    assert blobstore.chunk_id(data) == jax_blobstore.chunk_id(data)
    assert blobstore.split_chunks(data, 100) == jax_blobstore.split_chunks(data, 100)
    assert blobstore.split_chunks(b"", 100) == []
    _, store = _stores(tmp_path, "torch")
    store.save("m", _to_torch(_np_tree()))
    index = store.read_index("m")
    assert blobstore.manifest_chunk_sizes(index) == jax_blobstore.manifest_chunk_sizes(index)


# --------------------------------------------------------- delta restore

def _stats(st):
    return {k: getattr(st, k) for k in ("source", "bytes_total", "bytes_fetched",
                                        "bytes_deduped", "bytes_from_peer",
                                        "bytes_from_store", "chunks_rehashed",
                                        "chunks_refetched")}


def _cache_counts(cache):
    s = cache.summary()
    return {k: s[k] for k in ("peer_fetches", "store_fetches", "peer_serves",
                              "bytes_from_peer", "bytes_from_store")} | \
        {"snapshot": s["snapshot"]}


def _delta_sequence(root, pkg, lying_peer=False):
    """Two hosts of one package's Cluster: store, cached, peer, a half-new
    snapshot, a dropped memo, a killed peer. Returns every stats dict, the
    caches' counters and the restored leaves' bytes."""
    cluster_cls, cfg_cls = (JaxCluster, JaxSchedulerConfig) if pkg == "jax" \
        else (Cluster, SchedulerConfig)
    restore = jax_blobstore.delta_restore if pkg == "jax" else delta_restore
    conv = (lambda t: t) if pkg == "jax" else _to_torch
    cluster = cluster_cls(n_hosts=2, scheduler=cfg_cls())
    try:
        h0, h1 = (h.cache for h in cluster.hosts)
        if lying_peer:
            honest = h1.peer_chunks

            def lie(key, cids, requester):
                return {c: bytes(x ^ 0xFF for x in d)          # every byte flipped
                        for c, d in honest(key, cids, requester).items()}
            h1.peer_chunks = lie
        _, store = _stores(root, pkg)
        base = _np_tree(4)
        newer = dict(base, layers={"w": base["layers"]["w"] + 1, "b": base["layers"]["b"]})
        store.save("v1", conv(base))
        store.save("v2", conv(newer))
        out = []
        for cache, key in ((h0, "v1"), (h0, "v1"), (h1, "v1"), (h1, "v2"), (h0, "v2")):
            tree, st = restore(store, key, cache)
            out.append((_stats(st), sorted((p, _raw(x)) for p, x in
                                           pytree.flatten_with_paths(tree))))
        h1.snapshots.drop_tree("v2")
        out.append(_stats(restore(store, "v2", h1)[1]))  # chunks resident, no memo
        cluster.kill_host(0)
        h1.snapshots.drop("v1")
        out.append(_stats(restore(store, "v1", h1)[1]))  # the only peer is dead
        out.append([_cache_counts(h0), _cache_counts(h1)])
        return out
    finally:
        cluster.shutdown()


def test_delta_restore_stats_match_jax_over_two_hosts(tmp_path):
    got = _delta_sequence(tmp_path / "p", "torch")
    want = _delta_sequence(tmp_path / "j", "jax")
    assert got == want
    sources = [got[i][0]["source"] for i in range(5)]
    assert sources == ["delta", "cached", "delta", "delta", "delta"]
    assert got[2][0]["bytes_from_peer"] == got[2][0]["bytes_total"] > 0   # all from the peer
    assert 0 < got[3][0]["bytes_from_store"] < got[3][0]["bytes_total"]   # only the new leaf
    assert got[5]["bytes_fetched"] == 0 and got[5]["source"] == "delta"
    # the dead peer serves nothing; v1's leaves shared with v2 dedup from the tier
    assert got[6]["bytes_from_peer"] == 0
    assert got[6]["bytes_from_store"] == 3 * 40 * 4 == got[6]["bytes_fetched"]


def test_corrupt_peer_chunks_are_refetched_from_the_store_like_jax(tmp_path):
    got = _delta_sequence(tmp_path / "p", "torch", lying_peer=True)
    want = _delta_sequence(tmp_path / "j", "jax", lying_peer=True)
    assert got == want
    peer_read = got[2][0]                 # host 1's first restore asked the lying peer
    assert peer_read["chunks_refetched"] > 0 and peer_read["bytes_from_peer"] == 0
    assert peer_read["bytes_from_store"] == peer_read["bytes_total"]
    assert got[2][1] == got[0][1]         # and restored the right bytes anyway


def test_corrupt_store_chunk_raises(tmp_path):
    blobs, store = _stores(tmp_path, "torch")
    store.save("m", _to_torch(_np_tree()))
    cid = store.chunk_ids("m")[0]
    blobs._path(cid).write_bytes(b"\x01" * blobs.nbytes(cid))     # rot the stored bytes
    with pytest.raises(ChunkIntegrityError) as err:
        delta_restore(store, "m")
    assert err.value.cid == cid and err.value.where == "store"
    assert blobs.integrity_failures == 1
    with pytest.raises(ChunkIntegrityError):
        store.load_host("m")


def test_chunk_store_pins_defer_the_unlink_like_jax(tmp_path):
    out = []
    for store_cls in (ChunkStore, jax_blobstore.ChunkStore):
        s = store_cls(tmp_path / store_cls.__module__, chunk_bytes=CHUNK)
        (cids,) = s.put_all([[b"a" * 10, b"b" * 10, b"a" * 10]])
        s.pin(cids)
        gone = s.decref(cids)
        exists = [s.has(c) for c in cids]
        s.unpin(cids)
        out.append((cids, sorted(gone), exists, [s.has(c) for c in cids], s.stats()))
    assert out[0] == out[1]


# ------------------------------------------------------- oversize refusal

def test_snapshot_larger_than_the_tier_is_refused_and_restores_without_a_memo(tmp_path):
    out = []
    for pkg in ("torch", "jax"):
        cluster_cls, cfg_cls = (JaxCluster, JaxSchedulerConfig) if pkg == "jax" \
            else (Cluster, SchedulerConfig)
        restore = jax_blobstore.delta_restore if pkg == "jax" else delta_restore
        _, store = _stores(tmp_path / pkg, pkg)
        tree = _np_tree(5)
        store.save("m", tree if pkg == "jax" else _to_torch(tree))
        total = store.index_nbytes(store.read_index("m"))
        cluster = cluster_cls(n_hosts=1, scheduler=cfg_cls(snapshot_tier_bytes=total // 2))
        try:
            cache = cluster.hosts[0].cache
            first = _stats(restore(store, "m", cache)[1])
            again = _stats(restore(store, "m", cache)[1])
            out.append((first, again, cache.snapshots.contains("m"),
                        cache.snapshots.stats()))
        finally:
            cluster.shutdown()
    assert out[0] == out[1]
    first, again, resident, stats = out[0]
    assert not resident and stats["items"] == 0 and stats["bytes"] == 0
    assert again["source"] == "delta" and again["bytes_from_store"] == again["bytes_total"]
