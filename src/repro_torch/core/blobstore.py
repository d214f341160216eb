"""Content-addressed chunk store + per-host chunk tier: dedup'd snapshot bytes.

Copy of ``repro.core.blobstore``; ``stream_restore`` walks the port's own
parameter trees (``repro_torch.pytree``) where the JAX module uses
``jax.tree.leaves``.

Once boots are staged and hosts keep tiered caches, the dominant remaining
cold-start term is *moving weight bytes*: every host-tier
miss re-ships a whole snapshot from the global store. "How Low Can You Go?"
(Tan et al.) identifies artifact movement as the practical cold-start floor
once boot itself is fast, and FaaSLight shows loading only what's needed is
the highest-leverage application-level lever. This module applies both to the
snapshot path by making the CHUNK — not the snapshot — the unit of storage,
transfer, and caching:

* ``ChunkStore``    — the global store: BLAKE2-hashed fixed-size chunks on
                      disk, refcounted across snapshots, byte-accounted.
                      Two snapshots sharing base weights store shared chunks
                      ONCE; deleting one snapshot only deletes chunks no other
                      snapshot references.
* ``HostChunkTier`` — one host's RAM chunk cache. LRU is at *snapshot*
                      granularity (members register their chunk list), but
                      bytes are accounted at *chunk* granularity with
                      refcounts — so a chunk shared by two resident snapshots
                      costs its bytes once and survives eviction of either.
* ``delta_restore`` — the v2 restore path: read the snapshot's chunk manifest,
                      fetch ONLY the chunks missing from the host tier
                      (live peer first, global store last), and assemble host
                      arrays from resident + fetched chunks. Reports exactly
                      how many bytes moved (``bytes_fetched``) and how many
                      were already resident (``bytes_deduped``).
* ``stream_restore`` — the same restore, delivering each leaf in the
                      manifest's first-use order the moment it is assembled
                      (the ``unikernel_stream`` driver's producer).

Invariants:

* A chunk id is the BLAKE2b-160 hex digest of its content: equal bytes =>
  equal id, across leaves, snapshots, and functions. Chunk boundaries reset
  at every leaf, so identical leaves share all their chunks regardless of
  position in the tree.
* ``ChunkStore`` refcounts are per-snapshot-per-unique-chunk: ``incref`` on
  save, ``decref`` on evict, file deleted only at refcount zero. Bytes on
  disk = sum over live chunks (never double-counted for sharers).
* ``HostChunkTier`` never evicts the snapshot currently being registered,
  and never frees a chunk while any resident snapshot references it.
* Peer/store transfer accounting charges the bytes that actually moved —
  the delta — never the full snapshot size.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch import pytree

DEFAULT_CHUNK_BYTES = 1 << 20          # 1 MiB: ~60 chunks for the bench snapshot


def chunk_id(data: bytes) -> str:
    """Content address of one chunk (BLAKE2b-160 hex)."""
    return hashlib.blake2b(data, digest_size=20).hexdigest()


class ChunkIntegrityError(RuntimeError):
    """Bytes read for a chunk do not hash to its content id.

    Raised only when there is no further tier to fall back to (the global
    store is the source of truth): a restore NEVER silently serves bytes
    that fail their own content address. Peer-side mismatches never raise —
    they are dropped and transparently re-fetched from the store.
    """

    def __init__(self, cid: str, where: str = "store") -> None:
        super().__init__(f"chunk {cid} failed integrity check ({where})")
        self.cid = cid
        self.where = where


def split_chunks(data: bytes, chunk_bytes: int) -> List[bytes]:
    """Fixed-size split; the final chunk carries the remainder."""
    if not data:
        return []
    return [data[i:i + chunk_bytes] for i in range(0, len(data), chunk_bytes)]


class ChunkStore:
    """The global content-addressed chunk store (disk-backed, refcounted).

    Layout: ``<root>/<id[:2]>/<id>.chunk`` plus ``<root>/refs.json`` mapping
    chunk id -> number of snapshots referencing it. ``put`` is idempotent —
    storing bytes that already exist is a dedup hit, counted but not
    re-written. Deletion happens only through ``decref`` reaching zero.
    """

    def __init__(self, root: str | Path,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.chunk_bytes = int(chunk_bytes)
        self._lock = threading.Lock()
        self._refs: Dict[str, int] = {}
        self._sizes: Dict[str, int] = {}
        # in-flight restores pin the chunks they are about to read: a decref
        # that reaches zero while a cid is pinned DEFERS the unlink until the
        # last pin drops, so a redeploy/evict never deletes a file out from
        # under a reader mid-restore
        self._pins: Dict[str, int] = {}
        self._deferred: set = set()
        self.puts = 0
        self.dedup_hits = 0
        self.bytes_deduped = 0
        self.rehashes = 0              # reads whose digest was re-checked
        self.integrity_failures = 0    # reads that failed the check (raised)
        self._load_refs()

    # ------------------------------------------------------------------ paths
    def _path(self, cid: str) -> Path:
        return self.root / cid[:2] / f"{cid}.chunk"

    def _refs_path(self) -> Path:
        return self.root / "refs.json"

    def _load_refs(self) -> None:
        p = self._refs_path()
        if p.exists():
            saved = json.loads(p.read_text())
            self._refs = {k: int(v) for k, v in saved.get("refs", {}).items()}
            self._sizes = {k: int(v) for k, v in saved.get("sizes", {}).items()}

    def _save_refs(self) -> None:
        tmp = self._refs_path().with_suffix(".tmp")
        tmp.write_text(json.dumps({"refs": self._refs, "sizes": self._sizes}))
        os.replace(tmp, self._refs_path())

    # -------------------------------------------------------------------- api
    def put(self, data: bytes) -> str:
        """Store one chunk (idempotent); returns its content id."""
        with self._lock:
            return self._put_locked(data)

    def _put_locked(self, data: bytes) -> str:
        cid = chunk_id(data)
        path = self._path(cid)
        self.puts += 1
        if cid in self._sizes and path.exists():
            self.dedup_hits += 1
            self.bytes_deduped += len(data)
            return cid
        self._sizes[cid] = len(data)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{threading.get_ident()}")
        tmp.write_bytes(data)
        os.replace(tmp, path)                       # atomic publish
        return cid

    def put_all(self, chunk_lists: List[List[bytes]]) -> List[List[str]]:
        """Store many chunks and take ONE snapshot reference per unique id,
        atomically with respect to ``decref`` — the put-then-ref window in
        which a concurrent evict could delete a dedup-hit chunk does not
        exist. One refs.json write for the whole batch. Returns the content
        ids in the same nested shape (one list per leaf)."""
        with self._lock:
            out: List[List[str]] = []
            seen: set = set()
            for chunks in chunk_lists:
                cids = [self._put_locked(c) for c in chunks]
                for cid in cids:
                    if cid not in seen:
                        seen.add(cid)
                        self._refs[cid] = self._refs.get(cid, 0) + 1
                out.append(cids)
            self._save_refs()
            return out

    def get(self, cid: str, verify: bool = True) -> bytes:
        """Read one chunk, re-checking its content address by default.

        The store is the LAST tier — there is nowhere further to re-fetch
        from — so a mismatch re-reads once (a torn read is transient; rot is
        not) and then raises :class:`ChunkIntegrityError` rather than ever
        returning wrong bytes.
        """
        data = self._path(cid).read_bytes()
        if not verify:
            return data
        with self._lock:
            self.rehashes += 1
        if chunk_id(data) == cid:
            return data
        data = self._path(cid).read_bytes()            # one re-read: torn read?
        if chunk_id(data) == cid:
            return data
        with self._lock:
            self.integrity_failures += 1
        raise ChunkIntegrityError(cid)

    def has(self, cid: str) -> bool:
        return self._path(cid).exists()

    def nbytes(self, cid: str) -> int:
        with self._lock:
            size = self._sizes.get(cid)
        if size is not None:
            return size
        return self._path(cid).stat().st_size

    def refcount(self, cid: str) -> int:
        with self._lock:
            return self._refs.get(cid, 0)

    def incref(self, cids: Iterable[str]) -> None:
        """One snapshot now references these (unique) chunks."""
        with self._lock:
            for cid in set(cids):
                self._refs[cid] = self._refs.get(cid, 0) + 1
            self._save_refs()

    def decref(self, cids: Iterable[str]) -> List[str]:
        """One snapshot dropped these chunks; deletes refcount-zero files
        (unlinks are deferred for chunks a reader currently has pinned).

        Returns the ids actually scheduled for deletion."""
        deleted: List[str] = []
        unlink_now: List[str] = []
        with self._lock:
            for cid in set(cids):
                n = self._refs.get(cid, 0) - 1
                if n > 0:
                    self._refs[cid] = n
                else:
                    self._refs.pop(cid, None)
                    self._sizes.pop(cid, None)
                    deleted.append(cid)
                    if self._pins.get(cid):
                        self._deferred.add(cid)     # reader in flight: defer
                    else:
                        unlink_now.append(cid)
            self._save_refs()
        for cid in unlink_now:
            try:
                self._path(cid).unlink()
            except FileNotFoundError:
                pass
        return deleted

    # ------------------------------------------------------------------- pins
    def pin(self, cids: Iterable[str]) -> None:
        """Hold the named chunks' files live for the duration of a read, even
        if every referencing snapshot is evicted meanwhile."""
        with self._lock:
            for cid in set(cids):
                self._pins[cid] = self._pins.get(cid, 0) + 1

    def unpin(self, cids: Iterable[str]) -> None:
        """Release a pin; unlinks any chunk whose deletion was deferred."""
        unlink_now: List[str] = []
        with self._lock:
            for cid in set(cids):
                n = self._pins.get(cid, 0) - 1
                if n > 0:
                    self._pins[cid] = n
                else:
                    self._pins.pop(cid, None)
                    if cid in self._deferred:
                        self._deferred.discard(cid)
                        unlink_now.append(cid)
        for cid in unlink_now:
            try:
                self._path(cid).unlink()
            except FileNotFoundError:
                pass

    @property
    def bytes(self) -> int:
        """Bytes of live (referenced or just-put) chunks — dedup'd by content."""
        with self._lock:
            return sum(self._sizes.values())

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "chunks": float(len(self._sizes)),
                "bytes": float(sum(self._sizes.values())),
                "puts": float(self.puts),
                "dedup_hits": float(self.dedup_hits),
                "bytes_deduped": float(self.bytes_deduped),
            }


class HostChunkTier:
    """One host's RAM chunk cache: snapshot-granular LRU over refcounted chunks.

    Snapshots *register* their chunk list (plus an optional assembled-tree
    memo); chunks are stored once no matter how many resident snapshots
    reference them, and ``bytes`` counts each unique chunk once. Eviction pops
    least-recently-used snapshots and decrefs their chunks — a chunk is freed
    only when its last resident snapshot goes (the dedup invariant the tests
    pin: a chunk shared by two snapshots survives eviction of one).

    The assembled-tree memo mirrors ``ProgramArtifact.loaded``: once a restore
    has paid the chunk->array assembly, repeat boots on this host reuse the
    tree (executors treat params as read-only device_put sources, so sharing
    is safe). Like the program memo, the memo's bytes are on the order of the
    chunk bytes and live exactly as long as the member entry, so the tier's
    byte bound is ~2x worst-case rather than exact.
    """

    def __init__(self, capacity_bytes: int,
                 on_evict: Optional[Callable[[str], None]] = None) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self.on_evict = on_evict
        self._lock = threading.Lock()
        # cid -> [data, nbytes, refs]
        self._chunks: Dict[str, List[Any]] = {}
        # snapshot key -> (tuple of unique cids, logical nbytes, tree memo)
        self._members: "OrderedDict[str, List[Any]]" = OrderedDict()
        self.bytes = 0
        self.hits = 0                  # assembled-tree memo hits (boot-visible)
        self.misses = 0
        self.evictions = 0             # snapshot-level evictions
        self.chunk_hits = 0            # chunks already resident at register time
        self.chunk_misses = 0
        self.bytes_deduped = 0         # bytes NOT moved because chunks resident

    # --------------------------------------------------------------- queries
    def contains(self, key: str) -> bool:
        """Snapshot-residency probe without counter side effects (the
        scheduler's affinity score runs on every route)."""
        with self._lock:
            return key in self._members

    def tree(self, key: str) -> Optional[Any]:
        """Assembled-tree memo for a resident snapshot (counts hit/miss and
        refreshes recency — this is the boot path's first stop)."""
        with self._lock:
            member = self._members.get(key)
            if member is None or member[2] is None:
                self.misses += 1
                return None
            self._members.move_to_end(key)
            self.hits += 1
            return member[2]

    def drop_tree(self, key: str) -> None:
        """Forget the assembled memo but keep the chunks (benchmarks use this
        to measure pure chunk->array assembly on a warm tier)."""
        with self._lock:
            member = self._members.get(key)
            if member is not None:
                member[2] = None

    def has_chunk(self, cid: str) -> bool:
        with self._lock:
            return cid in self._chunks

    def missing(self, cids: Iterable[str]) -> List[str]:
        """The delta: which of these chunks this host does NOT hold."""
        with self._lock:
            return [cid for cid in dict.fromkeys(cids) if cid not in self._chunks]

    def chunk(self, cid: str) -> Optional[bytes]:
        with self._lock:
            entry = self._chunks.get(cid)
            return entry[0] if entry is not None else None

    def chunks_for(self, cids: Iterable[str]) -> Dict[str, bytes]:
        """Subset of ``cids`` this host holds — the peer-serving read (no
        counters, no recency: a peer read must not look like local traffic)."""
        with self._lock:
            return {cid: self._chunks[cid][0] for cid in cids
                    if cid in self._chunks}

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._members)

    # -------------------------------------------------------------- register
    def register(self, key: str, chunks: Dict[str, bytes],
                 nbytes_logical: int, tree: Any = None) -> bool:
        """Make a snapshot resident: insert its chunks and record membership.

        ``chunks`` maps cid -> bytes for every chunk of the snapshot — bytes
        the tier already holds are dedup'd (counted in ``bytes_deduped``),
        never copied. Evicts LRU snapshots (never ``key`` itself) until the
        unique chunk bytes fit; returns False when the snapshot alone exceeds
        the tier capacity (rejected rather than evicting everything for a
        value that can never fit).
        """
        evicted: List[str] = []
        with self._lock:
            unique = dict.fromkeys(chunks)          # preserve order, dedup ids
            # the oversize probe is the snapshot's TOTAL unique bytes, not
            # just the missing ones — a snapshot that can never fit alone
            # must not slip in via chunks it shares with a resident sibling
            # and wedge the tier above capacity forever
            if sum(len(chunks[cid]) for cid in unique) > self.capacity_bytes:
                return False
            if key in self._members:                # re-register: refresh below
                self._drop_locked(key)
            for cid in unique:
                entry = self._chunks.get(cid)
                if entry is None:
                    data = chunks[cid]
                    self._chunks[cid] = [data, len(data), 1]
                    self.bytes += len(data)
                    self.chunk_misses += 1
                else:
                    entry[2] += 1
                    self.chunk_hits += 1
                    self.bytes_deduped += entry[1]
            self._members[key] = [tuple(unique), int(nbytes_logical), tree]
            while self.bytes > self.capacity_bytes and len(self._members) > 1:
                victim = next(iter(self._members))
                if victim == key:                   # never evict the newcomer
                    victim = next(k for k in self._members if k != key)
                self._drop_locked(victim)
                self.evictions += 1
                evicted.append(victim)
        if self.on_evict is not None:
            for victim in evicted:
                self.on_evict(victim)
        return True

    def set_tree(self, key: str, tree: Any) -> None:
        """Park the assembled-tree memo on an already-resident snapshot."""
        with self._lock:
            member = self._members.get(key)
            if member is not None:
                member[2] = tree

    def drop(self, key: str) -> None:
        with self._lock:
            dropped = key in self._members
            if dropped:
                self._drop_locked(key)
        if dropped and self.on_evict is not None:
            self.on_evict(key)

    def _drop_locked(self, key: str) -> None:
        cids, _, _ = self._members.pop(key)
        for cid in cids:
            entry = self._chunks.get(cid)
            if entry is None:
                continue
            entry[2] -= 1
            if entry[2] <= 0:                       # last resident sharer left
                del self._chunks[cid]
                self.bytes -= entry[1]

    # --------------------------------------------------------------- reports
    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "items": float(len(self._members)),
                "chunks": float(len(self._chunks)),
                "bytes": float(self.bytes),
                "capacity_bytes": float(self.capacity_bytes),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "hit_rate": self.hits / total if total else 0.0,
                "chunk_hits": float(self.chunk_hits),
                "chunk_misses": float(self.chunk_misses),
                "bytes_deduped": float(self.bytes_deduped),
            }


# ------------------------------------------------------------- delta restore


class DeltaStats:
    """What one delta restore moved, skipped, verified, and spent."""

    __slots__ = ("source", "bytes_total", "bytes_fetched", "bytes_deduped",
                 "bytes_from_peer", "bytes_from_store", "t_peer_s", "t_store_s",
                 "chunks_rehashed", "chunks_refetched")

    def __init__(self) -> None:
        self.source = "delta"
        self.bytes_total = 0
        self.bytes_fetched = 0
        self.bytes_deduped = 0
        self.bytes_from_peer = 0
        self.bytes_from_store = 0
        self.t_peer_s = 0.0
        self.t_store_s = 0.0
        # integrity trail: chunks whose digest was re-checked on read, and
        # peer chunks that FAILED the check and fell through to the store
        self.chunks_rehashed = 0
        self.chunks_refetched = 0


def _verify_peer_chunks(fetched: Dict[str, bytes], stats: DeltaStats,
                        cache=None) -> None:
    """Re-hash peer-served chunks; drop (and un-account) any that lie.

    A dropped chunk simply stays missing, so the caller's store path
    re-fetches it — the transparent peer -> store fallback. Outcomes feed the
    ``peer`` circuit breaker when the host cache carries a breaker board, so
    a peer serving rot gets bypassed entirely for a cooldown.
    """
    if not fetched:
        return
    bad = [cid for cid, data in fetched.items() if chunk_id(data) != cid]
    stats.chunks_rehashed += len(fetched)
    breakers = getattr(cache, "breakers", None)
    if not bad:
        if breakers is not None:
            breakers.record("peer", True)
        return
    # the corrupt bytes DID move over the wire (the host cache keeps them in
    # its transfer accounting) but they bought nothing: un-count them from
    # the restore's useful-bytes view so bytes_deduped stays total - useful
    for cid in bad:
        stats.bytes_from_peer -= len(fetched.pop(cid))
    stats.chunks_refetched += len(bad)
    if breakers is not None:
        breakers.record("peer", False)


def manifest_chunk_sizes(index: Dict[str, Any]) -> Dict[str, int]:
    """cid -> nbytes for every chunk in a v2 index (sizes derive from each
    leaf's byte length and the fixed chunk size; the last chunk is the
    remainder)."""
    cb = int(index["chunk_bytes"])
    sizes: Dict[str, int] = {}
    for leaf in index["leaves"]:
        remaining = int(leaf["nbytes"])
        for cid in leaf["chunks"]:
            sizes[cid] = min(cb, remaining)
            remaining -= sizes[cid]
    return sizes


def delta_restore(store, key: str, cache=None) -> Tuple[Any, DeltaStats]:
    """Restore a v2 snapshot's host tree, moving only the missing chunks.

    ``store`` is a :class:`repro_torch.core.snapshot.SnapshotStore` with a blob
    store attached; ``cache`` is the host's
    :class:`repro_torch.core.scheduler.HostArtifactCache` (or None for a host-less
    restore, which fetches everything from the global store). Lookup order per
    missing chunk: host chunk tier (free) -> live peer's tier (charged the
    simulated peer cost on the delta bytes) -> global chunk store (charged the
    store cost on the delta bytes). The assembled tree is memoized on the
    tier so repeat boots skip assembly entirely.

    The manifest's chunks are PINNED in the blob store for the duration of
    the restore, so a concurrent redeploy/evict of this key cannot delete a
    chunk file out from under the read; if the manifest itself was replaced
    in the window before the pin landed, the restore retries once against
    the fresh index.
    """
    tier: Optional[HostChunkTier] = getattr(cache, "snapshots", None)
    if tier is not None and not isinstance(tier, HostChunkTier):
        tier = None
    for attempt in (0, 1):
        index = store.read_index(key)
        if index.get("format") != 2:
            raise ValueError(f"snapshot {key} is not chunked (v2)")
        try:
            return _delta_restore_once(store, index, key, cache, tier)
        except FileNotFoundError:
            if attempt:
                raise
            # the snapshot was overwritten between reading the index and
            # pinning its chunks — re-read and go again with the new manifest


def _delta_restore_once(store, index, key: str, cache,
                        tier: Optional[HostChunkTier]) -> Tuple[Any, DeltaStats]:
    stats = DeltaStats()
    # byte totals are LOGICAL (sum of leaf lengths) on every path, so the
    # same snapshot reports the same total whether it was served from the
    # memo, the tier, a peer, or the store; bytes_fetched is what actually
    # moved, and bytes_deduped = total - fetched (intra-snapshot repeated
    # chunks count as dedup'd — they only ever move once)
    stats.bytes_total = store.index_nbytes(index)

    if tier is not None:
        tree = tier.tree(key)
        if tree is not None:
            stats.source = "cached"
            stats.bytes_deduped = stats.bytes_total
            return tree, stats

    sizes = manifest_chunk_sizes(index)
    store.blobs.pin(sizes)
    try:
        all_cids = list(sizes)
        missing = tier.missing(all_cids) if tier is not None else all_cids

        fetched: Dict[str, bytes] = {}
        if missing and cache is not None:
            t0 = time.perf_counter()
            fetched = cache.fetch_chunks_from_peer(key, missing)
            stats.t_peer_s = time.perf_counter() - t0 if fetched else 0.0
            stats.bytes_from_peer = sum(len(b) for b in fetched.values())
            # integrity gate: a chunk whose bytes don't hash to its id is
            # dropped here and stays missing -> re-fetched from the store
            _verify_peer_chunks(fetched, stats, cache)
            missing = [c for c in missing if c not in fetched]
        if missing:
            t0 = time.perf_counter()
            blobs = {cid: store.blobs.get(cid) for cid in missing}
            stats.chunks_rehashed += len(blobs)   # store reads verify in get()
            store_bytes = sum(len(b) for b in blobs.values())
            if cache is not None:
                cache.account_store_chunks(store_bytes)
            stats.t_store_s = time.perf_counter() - t0
            stats.bytes_from_store = store_bytes
            fetched.update(blobs)
        stats.bytes_fetched = stats.bytes_from_peer + stats.bytes_from_store
        stats.bytes_deduped = stats.bytes_total - stats.bytes_fetched

        def chunk_bytes(cid: str) -> bytes:
            if cid in fetched:
                return fetched[cid]
            data = tier.chunk(cid) if tier is not None else None
            if data is None:            # evicted between missing() and here
                data = store.blobs.get(cid)
            return data

        tree = store.assemble_tree(index, chunk_bytes)
        if tier is not None:
            chunks = {cid: chunk_bytes(cid) for cid in sizes}
            if tier.register(key, chunks, stats.bytes_total, tree=tree) \
                    and cache is not None:
                cache.publish_snapshot(key)
    finally:
        store.blobs.unpin(sizes)
    return tree, stats


# ------------------------------------------------------------ stream restore


class RestoreAborted(RuntimeError):
    """A streamed restore observed its boot's cancel and stopped early."""


def stream_restore(store, key: str, cache=None,
                   on_leaf: Optional[Callable[[int, str, Any], None]] = None,
                   should_abort: Optional[Callable[[], bool]] = None
                   ) -> Tuple[Any, DeltaStats]:
    """``delta_restore`` that delivers leaves one at a time, in first-use order.

    The streamed boot's producer: leaves are assembled in the manifest's
    ``first_use_order`` (ordinal order when absent) and handed to ``on_leaf``
    ``(ordinal, path, host_leaf)`` the moment each is complete, so the caller
    can copy it to the device and open its readiness gate while later leaves
    are still being fetched. Fetch policy per chunk: host tier (free) -> the
    ONE upfront peer batch (peers serve batches, not a trickle) -> global
    store on demand — a withdrawn peer or a partial peer answer falls back to
    the store. ``should_abort`` is consulted before every leaf; a True raises
    :class:`RestoreAborted` (the cancelled speculative boot's path).

    Same pin + retry-once-on-FileNotFoundError contract as ``delta_restore``;
    on retry, already-delivered leaves are delivered again (consumers treat
    ``on_leaf`` as idempotent per ordinal).
    """
    tier: Optional[HostChunkTier] = getattr(cache, "snapshots", None)
    if tier is not None and not isinstance(tier, HostChunkTier):
        tier = None
    for attempt in (0, 1):
        index = store.read_index(key)
        if index.get("format") != 2:
            raise ValueError(f"snapshot {key} is not chunked (v2)")
        try:
            return _stream_restore_once(store, index, key, cache, tier, on_leaf, should_abort)
        except FileNotFoundError:
            if attempt:
                raise
            # the snapshot was overwritten between reading the index and
            # pinning its chunks — re-read and go again with the new manifest


def _stream_restore_once(store, index, key: str, cache, tier: Optional[HostChunkTier],
                         on_leaf, should_abort) -> Tuple[Any, DeltaStats]:
    from repro_torch.core.snapshot import _rebuild_structure   # snapshot imports this module

    stats = DeltaStats()
    stats.source = "stream"
    stats.bytes_total = store.index_nbytes(index)
    entries = index["leaves"]
    order = store.leaf_order(index)

    if tier is not None:
        tree = tier.tree(key)
        if tree is not None:
            stats.source = "cached"
            stats.bytes_deduped = stats.bytes_total
            if on_leaf is not None:
                leaves = pytree.leaves(tree)      # rebuilt trees flatten in ordinal order
                for i in order:
                    on_leaf(i, entries[i]["path"], leaves[i])
            return tree, stats

    sizes = manifest_chunk_sizes(index)
    store.blobs.pin(sizes)
    begin = getattr(cache, "begin_partial_snapshot", None)
    if begin is not None:
        begin(key, stats.bytes_total)
    try:
        all_cids = list(sizes)
        missing = tier.missing(all_cids) if tier is not None else all_cids
        fetched: Dict[str, bytes] = {}
        if missing and cache is not None:
            t0 = time.perf_counter()
            peer = cache.fetch_chunks_from_peer(key, missing)
            stats.t_peer_s = time.perf_counter() - t0 if peer else 0.0
            stats.bytes_from_peer = sum(len(b) for b in peer.values())
            # a lying peer chunk is dropped here; the on-demand store path
            # below re-fetches it when its leaf comes up in stream order
            _verify_peer_chunks(peer, stats, cache)
            fetched.update(peer)
        store_bytes = [0]

        def chunk_bytes(cid: str) -> bytes:
            data = fetched.get(cid)
            if data is not None:
                return data
            data = tier.chunk(cid) if tier is not None else None
            if data is None:            # peer didn't answer / tier evicted it
                t0 = time.perf_counter()
                data = store.blobs.get(cid)
                stats.chunks_rehashed += 1      # verified inside get()
                stats.t_store_s += time.perf_counter() - t0
                store_bytes[0] += len(data)
                fetched[cid] = data
            return data

        leaves: List[Any] = [None] * len(entries)
        for i in order:
            if should_abort is not None and should_abort():
                raise RestoreAborted(key)
            e = entries[i]
            leaf = store._leaf_from_chunks(e, chunk_bytes)
            leaves[i] = leaf
            if on_leaf is not None:
                on_leaf(i, e["path"], leaf)
        if store_bytes[0] and cache is not None:
            cache.account_store_chunks(store_bytes[0])
        stats.bytes_from_store = store_bytes[0]
        stats.bytes_fetched = stats.bytes_from_peer + stats.bytes_from_store
        stats.bytes_deduped = stats.bytes_total - stats.bytes_fetched

        tree = _rebuild_structure(index["treedef"], leaves)
        if tier is not None:
            chunks = {cid: chunk_bytes(cid) for cid in sizes}
            if tier.register(key, chunks, stats.bytes_total, tree=tree) \
                    and cache is not None:
                cache.publish_snapshot(key)
    finally:
        end = getattr(cache, "end_partial_snapshot", None)
        if end is not None:
            end(key)
        store.blobs.unpin(sizes)
    return tree, stats
