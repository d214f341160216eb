"""Locality-aware placement: rendezvous hashing + tiered per-host artifact caches.

Copy of ``repro.core.scheduler``; the program tier's loaded memo is a
``torch.export`` module here (see :class:`ProgramArtifact`).

The cold-only design makes every request pay a full boot — which is exactly why
*where* the boot runs starts to matter at fleet scale. "How Low Can You Go?"
(Tan et al.) shows the cold-start floor is dominated by per-invocation artifact
and placement overheads once the sandbox itself is cheap, and FaaSLight shows
application artifact loading is the dominant application-level cost. A fleet of
N hosts that all re-fetch the same program bytes and weight snapshots from the
global stores pays that cost N times and *grows* it with fleet size.

This module converts the fleet into one cache hierarchy:

* ``LruTier``       — a byte-accounted LRU over program payload bytes, with
                      hit/miss/evict counters (one per host);
* ``HostArtifactCache`` — the two tiers of one host: program payloads
                      (``LruTier``) and snapshot CHUNKS (a refcounted
                      :class:`repro_torch.core.blobstore.HostChunkTier` — dedup'd
                      across functions, so two configs sharing base weights
                      share chunk bytes), plus peer/store fetch accounting and
                      the simulated transfer-cost model, which charges the
                      bytes that actually moved (the delta), never whole
                      snapshots;
* ``CacheDirectory``— who holds what: hosts advertise the snapshots (and
                      therefore the chunk ranges those manifests name) they
                      hold, so a missing host fetches only its missing chunks
                      from a peer (cheap) instead of the global store
                      (expensive);
* ``Scheduler``     — placement: rendezvous/HRW hashing gives every artifact a
                      stable k-replica preferred set (minimal reshuffle when
                      hosts die or join), blended with live load so a hot host
                      sheds work to its replica siblings.

The boot pipeline consults the host tier before the global store and records
which path it took as distinct Timeline stages (``fetch_program_cached``,
``fetch_peer``, ``fetch_program``; ``restore_delta`` with
``fetch_chunks_peer``/``fetch_chunks_store`` sub-stages on the weights track),
so the benchmarks can show per-boot cost *dropping toward the delta* as
hosts warm up instead of staying flat.

Invariants: affinity probes (``LruTier.contains`` / ``HostChunkTier.contains``)
never mutate counters or recency; peer reads never inflate the owner's local
hit rate; hedges are strict — a backup that cannot land on a distinct host
stands down rather than re-landing on the straggler's own machine.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.blobstore import HostChunkTier
from repro_torch.core.resilience import BreakerBoard


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Placement + host-tier knobs (Gateway(scheduler=...) accepts one)."""

    # how many load units a cache hit is worth when scoring hosts: 0 disables
    # locality entirely (pure least-loaded, the pre-scheduler behavior)
    affinity_weight: float = 2.0
    # HRW replica set size: each artifact key maps to this many preferred
    # hosts, so load spreads without every host caching every image
    replicas: int = 2
    # byte capacity of the per-host RAM tiers
    program_tier_bytes: int = 256 << 20
    snapshot_tier_bytes: int = 2 << 30
    # simulated transfer cost (seconds per GB) charged on a tier miss; 0 = off
    # (tests stay timing-free). Peer transfers are modeled faster than global
    # store fetches — that difference is the locality win the bench measures.
    sim_store_s_per_gb: float = 0.0
    sim_peer_s_per_gb: float = 0.0
    # circuit-breaker / quarantine knobs (repro_torch.core.resilience.BreakerBoard):
    # a host whose breaker is OPEN is filtered out of routing candidates
    # (quarantined) until its cooldown elapses; then HALF_OPEN probe traffic
    # decides whether it re-closes. quarantine=False restores pre-breaker
    # routing (the breakers still record, they just don't gate).
    quarantine: bool = True
    breaker_failures: int = 5
    breaker_cooldown_s: float = 30.0
    breaker_probes: int = 1


def program_artifact_key(image_key: str, bucket_rows: Optional[int]) -> str:
    """Cache key for a program artifact (matches Deployment.bucket_image_key)."""
    if bucket_rows is None:
        return image_key
    return f"{image_key}-b{bucket_rows}"


def hrw_hosts(key: str, host_ids: Sequence[int], k: int) -> List[int]:
    """Rendezvous (highest-random-weight) top-k hosts for an artifact key.

    Each (key, host) pair hashes independently, so removing a host only
    reassigns the keys that ranked it — every other key's replica set is
    untouched (the minimal-reshuffle property consistent hashing is for).
    """
    def weight(hid: int) -> bytes:
        return hashlib.blake2b(f"{key}|{hid}".encode(), digest_size=8).digest()

    return sorted(host_ids, key=weight, reverse=True)[:max(k, 1)]


class LruTier:
    """Byte-bounded LRU cache with hit/miss/evict counters.

    Values are opaque (program payload bytes, snapshot host trees); the caller
    supplies each entry's byte cost. An entry larger than the whole tier is
    rejected rather than evicting everything for a value that can never fit.
    """

    def __init__(self, capacity_bytes: int,
                 on_evict: Optional[Callable[[str], None]] = None) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self.on_evict = on_evict
        self._entries: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str) -> Optional[Any]:
        """Value for ``key`` (marking it most-recently-used), or None (a miss)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def peek(self, key: str) -> Optional[Tuple[Any, int]]:
        """(value, nbytes) without touching counters or recency — peer reads
        must not inflate the owner's local hit rate."""
        with self._lock:
            return self._entries.get(key)

    def contains(self, key: str) -> bool:
        """Membership without counter side effects (the scheduler's affinity
        probe runs on every route and must not look like cache traffic)."""
        with self._lock:
            return key in self._entries

    def put(self, key: str, value: Any, nbytes: int) -> bool:
        """Insert (or refresh) an entry, evicting LRU entries past capacity.

        Returns False when the entry alone exceeds the tier capacity.
        """
        nbytes = int(nbytes)
        evicted: List[str] = []
        with self._lock:
            if nbytes > self.capacity_bytes:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self.bytes += nbytes
            while self.bytes > self.capacity_bytes:
                victim, (_, vbytes) = self._entries.popitem(last=False)
                self.bytes -= vbytes
                self.evictions += 1
                evicted.append(victim)
        if self.on_evict is not None:
            for victim in evicted:
                self.on_evict(victim)
        return True

    def drop(self, key: str) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self.bytes -= entry[1]
        if entry is not None and self.on_evict is not None:
            self.on_evict(key)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "items": float(len(self._entries)),
                "bytes": float(self.bytes),
                "capacity_bytes": float(self.capacity_bytes),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "hit_rate": self.hits / total if total else 0.0,
            }


PROGRAM_TIER = "program"
SNAPSHOT_TIER = "snapshot"


class ProgramArtifact:
    """A program-tier entry: serialized payload + a host-local loaded memo.

    Only the BYTES travel (peer transfers and store fetches ship the payload;
    ``peer_copy`` strips the memo), but once a boot on this host deserializes
    the program it parks the loaded module here — the analogue of an OS
    page-cache-warm binary: the next boot of the same image on the same host
    reuses the module instead of loading it again. The memo is the
    ``torch.export`` program's ``.module()``. Sharing it across executors,
    concurrent ones included, is safe because the serve program is
    weight-free (the parameters are an input) and allocates its KV cache
    inside ``forward`` (:mod:`repro_torch.core.deploy`): a call reads the
    module and writes nothing on it.

    Tier byte accounting covers the payload only: the loaded module's bytes
    are on the order of the payload and live exactly as long as the entry,
    so the bound is ~2x in the worst case rather than exact.
    """

    __slots__ = ("payload", "loaded")

    def __init__(self, payload: bytes, loaded: Optional[Callable] = None) -> None:
        self.payload = payload
        self.loaded = loaded

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    def peer_copy(self) -> "ProgramArtifact":
        """What a peer actually receives: the bytes, never this host's memo."""
        return ProgramArtifact(self.payload)


class CacheDirectory:
    """Fleet-wide view of which hosts hold which artifact (for peer fetches).

    Hosts publish on insert and withdraw on evict; lookups return host ids, and
    the scheduler resolves them against liveness at fetch time — a dead owner
    is just skipped, exactly like a peer that stopped answering.
    """

    def __init__(self) -> None:
        self._owners: Dict[Tuple[str, str], Set[int]] = {}
        self._lock = threading.Lock()

    def publish(self, tier: str, key: str, host_id: int) -> None:
        with self._lock:
            self._owners.setdefault((tier, key), set()).add(host_id)

    def withdraw(self, tier: str, key: str, host_id: int) -> None:
        with self._lock:
            owners = self._owners.get((tier, key))
            if owners is not None:
                owners.discard(host_id)
                if not owners:
                    del self._owners[(tier, key)]

    def owners(self, tier: str, key: str) -> Set[int]:
        with self._lock:
            return set(self._owners.get((tier, key), ()))

    def tier_owners(self, tier: str) -> Set[int]:
        """Every host holding ANYTHING in this tier — the chunk-range
        advertisement's fallback: a host that never held snapshot X may still
        hold most of X's chunks via a sibling config sharing base weights."""
        with self._lock:
            return {hid for (t, _), hids in self._owners.items()
                    if t == tier for hid in hids}


class HostArtifactCache:
    """One host's tiered RAM cache: program payload bytes + snapshot chunks.

    The program tier holds serialized executable payloads (deserialization is
    still per-boot — executors are per-request); the snapshot tier is a
    :class:`~repro_torch.core.blobstore.HostChunkTier` holding content-addressed
    weight chunks, refcounted across the snapshots resident on this host —
    two functions sharing base weights pay the shared bytes once, and a delta
    restore fetches only the chunks this host is missing. Every fetch records
    where the bytes came from (peer vs global store) and charges the simulated
    transfer cost on the bytes that ACTUALLY moved.
    """

    def __init__(self, host_id: int, cfg: SchedulerConfig,
                 directory: CacheDirectory) -> None:
        self.host_id = host_id
        self.cfg = cfg
        self.directory = directory
        self.programs = LruTier(
            cfg.program_tier_bytes,
            on_evict=lambda key: directory.withdraw(PROGRAM_TIER, key, host_id))
        self.snapshots = HostChunkTier(
            cfg.snapshot_tier_bytes,
            on_evict=lambda key: directory.withdraw(SNAPSHOT_TIER, key, host_id))
        # set by the Scheduler once the cluster exists: (tier, key, requester)
        # -> (value, nbytes) read out of a live peer's tier, or None
        self.peer_lookup: Optional[Callable[[str, str, int],
                                            Optional[Tuple[Any, int]]]] = None
        # (key, missing-cids, requester) -> {cid: bytes} gathered from live
        # peers' chunk tiers (only the delta ships)
        self.peer_chunks: Optional[Callable[[str, List[str], int],
                                            Dict[str, bytes]]] = None
        # the scheduler's BreakerBoard (set by make_cache): gates the "peer"
        # tier (open breaker -> skip straight to the global store) and records
        # chunk-integrity outcomes from the restore paths
        self.breakers = None
        self._lock = threading.Lock()
        self.peer_fetches = 0
        self.store_fetches = 0
        self.prefetched = 0             # planner-driven warm-ahead inserts
        self.peer_serves = 0            # reads served TO other hosts
        self.bytes_from_peer = 0
        self.bytes_from_store = 0
        # streamed (first-use-ordered) restores: completed count + the set
        # still in flight on this host — a partial restore's chunks are only
        # published to the directory once the FULL snapshot is resident, so
        # peers never fetch a range this host doesn't hold yet
        self.partial_restores = 0
        self._partial: Dict[str, int] = {}

    def tier(self, name: str):
        return self.programs if name == PROGRAM_TIER else self.snapshots

    # ------------------------------------------------------------------- get
    def get(self, tier: str, key: str) -> Optional[Any]:
        if tier != PROGRAM_TIER:
            raise ValueError("the snapshot tier is chunk-addressed")
        return self.programs.get(key)

    def fetch_from_peer(self, tier: str, key: str) -> Optional[Any]:
        """Try to pull a missing program artifact out of a live peer's tier.

        On success the simulated peer-transfer cost is charged, the artifact is
        inserted locally (and published), and the value returned.
        """
        if self.peer_lookup is None:
            return None
        found = self.peer_lookup(tier, key, self.host_id)
        if found is None:
            return None
        value, nbytes = found
        if hasattr(value, "peer_copy"):
            value = value.peer_copy()      # bytes travel; loaded memos don't
        with self._lock:
            self.peer_fetches += 1
            self.bytes_from_peer += int(nbytes)
        self._simulate(nbytes, self.cfg.sim_peer_s_per_gb)
        self.insert(tier, key, value, nbytes)
        return value

    def fetch_from_store(self, tier: str, key: str, value: Any,
                         nbytes: int) -> Any:
        """Account a global-store fetch the caller already performed: charge
        the simulated store latency and insert the artifact locally."""
        with self._lock:
            self.store_fetches += 1
            self.bytes_from_store += int(nbytes)
        self._simulate(nbytes, self.cfg.sim_store_s_per_gb)
        self.insert(tier, key, value, nbytes)
        return value

    def insert(self, tier: str, key: str, value: Any, nbytes: int) -> None:
        if tier != PROGRAM_TIER:
            raise ValueError("snapshot chunks register via delta_restore")
        if self.programs.put(key, value, nbytes):
            self.directory.publish(tier, key, self.host_id)

    def prefetch_program(self, key: str, value: Any, nbytes: int) -> bool:
        """Planner-driven warm-ahead: land a program artifact in this tier
        BEFORE any request routes here. A no-op when the key is already
        resident (probe only — hit/miss counters don't move); otherwise
        accounted exactly like a store fetch (the bytes really ship from the
        registry), plus the ``prefetched`` counter."""
        if self.programs.contains(key):
            return False
        with self._lock:
            self.prefetched += 1
        self.fetch_from_store(PROGRAM_TIER, key, value, nbytes)
        return True

    # ------------------------------------------------------------ chunk side
    def fetch_chunks_from_peer(self, key: str,
                               cids: List[str]) -> Dict[str, bytes]:
        """Pull missing snapshot chunks from live peers' chunk tiers.

        Only the delta ships: the peer returns the subset of ``cids`` it
        holds, and the simulated peer cost is charged on the bytes received —
        not on the snapshot size. Returns {} with no peers or no overlap.
        """
        if self.peer_chunks is None:
            return {}
        if self.breakers is not None and not self.breakers.allow("peer"):
            # peer tier breaker is open (repeated integrity failures): skip
            # the tier entirely; the caller falls through to the global store
            return {}
        got = self.peer_chunks(key, cids, self.host_id)
        if not got:
            return {}
        nbytes = sum(len(b) for b in got.values())
        with self._lock:
            self.peer_fetches += 1
            self.bytes_from_peer += nbytes
        self._simulate(nbytes, self.cfg.sim_peer_s_per_gb)
        return got

    def account_store_chunks(self, nbytes: int) -> None:
        """Charge a global-store chunk fetch (delta bytes, already read)."""
        with self._lock:
            self.store_fetches += 1
            self.bytes_from_store += int(nbytes)
        self._simulate(nbytes, self.cfg.sim_store_s_per_gb)

    def publish_snapshot(self, key: str) -> None:
        """Advertise a snapshot (and thus its chunk range) as resident here."""
        self.directory.publish(SNAPSHOT_TIER, key, self.host_id)

    # ----------------------------------------------------- partial restores
    def begin_partial_snapshot(self, key: str, nbytes: int) -> None:
        """A streamed restore of ``key`` started on this host (blobstore's
        ``stream_restore`` calls this before the first chunk moves)."""
        with self._lock:
            self._partial[key] = int(nbytes)

    def end_partial_snapshot(self, key: str) -> None:
        """The streamed restore finished (success or failure) — it is no
        longer in flight; success additionally registers + publishes the
        snapshot through the normal chunk-tier path."""
        with self._lock:
            if self._partial.pop(key, None) is not None:
                self.partial_restores += 1

    @staticmethod
    def _simulate(nbytes: int, s_per_gb: float) -> None:
        if s_per_gb > 0.0 and nbytes > 0:
            time.sleep(nbytes * s_per_gb / 1e9)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            peer_fetches, store_fetches = self.peer_fetches, self.store_fetches
            peer_serves = self.peer_serves
            bytes_from_peer = self.bytes_from_peer
            bytes_from_store = self.bytes_from_store
            partial_restores = self.partial_restores
            partial_in_flight = len(self._partial)
            prefetched = self.prefetched
        return {
            "program": self.programs.stats(),
            "snapshot": self.snapshots.stats(),
            "peer_fetches": peer_fetches,
            "store_fetches": store_fetches,
            "peer_serves": peer_serves,
            "bytes_from_peer": bytes_from_peer,
            "bytes_from_store": bytes_from_store,
            "partial_restores": partial_restores,
            "partial_in_flight": partial_in_flight,
            "prefetched": prefetched,
        }


class Scheduler:
    """Cache-affinity placement over a Cluster's hosts.

    ``select`` scores every candidate host as ``load - affinity_weight * a``
    where ``a`` is 1.0 for a host already caching the program artifact, 0.75
    for a host in the artifact's HRW replica set (it will cache it after one
    boot and *stay* preferred — rendezvous hashing keeps the mapping stable as
    hosts come and go), plus 0.25 if the weight snapshot is resident. Load is
    in-flight requests, so a busy preferred host loses to an idle sibling once
    the gap exceeds the affinity weight — locality never starves throughput.
    """

    def __init__(self, cluster, cfg: Optional[SchedulerConfig] = None) -> None:
        self.cluster = cluster
        self.cfg = cfg or SchedulerConfig()
        self.directory = CacheDirectory()
        # per-target circuit breakers (host:N / peer / store). The dispatcher
        # records attempt outcomes here and binds the run's clock; ``select``
        # reads it to quarantine open hosts and admit half-open probes.
        self.breakers = BreakerBoard(failures=self.cfg.breaker_failures,
                                     cooldown_s=self.cfg.breaker_cooldown_s,
                                     probes=self.cfg.breaker_probes)
        self._rr = 0
        self._lock = threading.Lock()
        self.routed = 0
        self.affinity_routed = 0        # landed on a host already caching the program
        self.quarantine_skips = 0       # routes that filtered out >=1 open host
        # HRW preferred-set memo: keyed by artifact key, valid only for the
        # alive-membership it was computed against. At fleet scale the
        # per-route blake2b over every (key, host) pair dominates routing
        # cost; membership changes (kill/add/revive) simply miss the memo.
        self._hrw_memo: Dict[str, Tuple[Tuple[int, ...], Set[int]]] = {}

    def make_cache(self, host_id: int) -> HostArtifactCache:
        cache = HostArtifactCache(host_id, self.cfg, self.directory)
        cache.peer_lookup = self._peer_lookup
        cache.peer_chunks = self._peer_chunk_lookup
        cache.breakers = self.breakers
        return cache

    # --------------------------------------------------------------- routing
    def select(self, image_key: Optional[str] = None,
               bucket_rows: Optional[int] = None,
               exclude: Optional[set] = None, strict: bool = False):
        """Pick a host, or return None when no (acceptable) host is alive.

        ``strict`` refuses to fall back into the excluded set — the hedge path
        uses it so a backup can never land on the host it is hedging against.
        """
        exclude = exclude or set()
        alive = self.cluster.alive_hosts()
        if not alive:
            return None
        candidates = [h for h in alive if h.host_id not in exclude]
        if not candidates:
            if strict:
                return None
            candidates = alive                 # retry beats failing outright
        probed: List[int] = []
        if self.cfg.quarantine:
            # breaker gate: OPEN hosts are quarantined out of routing;
            # HALF_OPEN hosts admit a bounded number of probes ("probe"
            # consumes a slot, released when the dispatcher records the
            # outcome — or right below, if the probe host isn't chosen).
            # If EVERY candidate is gated, fall back to the ungated set —
            # quarantine degrades placement, never availability.
            gates = {h.host_id: self.breakers.gate_host(h.host_id)
                     for h in candidates}
            probed = [hid for hid, g in gates.items() if g == "probe"]
            healthy = [h for h in candidates if gates[h.host_id] != "blocked"]
            if healthy and len(healthy) < len(candidates):
                with self._lock:
                    self.quarantine_skips += 1
            if healthy:
                candidates = healthy
        with self._lock:
            self._rr += 1
            rr = self._rr
        if image_key is not None:
            with self._lock:
                self.routed += 1
        if image_key is None or self.cfg.affinity_weight <= 0.0:
            chosen = min(candidates,
                         key=lambda h: (h.load, (h.host_id + rr) % len(candidates)))
        else:
            pkey = program_artifact_key(image_key, bucket_rows)
            preferred = self._preferred(pkey, [h.host_id for h in alive])

            def cost(h) -> float:
                cache = getattr(h, "cache", None)
                affinity = 0.0
                if cache is not None and cache.programs.contains(pkey):
                    affinity = 1.0
                elif h.host_id in preferred:
                    affinity = 0.75
                if cache is not None and cache.snapshots.contains(image_key):
                    affinity += 0.25
                return h.load - self.cfg.affinity_weight * affinity

            chosen = min(candidates,
                         key=lambda h: (cost(h), (h.host_id + rr) % len(candidates)))
            cache = getattr(chosen, "cache", None)
            if cache is not None and cache.programs.contains(pkey):
                with self._lock:
                    self.affinity_routed += 1
        for hid in probed:
            # half-open hosts we considered but did not pick get their probe
            # slot back immediately — only the CHOSEN host's probe stays
            # consumed (until the dispatcher records its outcome)
            if hid != chosen.host_id:
                self.breakers.release_probe_host(hid)
        return chosen

    def _preferred(self, pkey: str, alive_ids: List[int]) -> Set[int]:
        """HRW replica set for ``pkey`` over the current alive membership,
        memoized until membership changes (ids are stable, so the sorted
        tuple is a complete validity token)."""
        token = tuple(sorted(alive_ids))
        with self._lock:
            memo = self._hrw_memo.get(pkey)
            if memo is not None and memo[0] == token:
                return memo[1]
        preferred = set(hrw_hosts(pkey, alive_ids, self.cfg.replicas))
        with self._lock:
            self._hrw_memo[pkey] = (token, preferred)
        return preferred

    # ----------------------------------------------------------- peer lookup
    def _peer_lookup(self, tier: str, key: str,
                     requester_id: int) -> Optional[Tuple[Any, int]]:
        if tier != PROGRAM_TIER:
            return None                      # snapshots move chunk-wise below
        for hid in sorted(self.directory.owners(tier, key) - {requester_id}):
            host = self._live_host(hid)
            if host is None:
                continue
            entry = host.cache.programs.peek(key)
            if entry is not None:
                with host.cache._lock:
                    host.cache.peer_serves += 1
                return entry
        return None

    def _peer_chunk_lookup(self, key: str, cids: List[str],
                           requester_id: int) -> Dict[str, bytes]:
        """Gather missing chunks from live peers — exact-snapshot owners
        first (they hold the full chunk range by construction), then any
        other snapshot-tier owner, which may hold shared chunks via a
        different snapshot. Stops as soon as the delta is covered."""
        wanted = list(dict.fromkeys(cids))
        got: Dict[str, bytes] = {}
        exact = self.directory.owners(SNAPSHOT_TIER, key)
        others = self.directory.tier_owners(SNAPSHOT_TIER) - exact
        for hid in sorted(exact - {requester_id}) + sorted(others - {requester_id}):
            host = self._live_host(hid)
            if host is None:
                continue
            served = host.cache.snapshots.chunks_for(
                [c for c in wanted if c not in got])
            if served:
                with host.cache._lock:
                    host.cache.peer_serves += 1
                got.update(served)
            if len(got) == len(wanted):
                break
        return got

    def _live_host(self, hid: int):
        # lookup BY ID: once hosts churn mid-run, id != list position
        host = self.cluster.host_by_id(hid)
        if host is None or not host.alive \
                or getattr(host, "cache", None) is None:
            return None
        return host

    # --------------------------------------------------------------- reports
    def summary(self) -> Dict[str, Any]:
        hosts: Dict[int, Dict[str, Any]] = {}
        agg = {"program": [0, 0], "snapshot": [0, 0]}       # [hits, misses]
        peer_fetches = store_fetches = 0
        bytes_from_peer = bytes_from_store = 0
        bytes_deduped = 0
        partial_restores = partial_in_flight = 0
        prefetched = 0
        for h in self.cluster.hosts:
            cache = getattr(h, "cache", None)
            if cache is None:
                continue
            s = cache.summary()
            s["alive"] = h.alive
            s["load"] = h.load
            hosts[h.host_id] = s
            for tier in ("program", "snapshot"):
                agg[tier][0] += int(s[tier]["hits"])
                agg[tier][1] += int(s[tier]["misses"])
            peer_fetches += s["peer_fetches"]
            store_fetches += s["store_fetches"]
            bytes_from_peer += s["bytes_from_peer"]
            bytes_from_store += s["bytes_from_store"]
            bytes_deduped += int(s["snapshot"].get("bytes_deduped", 0))
            partial_restores += s["partial_restores"]
            partial_in_flight += s["partial_in_flight"]
            prefetched += s.get("prefetched", 0)
        with self._lock:
            routed, affinity_routed = self.routed, self.affinity_routed
            quarantine_skips = self.quarantine_skips
        def rate(hits: int, misses: int) -> float:
            return hits / (hits + misses) if hits + misses else 0.0
        return {
            "hosts": hosts,
            "program_hit_rate": rate(*agg["program"]),
            "snapshot_hit_rate": rate(*agg["snapshot"]),
            "peer_fetches": peer_fetches,
            "store_fetches": store_fetches,
            "bytes_from_peer": bytes_from_peer,
            "bytes_from_store": bytes_from_store,
            "bytes_deduped": bytes_deduped,
            "partial_restores": partial_restores,
            "partial_in_flight": partial_in_flight,
            "prefetched": prefetched,
            "routed": routed,
            "affinity_routed": affinity_routed,
            "quarantine_skips": quarantine_skips,
            "breakers": self.breakers.summary(),
            "replicas": self.cfg.replicas,
            "affinity_weight": self.cfg.affinity_weight,
        }
