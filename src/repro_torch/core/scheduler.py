"""Placement: rendezvous hashing blended with live load.

Port of the routing part of ``repro.core.scheduler``. The JAX module also
keeps a tiered artifact cache per host (program payloads and snapshot
chunks), peer fetches and circuit breakers, and scores a host higher when
its tiers already hold the artifact. The port's boot stages read the global
stores on every boot, so those tiers would stay empty; they come with the
control-plane slice that makes the boot stages consult them. With empty
tiers the JAX score reduces to the one below, so both packages route the
same keys to the same hosts.

Rendezvous/HRW hashing gives every artifact a stable k-replica preferred set
(minimal reshuffle when hosts die or join), blended with live load so a hot
host sheds work to its replica siblings.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

# how many load units a preferred host is worth when scoring hosts
AFFINITY_WEIGHT = 2.0
# the preferred weight of a host in the key's HRW replica set (the JAX score
# gives 1.0 to a host already caching the artifact, which the port's hosts
# never do yet)
PREFERRED_AFFINITY = 0.75
# HRW replica set size: each artifact key maps to this many preferred hosts
REPLICAS = 2


def program_artifact_key(image_key: str, bucket_rows: Optional[int]) -> str:
    """Cache key for a program artifact (matches the JAX package's
    ``Deployment.bucket_image_key``)."""
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


class Scheduler:
    """Affinity placement over a Cluster's hosts.

    ``select`` scores every candidate host as ``load - AFFINITY_WEIGHT * a``
    where ``a`` is 0.75 for a host in the artifact's HRW replica set and 0
    otherwise. Load is in-flight requests, so a busy preferred host loses to
    an idle sibling once the gap exceeds the affinity weight — locality never
    starves throughput.
    """

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self._rr = 0
        self._lock = threading.Lock()
        self.routed = 0
        # HRW preferred-set memo: keyed by artifact key, valid only for the
        # alive-membership it was computed against; membership changes
        # (kill/add/revive) simply miss the memo.
        self._hrw_memo: Dict[str, Tuple[Tuple[int, ...], Set[int]]] = {}

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
        with self._lock:
            self._rr += 1
            rr = self._rr
            if image_key is not None:
                self.routed += 1
        if image_key is None:
            return min(candidates,
                       key=lambda h: (h.load, (h.host_id + rr) % len(candidates)))
        preferred = self._preferred(program_artifact_key(image_key, bucket_rows),
                                    [h.host_id for h in alive])

        def cost(h) -> float:
            affinity = PREFERRED_AFFINITY if h.host_id in preferred else 0.0
            return h.load - AFFINITY_WEIGHT * affinity

        return min(candidates, key=lambda h: (cost(h), (h.host_id + rr) % len(candidates)))

    def _preferred(self, pkey: str, alive_ids: List[int]) -> Set[int]:
        """HRW replica set for ``pkey`` over the current alive membership,
        memoized until membership changes (ids are stable, so the sorted
        tuple is a complete validity token)."""
        token = tuple(sorted(alive_ids))
        with self._lock:
            memo = self._hrw_memo.get(pkey)
            if memo is not None and memo[0] == token:
                return memo[1]
        preferred = set(hrw_hosts(pkey, alive_ids, REPLICAS))
        with self._lock:
            self._hrw_memo[pkey] = (token, preferred)
        return preferred
