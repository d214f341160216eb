"""Autoscaling (port of ``repro.core.autoscaler``): the cold-only trivial case.

``ColdOnlyScaler`` is the paper's proposal: nothing. Scaling IS the request
queue — every request starts its own executor which exits on completion. The
class exists so cold and warm mode expose the same interface. The JAX
module's ``WarmPoolAutoscaler`` (Little's-law pool targets, prewarm,
idle-timeout expiry) comes with the ``warm`` driver.

Invariant: ``per_host_residency`` is zero by construction in cold mode.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.cluster import Cluster


class ColdOnlyScaler:
    """Load-driven by construction: no pools, no monitoring, no knobs."""

    def __init__(self) -> None:
        self.mode = "cold"

    def observe_arrival(self, fn_name: str) -> None:
        pass

    def observe_service_time(self, fn_name: str, seconds: float) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def target(self, fn_name: str) -> int:
        return 0

    def resident_nbytes(self, cluster: Cluster) -> int:
        return 0

    def per_host_residency(self, cluster: Cluster) -> Dict[int, int]:
        """Cold-only holds no executors between requests — zero everywhere, by
        construction (the placement report shows this next to warm's pools)."""
        return {h.host_id: 0 for h in cluster.hosts}
