"""A two-state Markov-modulated Poisson process, open loop: bursts at
``rate_on`` with exponential dwells of mean ``mean_on_s``, quiet periods at
``rate_off`` with dwells of mean ``mean_off_s``, starting quiet unless
``start_on``.

``BurstyPop`` below is a frozen copy of the generator of the repository's
JAX benchmarks (``benchmarks/traces.py``); the schedule is its draw from
``shape_seed`` over the window."""
from __future__ import annotations

import dataclasses
import random
from typing import List, Tuple

Arrival = Tuple[float, str]


def _pop_rng(seed: int, name: str) -> random.Random:
    return random.Random(f"{seed}:{name}")


@dataclasses.dataclass(frozen=True)
class BurstyPop:
    """2-state MMPP: exponential ON/OFF dwells, Poisson arrivals within ON."""

    name: str
    rate_on: float = 40.0
    rate_off: float = 0.0
    mean_on_s: float = 4.0
    mean_off_s: float = 20.0
    start_on: bool = False

    def generate(self, duration_s: float, seed: int) -> List[Arrival]:
        rng = _pop_rng(seed, self.name)
        out: List[Arrival] = []
        t = 0.0
        on = self.start_on
        while t < duration_s:
            dwell = rng.expovariate(1.0 / (self.mean_on_s if on
                                           else self.mean_off_s))
            t_end = min(t + dwell, duration_s)
            rate = self.rate_on if on else self.rate_off
            if rate > 0.0:
                tt = t
                while True:
                    tt += rng.expovariate(rate)
                    if tt >= t_end:
                        break
                    out.append((tt, self.name))
            t = t_end
            on = not on
        return out


def schedule(params: dict, seconds: float) -> dict:
    pop = BurstyPop("mmpp", rate_on=float(params["rate_on"]),
                    rate_off=float(params["rate_off"]), mean_on_s=float(params["mean_on_s"]),
                    mean_off_s=float(params["mean_off_s"]),
                    start_on=bool(params.get("start_on", False)))
    return {"open": [t for t, _ in pop.generate(seconds, int(params["shape_seed"]))]}
