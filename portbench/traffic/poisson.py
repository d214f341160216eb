"""Poisson arrivals at ``rate_rps`` (requests a second), open loop.

The window of ``seconds`` holds ``round(rate * seconds)`` arrivals, their
exponential gaps drawn from ``shape_seed`` and scaled to sum to the window
(a Poisson stream given its count)."""
from __future__ import annotations

import numpy as np


def schedule(params: dict, seconds: float) -> dict:
    rate = float(params["rate_rps"])
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(int(params["shape_seed"])).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()
    return {"open": np.concatenate([[0.0], np.cumsum(gaps)[:-1]]).tolist()}
