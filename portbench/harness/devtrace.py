"""The device's side of a traced window, from ``torch.profiler`` (CUPTI).

Only device activity is recorded (``ProfilerActivity.CUDA``): kernels,
copies and sets. The reduction reads the profiler's raw events
(``kineto_results.events()``), not its Python event tree, which would take
minutes at a window's hundreds of thousands of events."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple


@dataclasses.dataclass
class DeviceWindow:
    """What ran on the device between ``start_ns`` and ``stop_ns`` (the
    profiler's clock; ``pc_at(ns)`` maps it to ``time.perf_counter``)."""

    start_ns: int
    stop_ns: int
    pc_start: float
    busy_s: float                              # any kernel, copy or set running
    kernel_busy_s: float                       # any kernel running
    by_name: Dict[str, Tuple[int, float]]      # name -> (events, seconds inside)
    gaps: List[Tuple[int, int]]                # idle intervals, longest first
    events: int
    htod_busy_s: float = 0.0                   # any host-to-device copy running

    @property
    def window_s(self) -> float:
        return (self.stop_ns - self.start_ns) / 1e9

    def pc_at(self, ns: int) -> float:
        return self.pc_start + (ns - self.start_ns) / 1e9

    def kernels(self, *words: str) -> Tuple[int, float]:
        """(events, seconds) of the kernels whose name holds every word."""
        n, s = 0, 0.0
        for name, (k, t) in self.by_name.items():
            if all(w in name for w in words):
                n, s = n + k, s + t
        return n, s


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def is_htod(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


class DeviceTrace:
    def __init__(self) -> None:
        import torch
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def start(self) -> None:
        before = time.time_ns()
        self._prof.__enter__()
        self._t0 = (before, time.time_ns(), time.perf_counter())

    def stop(self) -> DeviceWindow:
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        return reduce_events(self._prof.profiler.kineto_results, self._t0, t1)


def reduce_events(results, t0, t1_ns: int) -> DeviceWindow:
    """``t0`` (time.time_ns before and after the profiler started,
    perf_counter) and ``t1_ns`` (time.time_ns at the stop). Where the
    profiler's own start (``trace_start_ns``) lies outside the first two, its
    events carry another clock than ``time.time_ns``, and the difference is
    taken out."""
    import torch
    offset = 0
    t_start = results.trace_start_ns()
    if not t0[0] <= t_start <= t0[1]:
        offset = t_start - t0[1]
    start, stop = t0[1] + offset, t1_ns + offset
    spans, kspans, hspans = [], [], []
    by_name: Dict[str, List] = {}
    n = 0
    for e in results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        a, b = max(a, start), min(b, stop)
        if b <= a:
            continue
        n += 1
        name = e.name()
        spans.append((a, b))
        if is_kernel(name):
            kspans.append((a, b))
        elif is_htod(name):
            hspans.append((a, b))
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e9
    busy = _union(spans)
    edges = [start] + [x for s in busy for x in s] + [stop]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return DeviceWindow(start_ns=start, stop_ns=stop, pc_start=t0[2],
                        busy_s=sum(b - a for a, b in busy) / 1e9,
                        kernel_busy_s=sum(b - a for a, b in _union(kspans)) / 1e9,
                        by_name={k: (v[0], v[1]) for k, v in by_name.items()},
                        gaps=gaps, events=n,
                        htod_busy_s=sum(b - a for a, b in _union(hspans)) / 1e9)
