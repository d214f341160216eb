"""One run of one cell: set up the system, offer the cell's traffic for the
window, read the metrics, check what was served, print the result.

``main`` is the command line; ``run_cell`` the run itself, which the tests
drive on the CPU at the port's reduced sizes (``device="cpu"``,
``reduced=True``) without the look for a card."""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench.harness import check, env, load, spec
from portbench.reference.arch import Arch, arch_of, param_count

GAP_LABEL_EDGES = (0, 1, 2, 4, 8)           # host-state buckets of an idle gap's label


@dataclasses.dataclass
class Run:
    """What a metric reader sees (``metrics/<metric>.py``: ``read(run)``)."""

    cell: spec.Cell
    arch: Arch
    seconds: float                  # the window's length
    t0: float                       # the window's start (perf_counter)
    give_up: float                  # when waiting for answers stopped
    setup_s: float
    requests: List[load.Request]    # every request due in the window
    timelines: Dict[int, object]    # request index -> the program's Timeline
    device: Optional[object] = None  # devtrace.DeviceWindow of a traced run

    @property
    def fn(self) -> dict:
        return self.cell.config["function"]

    @property
    def image_bytes(self) -> int:
        return 2 * param_count(self.arch)           # bfloat16

    def latencies(self) -> List[float]:
        return [r.latency(self.give_up) for r in self.requests]

    def answered_in_window(self) -> List[load.Request]:
        end = self.t0 + self.seconds
        return [r for r in self.requests if r.ok and r.done <= end]

    def served(self) -> List[object]:
        """Timelines of the requests that were answered."""
        return [self.timelines[r.i] for r in self.requests if r.ok and r.i in self.timelines]

    def executions_in_trace(self) -> int:
        """Requests whose execution began inside the traced window."""
        d = self.device
        lo, hi = d.pc_at(d.start_ns), d.pc_at(d.stop_ns)
        return sum(1 for t in self.served() if lo <= t.t_exec_begin < hi)


def _bucket(n: int) -> str:
    for lo, hi in zip(GAP_LABEL_EDGES, GAP_LABEL_EDGES[1:]):
        if n < hi:
            return str(lo) if hi - lo == 1 else f"{lo}-{hi - 1}"
    return f"{GAP_LABEL_EDGES[-1]}+"


def idle_gaps(run: Run, top: int = 10) -> List[list]:
    """Idle seconds of the device, summed by what the host was doing at each
    gap's middle: how many requests were queued (sent, no boot begun),
    booting and executing, from the program's Timelines."""
    d = run.device
    if d is None or not d.gaps:
        return []
    tls = run.served()
    mids = np.array([d.pc_at((a + b) // 2) for a, b in d.gaps])
    secs = np.array([(b - a) / 1e9 for a, b in d.gaps])

    def active(begin, end):
        b, e = np.sort(np.asarray(begin)), np.sort(np.asarray(end))
        return np.searchsorted(b, mids, side="right") - np.searchsorted(e, mids, side="right")

    q = active([t.t_enqueue for t in tls], [t.t_start_begin for t in tls])
    bt = active([t.t_start_begin for t in tls], [t.t_exec_begin for t in tls])
    ex = active([t.t_exec_begin for t in tls], [t.t_done for t in tls])
    by: Dict[str, float] = {}
    for k in range(len(mids)):
        label = (f"queued {_bucket(int(q[k]))}, booting {_bucket(int(bt[k]))}, "
                 f"executing {_bucket(int(ex[k]))}")
        by[label] = by.get(label, 0.0) + float(secs[k])
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(run: Run, top: int = 10) -> List[list]:
    if run.device is None:
        return []
    items = sorted(run.device.by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return [[name, secs] for name, (_, secs) in items]


def _apply(base: dict, override: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (override or {}).items():
        out[k] = _apply(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None, reduced: bool = False,
             t_start: Optional[float] = None, log=None):
    """Run cell ``name`` -> (result object, check lines, ``Run``). ``overrides``:
    ``{"config": {...}, "workload": {...}}`` merged into the cell's files
    (the tests' reduced sizes); ``t_start``: the perf_counter time set-up
    counts from, where not the process's start."""
    import torch
    from portbench.harness.system import System

    log = log or (lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True))
    since_start = (lambda: time.perf_counter() - t_start) if t_start is not None \
        else env.since_process_start
    cell = spec.load_cell(root, name)
    cell.config = _apply(cell.config, (overrides or {}).get("config"))
    cell.workload = _apply(cell.workload, (overrides or {}).get("workload"))
    cfg, fn = cell.config, cell.config["function"]
    B, S, K = fn["batch_size"], fn["prompt_len"], fn["decode_steps"]
    vocab = cfg["real_vocab"]
    readers = spec.readers(cell.metrics(trace))
    traffic = spec.traffic(cell.workload["traffic_kind"])
    schedule = traffic.schedule(cell.workload["traffic_params"], seconds)
    cuda = device == "cuda"

    system = System(cfg, cell.workload, seed, device, reduced=reduced)
    closed = False
    try:
        deploy_peak = torch.cuda.max_memory_allocated() if cuda else 0
        sent = system.warm_up(check.prompt(seed, check.WARM_UP, B, S, vocab))
        log(f"deployed {system.name}: {json.dumps(system.counters(), default=str)}; "
            f"warm-up invocations {sent}")

        def submit(i: int):
            return system.invoke(check.prompt(seed, i, B, S, vocab), f"pb{i}")

        tracer = None
        traced = trace or any(m["source"] == "device_trace" for m in cell.end_to_end)
        if traced and cuda:
            from portbench.harness.devtrace import DeviceTrace
            tracer = DeviceTrace()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter() + 0.05
        setup_s = since_start() + 0.05
        reqs = load.run(schedule, submit, t0, seconds)
        while time.perf_counter() < t0 + seconds:
            time.sleep(0.001)
        window = tracer.stop() if tracer is not None else None
        t_stop = time.perf_counter()
        load.drain(reqs, t0 + seconds + load.GRACE_S)
        give_up = time.perf_counter()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        timelines = {r.i: system.timeline(f"pb{r.i}") for r in reqs}
        timelines = {i: t for i, t in timelines.items() if t is not None}
        counters = system.counters()
        late = [r.sent - r.due for r in reqs]
        log(f"window {seconds} s: {len(reqs)} requests, {sum(r.ok for r in reqs)} answered, "
            f"sender late p50 {load.percentile_ms(late, 50)} ms p99 {load.percentile_ms(late, 99)} ms; "
            f"answers waited for {give_up - t_stop:.3f} s past the close; "
            f"memory peak {memory_peak} B in the window, {deploy_peak} B by deploy; "
            f"hedges {counters['hedges']} retries {counters['retries']} attempts "
            f"{counters['attempts']}; launches {counters['launches']}")
        if window is not None:
            log(f"trace: {window.events} device events, busy {window.busy_s:.6f} s, kernels "
                f"{window.kernel_busy_s:.6f} s, host-to-device copies "
                f"{window.htod_busy_s:.6f} s of {window.window_s:.6f} s; "
                f"stopping and reading took {time.perf_counter() - t_stop:.3f} s")
        system.close()
        closed = True

        run = Run(cell=cell, arch=arch_of(cfg), seconds=seconds, t0=t0, give_up=give_up,
                  setup_s=setup_s, requests=reqs, timelines=timelines, device=window)
        units = {m["name"]: m["unit"] for m in cell.metrics(trace)}
        metrics = {}
        for metric, read in readers.items():
            value = read(run)
            if value is not None:
                metrics[metric] = {"value": float(value), "unit": units[metric]}

        answered = [r.i for r in reqs if r.ok]
        picked = check.sample(answered, B, K, seed)
        by_i = {r.i: r for r in reqs}
        items = [(check.prompt(seed, i, B, S, vocab), by_i[i].tokens) for i in picked]
        t_check = time.perf_counter()
        gap = check.gaps(cfg, seed, device, items)["f32"] if items else None
        log(f"check: {len(items)} requests, {len(items) * B * K} served tokens against the "
            f"reference in {time.perf_counter() - t_check:.3f} s")
    finally:
        if not closed:
            system.close()

    failed = sum(not r.ok for r in reqs)
    errors = sorted({r.error for r in reqs if r.error})[:3]
    if errors:
        log(f"failed requests: {errors}")
    limit = cfg["check"]["max_logit_gap"]
    checks = {"max_logit_gap": {"value": gap, "limit": limit},
              "failed_requests": {"value": failed, "limit": 0}}
    correct = bool(gap is not None and limit is not None and gap <= limit and failed == 0)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(memory_peak)}
    if trace and window is not None:
        dev.update(busy_s=window.busy_s, window_s=window.window_s)
    result = {"correct": correct, "attempted": len(reqs), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and window is not None:
        result["breakdown"] = {"device_ops": device_ops(run), "idle_gaps": idle_gaps(run)}
    result["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return result, lines, run


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(root: Path, chips: int) -> Optional[str]:
    """Cache directories, the card check and the host compiler; returns why
    the run cannot go on, or None."""
    inductor = env.point_caches(root)
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the GPU only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, this machine has {torch.cuda.device_count()}"
    from repro_torch.core import compile_cache
    compile_cache.enable_inductor_disk_cache(inductor)
    with tempfile.TemporaryDirectory() as work:
        print(f"portbench: {env.host_compiler(Path(work))}; card {env.card_line()}",
              file=sys.stderr, flush=True)
    return None


def main(argv: List[str], root: Path) -> int:
    args = parse(argv)
    env.become_subreaper()
    try:
        cell = spec.load_cell(root, args.workload)
        why = prepare(root, cell.chips)
        if why is not None:
            print(f"portbench: {why}", file=sys.stderr, flush=True)
            return 1
        result, lines, _ = run_cell(root, args.workload, args.seed, args.seconds,
                                    bool(args.trace))
    except Exception:  # noqa: BLE001 - any failure ends the run without a result
        traceback.print_exc()
        env.reap()
        return 1
    print(f"portbench: processes left and ended: {env.reap()}", file=sys.stderr, flush=True)
    return emit(result, lines)


def emit(result: dict, lines: List[str]) -> int:
    """Print the checks as the last lines of standard error and the result
    as the last line of standard output; nothing, and 1, where the process
    holds a module of JAX or of the JAX package."""
    held = env.forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} after the window", file=sys.stderr,
              flush=True)
        return 1
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
