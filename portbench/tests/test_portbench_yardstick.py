"""The yardstick pinned to hand counts: peaks, a kernel's operations and
bytes, a request's model FLOPs, the device trace's reduction and the readers
that turn it into metrics."""
import types

import pytest

from conftest import ROOT

from portbench.harness import devtrace, flops, peaks, spec
from portbench.reference.arch import Arch

TINY = Arch(d=8, n_heads=2, n_kv_heads=1, head_dim=4, ff=16, vocab=10, layers=1, gated=True,
            bias=False, norm_affine=False, norm_eps=1e-5, rope_theta=1e4, tied=True)


def test_peaks_and_bound():
    assert (peaks.BF16_FLOP_PER_S, peaks.HBM_BYTES_PER_S) == (989e12, 3.35e12)
    assert peaks.bound_s(3.35e12, 1.0) == 1.0
    assert peaks.bound_s(1.0, 989e12) == 1.0


def test_flash_cost_by_hand():
    # B=1, S=3: 6 pairs under the causal mask; 4 x 1 x 2 heads x 4 x 6 FLOPs;
    # q and out 2 x 3 x 2 x 4, k and v 2 x 3 x 1 x 4 elements of 2 bytes
    assert flops.flash_cost(1, 3, TINY) == (192.0, (48 + 24) * 2)


def test_decode_cost_by_hand():
    # B=2 rows of 5 positions: 4 x 2 heads x 4 x 10 FLOPs; q and out 2 x 2 x 2 x 4,
    # K and V 2 x 10 x 1 x 4 elements of 2 bytes, 2 int32 lengths
    assert flops.decode_cost(2, 5, TINY) == (320.0, (32 + 80) * 2 + 8)
    assert flops.decode_lengths(512, 4) == [513, 514, 515]


def test_request_flops_by_hand():
    # per token and layer: 2 x (8x8 + 2x8x4 + 4x2x8) + 2 x 3 x 8 x 16 = 1152
    B, S, K = 1, 3, 2
    dense = 1152 * B * (S + K - 1)
    attn = 192 + 4 * 2 * 4 * 4                 # the prefill, one decode step over 4
    head = 2 * B * K * 8 * 10
    assert flops.request_flops(TINY, B, S, K) == dense + attn + head


class _Ev:
    def __init__(self, name, start, dur, cuda=True):
        import torch
        self._n, self._s, self._d = name, start, dur
        self._t = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


class _Results:
    def __init__(self, events, start):
        self._e, self._start = events, start

    def events(self):
        return self._e

    def trace_start_ns(self):
        return self._start


def test_trace_reduction():
    t0 = 1_000_000_000
    evs = [_Ev("void flash_fwd_wgmma_kernel<>", t0 + 100, 300),
           _Ev("Memcpy HtoD (Pinned -> Device)", t0 + 200, 400),     # overlaps: union
           _Ev("Memcpy HtoD (Pinned -> Device)", t0 + 500, 200),     # overlaps the copy
           _Ev("cudaLaunchKernel", t0 + 50, 10, cuda=False),
           _Ev("decode_partial_kernel", t0 + 900, 50),
           _Ev("late", t0 + 990, 100)]                                 # clipped at the stop
    w = devtrace.reduce_events(_Results(evs, t0 + 5), (t0, t0 + 10, 50.0), t0 + 1000)
    assert w.window_s == 990e-9 and w.events == 5
    assert w.busy_s == pytest.approx((600 + 50 + 10) / 1e9)
    assert w.kernel_busy_s == pytest.approx((300 + 50 + 10) / 1e9)
    assert w.htod_busy_s == pytest.approx(500 / 1e9)
    assert w.kernels("flash_fwd") == (1, pytest.approx(300e-9))
    assert w.gaps[0] == (t0 + 700, t0 + 900)                            # longest first
    assert w.pc_at(t0 + 10) == 50.0


def test_trace_reduction_takes_out_another_clock():
    evs = [_Ev("k", 5_000_100, 100)]
    w = devtrace.reduce_events(_Results(evs, 5_000_000), (1_000, 2_000, 0.0), 3_000)
    assert (w.start_ns, w.stop_ns) == (5_000_000, 5_001_000)
    assert w.busy_s == pytest.approx(100e-9)


def _run_with(by_name, busy, kernel_busy, window_s=1.0, htod_busy=0.0):
    cell = spec.load_cell(ROOT, "starcoder2-cold-fanout")
    dev = devtrace.DeviceWindow(start_ns=0, stop_ns=int(window_s * 1e9), pc_start=0.0,
                                busy_s=busy, kernel_busy_s=kernel_busy, by_name=by_name,
                                gaps=[], events=1, htod_busy_s=htod_busy)
    from portbench.reference.arch import arch_of
    return types.SimpleNamespace(device=dev, fn=cell.config["function"],
                                 arch=arch_of(cell.config))


def test_roofline_and_idle_readers():
    from portbench.reference.arch import arch_of
    cell = spec.load_cell(ROOT, "starcoder2-cold-fanout")
    a, fn = arch_of(cell.config), cell.config["function"]
    f, b = flops.flash_cost(fn["batch_size"], fn["prompt_len"], a)
    one = peaks.bound_s(b, f)
    run = _run_with({"void repro::flash_fwd_wgmma_kernel": (4, 8 * one)}, 0.25, 0.2)
    assert spec.reader("flash_attention_roofline")(run) == pytest.approx(50.0)
    assert spec.reader("device_idle_pct")(run) == pytest.approx(75.0)
    assert spec.reader("decode_attention_roofline")(run) is None     # nothing to read
    run.device = None
    assert spec.reader("flash_attention_roofline")(run) is None


def test_card_time_per_request_readers():
    run = _run_with({}, 0.25, 0.05, htod_busy=0.2)
    run.answered_in_window = lambda: [None] * 10
    assert spec.reader("device_ms_per_req")(run) == pytest.approx(25.0)
    assert spec.reader("htod_ms_per_req")(run) == pytest.approx(20.0)
    run.answered_in_window = lambda: []                 # nothing answered: nothing to read
    assert spec.reader("device_ms_per_req")(run) is None
    run.answered_in_window = lambda: [None]
    run.device = None                                   # no trace: nothing to read
    assert spec.reader("device_ms_per_req")(run) is None
    assert spec.reader("htod_ms_per_req")(run) is None


def test_latency_readers_and_the_sweeps_readings():
    import importlib.util

    import numpy as np
    from portbench.harness import load
    reqs = [load.Request(i, due=float(i)) for i in range(20)]
    for r in reqs[:19]:
        r.done, r.tokens = r.due + 0.001 * (r.i + 1), [0]
    run = types.SimpleNamespace(requests=reqs, give_up=100.0,
                                latencies=lambda: [r.latency(100.0) for r in reqs])
    # 19 answered after 1..19 ms, one never: it counts until waiting stopped
    assert spec.reader("req_p50_ms")(run) == pytest.approx(10.5)
    assert spec.reader("req_p95_ms")(run) == pytest.approx(
        float(np.percentile([0.001 * k for k in range(1, 20)] + [81.0], 95) * 1e3))
    path = ROOT / "portbench" / "tools" / "sweep.py"
    mod_spec = importlib.util.spec_from_file_location("portbench_sweep", path)
    sweep = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(sweep)
    traced = _run_with({}, 0.2, 0.1)
    vars(traced).update(vars(run), seconds=1.0, setup_s=3.0, t0=0.0, served=lambda: [],
                        answered_in_window=lambda: reqs[:1], executions_in_trace=lambda: 0)
    got = sweep.readings(traced)
    assert got["req_p50_ms"] == pytest.approx(10.5) and got["setup_s"] == 3.0
    assert got["served_rps.closed_loop"] == 1.0
    assert got["device_idle_pct"] == pytest.approx(80.0)
    assert got["device_ms_per_req"] == pytest.approx(200.0)
    assert "boot_ms.p50" not in got                  # nothing to read: left out
