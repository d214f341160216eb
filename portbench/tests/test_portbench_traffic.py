"""The traffic generators: seeded, and the same work for every seed."""
import numpy as np
import pytest

from conftest import ROOT

from portbench.harness import spec

MMPP = {"rate_on": 4.0, "rate_off": 1.0, "mean_on_s": 1.0, "mean_off_s": 2.0, "shape_seed": 7}


def test_frozen_mmpp_copy_gives_the_pinned_draws():
    # BurstyPop("x", 4/s on, 1/s off, dwells 1 s and 2 s) over 10 s at seed 7,
    # as benchmarks/traces.py draws it
    pop = spec.traffic("mmpp").BurstyPop("x", rate_on=4.0, rate_off=1.0, mean_on_s=1.0,
                                         mean_off_s=2.0)
    got = pop.generate(10.0, 7)
    assert len(got) == 17
    assert np.allclose([t for t, _ in got[:5]],
                       [1.469167, 1.523667, 2.417128, 2.685107, 2.704795], atol=1e-6)
    named = spec.traffic("mmpp").BurstyPop("mmpp", rate_on=4.0, rate_off=1.0, mean_on_s=1.0,
                                           mean_off_s=2.0)
    assert spec.traffic("mmpp").schedule(MMPP, 10.0)["open"] == \
        [t for t, _ in named.generate(10.0, 7)]


@pytest.mark.parametrize("kind,params", [("poisson", {"rate_rps": 5.0, "shape_seed": 1}),
                                         ("mmpp", MMPP)])
def test_open_schedules_are_one_draw_of_their_shape_seed(kind, params):
    gen = spec.traffic(kind)
    a, b = (gen.schedule(params, 30.0)["open"] for _ in range(2))
    c = gen.schedule({**params, "shape_seed": 8}, 30.0)["open"]
    assert a == b and a != c
    for s in (a, c):
        assert s == sorted(s) and 0.0 <= s[0] and s[-1] < 30.0
    if kind == "poisson":
        assert len(a) == len(c) == 150                          # round(5/s x 30 s)


def test_poisson_pinned():
    s = spec.traffic("poisson").schedule({"rate_rps": 5.0, "shape_seed": 1}, 4.0)["open"]
    assert len(s) == 20
    assert s[0] == 0.0 and np.isclose(sum(np.diff(s + [4.0])), 4.0)
    assert np.allclose(s[1:4], [0.218114, 0.280814, 1.373477], atol=1e-6)


def test_closed_is_its_callers():
    assert spec.traffic("closed").schedule({"callers": 32}, 30.0) == {"closed": 32}


def test_every_cell_names_a_generator_and_its_files():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = spec.load_cell(ROOT, w["name"])
        sched = spec.traffic(c.workload["traffic_kind"]).schedule(
            c.workload["traffic_params"], bench["run_seconds"])
        assert sched.get("closed", 0) > 0 or len(sched["open"]) > 0
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(m["name"]))


def test_open_loop_times_a_request_from_when_it_was_due():
    # The open-loop path of the Poisson and MMPP mixes, which no cell of
    # BENCHMARK.json runs yet: a slow send holds the next request back, and
    # its latency still counts from its due time.
    import threading
    import time
    from concurrent.futures import Future

    from portbench.harness import load

    def submit(i):
        fut = Future()
        if i == 0:
            time.sleep(0.2)                         # the sender is held up
        threading.Timer(0.05, fut.set_result, [[i]]).start()
        return fut

    t0 = time.perf_counter() + 0.01
    reqs = load.run({"open": [0.0, 0.05, 0.1]}, submit, t0, 1.0)
    load.drain(reqs, time.perf_counter() + 5.0)
    assert [r.i for r in reqs] == [0, 1, 2] and all(r.ok for r in reqs)
    assert [r.due - t0 for r in reqs] == pytest.approx([0.0, 0.05, 0.1])
    lat = [r.latency(time.perf_counter()) for r in reqs]
    assert lat[0] >= 0.25 and lat[1] >= 0.2 and lat[2] >= 0.15   # sent late, timed from due
    assert all(r.sent - r.due >= 0.09 for r in reqs[1:])
