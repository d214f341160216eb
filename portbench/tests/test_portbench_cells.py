"""Each cell's harness path, run on the CPU at the port's reduced sizes,
prints a well-formed last line; the command refuses to run without a card."""
import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from conftest import ROOT, cells, tiny_overrides

from portbench.harness import spec
from portbench.harness.main import emit, run_cell

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_a_well_formed_last_line(cell, trace):
    import torch
    threads = torch.get_num_threads()
    t = time.perf_counter()
    result, lines, _ = run_cell(ROOT, cell, 2**31 + 17, 2.0, bool(trace), device="cpu",
                                reduced=True, overrides=tiny_overrides(cell), t_start=t)
    assert torch.get_num_threads() == threads           # the serving threads' setting undone
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert emit(result, lines) == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last) == TOP_KEYS                      # the checks' key comes last
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    assert err.getvalue().strip().splitlines()[-2:] == lines
    c = spec.load_cell(ROOT, cell)
    want = {m["name"] for m in c.metrics(bool(trace))}
    # the CPU has no device trace: the device's metrics are left out, never 0
    device_only = {m["name"] for m in c.metrics(bool(trace)) if m["source"] == "device_trace"}
    assert set(last["metrics"]) == want - device_only
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert last["device"]["platform"] == "cpu"


def test_command_without_a_card_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        cells()[0], "--seed", "5", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
