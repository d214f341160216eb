"""Nothing the benchmark runs imports JAX, the JAX package (``repro``) or
the repository's JAX benchmarks: top-level module names compared whole,
since the port's name, ``repro_torch``, begins with ``repro``."""
import json
import subprocess
import sys
import types

from conftest import ROOT, tiny_overrides

from portbench.harness import env

DRIVE = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from portbench.harness import spec
from portbench.harness.main import emit, run_cell
for name in {metrics!r}:
    spec.reader(name)
for kind in ("poisson", "mmpp", "closed"):
    spec.traffic(kind)
import portbench.tools.sweep, portbench.tools.control
result, lines, _ = run_cell(spec.HERE.parent, {cell!r}, 5, 1.5, False, device="cpu",
                            reduced=True, overrides={over!r}, t_start=time.perf_counter())
rc = emit(result, lines)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


def test_a_run_holds_no_module_of_jax_or_the_jax_package():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = sorted(m["name"] for m in bench["end_to_end"] + bench["per_layer"])
    cell = bench["workloads"][0]["name"]
    code = DRIVE.format(root=str(ROOT), src=str(ROOT / "src"), metrics=metrics, cell=cell,
                        over=tiny_overrides(cell))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    names = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks", "traces"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch", types.ModuleType("repro_torch"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert env.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert env.forbidden_modules() == ["repro"]
