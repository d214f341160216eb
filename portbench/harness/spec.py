"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

For cell ``<cell>``: ``BENCHMARK.json``'s entry gives its configuration and
traffic names; ``configs/<config>.json`` the configuration as it is run;
``workloads/<cell>.json`` the traffic mix (``traffic.kind`` names the
generator ``traffic/<kind>.py``) and the gateway's hosts and slots; each
metric the run reports is read by ``metrics/<metric>.py``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]          # portbench/


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: List[dict]      # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[name]
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return Cell(name=name, chips=int(entry["chips"]), config=config, workload=workload,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _load_module(path: Path, tag: str):
    name = f"portbench_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def traffic(kind: str):
    return _load_module(HERE / "traffic" / f"{kind}.py", f"traffic_{kind}")


def reader(metric: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    tag = "metric_" + metric.replace(".", "_").replace("-", "_")
    return _load_module(HERE / "metrics" / f"{metric}.py", tag).read


def readers(metrics: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in metrics}
