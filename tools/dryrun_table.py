#!/usr/bin/env python3
"""Summarise the dry run's records as a markdown table.

    python3 tools/dryrun_table.py artifacts/dryrun [--mesh data16xmodel16]

Reads every ``<arch>__<shape>__<mesh>__<variant>.json`` that
``python -m repro_torch.launch.dryrun`` wrote under the directory and prints
one row per cell: the rules, gradient accumulation and moment dtype, the
trace's seconds, FLOPs per device against the analytic count over the
devices, the probes' extrapolation where there is one, collective bytes per
device, and bytes per device against the card's memory. A cell whose record
is missing is listed from its log (``<arch>__<shape>__<sp|mp>.log``) with
the log's last line.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def gb(x) -> str:
    return f"{x / 1e9:.2f}"


def row(rec: dict) -> str:
    ndev = rec["n_devices"]
    analytic = rec["analytic_flops_global"]["executed"] / ndev
    probe = rec.get("costs_per_device", {}).get("flops")
    coll = rec["collectives"]
    fits = rec.get("fits_device_memory")
    return (f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | {rec['rules']} | "
            f"{rec['grad_accum']} | {rec['opt_dtype']} | {rec['lower_s']:.1f} | "
            f"{rec['flops_per_device']:.4g} | {analytic:.4g} | "
            f"{'' if probe is None else f'{probe:.4g}'} | {gb(coll['total'])} "
            f"({coll['count']}) | {gb(rec['bytes_per_device'])} | "
            f"{'' if fits is None else ('yes' if fits else 'no')} |")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--mesh", default=None, help="only records of this mesh tag")
    args = ap.parse_args()
    root = Path(args.directory)
    print("| arch | shape | mesh | rules | ga | moments | trace s | FLOPs/device | "
          "analytic/device | probes | collective GB (calls) | GB/device | fits |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    seen = set()
    for path in sorted(root.glob("*.json")):
        rec = json.loads(path.read_text())
        if args.mesh and rec["mesh"] != args.mesh:
            continue
        seen.add((rec["arch"], rec["shape"], rec["mesh"].startswith("pod")))
        print(row(rec))
    for log in sorted(root.glob("*.log")):
        arch, shape, pass_ = log.stem.split("__")
        multi = pass_ == "mp"
        if (arch, shape, multi) in seen:
            continue
        if args.mesh and args.mesh.startswith("pod") != multi:
            continue
        lines = [ln for ln in log.read_text().splitlines() if ln.strip()]
        last = lines[-1][:160] if lines else "(empty log)"
        print(f"| {arch} | {shape} | {'multi-pod' if multi else 'single pod'} | failed: "
              f"`{last}` |||||||||||")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
