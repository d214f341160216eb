"""Runs of a cell at other traffic than its file's, in one process: the
sweeps its fixed rates were chosen from. Each ``--traffic`` is a JSON object
merged into the workload file (``traffic_kind`` and ``traffic_params``); each
is run once a seed, and one JSON line is printed a run, with every metric
that a reader under ``metrics/`` finds in it (the requests answered a second,
the latencies' percentiles, the layers' spans; the device's with
``--trace 1``).

    python3 portbench/tools/sweep.py --workload starcoder2-cold-fanout --seconds 30 \\
        --seeds 7 8 --traffic '{"traffic_kind": "closed", "traffic_params": {"callers": 32}}'
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import env, spec  # noqa: E402
from portbench.harness.main import prepare, run_cell  # noqa: E402


def readings(run) -> dict:
    """Every metric of ``metrics/<name>.py`` that finds something in ``run``."""
    out = {}
    for path in sorted((spec.HERE / "metrics").glob("*.py")):
        value = spec.reader(path.stem)(run)
        if value is not None:
            out[path.stem] = value
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--traffic", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[7])
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args()
    env.become_subreaper()
    why = prepare(ROOT, 1)
    if why is not None:
        print(why, file=sys.stderr)
        return 1
    for traffic in args.traffic:
        for seed in args.seeds:
            result, _, run = run_cell(ROOT, args.workload, seed, args.seconds,
                                      bool(args.trace), overrides={"workload": json.loads(traffic)})
            print(json.dumps({"workload": args.workload, "traffic": json.loads(traffic),
                              "seed": seed, "attempted": result["attempted"],
                              "failed": result["failed"], "correct": result["correct"],
                              "metrics": readings(run), "checks": result["checks"],
                              "device": result["device"],
                              "breakdown": result.get("breakdown")}), flush=True)
    env.reap()
    return 0


if __name__ == "__main__":
    sys.exit(main())
