"""The readings a cell's ``max_logit_gap`` limit is set from, on the card at
the cell's own size: for each seed, a run of the cell (its deploy, its load
for ``--seconds``, its sample of answered requests), then the widest gap of
the served tokens below the float32 reference's best (the program) and of
the tokens the float8 control puts first (the reference in the precision
below the served bfloat16). One JSON line a seed.

    python3 portbench/tools/control.py --workload starcoder2-cold-fanout --seconds 10 \\
        --seeds 11 12 13
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import check  # noqa: E402
from portbench.harness import env  # noqa: E402
from portbench.harness.main import prepare, run_cell  # noqa: E402


def readings(run, seed: int, device: str, precisions=("f32", "fp8")) -> dict:
    fn, cfg = run.fn, run.cell.config
    B, S, K = fn["batch_size"], fn["prompt_len"], fn["decode_steps"]
    answered = [r.i for r in run.requests if r.ok]
    by_i = {r.i: r for r in run.requests}
    items = [(check.prompt(seed, i, B, S, cfg["real_vocab"]), by_i[i].tokens)
             for i in check.sample(answered, B, K, seed)]
    out = check.gaps(cfg, seed, device, items, precisions)
    out["tokens"] = len(items) * B * K
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--program-only", action="store_true")
    args = p.parse_args()
    env.become_subreaper()
    why = prepare(ROOT, 1)
    if why is not None:
        print(why, file=sys.stderr)
        return 1
    precisions = ("f32",) if args.program_only else ("f32", "fp8")
    for seed in args.seeds:
        result, _, run = run_cell(ROOT, args.workload, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "attempted": result["attempted"], "failed": result["failed"],
                          **readings(run, seed, "cuda", precisions)}), flush=True)
    env.reap()
    return 0


if __name__ == "__main__":
    sys.exit(main())
