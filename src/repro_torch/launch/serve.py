"""Serving CLI (port of ``repro.launch.serve``, the same flags plus
``--device``) — stand up the cold-start FaaS platform and fire a workload at it.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --mode cold \\
      --hosts 2 --requests 50 --concurrency 4 --device cpu
"""
from __future__ import annotations

import argparse
import concurrent.futures
from typing import Optional, Sequence

from repro_torch.configs import list_archs
from repro_torch.core import FunctionSpec, Gateway


def main(argv: Optional[Sequence[str]] = None) -> Gateway:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-3b")
    ap.add_argument("--mode", choices=("cold", "warm"), default="cold")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--driver", default=None,
                    help="force a driver (unikernel/fork/paused/warm/cold_jit/...)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    gw = Gateway(n_hosts=args.hosts, slots_per_host=args.slots, mode=args.mode,
                 device=args.device)
    spec = FunctionSpec(arch=args.arch, batch_size=args.batch,
                        prompt_len=args.prompt_len, decode_steps=args.decode_steps)
    print(f"deploying {spec.name} ...")
    dep = gw.deploy(spec)
    m = dep.image.manifest
    print(f"image: program={m.program_bytes/1e3:.0f} kB "
          f"snapshot={m.snapshot_bytes/1e6:.2f} MB build={m.build_seconds:.1f}s")

    label = f"{spec.name}:{args.driver or gw.default_driver()}"
    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as pool:
        futs = [pool.submit(gw.invoke, spec.name, None, args.driver, label)
                for _ in range(args.requests)]
        for f in futs:
            f.result()

    for field in ("e2e", "startup", "queue_wait", "execution"):
        print(f"{field:10s} {gw.stats(label, field).row()}")
    print("residency:", gw.residency_summary())
    print("hedges:", gw.dispatcher.hedges_launched, "retries:", gw.dispatcher.retries)
    gw.shutdown()
    return gw


if __name__ == "__main__":
    main()
