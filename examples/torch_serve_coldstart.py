"""End-to-end serving driver on the PyTorch port: a multi-host cold-only FaaS
platform serving batched model requests, compared against the warm-pool
incumbent, with straggler hedging and a mid-run node failure.

    PYTHONPATH=src python examples/torch_serve_coldstart.py               # the GPU, published widths
    PYTHONPATH=src python examples/torch_serve_coldstart.py --device cpu --reduced

The counterpart of ``examples/serve_coldstart.py`` (the JAX package), with
its printed lines, on AOTInductor-compiled programs and the port's
hand-written kernels:
  1. cold-only E2E latency is in the same regime as warm-pool latency,
  2. while holding ZERO idle device memory between bursts,
  3. with no warm-affinity routing / idle-timeout machinery,
  4. and free fault tolerance: kill a host mid-burst, requests re-route.
``--device cuda`` (the default) needs a GPU; nothing falls back to the CPU.
``--reduced`` deploys the reduced same-family config, as the JAX example
does; ``--bursts``, ``--per-burst`` and ``--gap-s`` shape the traffic.
"""
import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.core import FunctionSpec, Gateway  # noqa: E402


def bursty_workload(gw: Gateway, spec: FunctionSpec, label: str, bursts: int = 3,
                    per_burst: int = 6, gap_s: float = 1.0) -> None:
    with ThreadPoolExecutor(3) as pool:
        for b in range(bursts):
            futs = [pool.submit(gw.invoke, spec.name, None, None, label)
                    for _ in range(per_burst)]
            for f in futs:
                f.result()
            time.sleep(gap_s)


def run_mode(mode: str, spec: FunctionSpec, args) -> None:
    print(f"\n=== {mode.upper()}-mode platform (2 hosts) ===")
    gw = Gateway(n_hosts=2, slots_per_host=3, mode=mode, hedging=True, device=args.device)
    gw.deploy(spec)
    label = f"demo:{mode}"
    bursty_workload(gw, spec, label, args.bursts, args.per_burst, args.gap_s)

    # mid-run node failure: kill host 0, keep serving
    gw.cluster.kill_host(0)
    t0 = time.perf_counter()
    gw.invoke(spec.name, label=label)
    print(f"  host 0 killed -> next request still served "
          f"({(time.perf_counter()-t0)*1e3:.0f} ms; retries={gw.dispatcher.retries})")
    gw.cluster.hosts[0].revive()

    st, su = gw.stats(label), gw.stats(label, "startup")
    gw.shutdown()
    res = gw.residency_summary()
    print(f"  e2e    p50={st.p50:7.1f} ms  p99={st.p99:7.1f} ms  (n={st.n})")
    print(f"  startup p50={su.p50:6.1f} ms  p99={su.p99:7.1f} ms")
    print(f"  device-memory byte-seconds: total={res['total_GBs']:.4f} GBs, "
          f"IDLE={res['idle_GBs']:.4f} GBs")
    print(f"  hedged backups launched: {gw.dispatcher.hedges_launched}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config of the JAX example (default: published widths)")
    ap.add_argument("--bursts", type=int, default=3)
    ap.add_argument("--per-burst", type=int, default=6)
    ap.add_argument("--gap-s", type=float, default=1.0)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu to run on "
                           "the CPU")
    spec = FunctionSpec(arch="qwen2-vl-2b", batch_size=2, prompt_len=32, decode_steps=4,
                        reduced=args.reduced)
    run_mode("cold", spec, args)    # the paper's proposal: every start cold, zero idle memory
    run_mode("warm", spec, args)    # the incumbent: warm pools + autoscaler + idle timeouts
    print("\nReading: cold-mode p50 should sit within a small factor of warm-mode "
          "p50 (the paper's Table I claim), with idle_GBs ~ 0 for cold vs "
          "substantial for warm (the resource-waste claim).")


if __name__ == "__main__":
    main()
