"""Quickstart on the PyTorch port: deploy a model function as a
unikernel-style image, invoke it cold.

    PYTHONPATH=src python examples/torch_quickstart.py                # the GPU, published widths
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --reduced

The counterpart of ``examples/quickstart.py`` (the JAX package), with its
printed lines. Deploy builds the image once (the serve program compiled ahead
of time with AOTInductor, and the weight snapshot); each cold invoke then
starts a fresh executor from the image (package load + snapshot -> device),
runs prefill + 4 greedy decode steps, returns tokens, and exits, freeing all
device memory. Compare against ``cold_jit``, the re-trace-and-recompile path
every naive deployment pays. ``--device cuda`` (the default) needs a GPU;
nothing falls back to the CPU. ``--reduced`` deploys the reduced
same-family config, as the JAX example does.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.core import FunctionSpec, Gateway  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config of the JAX example (default: published widths)")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu to run on "
                           "the CPU")

    gw = Gateway(n_hosts=1, slots_per_host=2, mode="cold", device=args.device)
    spec = FunctionSpec(arch="llama3.2-3b", batch_size=2, prompt_len=32,
                        decode_steps=4, reduced=args.reduced)

    print("deploying (build AOT image + weight snapshot) ...")
    dep = gw.deploy(spec)
    m = dep.image.manifest
    print(f"  image: program={m.program_bytes/1e3:.0f} kB, "
          f"snapshot={m.snapshot_bytes/1e6:.2f} MB, build={m.build_seconds:.1f} s")

    print("\n3 cold invokes (unikernel driver):")
    for i in range(3):
        out = gw.invoke(spec.name, driver="unikernel", label="quick:uni")
        print(f"  tokens[{i}] = {out[0].tolist()}")
    tl = gw.recorder.timelines("quick:uni")[-1]
    print(f"  last start breakdown: program={tl.t_program*1e3:.1f} ms, "
          f"weights={tl.t_weights*1e3:.1f} ms, exec={tl.execution*1e3:.1f} ms")
    stages = ", ".join(f"{k}={v*1e3:.1f}" for k, v in sorted(tl.stage_s.items()))
    print(f"  boot stages (ms): {stages}")
    print(f"  boot wall={tl.t_boot_wall*1e3:.1f} ms "
          f"(overlap saved {tl.boot_overlap_saved*1e3:.1f} ms)")

    print("\n1 invoke via the full-JIT cold path (the 'Docker stack' tier):")
    # a whole trace and compile with every cache off: at published widths
    # longer than invoke's default timeout of 600 s
    gw.invoke(spec.name, driver="cold_jit", label="quick:jit", timeout=3600.0)
    uni = gw.stats("quick:uni", "startup").p50
    jit = gw.stats("quick:jit", "startup").p50
    print(f"  startup: unikernel={uni:.1f} ms vs cold_jit={jit:.0f} ms "
          f"({jit/max(uni,1e-9):.0f}x)")
    print(f"  idle device memory held right now: "
          f"{gw.scaler.resident_nbytes(gw.cluster)} bytes (cold-only => 0)")
    gw.shutdown()


if __name__ == "__main__":
    main()
