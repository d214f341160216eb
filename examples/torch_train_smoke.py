"""Fault-tolerant training demo on the PyTorch port: train a reduced llama
on the synthetic bigram stream, checkpoint periodically, simulate a crash,
resume exactly, and promote the final checkpoint into the serving
platform's snapshot store.

    PYTHONPATH=src python examples/torch_train_smoke.py [--steps 120]        # the GPU
    PYTHONPATH=src python examples/torch_train_smoke.py --device cpu --steps 8

The counterpart of ``examples/train_smoke.py`` (the JAX package), with its
printed lines, on the same config: reduced llama3.2-3b in float32 on both
devices (``--reduced`` is accepted and changes nothing). ``--device cuda``
(the default) needs a GPU; nothing falls back to the CPU. ``--ckpt-dir``
keeps the checkpoints and the promoted snapshot there (default: a new
temporary directory).
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="accepted for the other examples' sake: the config is always reduced")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu to run on "
                           "the CPU")

    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    half = args.steps // 2

    def make(steps):
        return Trainer(
            cfg,
            TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                          steps=steps, ckpt_every=20, log_every=20),
            AdamWConfig(peak_lr=1e-3, warmup=20, total_steps=args.steps),
            ckpt_dir=ckpt_dir, device=args.device)

    print(f"--- phase 1: train to step {half}, then 'crash' ---")
    t1 = make(half)
    t1.run()

    print("--- phase 2: new process resumes from the latest checkpoint ---")
    t2 = make(args.steps)
    out = t2.run()
    print(f"resumed at step {t2.history[0]['step']}, "
          f"final loss {out['final_loss']:.4f} "
          f"(straggler events: {len(t2.straggler_events)})")

    # promote the trained weights into the FaaS snapshot store (zero-copy layout)
    from repro_torch.core.snapshot import SnapshotStore
    store = SnapshotStore(Path(ckpt_dir) / "serving")
    nbytes = store.save("trained-llama-reduced", out["params"])
    print(f"promoted final weights into serving snapshot store "
          f"({nbytes/1e6:.2f} MB) -> ready for cold-start deployment")


if __name__ == "__main__":
    main()
