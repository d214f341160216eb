"""Training CLI (port of ``repro.launch.train``, the same flags plus
``--device``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --device cpu --dtype float32 --steps 100 --seq-len 128 --batch 8 \\
      --ckpt-dir /tmp/run1
  # resume after interruption: the same command (restores the latest checkpoint)
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from repro_torch.configs import get_config, list_archs
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--opt-state-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None, help="override model dtype (e.g. float32)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)

    tcfg = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.batch, steps=args.steps,
        ckpt_every=args.ckpt_every, grad_accum=args.grad_accum, seed=args.seed)
    ocfg = AdamWConfig(peak_lr=args.lr, warmup=args.warmup, total_steps=args.steps,
                       state_dtype=args.opt_state_dtype)
    trainer = Trainer(cfg, tcfg, ocfg, ckpt_dir=args.ckpt_dir, device=args.device)
    out = trainer.run()
    loss = "none (no step left to take)" if out["final_loss"] is None \
        else f"{out['final_loss']:.4f}"
    print(f"final loss: {loss}; straggler events: {len(trainer.straggler_events)}")
    return {"trainer": trainer, **out}


if __name__ == "__main__":
    main()
