"""Fault-tolerant training loop on one device (port of ``repro.train.trainer``):
checkpoint/restart and the straggler log.

Restart contract: state = (params, opt_state, step); the data pipeline is a
pure function of step, so a resumed run takes the same batches as an
uninterrupted one. The checkpoint is host numpy in the snapshot format,
readable by either package.

Straggler detection is accounting: each step's wall time against a robust
EWMA envelope (the first step after ``start`` is ignored), recorded in
``Trainer.straggler_events`` and the log.

The JAX trainer also shards a run over a device mesh (``mesh``, ``rules``);
the port's multi-device layer is not written yet (ROADMAP A10b), so a mesh
is refused, never ignored.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    steps: int = 100
    ckpt_every: int = 25
    ckpt_keep: int = 3
    ckpt_async: bool = True
    grad_accum: int = 1
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0     # step slower than factor x EWMA => event


class Trainer:
    def __init__(self, arch_cfg: ArchConfig, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 ckpt_dir: Optional[str] = None,
                 mesh=None, rules=None,
                 log: Callable[[str], None] = print, device="cuda") -> None:
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "the port trains on one device: a mesh and sharding rules need its "
                "multi-device layer, which is not ported yet (ROADMAP A10b)")
        self.cfg = arch_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.log = log
        self.model = build_model(arch_cfg, max_seq=tcfg.seq_len)
        self.opt = AdamW(opt_cfg or AdamWConfig(total_steps=tcfg.steps))
        self.data = SyntheticTokenPipeline(
            vocab_size=arch_cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.ckpt = CheckpointManager(ckpt_dir, keep=tcfg.ckpt_keep) if ckpt_dir else None
        self.history: List[Dict] = []
        self.straggler_events: List[Dict] = []
        self._step = make_train_step(self.model, self.opt, grad_accum=tcfg.grad_accum)

    # -------------------------------------------------------------------- init
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen)
        return params, self.opt.init(params)

    def resume_or_init(self):
        if self.ckpt is not None:
            restored, step = self.ckpt.restore_latest_or_none(device=self.device)
            if restored is not None:
                self.log(f"[trainer] resumed from step {step}")
                return restored["params"], restored["opt_state"], int(step)
        return (*self.init_state(), 0)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_dict(step).items()}

    # --------------------------------------------------------------------- run
    def run(self, steps: Optional[int] = None) -> Dict:
        steps = steps or self.tcfg.steps
        params, opt_state, start = self.resume_or_init()
        ewma: Optional[float] = None
        for step in range(start, steps):
            batch = self._batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            # straggler envelope (ignore the first-step outlier at `start`)
            if step > start + 1:
                if ewma is not None and dt > self.tcfg.straggler_factor * ewma:
                    self.straggler_events.append({"step": step, "dt": dt, "ewma": ewma})
                    self.log(f"[trainer] straggler step {step}: {dt*1e3:.0f}ms "
                             f"vs envelope {ewma*1e3:.0f}ms")
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step:5d} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            if self.ckpt is not None and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1,
                               {"params": params, "opt_state": opt_state},
                               blocking=not self.tcfg.ckpt_async)
        if self.ckpt is not None:
            self.ckpt.wait()
            self.ckpt.save(steps, {"params": params, "opt_state": opt_state},
                           blocking=True)
        return {"params": params, "opt_state": opt_state,
                "final_loss": self.history[-1]["loss"] if self.history else None}
