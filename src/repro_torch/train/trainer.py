"""Fault-tolerant training loop (port of ``repro.train.trainer``):
checkpoint/restart, elastic re-mesh, straggler log.

Restart contract: state = (params, opt_state, step); the data pipeline is a
pure function of step, so a resumed run takes the same batches as an
uninterrupted one. Elastic contract: the checkpoint is layout-free host
numpy in the snapshot format (readable by either package), so a run can
resume on a different mesh: restore lays the tree out with the new mesh's
placements.

On a mesh (``mesh``, ``rules``: one process per rank of an initialised
``torch.distributed`` world) every rank draws the weights from the seed and
rank 0's are laid out (``distribute_tree``), so they equal the
single-device run's; each step shards the batch over the batch axes and
runs under ``use_rules``; rank 0 logs and writes checkpoints.

Straggler detection is accounting: each step's wall time against a robust
EWMA envelope (the first step after ``start`` is ignored), recorded in
``Trainer.straggler_events`` and the log.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.dist.sharding import (
    Rules, distribute_tree, is_dtensor, param_shardings, placements, use_rules,
)
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
                 mesh=None, rules: Optional[Rules] = None,
                 log: Callable[[str], None] = print, device="cuda") -> None:
        if (mesh is None) != (rules is None):
            raise ValueError("a mesh and its sharding rules come together")
        self.cfg = arch_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.rules = rules
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.rank = mesh.get_rank() if mesh is not None else 0
        self.log = log if self.rank == 0 else (lambda _msg: None)
        self.model = build_model(arch_cfg, max_seq=tcfg.seq_len)
        self.opt = AdamW(opt_cfg or AdamWConfig(total_steps=tcfg.steps))
        self.data = SyntheticTokenPipeline(
            vocab_size=arch_cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=tcfg.ckpt_keep, write=self.rank == 0)
                     if ckpt_dir else None)
        self.history: List[Dict] = []
        self.straggler_events: List[Dict] = []
        self._build_step()

    # ------------------------------------------------------------------- build
    def _build_step(self) -> None:
        if self.mesh is None:
            self._step = make_train_step(self.model, self.opt, grad_accum=self.tcfg.grad_accum)
            self._param_sh = self._opt_sh = None
            return
        specs = self.model.param_specs()
        self._param_sh = param_shardings(specs, self.rules, self.mesh)
        self._opt_sh = param_shardings(self.opt.state_specs(specs), self.rules, self.mesh)
        raw_step = make_train_step(self.model, self.opt, grad_accum=self.tcfg.grad_accum,
                                   place_batch=self._place_batch)

        def sharded_step(params, opt_state, batch):
            with use_rules(self.rules, self.mesh):
                return raw_step(params, opt_state, batch)

        self._step = sharded_step

    def _place_batch(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """A (micro-)batch that every rank holds whole, sharded over the batch
        axes: each rank keeps its own rows, nothing crosses ranks."""
        from torch.distributed.tensor import distribute_tensor

        def put(x):
            pl = placements(self.rules, self.mesh, ("batch",) + (None,) * (x.dim() - 1),
                            x.shape)
            return distribute_tensor(x, self.mesh, list(pl), src_data_rank=None)

        return {k: put(v) for k, v in batch.items()}

    def _lay_out(self, tree, shardings, src_rank=0):
        """``tree`` laid out on the mesh (rank ``src_rank``'s values; None:
        each rank's own), leaf by leaf from wherever it is; the whole copies
        are then freed, on the card too."""
        tree = distribute_tree(tree, shardings, self.mesh, device=self.device,
                               src_rank=src_rank)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return tree

    # -------------------------------------------------------------------- init
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen)
        if self.mesh is None:
            return params, self.opt.init(params)
        params = self._lay_out(params, self._param_sh)   # moments made beside the shards
        return params, self._lay_out(self.opt.init(params), self._opt_sh)

    def resume_or_init(self):
        if self.ckpt is not None:
            # on a mesh, restored to host memory and laid out leaf by leaf
            restored, step = self.ckpt.restore_latest_or_none(
                device=self.device if self.mesh is None else None)
            if restored is not None:
                params, opt_state = restored["params"], restored["opt_state"]
                if self.mesh is not None:          # elastic re-mesh on restore
                    # every rank read the same file: each keeps its own slice
                    params = self._lay_out(params, self._param_sh, src_rank=None)
                    opt_state = self._lay_out(opt_state, self._opt_sh, src_rank=None)
                self.log(f"[trainer] resumed from step {step}")
                return params, opt_state, int(step)
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
            loss_t = metrics["loss"]
            loss = float(loss_t.full_tensor() if is_dtensor(loss_t) else loss_t)
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
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()                   # rank 0's last checkpoint is on disk
        return {"params": params, "opt_state": opt_state,
                "final_loss": self.history[-1]["loss"] if self.history else None}
