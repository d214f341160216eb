"""Atomic, async-capable, retention-managed checkpointing (port of
``repro.checkpoint.checkpoint``).

Built on the port's snapshot store (v1: one ``.npy`` per leaf and a JSON
index, tmp-dir + rename): a training checkpoint IS a deployable weight
snapshot, and a checkpoint written by either package restores in the other
byte for byte (bf16 leaves as uint16 views, int8 moments, the 0-d int32
step).

Fault-tolerance contract:
  * save is all-or-nothing (a save that fails never corrupts the latest
    checkpoint);
  * restore returns the newest complete step;
  * ``save`` copies the tree to host memory before it returns (a
    point-in-time copy, as ``jax.device_get`` gives), and async mode writes
    it in a background thread, overlapping I/O with the next train steps; at
    most one save is in flight, and ``wait`` re-raises a failed one;
  * retention keeps the last ``keep`` checkpoints.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch import pytree
from repro_torch.core.snapshot import SnapshotStore


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.store = SnapshotStore(self.dir)
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        # one record per written checkpoint: step, bytes, the host copy's
        # seconds (on the caller's thread) and the write's
        self.saves: List[Dict[str, float]] = []

    # ------------------------------------------------------------------- names
    @staticmethod
    def _name(step: int) -> str:
        return f"step_{step:010d}"

    def steps(self) -> List[int]:
        out = []
        for d in self.dir.iterdir():
            if d.name.startswith("step_") and self.store.has(d.name):
                try:
                    out.append(int(d.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -------------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Copy ``tree`` (tensors on any device) to host memory now, then
        write it as checkpoint ``step``: here, or in a thread when not
        ``blocking``."""
        self.wait()                           # at most one save in flight
        t0 = time.perf_counter()
        host = pytree.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        copy_s = time.perf_counter() - t0

        def _write():
            t1 = time.perf_counter()
            nbytes = self.store.save(self._name(step), host)
            self.saves.append({"step": step, "bytes": nbytes, "copy_s": copy_s,
                               "write_s": time.perf_counter() - t1})
            self._prune()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as e:           # re-raised by wait()
                self._async_error = e

        t = threading.Thread(target=_run, daemon=True)
        with self._lock:
            self._async_thread = t
        t.start()

    def wait(self) -> None:
        """Block until the save in flight (if any) is written; re-raise its
        error."""
        with self._lock:
            t = self._async_thread
        if t is not None:
            t.join()
        with self._lock:
            err, self._async_error = self._async_error, None
            if self._async_thread is t:
                self._async_thread = None
        if err is not None:
            raise err

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            self.store.evict(self._name(s))

    # ----------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, device=None) -> Any:
        """The checkpoint tree: host tensors (copies, independent of the
        files), or on ``device``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        tree = self.store.load_host(self._name(step))
        target = torch.device(device) if device is not None else torch.device("cpu")
        return pytree.tree_map(lambda t: t.to(target, copy=True), tree)

    def restore_latest_or_none(self, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, device), step
