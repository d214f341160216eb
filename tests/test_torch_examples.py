"""The port's examples (``examples/torch_*.py``) on the CPU, each run as a
user runs it: a subprocess with ``--device cpu --reduced`` and small step and
burst counts, under a timeout of its own.

* ``torch_quickstart.py``: deploy, three cold invokes with their boot-stage
  breakdown, a ``cold_jit`` invoke and the startup ratio; the cold-only
  platform holds 0 idle device bytes.
* ``torch_serve_coldstart.py``: cold against warm mode on 2 hosts with
  hedging, a host killed mid-run and still served; cold mode's idle
  byte-seconds are 0.
* ``torch_train_smoke.py``: train, "crash" at half the steps, resume there,
  promote the final weights into a ``SnapshotStore``, whose v1 snapshot the
  JAX package's ``SnapshotStore.load_host`` restores byte for byte, leaf for
  leaf, as the port's does.
* ``--device cuda`` without a card raises: nothing falls back to the CPU.

``tests/test_torch_imports.py`` holds the examples to the port's import
rules: they import nothing of ``repro`` or JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.snapshot import SnapshotStore as JaxSnapshotStore
from repro_torch import pytree
from repro_torch.core.snapshot import SnapshotStore

ROOT = Path(__file__).resolve().parents[1]
TRAIN_STEPS = 8


def _run(name, *args, timeout):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, str(ROOT / "examples" / name), *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def _ok(proc):
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_quickstart_deploys_invokes_cold_and_holds_no_idle_memory():
    lines = _ok(_run("torch_quickstart.py", "--device", "cpu", "--reduced", timeout=420))
    tokens = [line.split("=", 1)[1].strip() for line in lines if "tokens[" in line]
    assert len(tokens) == 3 and len(set(tokens)) == 1          # the same image, the same tokens
    stages = next(line for line in lines if "boot stages (ms):" in line)
    assert "device_put" in stages and "deserialize_program" in stages
    assert any("startup: unikernel=" in line and "cold_jit=" in line for line in lines)
    assert "  idle device memory held right now: 0 bytes (cold-only => 0)" in lines


def test_serve_coldstart_serves_cold_and_warm_through_a_host_kill():
    lines = _ok(_run("torch_serve_coldstart.py", "--device", "cpu", "--reduced", "--bursts",
                     "1", "--per-burst", "3", "--gap-s", "0.2", timeout=420))
    assert "=== COLD-mode platform (2 hosts) ===" in lines
    assert "=== WARM-mode platform (2 hosts) ===" in lines
    killed = [line for line in lines if "host 0 killed -> next request still served" in line]
    assert len(killed) == 2
    cold, warm = [line for line in lines if "device-memory byte-seconds" in line]
    assert cold.endswith("IDLE=0.0000 GBs") and not warm.endswith("IDLE=0.0000 GBs")
    assert [line.strip().split()[-1] for line in lines
            if line.strip().startswith("e2e")] == ["(n=4)", "(n=4)"]


def test_train_smoke_resumes_at_half_and_promotes_a_snapshot_jax_restores(tmp_path):
    lines = _ok(_run("torch_train_smoke.py", "--device", "cpu", "--reduced", "--steps",
                     str(TRAIN_STEPS), "--ckpt-dir", str(tmp_path), timeout=240))
    resumed = next(line for line in lines if line.startswith("resumed at step"))
    assert resumed.startswith(f"resumed at step {TRAIN_STEPS // 2}, final loss ")
    assert any(line.startswith("promoted final weights into serving snapshot store")
               for line in lines)
    name = "trained-llama-reduced"
    ours = dict(pytree.flatten_with_paths(SnapshotStore(tmp_path / "serving").load_host(name)))
    theirs = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(
                  JaxSnapshotStore(tmp_path / "serving").load_host(name))[0]}
    assert sorted(ours) == sorted(theirs) and ours
    for path, t in ours.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32, path
        assert theirs[path].dtype == np.float32 and theirs[path].shape == tuple(t.shape), path
        assert theirs[path].tobytes() == t.numpy().tobytes(), path


@pytest.mark.parametrize("name", ["torch_quickstart.py", "torch_serve_coldstart.py",
                                  "torch_train_smoke.py"])
def test_an_example_on_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run(name, timeout=120)                       # --device cuda, the default
    assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr
