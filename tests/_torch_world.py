"""Multi-process worlds for the port's mesh tests, on the CPU.

:func:`run_world` starts ``n`` Python processes that form one
``torch.distributed`` world over a ``FileStore`` under the test's
``tmp_path`` (no port is opened, so concurrent xdist workers never collide),
each running the same body with ``RANK``, ``WORLD`` and ``TMP`` bound and a
``RESULT`` dict to fill; it returns the ranks' results. :func:`run_jax`
runs a JAX snippet in a process with ``n`` host devices, as
``tests/test_distributed.py`` does. Every process has its own timeout.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import Dict, List

SRC = str(Path(__file__).resolve().parent.parent / "src")
TIMEOUT_S = 240
_WORLDS = itertools.count()

_PRELUDE = """
import json, sys
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_world
init_world(RANK, WORLD, store_path=TMP + "/store", device="cpu", log=lambda s: None)
RESULT = {}
"""

_EPILOGUE = """
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
with open(f"{TMP}/result_{RANK}.json", "w") as f:
    json.dump(RESULT, f)
"""


def _env(extra: Dict[str, str] = None) -> Dict[str, str]:
    env = dict(os.environ)
    env.update({"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
                "TF_CPP_MIN_LOG_LEVEL": "3"})
    env.update(extra or {})
    return env


def run_world(tmp_path, n: int, body: str, timeout: int = TIMEOUT_S) -> List[dict]:
    """Run ``body`` on ``n`` ranks; returns each rank's ``RESULT``. A rank
    that fails or outlives ``timeout`` fails the test (the others are
    killed)."""
    tmp = Path(tmp_path) / f"world{next(_WORLDS)}_{n}"
    tmp.mkdir(parents=True)
    script = tmp / "rank.py"
    script.write_text(_PRELUDE + textwrap.dedent(body) + _EPILOGUE)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env()) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, f"ranks failed {failed}:\n" + "\n".join(o[-4000:] for o in outs)
    return [json.loads((tmp / f"result_{r}.json").read_text()) for r in range(n)]


def run_jax(code: str, n_devices: int, timeout: int = TIMEOUT_S) -> dict:
    """Run a JAX snippet on ``n_devices`` host devices; it prints one JSON
    object as its last line, which is returned."""
    env = _env({"XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}"})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=timeout, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])
