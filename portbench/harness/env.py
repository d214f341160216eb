"""The run's surroundings: where compiles are cached, which host compiler
AOTInductor links with, when the process started, and which modules it must
not hold."""
from __future__ import annotations

import contextlib
import ctypes
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List

# Top-level module names the run may not hold once its window has closed:
# the JAX package and JAX itself. Compared whole: ``repro_torch`` is not
# ``repro``.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cache_root(root: Path) -> Path:
    """Every compile cache of a run, at fixed paths inside the checkout:
    Inductor's (the AOTInductor packages among them) and Triton's."""
    return root / "portbench" / ".cache"


def point_caches(root: Path) -> Path:
    """Set the cache directories before torch is imported; returns Inductor's.

    Also ``TORCHINDUCTOR_VEC_ISA_OK=0``: Inductor's first package load in a
    process otherwise probes the host CPU's vector ISAs by compiling and
    loading test libraries in child processes, which took 57-66 s a process
    on the card's machine. Its result only labels the package's metadata
    (a mismatch is a warning) and Inductor's code for the CPU; the served
    programs run on the GPU."""
    base = cache_root(root)
    inductor, triton = base / "inductor", base / "triton"
    for d in (inductor, triton):
        d.mkdir(parents=True, exist_ok=True)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(inductor)
    os.environ["TRITON_CACHE_DIR"] = str(triton)
    os.environ["TORCHINDUCTOR_VEC_ISA_OK"] = "0"
    return inductor


def process_start_s() -> float:
    """This process's start on ``time.CLOCK_BOOTTIME`` (seconds)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def since_process_start() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - process_start_s()


def host_compiler(work: Path) -> str:
    """Give AOTInductor a host compiler that links its OpenMP wrapper. The
    compiler Inductor picks (``CXX``) is tried first, then each ``g++`` on
    ``PATH``: on a machine whose ``CXX`` has no ``libgomp.spec`` the first
    ``g++`` that links is used. Returns a line for the log; raises if none
    links."""
    from torch._inductor import config as inductor_config
    from torch._inductor import cpp_builder

    src = work / "omp_probe.cpp"
    src.write_text("int f(int n) { int s = 0;\n#pragma omp parallel for reduction(+:s)\n"
                   "for (int i = 0; i < n; ++i) s += i; return s; }\n")
    chosen = cpp_builder.get_cpp_compiler()
    path_gxx = [str(Path(d) / "g++") for d in os.environ.get("PATH", "").split(os.pathsep)
                if d and (Path(d) / "g++").is_file()]
    tried = []
    for cxx in dict.fromkeys([chosen] + path_gxx):
        r = subprocess.run([cxx, "-shared", "-fPIC", "-fopenmp", str(src), "-o",
                            str(work / "omp_probe.so"), "-lgomp"], capture_output=True,
                           text=True)
        tried.append(f"{cxx}: {'links' if r.returncode == 0 else r.stderr.strip()[:120]}")
        if r.returncode == 0:
            inductor_config.cpp.cxx = (None, cxx)
            os.environ["CXX"] = cxx
            return f"host compiler {cxx}"
    raise RuntimeError("no host compiler links an OpenMP shared object: " + "; ".join(tried))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


PR_SET_CHILD_SUBREAPER = 36


def become_subreaper() -> None:
    """Adopt every orphan of the processes this one starts, so that
    ``reap`` finds them."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def _descendants(pid: int) -> set:
    seen, todo = set(), [pid]
    while todo:
        for path in Path(f"/proc/{todo.pop()}/task").glob("*/children"):
            with contextlib.suppress(OSError):
                for child in map(int, path.read_text().split()):
                    if child not in seen:
                        seen.add(child)
                        todo.append(child)
    return seen


def reap(wait_s: float = 10.0) -> int:
    """Shut Inductor's compile workers down, then kill every process this
    one started that is still there and wait for each to end; returns how
    many were left."""
    workers = sys.modules.get("torch._inductor.async_compile")
    if workers is not None and hasattr(workers, "shutdown_compile_workers"):
        with contextlib.suppress(Exception):
            workers.shutdown_compile_workers()
    left = _descendants(os.getpid())
    deadline = time.monotonic() + wait_s
    while True:
        alive = _descendants(os.getpid())
        for pid in alive:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, signal.SIGKILL)
        while True:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
        if not alive or time.monotonic() > deadline:
            return len(left)
        time.sleep(0.05)
