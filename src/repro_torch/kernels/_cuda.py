"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Route: every source is compiled by ``nvcc`` for ``sm_90a`` into an object
file, all sources at once in parallel processes, and the objects are linked
into one shared library with a plain C interface that ``ctypes`` loads. Nothing
includes PyTorch's headers, so a build takes seconds, not minutes. The flash
kernel's TMA tensor maps come from the driver API's ``cuTensorMapEncodeTiled``,
which the C side reaches through the runtime's ``cudaGetDriverEntryPoint``, so
the link needs no ``-lcuda`` and the flags are unchanged.

The build happens at first use, never at import: the CPU tests import every
module on a machine with no ``nvcc``. It goes into ``build/kernels/<hash>/``
at the root of the checkout (listed in ``.gitignore``), where ``<hash>``
covers the sources and the flags, so a changed source builds anew and an
unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0          # wall time of this process's build (0 if loaded)


class LaunchCounter:
    """Launches of one kernel; its wrapper adds one per launch, nowhere else."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the CUDA "
            "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return its path."""
    global build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in cus:                       # one nvcc per source, all at once
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp_lib),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)         # atomic publish
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.repro_flash_attention.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
            lib.repro_flash_attention.restype = i32
            lib.repro_flash_tensor_map_us.argtypes = [ptr] * 3 + [i32] * 7
            lib.repro_flash_tensor_map_us.restype = ctypes.c_double
            lib.repro_decode_attention.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
            lib.repro_decode_attention.restype = i32
            lib.repro_decode_attention_stats.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
            lib.repro_decode_attention_stats.restype = i32
            lib.repro_paged_decode_attention.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
            lib.repro_paged_decode_attention.restype = i32
            lib.repro_mlstm.argtypes = [ptr] * 12 + [i32] * 6 + [ctypes.c_float, ptr]
            lib.repro_mlstm.restype = i32
            lib.repro_selective_scan.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
            lib.repro_selective_scan.restype = i32
            lib.repro_cuda_error_string.argtypes = [i32]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")
