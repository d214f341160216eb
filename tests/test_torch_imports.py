"""The port stands alone: no JAX, no ml_dtypes, nothing of the JAX package;
it imports with no nvcc and no card; a CUDA call never falls back to the plain
version, and a CPU call never needs the kernels."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _cuda, ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_sources_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"ops.py", "deploy.py", "boot.py", "chip_smoke.py"} <= names


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    code = ("import sys; import repro_torch.kernels.ops, repro_torch.core.drivers; "
            "from repro_torch.kernels import _cuda; "
            "assert _cuda._lib is None; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'repro')], 'JAX loaded'; print('ok')")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_routing_is_by_device_with_no_capability_fallback():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.get_impl() == "auto"
    assert ops.use_kernel(cpu) is False
    assert ops.use_kernel(cuda) is True
    with ops.impl_scope("plain"):
        assert ops.use_kernel(cuda) is False
    with ops.impl_scope("kernel"):
        assert ops.use_kernel(cuda) is True
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.use_kernel(cpu)
    assert ops.get_impl() == "auto"
    with pytest.raises(ValueError):
        ops.set_impl("ref")


def test_kernel_impl_on_cpu_tensors_raises():
    q = torch.zeros(1, 4, 2, 32)
    with ops.impl_scope("kernel"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.attention(q, q[:, :, :1], q[:, :, :1])


def test_kernel_wrappers_refuse_non_cuda_tensors():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention(q[:, 0], q, q, 4)
    assert fa.LAUNCHES.count == 0 and da.LAUNCHES.count == 0


def test_cuda_call_without_a_toolkit_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """Where the kernels cannot be built the launch path raises; the plain
    version is never substituted."""
    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library()
    assert _cuda._lib is None


def test_source_hash_covers_every_kernel_source():
    h = _cuda.source_hash()
    assert len(h) == 16
    names = {p.name for p in _cuda.CSRC.iterdir()}
    assert {"flash_attention.cu", "decode_attention.cu", "common.cuh"} <= names
