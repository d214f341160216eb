"""The port stands alone: no JAX, no ml_dtypes, nothing of the JAX package;
it imports with no nvcc and no card; a CUDA call never falls back to the plain
version, and a CPU call never needs the kernels."""
import ast
import importlib.util
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
    assert {"ops.py", "deploy.py", "boot.py", "chip_smoke.py", "decode.py", "paging.py",
            "cluster.py", "scheduler.py", "resilience.py",
            "paged_decode_attention.py", "mlstm.py", "ssm.py", "xlstm_1_3b.py",
            "selective_scan.py", "moe.py", "jamba_1_5_large_398b.py"} <= names


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    code = ("import sys; import repro_torch.kernels.ops, repro_torch.core.drivers, "
            "repro_torch.core.decode, repro_torch.core.cluster; "
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
    pages, table = torch.zeros(3, 4, 1, 32), torch.zeros(1, 2, dtype=torch.int32)
    # x, dt [1,4,2]; a_log [2,32]; b, c [1,4,32]; d_skip [2]
    scan = (q[..., 0], q[..., 0], q[0, 0], q[:, :, 0], q[:, :, 0], q[0, 0, :, 0])
    with ops.impl_scope("kernel"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.attention(q, q[:, :, :1], q[:, :, :1])
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.decode_attention(q[:, 0], q[:, :, :1], q[:, :, :1], 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.paged_decode_attention(q[:, 0], pages, pages, table, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.mlstm(q, q, q, q[..., 0], q[..., 0])
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.selective_scan(*scan)
    # and on the CPU, "auto" and "plain" take the plain versions of all five ops
    for impl in ("auto", "plain"):
        with ops.impl_scope(impl):
            assert ops.paged_decode_attention(q[:, 0], pages, pages, table, 2).shape == (1, 2, 32)
            assert ops.mlstm(q, q, q, q[..., 0], q[..., 0])[0].shape == (1, 4, 2, 32)
            y, h = ops.selective_scan(*scan)
            assert y.shape == (1, 4, 2) and h.shape == (1, 2, 32)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as mk
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import selective_scan as ss
    q = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention(q[:, 0], q, q, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pda.paged_decode_attention(q[:, 0], q, q, torch.zeros(1, 1, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.mlstm(q, q, q, q[..., 0], q[..., 0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.selective_scan(q[..., 0], q[..., 0], q[0, 0], q[:, :, 0], q[:, :, 0],
                          q[0, 0, :, 0])
    assert fa.LAUNCHES.count == 0 and da.LAUNCHES.count == 0 and pda.LAUNCHES.count == 0
    assert mk.LAUNCHES.count == 0 and ss.LAUNCHES.count == 0
    assert set(ops.launch_counts()) == {"flash_attention", "decode_attention",
                                        "paged_decode_attention", "mlstm",
                                        "selective_scan"}


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
    assert {"flash_attention.cu", "decode_attention.cu", "paged_decode_attention.cu",
            "mlstm.cu", "selective_scan.cu", "decode_sweep.cuh", "common.cuh",
            "hopper.cuh"} <= names


def test_chip_smoke_logs_the_ptxas_lines_of_the_redesigned_kernels(tmp_path):
    """chip_smoke.py prints the registers, shared memory and spills that
    ptxas reports for the redesigned kernels (flash_attention.cu, mlstm.cu,
    decode_attention.cu, paged_decode_attention.cu), and only for them."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    (tmp_path / "build.log").write_text(
        "== decode_attention.cu (rc 0)\n"
        "ptxas info    : Compiling entry function 'dec' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n"
        "== flash_attention.cu (rc 0)\n"
        "ptxas info    : Compiling entry function 'fa' for 'sm_90a'\n"
        "ptxas info    : Function properties for fa\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 167 registers, used 1 barriers\n"
        "ptxas info    : Compile time = 76.058 ms\n"
        "== mlstm.cu (rc 0)\n"
        "ptxas info    : Used 231 registers, used 1 barriers\n"
        "== selective_scan.cu (rc 0)\n"
        "ptxas info    : Used 64 registers\n"
        "== paged_decode_attention.cu (rc 0)\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 34816 bytes smem\n")
    lines = chip_smoke.ptxas_lines(tmp_path / "librepro_kernels.so")
    assert lines == ["== decode_attention.cu (rc 0)",
                     "ptxas info    : Compiling entry function 'dec' for 'sm_90a'",
                     "ptxas info    : Used 40 registers",
                     "== flash_attention.cu (rc 0)",
                     "ptxas info    : Compiling entry function 'fa' for 'sm_90a'",
                     "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                     "ptxas info    : Used 167 registers, used 1 barriers",
                     "== mlstm.cu (rc 0)",
                     "ptxas info    : Used 231 registers, used 1 barriers",
                     "== paged_decode_attention.cu (rc 0)",
                     "ptxas info    : Used 80 registers, used 1 barriers, 34816 bytes smem"]
    assert chip_smoke.ptxas_lines(tmp_path / "missing" / "lib.so") == [
        "no build.log beside the library"]
