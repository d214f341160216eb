"""Persistent program store — the "image registry" of unikernel executors.

Port of ``repro.core.compile_cache``. Every program of the image (the
fused serve program, its head/tail split, the coalescer's bucket programs,
the decode bundle's admit and step programs) is compiled ahead of time at
deploy with AOTInductor into a ``.pt2`` package (:func:`compile_package`),
as the JAX package ships an executable compiled by
``jax.jit(...).lower(...).compile()``: shape-specialised, weight-free (the
parameters are an input, as in ``serve(params, tokens)``), and loaded at
boot with ``aoti_load_package`` into compiled code, with no trace and no
compile. The hand-written kernels stay opaque calls of the
``repro_torch::*`` custom ops inside the packages; Inductor generates code
for the glue around them only.

Every stored payload starts with a tag line naming its format (:data:`AOTI`,
the only one), and ``deserialize_program`` loads by the tag; a payload
without one, or with another format's, is refused.

Layout on disk (content-addressed by FunctionSpec.cache_key):

    <root>/<key>/program.bin     tag line + the .pt2 package
    <root>/<key>/manifest.json   ImageManifest

Compiled-package cache: :func:`compile_package` keeps each package it builds
under ``<Inductor cache dir>/repro_torch_aoti/<hash>.pt2``, keyed by the
exported graph (code, every node's shapes, dtypes, strides and devices), the
Inductor options, the torch and Triton versions and the device, and reads it
back on a later compile of the same graph. Inductor's own FX-graph cache
refuses AOT compiles (``compile_fx`` skips it in AOT mode), so this is the
cache a re-trace-and-compile boot (``cold_jit_cached``) hits. It follows
Inductor's settings: on by default, off when ``fx_graph_cache`` is off or
``force_disable_caches`` is on (the ``cold_jit`` driver). Its lookups count
in ``torch._dynamo.utils.counters["repro_torch"]`` (``aoti_package_cache_hit``
/ ``_miss`` / ``_disabled``).

Invariants: ``put_package`` publishes atomically (a
concurrent reader sees the old blob or the new one, never a torn write);
payload bytes are immutable once published under a key (the host program
tier and peer transfers hand the same bytes on). The custom ops the programs
call (``repro_torch::*``) are registered by importing
``repro_torch.kernels.ops``, which this module does, before any load.
"""
from __future__ import annotations

import contextlib
import fcntl
import hashlib
import io
import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.artifact import ImageManifest
from repro_torch.kernels import ops  # noqa: F401  (registers the custom ops)

# Derived keys of the sub-programs published beside the fused program ('#'
# never appears in a FunctionSpec.cache_key): the streamed boot's
# head (prefill + first token) and tail (the decode loop), and the
# continuous-batching decode bundle's admit and step programs.
HEAD_SUFFIX = "#head"
TAIL_SUFFIX = "#tail"
DECODE_ADMIT_SUFFIX = "#decode_admit"
DECODE_STEP_SUFFIX = "#decode_step"


def head_key(key: str) -> str:
    return key + HEAD_SUFFIX


def tail_key(key: str) -> str:
    return key + TAIL_SUFFIX


def decode_admit_key(key: str) -> str:
    return key + DECODE_ADMIT_SUFFIX


def decode_step_key(key: str) -> str:
    return key + DECODE_STEP_SUFFIX


# The payload format, named by the tag line each stored payload starts with.
AOTI = "aoti"                       # an AOTInductor .pt2 package
_TAG = b"repro_torch program "

# Inductor options of every AOT compile: keep eager's roundings of
# low-precision intermediates, so the compiled program's greedy tokens can
# equal the eager program's (deploy's gate).
AOTI_OPTIONS = {"emulate_precision_casts": True}


def compile_options() -> dict:
    """The Inductor options an AOT compile runs under: ``AOTI_OPTIONS``, and a
    fresh ``aot_inductor.metadata``. AOTInductor fills that dict in place with
    the device it compiled for; left to the global one, the first compile in a
    process would change the configuration hash of every later one, and a
    trace of the same program would miss the package deploy compiled."""
    return {**AOTI_OPTIONS, "aot_inductor.metadata": {}}


def _tagged(fmt: str, body: bytes) -> bytes:
    return _TAG + fmt.encode() + b"\n" + body


def payload_format(payload: bytes) -> Tuple[str, int]:
    """(format, length of the tag line) of a stored program payload; raises
    on a payload with no tag or an unknown format."""
    head = bytes(payload[:64])
    end = head.find(b"\n")
    if not head.startswith(_TAG) or end < 0:
        raise ValueError("program payload has no format tag")
    fmt = head[len(_TAG):end].decode()
    if fmt != AOTI:
        raise ValueError(f"unknown program format {fmt!r}")
    return fmt, end + 1


def package_op_calls(payload: bytes) -> List[str]:
    """The custom-op calls an AOTI payload's compiled code makes, in program
    order (``repro_torch::flash_attention``, ...): the ops AOTInductor left
    as opaque calls, as its package lists them for its op dispatcher."""
    fmt, n = payload_format(payload)
    if fmt != AOTI:
        raise ValueError(f"not an AOTI package: {fmt}")
    calls: List[str] = []
    with zipfile.ZipFile(io.BytesIO(memoryview(payload)[n:])) as z:
        for name in z.namelist():
            if name.endswith(".wrapper.json"):
                calls += [e["node"]["target"] for e in json.loads(z.read(name))["nodes"]]
    return calls


def _val_str(val) -> str:
    if isinstance(val, torch.Tensor):
        return f"T{tuple(val.shape)}{tuple(val.stride())}{val.dtype}{val.device}"
    if isinstance(val, (list, tuple)):
        return "(" + ",".join(_val_str(v) for v in val) + ")"
    return repr(val)


def _device_id(device: torch.device) -> str:
    if device.type == "cuda":
        import triton
        major, minor = torch.cuda.get_device_capability(device)
        return (f"cuda {torch.cuda.get_device_name(device)} sm_{major}{minor} "
                f"CUDA {torch.version.cuda} triton {triton.__version__}")
    return f"{device.type} {torch.backends.cpu.get_cpu_capability()}"


def package_key_parts(exported: torch.export.ExportedProgram) -> Dict[str, str]:
    """What :func:`package_key` hashes, by part: the torch version, the hash of
    the Inductor configuration in force (call under the compile's options),
    the graph's code, its input and output specs, every node's value metadata
    (shapes, strides, dtypes, devices; one line per node) and each device the
    graph touches. Two traces that should share a package and do not differ
    in at least one part."""
    from torch._inductor import config as inductor_config
    devices = set()
    nodes = []
    for node in exported.graph.nodes:
        val = node.meta.get("val")
        nodes.append(f"{node.name} {_val_str(val)}")
        for v in val if isinstance(val, (list, tuple)) else (val,):
            if isinstance(v, torch.Tensor):
                devices.add(v.device)
    return {"torch": torch.__version__, "config": inductor_config.get_hash().hex(),
            "code": exported.graph_module.code, "in_spec": str(exported.call_spec.in_spec),
            "out_spec": str(exported.call_spec.out_spec), "nodes": "\n".join(nodes),
            "devices": "\n".join(sorted(_device_id(d) for d in devices))}


def package_key(exported: torch.export.ExportedProgram) -> str:
    """Key of ``exported``'s package in the compiled-package cache: the hash of
    its :func:`package_key_parts`."""
    h = hashlib.sha256()
    for name, part in package_key_parts(exported).items():
        h.update(f"{name}\0{part}\0".encode())
    return h.hexdigest()


def aoti_package_key_parts(exported: torch.export.ExportedProgram) -> Dict[str, str]:
    """:func:`package_key_parts` under the options :func:`compile_package`
    compiles with (:func:`compile_options`), each part as its SHA-256: what
    deploy records in the manifest, so a later trace can be held against the
    one deploy compiled."""
    from torch._inductor import config as inductor_config
    with inductor_config.patch(compile_options()):
        parts = package_key_parts(exported)
    return {k: hashlib.sha256(v.encode()).hexdigest() for k, v in parts.items()}


def package_cache_dir() -> Path:
    """Where the compiled-package cache lives: under Inductor's cache
    directory (``TORCHINDUCTOR_CACHE_DIR``, which
    :func:`enable_inductor_disk_cache` sets)."""
    from torch._inductor.runtime.cache_dir_utils import cache_dir
    return Path(cache_dir()) / "repro_torch_aoti"


class LockWaits:
    """How long callers waited to take a lock: calls, seconds in all, the
    longest wait."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.calls, self.total_s, self.max_s = 0, 0.0, 0.0

    def add(self, wait_s: float) -> None:
        with self._lock:
            self.calls += 1
            self.total_s += wait_s
            self.max_s = max(self.max_s, wait_s)

    def summary(self) -> dict:
        with self._lock:
            return {"calls": self.calls, "total_s": self.total_s, "max_s": self.max_s}


_COMPILE_LOCK = threading.RLock()
_COMPILE_DEPTH = threading.local()
COMPILE_WAITS = LockWaits()     # builds waiting for another build of the process
PROGRAM_WAITS = LockWaits()     # calls of a loaded package waiting for another call


@contextlib.contextmanager
def build_slot():
    """Hold the process's one program build: a trace and compile run alone.
    Inductor's options, which each compile patches, its cache directory and
    the metadata AOTInductor fills in are process-wide, and ``torch.export``
    patches process-wide state while it traces, so two builds at once would
    read each other's settings. The wait of the outermost hold counts in
    :data:`COMPILE_WAITS`."""
    t0 = time.perf_counter()
    with _COMPILE_LOCK:
        depth = getattr(_COMPILE_DEPTH, "n", 0)
        if depth == 0:
            COMPILE_WAITS.add(time.perf_counter() - t0)
        _COMPILE_DEPTH.n = depth + 1
        try:
            yield
        finally:
            _COMPILE_DEPTH.n = depth


def compile_package(exported: torch.export.ExportedProgram,
                    disable_caches: bool = False) -> bytes:
    """Compile ``exported`` (with its example inputs: real tensors, or fakes
    of the same shapes) ahead of time with AOTInductor for the device its
    graph runs on; returns the ``.pt2`` package's bytes.

    Through the compiled-package cache unless Inductor's caches are off. With
    ``disable_caches`` every cache is off for this compile: this cache, and
    Inductor's and Triton's, which compile into a fresh temporary directory
    (``force_disable_caches``), so nothing an earlier compile left is read.
    Compiles run one at a time in a process (:func:`build_slot`): a second
    boot that compiles waits for the first. One process at a time compiles a
    given key (a file lock beside the entry: the others wait, then read it).
    A failure to compile raises; there is no other route.
    """
    from torch._inductor import config as inductor_config
    from torch._inductor.utils import fresh_cache
    stats = counters()
    with build_slot(), inductor_config.patch(compile_options()):
        if disable_caches:
            stats["aoti_package_cache_disabled"] += 1
            with inductor_config.patch(force_disable_caches=True), fresh_cache():
                return _aoti_compile(exported)
        if inductor_config.force_disable_caches or not inductor_config.fx_graph_cache:
            stats["aoti_package_cache_disabled"] += 1
            return _aoti_compile(exported)
        path = package_cache_dir() / f"{package_key(exported)}.pt2"
        path.parent.mkdir(parents=True, exist_ok=True)
        # one process compiles a key at a time; the others wait, then read it
        with open(path.with_suffix(".lock"), "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists():
                stats["aoti_package_cache_hit"] += 1
                return path.read_bytes()
            stats["aoti_package_cache_miss"] += 1
            package = _aoti_compile(exported)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_bytes(package)
            os.replace(tmp, path)                      # atomic publish
            return package


def _aoti_compile(exported: torch.export.ExportedProgram) -> bytes:
    import torch._inductor
    buf = io.BytesIO()
    torch._inductor.aoti_compile_and_package(exported, package_path=buf)
    return buf.getvalue()


def counters():
    """This module's counters of compiled-package cache lookups (a view of
    ``torch._dynamo.utils.counters["repro_torch"]``)."""
    from torch._dynamo.utils import counters as dynamo_counters
    return dynamo_counters["repro_torch"]


def slim(exported: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """Drop from an exported program what a boot would only pay to load:
    the example inputs (the weights themselves: 6.4 GB at full width), the
    per-node debug metadata (stack traces, module stacks) and the dtype
    assertions ``torch.export`` records beside every ``.to()``. The graph's
    computation is unchanged. Returns ``exported``, edited in place."""
    exported.example_inputs = None
    graph = exported.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and \
                node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            continue
        for key in [k for k in node.meta if k not in ("val", "tensor_meta")]:
            del node.meta[key]
    exported.graph_module.recompile()
    return exported


class CompiledProgram:
    """A loaded AOTInductor package, run by one caller at a time.

    Executors on one host share the loaded program (the host program tier).
    The package's runner makes a second caller wait inside C++ with the GIL
    held, while the first caller's ``repro_torch::*`` custom ops, which are
    Python, need the GIL to go on: two concurrent calls deadlock. A Python
    lock, which waits without the GIL, orders the calls instead; the waits
    count in :data:`PROGRAM_WAITS`.
    """

    def __init__(self, model: Callable) -> None:
        self._model = model
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        with self._lock:
            PROGRAM_WAITS.add(time.perf_counter() - t0)
            return self._model(*args, **kwargs)


class CompileCache:
    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ paths
    def _dir(self, key: str) -> Path:
        return self.root / key

    def program_path(self, key: str) -> Path:
        return self._dir(key) / "program.bin"

    def manifest_path(self, key: str) -> Path:
        return self._dir(key) / "manifest.json"

    # -------------------------------------------------------------------- api
    def has(self, key: str) -> bool:
        return self.program_path(key).exists()

    def _publish(self, key: str, payload: bytes) -> int:
        d = self._dir(key)
        d.mkdir(parents=True, exist_ok=True)
        tmp = self.program_path(key).with_suffix(".tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, self.program_path(key))        # atomic publish
        return len(payload)

    def put_package(self, key: str, package: bytes) -> int:
        """Store an AOTInductor package (:func:`compile_package`'s bytes);
        returns the stored size in bytes."""
        return self._publish(key, _tagged(AOTI, package))

    def program_format(self, key: str) -> str:
        """The stored program's format (:data:`AOTI`)."""
        with open(self.program_path(key), "rb") as f:
            return payload_format(f.read(64))[0]

    def read_program_bytes(self, key: str) -> bytes:
        """Fetch the serialized payload only (the boot pipeline's FetchProgram)."""
        return self.program_path(key).read_bytes()

    @staticmethod
    def deserialize_program(payload: bytes) -> Callable:
        """Payload -> runnable program (the boot pipeline's
        DeserializeProgram): an AOTI package loads into its compiled code;
        a payload with no format tag, or another format's, raises."""
        _, n = payload_format(payload)
        return CompileCache.load_package(memoryview(payload)[n:])

    @staticmethod
    def load_package(package) -> Callable:
        """AOTI package bytes (untagged) -> its compiled program."""
        import torch._inductor
        return CompiledProgram(torch._inductor.aoti_load_package(io.BytesIO(package)))

    def load_program(self, key: str) -> Callable:
        """Deserialize into a callable program — the unikernel 'boot'."""
        return self.deserialize_program(self.read_program_bytes(key))

    def put_manifest(self, key: str, manifest: ImageManifest) -> None:
        self.manifest_path(key).write_text(manifest.to_json())

    def load_manifest(self, key: str) -> ImageManifest:
        return ImageManifest.from_json(self.manifest_path(key).read_text())

    def evict(self, key: str) -> None:
        shutil.rmtree(self._dir(key), ignore_errors=True)


_DISK_CACHE_ENV = ("TORCHINDUCTOR_CACHE_DIR", "TORCHINDUCTOR_FX_GRAPH_CACHE",
                   "TORCHINDUCTOR_AUTOGRAD_CACHE")
_saved_env: dict = {}


def enable_inductor_disk_cache(path: str | Path) -> None:
    """Point PyTorch's persistent compile caches at ``path`` (the gVisor-tier
    cold path, the counterpart of the JAX package's XLA disk cache): the
    compiled-package cache of :func:`compile_package` (``<path>/
    repro_torch_aoti``), and Inductor's own caches (FX graphs, generated
    code, Triton kernels), for every compile in this process from now on.

    The ``cold_jit_cached`` driver's ``TraceCompile`` re-traces and compiles
    through it: a boot reads back the package of the same trace that deploy
    (whose compiles go through it too) or an earlier boot compiled, and skips
    the compile; the first boot of a shape nobody compiled fills it. The
    ``cold_jit`` driver compiles with every cache off, whatever this sets.
    Undo with :func:`disable_inductor_disk_cache`.
    """
    Path(path).mkdir(parents=True, exist_ok=True)
    for name in _DISK_CACHE_ENV:
        _saved_env.setdefault(name, os.environ.get(name))
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(path)
    os.environ["TORCHINDUCTOR_FX_GRAPH_CACHE"] = "1"
    os.environ["TORCHINDUCTOR_AUTOGRAD_CACHE"] = "1"


def disable_inductor_disk_cache() -> None:
    """Restore the compile-cache settings from before
    :func:`enable_inductor_disk_cache`."""
    for name, value in _saved_env.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    _saved_env.clear()

