"""Persistent program store — the "image registry" of unikernel executors.

Port of ``repro.core.compile_cache``. The stored program is a ``torch.export``
``ExportedProgram`` of the serve program, traced once at deploy time:
shape-specialised, weight-free (the parameters are an input, as in
``serve(params, tokens)``), and loaded at boot without re-tracing user code.
It is the closest counterpart of the JAX package's serialized AOT executable.
Compiling it ahead of time with AOTInductor is later work.

Layout on disk (content-addressed by FunctionSpec.cache_key):

    <root>/<key>/program.bin     torch.export.save(ExportedProgram)
    <root>/<key>/manifest.json   ImageManifest

Invariants: ``put_program`` publishes atomically (a concurrent reader sees the
old blob or the new one, never a torn write); payload bytes are immutable
once published under a key. The custom ops the program calls
(``repro_torch::*``) are registered by importing ``repro_torch.kernels.ops``,
which this module does, before any load.
"""
from __future__ import annotations

import contextlib
import io
import os
import threading
import typing
from pathlib import Path
from typing import Callable

import torch

from repro_torch.core.artifact import ImageManifest
from repro_torch.kernels import ops  # noqa: F401  (registers the custom ops)

# Derived keys of the sub-programs later slices publish beside the fused
# program ('#' never appears in a FunctionSpec.cache_key): the streamed boot's
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


_HINTS_LOCK = threading.Lock()


@contextlib.contextmanager
def _memoized_type_hints():
    """``torch.export.load`` decodes the program's JSON into dataclasses and
    calls ``typing.get_type_hints`` once per decoded object — tens of
    thousands of identical calls for an unrolled serve program, about half of
    the load. The answer depends on the arguments alone, so memoize it while
    a load runs (one load at a time; the original is restored after)."""
    with _HINTS_LOCK:
        original = typing.get_type_hints
        memo: dict = {}

        def hints(obj, globalns=None, localns=None, include_extras=False):
            key = (obj, id(globalns), id(localns), include_extras)
            try:
                return memo[key]
            except KeyError:
                memo[key] = original(obj, globalns, localns, include_extras)
                return memo[key]
            except TypeError:                       # unhashable obj
                return original(obj, globalns, localns, include_extras)

        typing.get_type_hints = hints
        try:
            yield
        finally:
            typing.get_type_hints = original


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

    def put_program(self, key: str, exported: torch.export.ExportedProgram) -> int:
        """Serialize an ExportedProgram; returns the stored size in bytes."""
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        payload = buf.getvalue()
        d = self._dir(key)
        d.mkdir(parents=True, exist_ok=True)
        tmp = self.program_path(key).with_suffix(".tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, self.program_path(key))        # atomic publish
        return len(payload)

    def read_program_bytes(self, key: str) -> bytes:
        """Fetch the serialized payload only (the boot pipeline's FetchProgram)."""
        return self.program_path(key).read_bytes()

    @staticmethod
    def deserialize_program(payload: bytes) -> Callable:
        """Payload -> runnable module (the boot pipeline's DeserializeProgram)."""
        with _memoized_type_hints():
            exported = torch.export.load(io.BytesIO(payload))
        return exported.module()

    def load_program(self, key: str) -> Callable:
        """Deserialize into a callable program — the unikernel 'boot'."""
        return self.deserialize_program(self.read_program_bytes(key))

    def put_manifest(self, key: str, manifest: ImageManifest) -> None:
        self.manifest_path(key).write_text(manifest.to_json())

    def load_manifest(self, key: str) -> ImageManifest:
        return ImageManifest.from_json(self.manifest_path(key).read_text())

