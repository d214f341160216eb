"""ExecutorImage — the unikernel analogue (port of ``repro.core.artifact``).

A single-purpose executor artifact for exactly one (architecture x request
shape x device): the serialized program (``repro_torch.core.compile_cache``),
the weight snapshot laid out for zero-transform loading
(``repro_torch.core.snapshot``), and a manifest of identity and sizes.

Invariants: ``FunctionSpec.cache_key()`` is a pure function of the spec and
the software/device it was built for; specs and manifests are immutable once
built.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """What the user deploys: a model + fixed request geometry (the 'function')."""

    arch: str                  # registered architecture name
    batch_size: int
    prompt_len: int
    decode_steps: int = 4
    reduced: bool = True       # CPU tests deploy reduced same-family configs
    seed: int = 0

    @property
    def name(self) -> str:
        return (f"{self.arch}@b{self.batch_size}s{self.prompt_len}"
                f"d{self.decode_steps}{'r' if self.reduced else ''}")

    def cache_key(self, device="cuda") -> str:
        """Image identity: the spec plus the torch and CUDA versions and the
        device's compute capability ("cpu" on the CPU) it was built for."""
        device = torch.device(device)
        target = (list(torch.cuda.get_device_capability(device))
                  if device.type == "cuda" else "cpu")
        payload = json.dumps({
            "spec": dataclasses.asdict(self),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "target": target,
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:24]


@dataclasses.dataclass
class ImageManifest:
    """Everything the platform needs to know about one ExecutorImage."""

    key: str
    function: str
    program_bytes: int          # serialized program size ("kernel image")
    snapshot_bytes: int         # weight snapshot size ("rootfs")
    param_count: int
    built_at: float
    build_seconds: float
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ImageManifest":
        return cls(**json.loads(s))


@dataclasses.dataclass
class ExecutorImage:
    """Handle to a built image. Contents live in the cache/snapshot stores on disk."""

    manifest: ImageManifest
    spec: FunctionSpec

    @property
    def key(self) -> str:
        return self.manifest.key
