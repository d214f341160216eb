"""Deploy-time image building (port of ``repro.core.deploy``).

``deploy()`` turns a FunctionSpec into a ready Deployment:
  1. build the model and the single-purpose serve program (prefill + K greedy
     decode steps, the K steps unrolled into one program — nothing generic),
  2. init the weights on the device from ``spec.seed``,
  3. export the serve program with ``torch.export``, save it into the
     CompileCache, load it back and run it once on probe tokens: the image is
     accepted only if the loaded program gives the eager program's tokens,
     and deploy raises otherwise (the JAX package's in-process fallback for
     XLA:CPU's AOT loader has no counterpart here),
  4. write the v1 weight snapshot and the ImageManifest.

Later slices add the head/tail split, the first-use order, shape buckets,
the decode bundle and the generic checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.core.artifact import ExecutorImage, FunctionSpec, ImageManifest
from repro_torch.core.compile_cache import CompileCache, slim
from repro_torch.core.executor import synchronize
from repro_torch.core.metrics import now
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.models.transformer import split_layers
from repro_torch import pytree


class ServeProgram(nn.Module):
    """The function body: prefill the prompt, then greedy-decode K tokens.

    ``forward(params, tokens [B, S] int32) -> tokens [B, K] int32``. The
    weights are an input, not module state, so the exported program is
    weight-free and one image serves any snapshot of the same shapes.
    """

    def __init__(self, model: Model, spec: FunctionSpec) -> None:
        super().__init__()
        self.model = model
        self.decode_steps = spec.decode_steps
        self.capacity = spec.prompt_len + spec.decode_steps

    def forward(self, params, tokens):
        params = {**params, "stack": split_layers(params["stack"])}
        logits, cache = self.model.prefill(params, {"tokens": tokens}, capacity=self.capacity)
        toks = []
        for _ in range(self.decode_steps):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits, cache = self.model.decode(params, cache, tok)
            toks.append(tok[:, 0])
        return torch.stack(toks, dim=1)                    # [B, decode_steps]


def make_serve_fn(model: Model, spec: FunctionSpec) -> ServeProgram:
    return ServeProgram(model, spec)


@dataclasses.dataclass
class Deployment:
    """Everything a driver needs to start executors for one function."""

    spec: FunctionSpec
    image: ExecutorImage
    model: Model
    serve_fn: Callable
    cache: CompileCache
    snapshots: SnapshotStore
    device: torch.device
    build_seconds: float

    def program_key(self) -> str:
        """Registry/cache key of the program artifact."""
        return self.image.key

    def load_program(self) -> Callable:
        """The unikernel 'boot': deserialize the program from the image registry."""
        return self.cache.load_program(self.program_key())

    def fetch_program_payload(self) -> bytes:
        """Serialized-program bytes for the boot pipeline's FetchProgram stage."""
        return self.cache.read_program_bytes(self.program_key())

    def example_tokens(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.model.cfg.vocab_size,
                            (self.spec.batch_size, self.spec.prompt_len), dtype=np.int32)


def deploy(spec: FunctionSpec, cache: CompileCache, snapshots: SnapshotStore,
           work_dir: str, device="cuda") -> Deployment:
    """Build the image of ``spec`` for ``device``. ``work_dir`` is where the
    JAX package writes its generic checkpoint, which this slice does not
    build; it is kept so the two ``deploy`` signatures match."""
    t_begin = now()
    device = torch.device(device)
    cfg = get_config(spec.arch)
    if spec.reduced:
        cfg = cfg.reduced()
    capacity = spec.prompt_len + spec.decode_steps
    model = build_model(cfg, max_seq=capacity)
    serve_fn = make_serve_fn(model, spec)
    params = model.init(torch.Generator(device=device).manual_seed(spec.seed))
    key = spec.cache_key(device)

    # 1) the program -> compile cache ("unikernel image build")
    probe_tokens = torch.zeros((spec.batch_size, spec.prompt_len), dtype=torch.int32,
                               device=device)
    exported = slim(torch.export.export(serve_fn, (params, probe_tokens)))
    program_bytes = cache.put_program(key, exported)
    # deploy-time verification: boot the saved image once and run it
    with torch.inference_mode():
        booted = cache.load_program(key)(params, probe_tokens)
        eager = serve_fn(params, probe_tokens)
    synchronize(device)
    if booted.shape != eager.shape or not torch.equal(booted, eager):
        raise RuntimeError(
            f"deploy {spec.name}: the saved program's tokens differ from the eager "
            f"program's on probe tokens ({booted.tolist()} vs {eager.tolist()})")

    # 2) pre-laid-out snapshot
    snapshot_bytes = snapshots.save(key, params)
    build_seconds = now() - t_begin
    manifest = ImageManifest(
        key=key, function=spec.name,
        program_bytes=program_bytes, snapshot_bytes=snapshot_bytes,
        param_count=int(sum(t.numel() for t in pytree.leaves(params))),
        built_at=now(), build_seconds=build_seconds,
        extra={"program_format": "torch.export", "device": str(device)},
    )
    cache.put_manifest(key, manifest)
    return Deployment(spec=spec, image=ExecutorImage(manifest=manifest, spec=spec),
                      model=model, serve_fn=serve_fn, cache=cache, snapshots=snapshots,
                      device=device, build_seconds=build_seconds)
