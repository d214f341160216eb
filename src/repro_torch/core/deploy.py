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

``Deployment.ensure_decode`` builds the continuous-batching decode bundle
(the admit and step programs of :mod:`repro_torch.core.decode`) once per
deployment, under the same export -> save -> load -> verify rule.

Later slices add the head/tail split, the first-use order, shape buckets
and the generic checkpoint.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.core.artifact import ExecutorImage, FunctionSpec, ImageManifest
from repro_torch.core.boot import streamed_device_put
from repro_torch.core.compile_cache import CompileCache, decode_admit_key, decode_step_key, slim
from repro_torch.core.executor import synchronize
from repro_torch.core.metrics import now
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.models.transformer import split_cache, split_layers
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
        cache = {**cache, "inner": split_cache(self.model.cfg, cache["inner"])}
        toks = []
        for _ in range(self.decode_steps):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits, cache = self.model.decode(params, cache, tok)
            toks.append(tok[:, 0])
        return torch.stack(toks, dim=1)                    # [B, decode_steps]


def make_serve_fn(model: Model, spec: FunctionSpec) -> ServeProgram:
    return ServeProgram(model, spec)


class AdmitProgram(nn.Module):
    """Continuous-batching admit: prefill ONE request into its reserved pages.

    ``forward(params, tokens [1, S] int32, k_pages, v_pages, page_ids
    [max_pages] int32) -> (logits [V], k_pages, v_pages)``. Prefills at the
    table's capacity (``max_pages * page_size``), so each layer's
    [capacity, ...] cache reshapes exactly into ``max_pages`` page rows, and
    writes those rows into the pools **in place** at ``page_ids`` (padded
    with the null page: rows past the chain's reservation land on page 0,
    garbage territory by invariant). The logits are the request's first
    response token.
    """

    def __init__(self, model: Model, max_pages: int, page_size: int) -> None:
        super().__init__()
        self.model = model
        self.max_pages = max_pages
        self.page_size = page_size

    def forward(self, params, tokens, k_pages, v_pages, page_ids):
        params = {**params, "stack": split_layers(params["stack"])}
        logits, cache = self.model.prefill(params, {"tokens": tokens},
                                           capacity=self.max_pages * self.page_size)
        ids = page_ids.long()
        for pool, new in ((k_pages, cache["inner"]["k"]), (v_pages, cache["inner"]["v"])):
            rows = new[:, 0].reshape(pool.shape[0], self.max_pages, self.page_size,
                                     *pool.shape[3:])
            pool[:, ids] = rows.to(pool.dtype)
        return logits[0], k_pages, v_pages


class StepProgram(nn.Module):
    """Continuous-batching step: one token for every resident slot at once.

    ``forward(params, k_pages, v_pages, page_table [slots, max_pages] int32,
    pos [slots] int32, token [slots, 1] int32) -> (logits [slots, V],
    k_pages, v_pages)``, the pools written in place.
    """

    def __init__(self, model: Model) -> None:
        super().__init__()
        self.model = model

    def forward(self, params, k_pages, v_pages, page_table, pos, token):
        params = {**params, "stack": split_layers(params["stack"])}
        return self.model.decode_paged(params, k_pages, v_pages, page_table, pos, token)


def make_admit_fn(model: Model, max_pages: int, page_size: int) -> AdmitProgram:
    return AdmitProgram(model, max_pages, page_size)


def make_step_fn(model: Model) -> StepProgram:
    return StepProgram(model)


@dataclasses.dataclass
class DecodeBundle:
    """The two fixed-shape programs the decode step loop runs, plus geometry."""

    slots: int                     # batch rows of the step program
    page_size: int                 # tokens per KV page
    n_pages: int                   # device pool size INCLUDING the null page
    max_pages: int                 # page-table width (pages per chain, max)
    admit: Callable                # (params, tokens[1,S], k, v, ids) -> (logits[V], k, v)
    step: Callable                 # (params, k, v, table, pos, tok) -> (logits[B,V], k, v)
    build_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds by stage


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
    build_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds by stage
    _decode_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                                     repr=False)
    _decode_bundle: Optional[DecodeBundle] = dataclasses.field(default=None, repr=False)

    @property
    def name(self) -> str:
        return self.spec.name

    def program_key(self) -> str:
        """Registry/cache key of the program artifact."""
        return self.image.key

    def load_program(self) -> Callable:
        """The unikernel 'boot': deserialize the program from the image registry."""
        return self.cache.load_program(self.program_key())

    def fetch_program_payload(self) -> bytes:
        """Serialized-program bytes for the boot pipeline's FetchProgram stage."""
        return self.cache.read_program_bytes(self.program_key())

    def ensure_decode(self, slots: int, page_size: int) -> DecodeBundle:
        """Build, save and load the continuous-batching decode bundle.

        Two programs, once per deployment: admit (prefill one request into its
        reserved pages, yielding its first token) and step (one token for
        every resident slot). Both are fixed shape — ``slots`` rows, a
        ``[slots, max_pages]`` page table, a pool of ``n_pages`` pages — so no
        request pays a trace. Each is exported with ``torch.export``, slimmed,
        saved under its derived key, loaded back, and run once beside the eager
        program on probe inputs, each on its own clone of a zero pool; a
        difference in logits or in any page but the null page raises.
        ``max_pages`` covers the spec's worst case (prompt + decode budget),
        and ``n_pages`` gives every slot a full reservation plus the null
        page. Later calls return the first bundle, whatever they ask for.
        """
        max_pages = -(-(self.spec.prompt_len + self.spec.decode_steps) // page_size)
        n_pages = 1 + slots * max_pages
        with self._decode_lock:
            if self._decode_bundle is None:
                self._decode_bundle = self._build_decode(slots, page_size, max_pages, n_pages)
            return self._decode_bundle

    def _build_decode(self, slots: int, page_size: int, max_pages: int,
                      n_pages: int) -> DecodeBundle:
        times: Dict[str, float] = {}
        t = now()

        def lap(stage: str) -> None:
            nonlocal t
            t1 = now()
            times[stage] = t1 - t
            t = t1

        dev, model, S = self.device, self.model, self.spec.prompt_len
        params = streamed_device_put(self.snapshots.load_host(self.image.key), dev)
        pools = model.init_page_pool(n_pages, page_size, dev)
        kp, vp = pools["k_pages"], pools["v_pages"]
        tok1 = torch.zeros((1, S), dtype=torch.int32, device=dev)
        chain = torch.arange(1, max_pages + 1, dtype=torch.int32, device=dev)
        table = torch.zeros((slots, max_pages), dtype=torch.int32, device=dev)
        table[0] = chain
        pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        pos[0] = S
        tok = torch.ones((slots, 1), dtype=torch.int32, device=dev)
        admit_args = (tok1, kp, vp, chain)
        step_args = (kp, vp, table, pos, tok)
        admit_fn = make_admit_fn(model, max_pages, page_size)
        step_fn = make_step_fn(model)
        lap("restore")
        admit_x = slim(torch.export.export(admit_fn, (params,) + admit_args))
        step_x = slim(torch.export.export(step_fn, (params,) + step_args))
        lap("export")
        key = self.image.key
        self.cache.put_program(decode_admit_key(key), admit_x)
        self.cache.put_program(decode_step_key(key), step_x)
        lap("save")
        admit_p = self.cache.load_program(decode_admit_key(key))
        step_p = self.cache.load_program(decode_step_key(key))
        lap("load")
        def run_admit(fn, k, v):
            return fn(params, tok1, k, v, chain)

        def run_step(fn, k, v):                     # on the pools one admit filled
            _, k, v = admit_fn(params, tok1, k, v, chain)
            return fn(params, k, v, table, pos, tok)

        with torch.inference_mode():
            zero = model.init_page_pool(n_pages, page_size, dev)
            for saved, eager, run in ((admit_p, admit_fn, run_admit),
                                      (step_p, step_fn, run_step)):
                (l1, k1, v1), (l2, k2, v2) = [
                    run(fn, zero["k_pages"].clone(), zero["v_pages"].clone())
                    for fn in (saved, eager)]
                synchronize(dev)
                # page 0 takes the empty slots' writes in no fixed order
                if not (torch.equal(l1, l2) and torch.equal(k1[:, 1:], k2[:, 1:])
                        and torch.equal(v1[:, 1:], v2[:, 1:])):
                    raise RuntimeError(
                        f"ensure_decode {self.name}: the saved {type(eager).__name__}'s "
                        "logits or pools differ from the eager program's on probe inputs")
        lap("verify")
        return DecodeBundle(slots=slots, page_size=page_size, n_pages=n_pages,
                            max_pages=max_pages, admit=admit_p, step=step_p, build_s=times)

    def example_tokens(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.model.cfg.vocab_size,
                            (self.spec.batch_size, self.spec.prompt_len), dtype=np.int32)


def deploy(spec: FunctionSpec, cache: CompileCache, snapshots: SnapshotStore,
           work_dir: str, device="cuda") -> Deployment:
    """Build the image of ``spec`` for ``device``. ``work_dir`` is where the
    JAX package writes its generic checkpoint, which this slice does not
    build; it is kept so the two ``deploy`` signatures match."""
    t_begin = t = now()
    times: Dict[str, float] = {}

    def lap(stage: str) -> None:
        nonlocal t
        t1 = now()
        times[stage] = t1 - t
        t = t1

    device = torch.device(device)
    cfg = get_config(spec.arch)
    if spec.reduced:
        cfg = cfg.reduced()
    capacity = spec.prompt_len + spec.decode_steps
    model = build_model(cfg, max_seq=capacity)
    serve_fn = make_serve_fn(model, spec)
    params = model.init(torch.Generator(device=device).manual_seed(spec.seed))
    key = spec.cache_key(device)
    synchronize(device)
    lap("init")

    # 1) the program -> compile cache ("unikernel image build")
    probe_tokens = torch.zeros((spec.batch_size, spec.prompt_len), dtype=torch.int32,
                               device=device)
    exported = slim(torch.export.export(serve_fn, (params, probe_tokens)))
    lap("export")
    program_bytes = cache.put_program(key, exported)
    lap("save")
    # deploy-time verification: boot the saved image once and run it
    program = cache.load_program(key)
    lap("load")
    with torch.inference_mode():
        booted = program(params, probe_tokens)
        eager = serve_fn(params, probe_tokens)
    synchronize(device)
    if booted.shape != eager.shape or not torch.equal(booted, eager):
        raise RuntimeError(
            f"deploy {spec.name}: the saved program's tokens differ from the eager "
            f"program's on probe tokens ({booted.tolist()} vs {eager.tolist()})")
    lap("verify")

    # 2) pre-laid-out snapshot
    snapshot_bytes = snapshots.save(key, params)
    lap("snapshot")
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
                      device=device, build_seconds=build_seconds, build_s=times)
