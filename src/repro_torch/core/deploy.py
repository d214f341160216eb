"""Deploy-time image building (port of ``repro.core.deploy``).

``deploy()`` turns a FunctionSpec into a ready Deployment:
  1. build the model and the single-purpose serve program (prefill + K greedy
     decode steps, the K steps unrolled into one program — nothing generic),
  2. init the weights on the device from ``spec.seed``,
  3. export the serve program with ``torch.export``, compile it ahead of
     time with AOTInductor into a ``.pt2`` package
     (:func:`repro_torch.core.compile_cache.compile_package`), save the
     package into the CompileCache, load it back and run it once on probe
     tokens: the image is accepted only if the loaded program gives the
     eager program's tokens, and deploy raises otherwise (the JAX package's
     in-process fallback for XLA:CPU's AOT loader has no counterpart here;
     a program that fails to compile or load raises too),
  4. for streamed boots, export and compile the head/tail split of the same
     program (``HeadProgram``: prefill + the first token; ``TailProgram``:
     the decode steps), save both packages under their derived keys, load
     them back, and accept the split (``split_ok``) only if head + tail give
     the fused program's tokens bit for bit — otherwise the keys are evicted
     and the streamed driver boots the fused program,
  5. walk the exported graph once for the leaves' first-use order
     (:func:`first_use_order`) and write the weight snapshot with it (v2
     chunks when the store has a blob store, as the Gateway's does; v1 files
     otherwise), then the ImageManifest.

``Deployment.ensure_decode`` builds the continuous-batching decode bundle
(the admit and step programs of :mod:`repro_torch.core.decode`) once per
deployment, under the same export -> compile -> save -> load -> verify
rule. The loaded programs write the caller's page pools in place and return
those same tensors; the verify step holds them to the eager programs
(:func:`_decode_gate`). Every program is stored as an AOTInductor package
(``_publish``).
``Deployment.ensure_generic`` writes the generic checkpoint of the cold_jit
drivers once per deployment, when the first such boot plans (the JAX package
writes it in ``deploy``; at jamba's size it is a 65 GB float32 file, so the
port writes it only for a deployment that is booted that way).

``Deployment.ensure_bucket`` builds the coalescer's bucket program for a
batch of ``rows`` token rows (``repro_torch.core.batching``), once per
bucket, under the same export -> compile -> save -> load -> verify rule; it
is keyed by ``bucket_image_key`` and has no head/tail split. ``ensure_buckets`` builds
several, restoring the snapshot's weights to the device once for all. The JAX package's
in-process fallback for a bucket its loader refuses is not ported: a bucket
that fails to export, compile, load or verify raises.

``precompile`` compiles a spec's serve, head and tail programs, and with a
decode geometry its admit and step programs, into the compiled-package cache
before it is deployed, traced on fake tensors (``trace_on_fakes``): a build
process can fill the cache while another process serves, and the later
``deploy`` and ``ensure_decode`` read the packages back and verify them
under the rules above.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as torch_pytree
from torch import nn

from repro_torch.configs import get_config
from repro_torch.core.artifact import ExecutorImage, FunctionSpec, ImageManifest
from repro_torch.core.boot import fake_inputs, streamed_device_put
from repro_torch.core.compile_cache import (
    AOTI, CompileCache, aoti_package_key_parts, build_slot, compile_package, decode_admit_key,
    decode_step_key, head_key, slim, tail_key,
)
from repro_torch.core.executor import synchronize
from repro_torch.core.metrics import now
from repro_torch.core.scheduler import program_artifact_key
from repro_torch.core.snapshot import SnapshotStore, save_generic_checkpoint
from repro_torch.dtypes import torch_dtype
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


class HeadProgram(nn.Module):
    """Streamed-boot head: prefill + the FIRST response token.

    ``forward(params, tokens) -> (tok0 [B, 1] int32, logits [B, V], cache)``,
    ``cache`` the prefill's decode state (the stacked tensors, padded to the
    fused program's capacity). The moment its output is ready the response
    has begun — the TTFR stamp; the logits and cache let the tail resume the
    fused computation exactly.
    """

    def __init__(self, model: Model, spec: FunctionSpec) -> None:
        super().__init__()
        self.model = model
        self.capacity = spec.prompt_len + spec.decode_steps

    def forward(self, params, tokens):
        params = {**params, "stack": split_layers(params["stack"])}
        logits, cache = self.model.prefill(params, {"tokens": tokens}, capacity=self.capacity)
        tok0 = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return tok0, logits, cache["inner"]


class TailProgram(nn.Module):
    """Streamed-boot tail: the decode steps of ``ServeProgram``, verbatim.

    ``forward(params, logits, cache) -> tokens [B, K] int32``. Takes the
    head's prefill logits and cache and re-derives token 0 from the logits as
    the fused program does, so head + tail give its tokens bit for bit
    (checked at deploy). The cache is cloned once at the top: the decode
    steps write into that copy in place, as the fused program writes into its
    own intermediate, so the exported graph keeps in-place writes (no
    functional cache copy per step) and the caller's tensors are unchanged.
    """

    def __init__(self, model: Model, spec: FunctionSpec) -> None:
        super().__init__()
        self.model = model
        self.decode_steps = spec.decode_steps
        self.prompt_len = spec.prompt_len

    def forward(self, params, logits, cache):
        params = {**params, "stack": split_layers(params["stack"])}
        inner = pytree.tree_map(torch.clone, cache)
        cache = {"inner": split_cache(self.model.cfg, inner), "pos": self.prompt_len}
        toks = []
        for _ in range(self.decode_steps):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits, cache = self.model.decode(params, cache, tok)
            toks.append(tok[:, 0])
        return torch.stack(toks, dim=1)                    # [B, decode_steps]


def make_head_fn(model: Model, spec: FunctionSpec) -> HeadProgram:
    return HeadProgram(model, spec)


def make_tail_fn(model: Model, spec: FunctionSpec) -> TailProgram:
    return TailProgram(model, spec)


# Graph nodes that only re-view their input: a leaf flows through them
# without being read, so the walk follows them to the first node that
# computes with the leaf.
_VIEW_OPS = {
    operator.getitem, torch.ops.aten.alias.default, torch.ops.aten.detach.default,
    torch.ops.aten.view.default, torch.ops.aten.reshape.default,
    torch.ops.aten._unsafe_view.default, torch.ops.aten.unbind.int,
    torch.ops.aten.select.int, torch.ops.aten.slice.Tensor, torch.ops.aten.t.default,
    torch.ops.aten.transpose.int, torch.ops.aten.permute.default,
    torch.ops.aten.expand.default, torch.ops.aten.squeeze.dim,
    torch.ops.aten.unsqueeze.default,
}


def _publish(cache: CompileCache, key: str, exported, lap=None) -> int:
    """Compile ``exported`` into an AOTInductor package (``lap("compile")``
    after the compile, when given) and store it under ``key``. Returns the
    payload's bytes."""
    package = compile_package(exported)
    if lap is not None:
        lap("compile")
    return cache.put_package(key, package)


def _keystr(path) -> str:
    """A torch pytree key path as JAX's ``keystr`` (``['embed']['tok']``)."""
    out = []
    for k in path:
        if isinstance(k, torch_pytree.MappingKey):
            out.append(f"[{k.key!r}]")
        elif isinstance(k, torch_pytree.SequenceKey):
            out.append(f"[{k.idx}]")
        else:
            raise TypeError(f"unexpected key in a parameter path: {k!r}")
    return "".join(out)


def first_use_order(exported: torch.export.ExportedProgram) -> List[str]:
    """Parameter leaf paths of ``exported`` (a program whose first input is
    the parameter tree) in the order execution first computes with each.

    A deploy-time pass over the exported graph — no trace, no execution. The
    graph's node list is a topological order that tracks trace order, so the
    first node that consumes a leaf gives the order execution first needs it:
    embedding and early layers before late layers. ``ServeProgram`` unbinds
    every stacked ``[L, ...]`` leaf at its top, so view-like nodes (unbind,
    select, getitem, view, reshape, slice, ...) do not count as a use: the
    walk follows a leaf through them to the first node that computes with
    it. Placeholders map to leaf paths through torch's own input spec (torch
    flattens dicts in insertion order, the snapshot in JAX's sorted order).
    Leaves no node computes with are appended in JAX's flattening order, so
    the result is always a permutation of every leaf path.
    """
    in_spec = exported.call_spec.in_spec
    flat = torch_pytree.tree_flatten_with_path(
        torch_pytree.tree_unflatten(list(range(in_spec.num_leaves)), in_spec))[0]
    # (args, kwargs) -> args[0] is the parameter tree
    leaf_path = {i: _keystr(path[2:]) for path, i in flat
                 if len(path) > 2 and path[:2] == (torch_pytree.SequenceKey(0),
                                                   torch_pytree.SequenceKey(0))}
    user = [s.arg.name for s in exported.graph_signature.input_specs
            if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    alias: Dict[str, str] = {name: leaf_path[i] for i, name in enumerate(user)
                             if i in leaf_path}
    seen: List[str] = []
    seen_set: set = set()
    for node in exported.graph.nodes:
        if node.op != "call_function":
            continue
        inputs = [a for a in node.all_input_nodes if a.name in alias]
        if not inputs:
            continue
        if node.target in _VIEW_OPS and len(inputs) == 1:
            alias[node.name] = alias[inputs[0].name]
            continue
        for a in inputs:
            path = alias[a.name]
            if path not in seen_set:
                seen_set.add(path)
                seen.append(path)
    all_paths = sorted(leaf_path.values(), key=_jax_order(leaf_path.values()))
    return seen + [p for p in all_paths if p not in seen_set]


def _jax_order(paths):
    """Sort key putting ``keystr`` paths in JAX's flattening order."""
    def parts(p: str):
        return [int(k) if k.isdigit() else k.strip("'") for k in p[1:-1].split("][")]
    return lambda p: [(isinstance(k, str), k) for k in parts(p)]


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
    # the deploy-time gate's comparison of each loaded program with the eager
    # one, by program ("admit", "step"): see _decode_gate
    gate: Dict[str, dict] = dataclasses.field(default_factory=dict)


def decode_geometry(spec: FunctionSpec, slots: int, page_size: int,
                    max_pages: Optional[int] = None,
                    n_pages: Optional[int] = None) -> Tuple[int, int]:
    """``(max_pages, n_pages)`` of a decode bundle, defaulted as the JAX
    package's ``ensure_decode`` defaults them: ``max_pages`` covers the
    spec's worst case (prompt + decode budget), ``n_pages`` gives every slot
    a full reservation plus the null page."""
    if max_pages is None:
        max_pages = -(-(spec.prompt_len + spec.decode_steps) // page_size)
    if n_pages is None:
        n_pages = 1 + slots * max_pages
    return max_pages, n_pages


def _decode_inputs(model: Model, prompt_len: int, slots: int, page_size: int,
                   max_pages: int, n_pages: int, device):
    """The inputs, but the parameters, that the admit and step programs are
    traced and verified on: ``(admit_args, step_args)``; call it inside a
    ``FakeTensorMode`` for their shapes alone. Zero pools; the admit's chain
    takes pages 1, 2, ... (the null page past the pool's end); the step's slot
    0 holds that chain at the prompt's end, and the other slots are empty."""
    pools = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for k, s in model.page_pool_specs(n_pages, page_size).items()}
    kp, vp = pools["k_pages"], pools["v_pages"]
    tok1 = torch.zeros((1, prompt_len), dtype=torch.int32, device=device)
    chain = torch.arange(1, max_pages + 1, dtype=torch.int32, device=device)
    chain = chain * (chain < n_pages)
    table = torch.zeros((slots, max_pages), dtype=torch.int32, device=device)
    table[0] = chain
    pos = torch.zeros((slots,), dtype=torch.int32, device=device)
    pos[0] = prompt_len
    tok = torch.ones((slots, 1), dtype=torch.int32, device=device)
    return (tok1, kp, vp, chain), (kp, vp, table, pos, tok)


def _rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref).norm() / ref.norm())


def _decode_gate(name: str, model: Model, params, admit_args, step_args, programs: dict,
                 page_size: int) -> Dict[str, dict]:
    """Hold the loaded admit and step programs (``programs``: kind ->
    (loaded, eager)) to the eager ones on the probe inputs; raise if one
    fails, else return the comparison by kind.

    Each program runs on its own clones of one input pool (the step's: the
    pools one eager admit filled). The loaded program must write those
    clones in place and return them, not copies (``in_place``). Its logits
    and every page but the null page (which takes the empty slots' writes in
    no fixed order) are compared with the eager program's: the largest
    difference and the count of differing elements of the logits and of the
    pages. Equal bit for bit passes. Otherwise the rule the serve path holds
    a compiled program to: the greedy token of the live rows equals the
    eager one, and the logits and the K and V the program wrote (the admit's
    chain, the step's one row) are no farther from the float32 program on
    the plain route (rel_l2) than twice the eager bfloat16 program is; and
    every other page but the null page, which neither program may write, is
    equal to the eager program's bit for bit (``untouched_equal``).
    """
    from repro_torch.kernels import ops
    tok1, kp0, vp0, chain = admit_args
    _, _, table, pos, tok = step_args
    p0 = int(pos[0])
    # the (page, offset) index of what each program writes but the null page
    rows = {"admit": (chain[chain > 0].long(),),
            "step": (int(table[0, p0 // page_size]), p0 % page_size)}
    admit_eager = programs["admit"][1]
    runs = {"admit": lambda fn, prm, k, v: fn(prm, tok1, k, v, chain),
            "step": lambda fn, prm, k, v: fn(prm, k, v, table, pos, tok)}
    live = {"admit": lambda lg: lg, "step": lambda lg: lg[0]}
    with torch.inference_mode():
        filled = admit_eager(params, tok1, kp0.clone(), vp0.clone(), chain)[1:]
    pools = {"admit": (kp0, vp0), "step": filled}
    variants: dict = {}

    def variant(dtype: str):
        """The eager admit and step programs of ``model`` in ``dtype``, and
        the parameters cast to it."""
        if dtype not in variants:
            m = build_model(dataclasses.replace(model.cfg, dtype=dtype), model.max_seq)
            cast = pytree.tree_map(lambda t: t.to(torch_dtype(dtype)), params)
            variants[dtype] = ({"admit": make_admit_fn(m, admit_eager.max_pages, page_size),
                                "step": make_step_fn(m)}, cast)
        return variants[dtype]

    gate: Dict[str, dict] = {}
    for kind, (saved, eager) in programs.items():
        run, (k0, v0) = runs[kind], pools[kind]
        ins = [(k0.clone(), v0.clone()) for _ in range(2)]
        with torch.inference_mode():
            (lc, kc, vc), (le, ke, ve) = [run(fn, params, k, v)
                                          for fn, (k, v) in zip((saved, eager), ins)]
        synchronize(k0.device)
        g: dict = {"in_place": kc.data_ptr() == ins[0][0].data_ptr()
                   and vc.data_ptr() == ins[0][1].data_ptr()
                   and not torch.equal(ins[0][0], k0)}
        if not g["in_place"]:
            raise RuntimeError(f"ensure_decode {name}: the saved {type(eager).__name__} does not "
                               "write the caller's pools in place")
        pairs = {"logits": (lc, le), "pages": (torch.stack((kc[:, 1:], vc[:, 1:])),
                                               torch.stack((ke[:, 1:], ve[:, 1:])))}
        g["equal"] = all(torch.equal(a, b) for a, b in pairs.values())
        for what, (a, b) in pairs.items():
            d = (a.float() - b.float()).abs()
            g[f"{what}_max_diff"], g[f"{what}_n_diff"] = float(d.max()), int((d > 0).sum())
        if not g["equal"]:
            progs32, params32 = variant("float32")
            with torch.inference_mode(), ops.impl_scope("plain"):
                l32, k32, v32 = run(progs32[kind], params32, k0.float(), v0.float())
            if model.cfg.dtype == "bfloat16":
                lb, kb, vb = le, ke, ve
            else:
                progs16, params16 = variant("bfloat16")
                with torch.inference_mode():
                    lb, kb, vb = run(progs16[kind], params16, k0.to(torch.bfloat16),
                                     v0.to(torch.bfloat16))
            g["argmax_equal"] = bool(torch.equal(live[kind](lc).float().argmax(-1),
                                                 live[kind](le).float().argmax(-1)))
            at = (slice(None),) + rows[kind]
            ref = {"logits": (live[kind](lc), live[kind](lb), live[kind](l32).float()),
                   "k": (kc[at], kb[at], k32[at]), "v": (vc[at], vb[at], v32[at])}
            g["rel_l2"] = {what: (_rel_l2(c, r), _rel_l2(b, r))
                           for what, (c, b, r) in ref.items()}
            untouched = torch.ones(kc.shape[1:3], dtype=torch.bool, device=kc.device)
            untouched[0] = False
            untouched[rows[kind]] = False
            g["untouched_equal"] = all(torch.equal(a[:, untouched], b[:, untouched])
                                       for a, b in ((kc, ke), (vc, ve)))
            if not (g["argmax_equal"] and g["untouched_equal"]
                    and all(c <= 2.0 * b for c, b in g["rel_l2"].values())):
                raise RuntimeError(
                    f"ensure_decode {name}: the saved {type(eager).__name__}'s logits or pools "
                    f"differ from the eager program's on probe inputs beyond the compiled "
                    f"programs' rule: {g}")
        gate[kind] = g
    return gate


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
    # where the cold_jit drivers' generic checkpoint lives; written on first
    # use by ensure_generic
    generic_ckpt: str = ""
    build_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds by stage
    # streamed-boot metadata (deploy-time graph walk / split build):
    first_use_order: List[str] = dataclasses.field(default_factory=list)
    head_leaves: List[str] = dataclasses.field(default_factory=list)
    split_ok: bool = False         # head/tail sub-programs published and verified
                                   # bit-identical to the fused program
    _decode_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                                     repr=False)
    _decode_bundle: Optional[DecodeBundle] = dataclasses.field(default=None, repr=False)
    _generic_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                                      repr=False)
    # shape-bucket program registry (repro_torch.core.batching): the token-row
    # counts whose program is saved and verified (build_s has the seconds of
    # each one's stages as ``bucket<rows>_<stage>``)
    _buckets: set = dataclasses.field(default_factory=set, repr=False)
    _bucket_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                                     repr=False)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def base_rows(self) -> int:
        """Token rows of the request shape (the deploy-time program's)."""
        return self.spec.batch_size

    def abstract_params(self) -> Any:
        """The parameter tree's shapes and dtypes (:class:`ParamSpec`
        leaves): the template a generic checkpoint is cast back to and a
        re-trace runs on."""
        return self.model.param_specs()

    def bucket_image_key(self, rows: int) -> str:
        # single source of truth with the scheduler's affinity keys: routing
        # probes and tier inserts must agree on this exact string
        return program_artifact_key(self.image.key, rows)

    def abstract_tokens_for(self, rows: Optional[int]) -> Tuple[int, int]:
        """The int32 token shape of a program at ``rows`` token rows (None:
        the deploy-time request shape)."""
        return (self.base_rows if rows is None else rows, self.spec.prompt_len)

    def ensure_bucket(self, rows: int) -> None:
        """Export, compile, save, load and verify the serve program for a
        coalesced batch of ``rows`` token rows.

        One build per bucket, ever — every later batch rounded to this bucket
        boots the saved program exactly like the base one. The program is
        exported with ``torch.export`` at ``[rows, prompt_len]`` on the
        snapshot's weights, compiled with AOTInductor, saved under
        ``bucket_image_key(rows)``, loaded back, and run beside the eager
        program on seeded probe tokens; a difference raises, and nothing is
        registered.
        """
        self.ensure_buckets((rows,))

    def ensure_buckets(self, rows: Iterable[int]) -> None:
        """``ensure_bucket`` for each of ``rows``, with the snapshot's weights
        restored to the device once for all the buckets still to build
        (``build_s["buckets_restore"]``) and released after."""
        with self._bucket_lock:
            todo = [r for r in dict.fromkeys(rows)
                    if r != self.base_rows and r not in self._buckets]
            if not todo:
                return
            t = now()
            params = streamed_device_put(self.snapshots.load_host(self.image.key), self.device)
            self.build_s["buckets_restore"] = now() - t
            for r in todo:
                self._build_bucket(r, params)
                self._buckets.add(r)

    def _build_bucket(self, rows: int, params) -> None:
        t = now()

        def lap(stage: str) -> None:
            nonlocal t
            t1 = now()
            self.build_s[f"bucket{rows}_{stage}"] = t1 - t
            t = t1

        dev, key = self.device, self.bucket_image_key(rows)
        rng = np.random.default_rng(rows)
        probe = torch.from_numpy(rng.integers(0, self.model.cfg.vocab_size,
                                              self.abstract_tokens_for(rows),
                                              dtype=np.int32)).to(dev)
        fn = make_serve_fn(self.model, self.spec)
        exported = torch.export.export(fn, (params, probe))
        lap("export")
        _publish(self.cache, key, exported, lap)
        del exported
        lap("save")
        program = self.cache.load_program(key)
        lap("load")
        with torch.inference_mode():
            booted = program(params, probe)
            eager = fn(params, probe)
        synchronize(dev)
        if booted.shape != eager.shape or not torch.equal(booted, eager):
            self.cache.evict(key)
            raise RuntimeError(
                f"ensure_bucket {self.name}: the saved {rows}-row program's tokens differ "
                "from the eager program's on probe tokens")
        lap("verify")

    def _require_bucket(self, bucket_rows: Optional[int]) -> None:
        if bucket_rows is None or bucket_rows == self.base_rows:
            return
        with self._bucket_lock:
            if bucket_rows not in self._buckets:
                raise KeyError(f"bucket {bucket_rows} not built for {self.name}; "
                               "call Deployment.ensure_bucket first")

    def program_key(self, bucket_rows: Optional[int] = None) -> str:
        """Registry/cache key of the program artifact for a request shape —
        the unit of placement affinity (repro_torch.core.scheduler) and of
        the per-host program tier."""
        if bucket_rows is None or bucket_rows == self.base_rows:
            return self.image.key
        return self.bucket_image_key(bucket_rows)

    def load_program(self, bucket_rows: Optional[int] = None) -> Callable:
        """The unikernel 'boot': deserialize the program from the image registry."""
        self._require_bucket(bucket_rows)
        return self.cache.load_program(self.program_key(bucket_rows))

    def fetch_program_payload(self, bucket_rows: Optional[int] = None) -> bytes:
        """Serialized-program bytes for the boot pipeline's FetchProgram stage."""
        self._require_bucket(bucket_rows)
        return self.cache.read_program_bytes(self.program_key(bucket_rows))

    def head_program_key(self) -> str:
        return head_key(self.image.key)

    def tail_program_key(self) -> str:
        return tail_key(self.image.key)

    def fetch_head_payload(self) -> Optional[bytes]:
        """Serialized head sub-program bytes, or None when no verified split
        exists (the streamed boot then boots the fused program)."""
        if not self.split_ok:
            return None
        return self.cache.read_program_bytes(self.head_program_key())

    def ensure_generic(self) -> str:
        """Write the generic checkpoint of this deployment's snapshot, once,
        and return its path (``generic_ckpt``). The cold_jit drivers call it
        when they plan a boot, as the paused driver parks its weights on
        first use; the file equals, array for array, the one the JAX
        package's ``deploy`` writes for the same parameters."""
        with self._generic_lock:
            if not Path(self.generic_ckpt).exists():
                save_generic_checkpoint(self.generic_ckpt,
                                        self.snapshots.iter_host_leaves(self.image.key))
            return self.generic_ckpt

    def ensure_decode(self, slots: int, page_size: int, max_pages: Optional[int] = None,
                      n_pages: Optional[int] = None) -> DecodeBundle:
        """Build, save and load the continuous-batching decode bundle.

        Two programs, once per deployment: admit (prefill one request into its
        reserved pages, yielding its first token) and step (one token for
        every resident slot). Both are fixed shape — ``slots`` rows, a
        ``[slots, max_pages]`` page table, a pool of ``n_pages`` pages — so no
        request pays a trace. Each is exported with ``torch.export``, compiled
        with AOTInductor, saved under its derived key, loaded back, and held
        to the eager program on probe inputs (:func:`_decode_gate`); a
        program that fails to compile, load or pass raises, and nothing is
        installed. ``max_pages`` and ``n_pages`` default as in the JAX
        package (:func:`decode_geometry`). Later calls return the first
        bundle, whatever they ask for.
        """
        max_pages, n_pages = decode_geometry(self.spec, slots, page_size, max_pages, n_pages)
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

        dev, model, key = self.device, self.model, self.image.key
        params = streamed_device_put(self.snapshots.load_host(key), dev)
        admit_args, step_args = _decode_inputs(model, self.spec.prompt_len, slots, page_size,
                                               max_pages, n_pages, dev)
        admit_fn = make_admit_fn(model, max_pages, page_size)
        step_fn = make_step_fn(model)
        keys = (decode_admit_key(key), decode_step_key(key))
        lap("restore")
        exported = [torch.export.export(admit_fn, (params,) + admit_args),
                    torch.export.export(step_fn, (params,) + step_args)]
        lap("export")
        packages = [compile_package(x) for x in exported]
        del exported
        lap("compile")
        for k, package in zip(keys, packages):
            self.cache.put_package(k, package)
        del packages
        lap("save")
        admit_p, step_p = (self.cache.load_program(k) for k in keys)
        lap("load")
        gate = _decode_gate(self.name, model, params, admit_args, step_args,
                            {"admit": (admit_p, admit_fn), "step": (step_p, step_fn)},
                            page_size)
        lap("verify")
        return DecodeBundle(slots=slots, page_size=page_size, n_pages=n_pages,
                            max_pages=max_pages, admit=admit_p, step=step_p, build_s=times,
                            gate=gate)

    def example_tokens(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.model.cfg.vocab_size,
                            (self.spec.batch_size, self.spec.prompt_len), dtype=np.int32)


def _split_args(model: Model, spec: FunctionSpec, params, tokens, mode=None):
    """The head and tail programs of ``spec``, each with what it is traced
    on: ``(kind, module, args)``. The tail's arguments are the head's outputs
    on ``params`` and ``tokens``, computed in ``mode`` (the
    ``FakeTensorMode`` of fake inputs; None: eagerly)."""
    head_fn, tail_fn = make_head_fn(model, spec), make_tail_fn(model, spec)
    with mode or contextlib.nullcontext(), torch.no_grad():
        _tok0, logits, inner = head_fn(params, tokens)
    return (("head", head_fn, (params, tokens)), ("tail", tail_fn, (params, logits, inner)))


def _build_split(spec: FunctionSpec, model: Model, cache: CompileCache, key: str,
                 params, probe_tokens, fused_out) -> bool:
    """Export, compile, save and load the head and tail programs of ``spec``;
    True only if head + tail give ``fused_out`` (the loaded fused program's
    tokens on ``probe_tokens``) bit for bit, and token 0 equals its first
    column. A program that fails to compile or load raises."""
    keys = {"head": head_key(key), "tail": tail_key(key)}
    for kind, fn, args in _split_args(model, spec, params, probe_tokens):
        _publish(cache, keys[kind], torch.export.export(fn, args))
    del fn, args
    head_p = cache.load_program(head_key(key))
    tail_p = cache.load_program(tail_key(key))
    with torch.inference_mode():
        tok0, logits, inner = head_p(params, probe_tokens)
        split_out = tail_p(params, logits, inner)
    synchronize(probe_tokens.device)
    return bool(split_out.shape == fused_out.shape and torch.equal(split_out, fused_out)
                and torch.equal(tok0[:, 0], fused_out[:, 0]))


def deploy(spec: FunctionSpec, cache: CompileCache, snapshots: SnapshotStore,
           work_dir: str, device="cuda") -> Deployment:
    """Build the image of ``spec`` for ``device``. ``work_dir`` is where the
    generic checkpoint of the cold_jit drivers goes
    (``<work_dir>/<key>_generic.npz``, as in the JAX package), written by
    ``Deployment.ensure_generic`` on first use."""
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
    exported = torch.export.export(serve_fn, (params, probe_tokens))
    lap("export")
    # what the compiled-package cache keys this program by: a later trace of
    # the same shape (TraceCompile) is held against it
    key_parts = aoti_package_key_parts(exported)
    program_bytes = _publish(cache, key, exported, lap)
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
    del program
    lap("verify")

    # 1b) split image for streamed boots, published under derived keys and
    # accepted only if bit-identical to the fused program on the probe
    split_ok = _build_split(spec, model, cache, key, params, probe_tokens, booted)
    if not split_ok:
        cache.evict(head_key(key))
        cache.evict(tail_key(key))
    lap("split")

    # 1c) which leaf does execution compute with first? Persisted into the
    # snapshot index so a streamed restore moves leaves in that order
    use_order = first_use_order(slim(exported))
    # the head program reads the whole parameter tree, so serving the first
    # request needs every leaf resident
    head_leaves = [p for p, _ in pytree.flatten_with_paths(params)] if split_ok else []
    lap("first_use_order")

    # 2) pre-laid-out snapshot
    snapshot_bytes = snapshots.save(key, params, first_use_order=use_order)
    lap("snapshot")
    build_seconds = now() - t_begin
    extra = {"program_format": AOTI, "package_key_parts": key_parts,
             "device": str(device),
             "split_serve": split_ok, "first_use_order_len": len(use_order)}
    if snapshots.blobs is not None:
        # chunked (v2) snapshot: the manifest geometry, for dedup reports
        index = snapshots.read_index(key)
        extra.update(snapshot_format=2,
                     snapshot_chunks=sum(len(e["chunks"]) for e in index["leaves"]),
                     chunk_bytes=index["chunk_bytes"])
    manifest = ImageManifest(
        key=key, function=spec.name,
        program_bytes=program_bytes, snapshot_bytes=snapshot_bytes,
        param_count=int(sum(t.numel() for t in pytree.leaves(params))),
        built_at=now(), build_seconds=build_seconds,
        extra=extra,
    )
    cache.put_manifest(key, manifest)
    return Deployment(spec=spec, image=ExecutorImage(manifest=manifest, spec=spec),
                      model=model, serve_fn=serve_fn, cache=cache, snapshots=snapshots,
                      device=device, build_seconds=build_seconds,
                      generic_ckpt=f"{work_dir}/{key}_generic.npz", build_s=times,
                      first_use_order=use_order, head_leaves=head_leaves,
                      split_ok=split_ok)


def trace_on_fakes(spec: FunctionSpec, device="cuda", decode: Optional[tuple] = None
                   ) -> Iterator[Tuple[str, torch.export.ExportedProgram]]:
    """The serve, head and tail programs that ``deploy`` of ``spec`` on
    ``device`` compiles, traced on ``FakeTensor``s from the parameters'
    shapes alone: no weight is read or allocated. Yields ``(kind, program)``,
    the serve program first. With ``decode``, the arguments of
    ``Deployment.ensure_decode`` (``(slots, page_size)``, optionally
    ``max_pages`` and ``n_pages`` after them), then the admit and step
    programs it compiles (kinds ``decode_admit`` and ``decode_step``)."""
    cfg = get_config(spec.arch)
    if spec.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, max_seq=spec.prompt_len + spec.decode_steps)
    mode, params, tokens = fake_inputs(model.param_specs(),
                                       (spec.batch_size, spec.prompt_len), device)
    yield "serve", torch.export.export(make_serve_fn(model, spec), (params, tokens))
    for kind, fn, args in _split_args(model, spec, params, tokens, mode):
        yield kind, torch.export.export(fn, args)
    if decode is None:
        return
    slots, page_size = decode[:2]
    max_pages, n_pages = decode_geometry(spec, *decode)
    with mode:
        admit_args, step_args = _decode_inputs(model, spec.prompt_len, slots, page_size,
                                               max_pages, n_pages, tokens.device)
    yield "decode_admit", torch.export.export(make_admit_fn(model, max_pages, page_size),
                                              (params,) + admit_args)
    yield "decode_step", torch.export.export(make_step_fn(model), (params,) + step_args)


def precompile(spec: FunctionSpec, device="cuda", decode: Optional[tuple] = None
               ) -> Dict[str, float]:
    """Compile the serve, head and tail programs of ``spec`` for ``device``,
    and with ``decode`` (``ensure_decode``'s arguments, see
    :func:`trace_on_fakes`) the decode bundle's admit and step programs, into
    the compiled-package cache (:func:`compile_package`) before it is
    deployed, from shapes alone: a build process fills the cache, and a later
    ``deploy`` and ``ensure_decode`` of the same spec, in this process or
    another on the same cache directory, read the packages back instead of
    compiling. Their rules still hold what they read: the token gate against
    eager, the split's bit-identity, the decode gate. Returns seconds by
    ``<kind>_trace`` and ``<kind>_compile``."""
    times: Dict[str, float] = {}
    t = now()
    with build_slot():
        for kind, exported in trace_on_fakes(spec, device, decode):
            times[f"{kind}_trace"] = now() - t
            t = now()
            compile_package(exported)
            times[f"{kind}_compile"] = now() - t
            t = now()
    return times
