"""Multi-pod dry run: trace every (architecture x shape) cell on the production
mesh of a fake world and count what one device would do (port of
``repro.launch.dryrun``).

The JAX package lowers and compiles each cell for 512 host devices and reads
XLA's memory and cost analyses and the collectives of the compiled HLO. The
port starts ``torch.distributed``'s fake process group instead
(``launch.mesh.init_fake_world``): this process is rank 0 of 256 or 512
ranks, the parameters, optimizer state and caches are DTensors on the
production mesh whose local shards are fake tensors (no storage), and one
step of the cell (train step, prefill or decode) runs on them. A dispatch
mode below DTensor (:class:`CostCounter`) sees the ops DTensor runs on rank
0's local shards and counts, per device:

* FLOPs, from ``torch.utils.flop_counter``'s formulas and the custom ops'
  (``costmodel.register_flop_formulas``);
* bytes accessed: each local op's input plus output bytes, with no fusion
  (views and allocations move nothing);
* collectives: the functional collectives DTensor calls, by kind, with the
  JAX package's ring convention: result bytes, an all-reduce counted twice;
* memory: the arguments' local bytes, and the peak of the storages the step
  allocates while they live.

For each cell this writes ``<out>/<arch>__<shape>__<mesh>__<variant>.json``
with the JAX package's record keys (``lower_s`` is the trace's seconds).

Usage (``--device cpu`` on a machine with no card):
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k      # one cell
  python -m repro_torch.launch.dryrun --all --jobs 4                       # every cell
  python -m repro_torch.launch.dryrun --arch kimi... --shape train_4k --multi-pod
Variants (--rules / --grad-accum / --remat / --opt-dtype) as in the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import pytree, util
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.sharding import (
    Rules, abstract_state, is_dtensor, local_shape_and_offset, make_rules, param_shardings,
    placements, use_rules,
)
from repro_torch.kernels import ops
from repro_torch.launch.costmodel import analytic_flops, probe_costs, register_flop_formulas
from repro_torch.launch.mesh import init_fake_world, make_production_mesh, mesh_tag
from repro_torch.models import build_model, input_specs
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train.step import make_train_step

# ---------------------------------------------------------------------- defaults

BIG_MODEL_BYTES = 8 * 2 ** 30 * 16       # serve_tp replicates over data: cap 8GB/chip


def default_rules_preset(cfg: ArchConfig, shape: ShapeSpec) -> str:
    if shape.kind == "train":
        return "train"
    if shape.name == "long_500k":
        return "serve_seqkv"
    total_bytes = cfg.param_counts()["total"] * 2   # bf16
    return "serve_tp" if total_bytes <= BIG_MODEL_BYTES else "serve_2d"


def default_opt_dtype(cfg: ArchConfig) -> str:
    # >=398B models need quantized moments to fit 512 x 16GB (see optim/adamw.py)
    return "int8" if cfg.param_counts()["total"] > 100e9 else "float32"


def default_grad_accum(cfg: ArchConfig, shape: ShapeSpec, n_data: int) -> int:
    """Pick microbatch ~2 sequences per data shard at 4k tokens."""
    if shape.kind != "train":
        return 1
    per_shard = max(shape.global_batch // n_data, 1)
    target_micro = 2
    return max(per_shard // target_micro, 1)


# ------------------------------------------------------------------- counting

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# ``_c10d_functional`` op -> the JAX package's kind; an all-reduce moves its
# result twice (reduce-scatter + all-gather), as the JAX package counts it
_FUNCTIONAL = {"all_gather_into_tensor": ("all-gather", 1),
               "all_gather_into_tensor_coalesced": ("all-gather", 1),
               "all_reduce": ("all-reduce", 2), "all_reduce_coalesced": ("all-reduce", 2),
               "reduce_scatter_tensor": ("reduce-scatter", 1),
               "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1),
               "all_to_all_single": ("all-to-all", 1)}
# ops that move no bytes: allocations (no initialisation) and metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "device", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "is_same_size", "set_"}


def _tensors(tree) -> List[torch.Tensor]:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    del walk        # break the recursive closure's reference cycle
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceFakeMode(FakeTensorMode):
    """The trace's ``FakeTensorMode``, counting how deep it is entered:
    DTensor re-enters the active fake mode to propagate global shapes, and
    the ops it runs there are not a device's work."""

    depth = 0

    def __init__(self) -> None:
        super().__init__(allow_non_fake_inputs=True)

    def __enter__(self):
        self.depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self.depth -= 1
        return super().__exit__(*exc)


class CostCounter(TorchDispatchMode):
    """Counts, per device, what the ops below DTensor do: FLOPs, bytes
    accessed, collectives (by kind, result bytes, all-reduce twice), local
    ops, and the peak bytes of the storages allocated while the counter is
    on and still alive. DTensor ops are handed to
    DTensor (``NotImplemented``), which runs them on local tensors with the
    counter still on; under a :class:`TraceFakeMode` the ops DTensor runs to
    propagate global shapes are not counted. Works on real tensors as on
    fake ones (the card check counts a real step)."""

    def __init__(self, fake_mode=None, keep_ops: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        register_flop_formulas()
        self._flops = flop_registry
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collectives["count"] = 0
        self.op_names: Optional[List[str]] = [] if keep_ops else None
        self._known: Dict[int, int] = {}      # storage key -> bytes (live allocations)
        self._arguments: set = set()
        self.live = 0
        self.peak = 0

    # ------------------------------------------------------------------ memory
    def add_arguments(self, tensors) -> int:
        """Mark ``tensors``' storages as the step's arguments (not counted as
        allocations); returns their local bytes."""
        total = 0
        for t in tensors:
            t = _local(t)
            key = t.untyped_storage()._cdata
            if key not in self._arguments:
                self._arguments.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def aliases_argument(self, t: torch.Tensor) -> bool:
        return _local(t).untyped_storage()._cdata in self._arguments

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._arguments:
            return
        n = st.nbytes()
        self._known[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._known.pop(key, 0)

    # ---------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.fake_mode is not None and self.fake_mode.depth > 1:
            return out                     # DTensor's shape propagation
        packet = func._overloadpacket
        name = packet.__name__
        self.n_ops += 1
        if self.op_names is not None:
            self.op_names.append(str(func))
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if func.namespace == "_c10d_functional" and name in _FUNCTIONAL:
            kind, times = _FUNCTIONAL[name]
            self.collectives[kind] += times * sum(_nbytes(t) for t in outs)
            self.collectives["count"] += 1
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def collectives_record(self) -> Dict[str, int]:
        rec = dict(self.collectives)
        rec["total"] = sum(rec[k] for k in COLLECTIVES)
        return rec


class _Replay:
    """What a traced region did, for replaying it: the counter's deltas, the
    peak of live bytes above the region's start, and the layouts of what it
    returned."""

    @classmethod
    def trace(cls, counter: "CostCounter", run):
        """``run()`` under ``counter`` -> (its result, the record)."""
        c, rec = counter, cls()
        before = (c.flops, c.bytes, c.n_ops, dict(c.collectives))
        live0, peak0 = c.live, c.peak
        c.peak = c.live
        out = run()
        rec.flops, rec.bytes = c.flops - before[0], c.bytes - before[1]
        rec.n_ops = c.n_ops - before[2]
        rec.collectives = {k: v - before[3][k] for k, v in c.collectives.items()}
        rec.peak_above = c.peak - live0
        c.peak = max(peak0, c.peak)
        rec.struct = pytree.structure(out)
        rec.layouts = [_layout(t) for t in pytree.leaves(out)]
        return out, rec

    def replay(self, counter: "CostCounter"):
        c = counter
        c.flops += self.flops
        c.bytes += self.bytes
        for k, v in self.collectives.items():
            c.collectives[k] += v
        c.peak = max(c.peak, c.live + self.peak_above)
        n0 = c.n_ops
        out = pytree.unflatten(self.struct, [_rebuild(lay) for lay in self.layouts])
        c.n_ops = n0 + self.n_ops
        return out


def _layout(t):
    """A leaf's layout: a tensor's (a DTensor's local) shape, stride, dtype
    and device, and a DTensor's mesh, placements, shape and stride; any
    other leaf as it is."""
    if not isinstance(t, torch.Tensor):
        return ("value", t)
    local = t.to_local() if is_dtensor(t) else t
    plain = (tuple(local.shape), tuple(local.stride()), local.dtype, local.device)
    if not is_dtensor(t):
        return ("tensor", plain)
    return ("dtensor", plain, t.device_mesh, tuple(t.placements), tuple(t.shape),
            tuple(t.stride()))


def _rebuild(lay):
    if lay[0] == "value":
        return lay[1]
    shape, stride, dtype, device = lay[1]
    local = torch.empty_strided(shape, stride, dtype=dtype, device=device)
    if lay[0] == "tensor":
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, lay[2], list(lay[3]), run_check=False,
                              shape=torch.Size(lay[4]), stride=lay[5])


def _signature(tree) -> tuple:
    """A hashable key of a tree's structure and its leaves' layouts."""
    lays = []
    for t in pytree.leaves(tree):
        lay = _layout(t)
        lays.append(lay if lay[0] != "dtensor" else (lay[0], lay[1], id(lay[2])) + lay[3:])
    return (repr(pytree.structure(tree)), tuple(lays))


# a custom op's VJP, by signature -> its _Replay (the ops depend on nothing
# else, so the records hold across traces)
_VJP_RECORDS: Dict[tuple, _Replay] = {}


class VjpMemo:
    """``kernels.ops.VJP_RUNNER`` for a trace under a :class:`CostCounter`:
    the first VJP of a custom op at a given signature (the op, the local
    layouts of its saved inputs and incoming gradients, its non-tensor
    arguments, probe mode) is traced and recorded; a later one of the same
    signature, in this trace or another, adds the recorded counts and peak
    and returns empty gradients of the recorded layouts, without tracing its
    thousands of ops again (the plain flash VJP at 4,096 positions is
    ~30,000 ops). The counts are the ones a new trace would give."""

    def __init__(self, counter: "CostCounter") -> None:
        self.counter = counter
        self.replays = 0

    def __call__(self, name, vjp, saved, present, args, grads):
        from repro_torch.util import in_probe_mode
        key = (name, _signature([t if here else None for t, here in zip(saved, present)]),
               tuple(args), _signature(list(grads)), in_probe_mode())
        rec = _VJP_RECORDS.get(key)
        if rec is None:
            out, _VJP_RECORDS[key] = _Replay.trace(
                self.counter, lambda: vjp(saved, present, args, grads))
            return out
        self.replays += 1
        return rec.replay(self.counter)


class ScanMemo:
    """``util.SCAN_RUNNER`` for one trace under a :class:`CostCounter`: the
    first trip of an ``rscan`` body with a given carry and slice layout is
    traced and recorded; a later trip of the same layout (the micro-batches
    after the second: the first has no accumulators yet) adds the recorded
    counts and peak and returns a carry of the recorded layouts. A body is a
    pure function of its carry and slice, as ``lax.scan`` requires."""

    def __init__(self, counter: "CostCounter") -> None:
        self.counter = counter
        self.records: Dict[tuple, _Replay] = {}
        self.replays = 0

    def __call__(self, body, carry, x):
        key = (body.__code__, _signature(carry), _signature(x))
        rec = self.records.get(key)
        if rec is None:
            out, self.records[key] = _Replay.trace(self.counter, lambda: body(carry, x))
            return out
        self.replays += 1
        return rec.replay(self.counter)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


# ------------------------------------------------------------------- cell build

def _laid_out(meta_tree, shardings, mesh, device):
    """Fake tensors of ``meta_tree``'s shapes and dtypes on ``device`` (call
    under the fake mode): with a mesh, DTensors whose local shards are laid
    out as ``shardings``; with none, plain tensors."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        shape = tuple(t.shape)
        if mesh is None:
            return torch.empty(shape, dtype=t.dtype, device=device)
        local_shape, _ = local_shape_and_offset(shape, mesh, pl)
        local = torch.empty(local_shape, dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, list(pl), run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    if mesh is None:
        return pytree.tree_map(lambda t: one(t, None), meta_tree)
    from repro_torch.dist.sharding import _is_placements
    return pytree.tree_map(lambda pl, t: one(t, pl), shardings, meta_tree,
                           is_leaf=_is_placements)


def _place_batch(rules: Rules, mesh):
    """A micro-batch every rank holds whole, laid out over the batch axes
    (each rank keeps its own rows, no collective), as the ``Trainer`` lays
    it out."""
    from torch.distributed.tensor import distribute_tensor

    def put(x):
        pl = placements(rules, mesh, ("batch",) + (None,) * (x.dim() - 1), x.shape)
        return distribute_tensor(x, mesh, list(pl), src_data_rank=None)

    return lambda batch: {k: put(v) for k, v in batch.items()}


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: Optional[Rules], *,
               grad_accum: int, opt_dtype: str, device: str = "cuda"):
    """Returns (fn, args): ``fn(*args)`` runs one step of the cell. Call
    under a fake mode: parameters, optimizer state and the decode cache are
    fake DTensors laid out by ``param_shardings`` on ``mesh`` (plain fake
    tensors with no mesh); the inputs are fake tensors every rank holds
    whole, as the JAX package's unsharded inputs (the model's ``constrain``
    lays them out)."""
    model = build_model(cfg, max_seq=shape.seq_len + 1)
    specs = model.param_specs()

    def state(spec_tree):
        sh = param_shardings(spec_tree, rules, mesh) if mesh is not None else None
        return _laid_out(abstract_state(spec_tree), sh, mesh, device)

    params = state(specs)
    inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
              for k, v in input_specs(cfg, shape).items()}

    def under_rules(step):
        def fn(*args):
            with use_rules(rules, mesh):
                return step(*args)
        return fn if mesh is not None else step

    if shape.kind == "train":
        opt = AdamW(AdamWConfig(state_dtype=opt_dtype))
        opt_state = state(opt.state_specs(specs))
        place = _place_batch(rules, mesh) if mesh is not None else None
        raw = make_train_step(model, opt, grad_accum=grad_accum, place_batch=place)
        return under_rules(raw), (params, opt_state, inputs)

    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, capacity=shape.seq_len)
        return under_rules(prefill), (params, inputs)

    # decode: a cache of depth seq_len, one new token at its last position
    cache = state(model.cache_specs(shape.global_batch, shape.seq_len))
    cache["pos"] = shape.seq_len - 1

    def decode(params, cache, token):
        with torch.no_grad():
            return model.decode(params, cache, token)
    return under_rules(decode), (params, cache, inputs["token"])


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: Optional[Rules], *,
               grad_accum: int, opt_dtype: str, device: str = "cuda",
               keep_ops: bool = False) -> Dict:
    """Build the cell on fake tensors and trace one step under a
    :class:`CostCounter` -> {"lower_s", "memory", "bytes_per_device",
    "flops_per_device", "bytes_accessed_per_device", "collectives", "ops"}
    (and "op_names" with ``keep_ops``)."""
    fake = TraceFakeMode()
    # DTensor warns of every two-step redistribution it plans; the counts say it
    quiet = logging.getLogger("torch.distributed.tensor._redistribute")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    with fake, contextlib.ExitStack() as restore:
        restore.callback(quiet.setLevel, level)
        fn, args = build_cell(cfg, shape, mesh, rules, grad_accum=grad_accum,
                              opt_dtype=opt_dtype, device=device)
        counter = CostCounter(fake_mode=fake, keep_ops=keep_ops)
        arg_tensors = _tensors(args)
        arg_bytes = counter.add_arguments(arg_tensors)
        memo, scans = VjpMemo(counter), ScanMemo(counter)
        t0 = time.perf_counter()
        ops.VJP_RUNNER, util.SCAN_RUNNER = memo, scans
        try:
            with counter:
                out = fn(*args)
        finally:
            ops.VJP_RUNNER = util.SCAN_RUNNER = None
        lower_s = time.perf_counter() - t0
        outs = _tensors(out)
        seen, out_bytes, alias_bytes = set(), 0, 0
        for t in outs:
            st = _local(t).untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            out_bytes += st.nbytes()
            if counter.aliases_argument(t):
                alias_bytes += st.nbytes()
        del out, outs, fn, args, arg_tensors
    rec = {
        "lower_s": round(lower_s, 3),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": counter.peak,
                   "alias_size_in_bytes": alias_bytes},
        # the arguments plus the peak of what the step allocates; an output
        # written in place into an argument (alias) adds nothing
        "bytes_per_device": arg_bytes + counter.peak,
        "flops_per_device": float(counter.flops),
        "bytes_accessed_per_device": float(counter.bytes),
        "bytes_accessed_convention": "each local op's input plus output bytes, no fusion; "
                                     "views and allocations move nothing",
        "collectives": counter.collectives_record(),
        "ops": counter.n_ops,
        "vjp_replays": memo.replays,
        "scan_replays": scans.replays,
    }
    if keep_ops:
        rec["op_names"] = counter.op_names
    return rec


def device_memory_bytes(device: str) -> Optional[int]:
    """The card's memory (``torch.cuda.mem_get_info``'s total), or None off
    the card."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info()[1])


# -------------------------------------------------------------------- one cell

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_preset: Optional[str] = None, grad_accum: Optional[int] = None,
             opt_dtype: Optional[str] = None, remat: Optional[str] = None,
             variant: str = "baseline", out_dir: str = "artifacts/dryrun",
             save_hlo: bool = False, probes: bool = True,
             rule_overrides: Optional[Dict] = None, device: str = "cuda",
             shape: Optional[ShapeSpec] = None, single_device: bool = False) -> Dict:
    """Trace one cell on the production mesh of the initialised fake world
    (:func:`repro_torch.launch.mesh.init_fake_world`) and write its record.
    ``shape`` replaces ``SHAPES[shape_name]``; ``single_device`` traces the
    cell on one device with no mesh (plain fake tensors, mesh tag
    ``single``)."""
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    if shape.name in cfg.skipped_shapes():
        raise SystemExit(f"cell ({arch}, {shape.name}) is assignment-skipped: "
                         f"{cfg.skipped_shapes()[shape.name]}")
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if single_device:
        mesh, rules, n_data, n_devices, tag, preset = None, None, 1, 1, "single", None
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        n_data = int(mesh.mesh.shape[-2])
        n_devices = int(mesh.mesh.numel())
        tag = mesh_tag(mesh)
        preset = rules_preset or default_rules_preset(cfg, shape)
        rules = make_rules(preset, mesh, **(rule_overrides or {}))
    ga = grad_accum if grad_accum is not None else default_grad_accum(cfg, shape, n_data)
    od = opt_dtype or default_opt_dtype(cfg)

    record: Dict = {
        "arch": arch, "shape": shape.name, "variant": variant,
        "mesh": tag, "n_devices": n_devices,
        "rules": preset, "grad_accum": ga, "opt_dtype": od,
        "remat": cfg.remat, "device": torch.device(device).type,
        "params_total": cfg.param_counts()["total"],
        "params_active": cfg.param_counts()["active"],
    }
    traced = trace_cell(cfg, shape, mesh, rules, grad_accum=ga, opt_dtype=od, device=device,
                        keep_ops=save_hlo)
    op_names = traced.pop("op_names", None)
    record.update(traced)
    record["device_memory_bytes"] = device_memory_bytes(device)
    if record["device_memory_bytes"] is not None:
        record["fits_device_memory"] = record["bytes_per_device"] <= record["device_memory_bytes"]

    # useful-model-FLOPs: 6*N*D per token (training does fwd+bwd; serve_step fwd only)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = record["params_active"]
    factor = 6.0 if shape.kind == "train" else 2.0
    record["model_flops_global"] = factor * n_active * tokens
    record["tokens"] = tokens
    record["analytic_flops_global"] = analytic_flops(cfg, shape, grad_accum=ga)

    # ---- cost probes: reduced-depth variants -> per-device costs by extrapolation
    if probes:
        def build_and_lower(pcfg, pga, micro):
            pshape = dataclasses.replace(shape, global_batch=micro * pga)
            p = trace_cell(pcfg, pshape, mesh, rules, grad_accum=pga, opt_dtype=od,
                           device=device)
            return p["flops_per_device"], p["bytes_accessed_per_device"], p["collectives"]

        t2 = time.perf_counter()
        pcost = probe_costs(build_and_lower, cfg, shape, ga)
        record["probe_s"] = round(time.perf_counter() - t2, 3)
        ext = pcost["extrapolated"]
        corr = pcost["slstm_correction"]
        ndev = record["n_devices"]
        record["costs_per_device"] = {
            "flops": ext["flops"] + corr["flops"] / ndev,
            "bytes": ext["bytes"] + corr["bytes"] / ndev,
            "collectives": {k: ext[k] for k in
                            ("all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all", "collective-permute", "coll_total")},
        }
        record["probe_detail"] = pcost["probes"]

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape.name}__{record['mesh']}__{variant}"
    (out / f"{name}.json").write_text(json.dumps(record, indent=2))
    if save_hlo:
        (out / f"{name}.ops.txt").write_text("\n".join(op_names) + "\n")
    return record


# ----------------------------------------------------------------- orchestrator

def _session_alive(sid: int) -> bool:
    """Whether a process of session ``sid`` still runs (``/proc/*/stat``
    field 6; zombies have exited)."""
    for path in Path("/proc").glob("[0-9]*/stat"):
        with contextlib.suppress(OSError, ValueError, IndexError):
            fields = path.read_text().rsplit(")", 1)[1].split()
            if int(fields[3]) == sid and fields[0] != "Z":
                return True
    return False


def _kill_session(proc: subprocess.Popen, wait_s: float = 10.0) -> None:
    """Kill every process of ``proc``'s session (it leads one), reap it, and
    wait until no process of the session runs (a kill is delivered
    asynchronously)."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()
    deadline = time.monotonic() + wait_s
    while _session_alive(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.02)


def cell_command(arch: str, shape_name: str, out_dir: str, multi_pod: bool,
                 device: str) -> List[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape_name, "--out", out_dir, "--device", device]
    if multi_pod:
        # multi-pod pass proves the 'pod' axis shards; roofline (probes)
        # is derived from the single-pod artifacts only
        cmd.extend(["--multi-pod", "--no-probes"])
    return cmd


def all_cells_cli(jobs: int, out_dir: str, multi_pod_also: bool, timeout: int,
                  device: str = "cuda", command=cell_command, poll_s: float = 2.0) -> int:
    """Run every runnable cell in subprocesses (isolation + parallelism).
    Each cell runs in a session of its own; on its timeout, and on the way
    out of this call (an exception or Ctrl-C included), the whole session is
    killed and reaped, so no cell process outlives the call."""
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name in cfg.shape_names():
            cells.append((arch, shape_name, False))
            if multi_pod_also:
                cells.append((arch, shape_name, True))
    procs: Dict[Tuple, Tuple[subprocess.Popen, float, object]] = {}
    failures = []
    done = 0
    pending = list(reversed(cells))
    t_start = time.time()
    try:
        while pending or procs:
            while pending and len(procs) < jobs:
                arch, shape_name, mp = pending.pop()
                tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                outp = Path(out_dir)
                outp.mkdir(parents=True, exist_ok=True)
                existing = list(outp.glob(
                    f"{arch}__{shape_name}__{'pod2x' if mp else 'data16x'}*__baseline.json"))
                if existing:
                    done += 1
                    print(f"[dryrun] skip (cached): {tag}")
                    continue
                log = open(outp / f"{tag}.log", "w")
                procs[(arch, shape_name, mp)] = (subprocess.Popen(
                    command(arch, shape_name, out_dir, mp, device), stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True), time.time(), log)
                print(f"[dryrun] launch: {tag} ({len(procs)} running, "
                      f"{len(pending)} queued, {done} done, {time.time()-t_start:.0f}s)")
            time.sleep(poll_s)
            for key, (p, t0, log) in list(procs.items()):
                rc = p.poll()
                if rc is None and time.time() - t0 > timeout:
                    _kill_session(p)
                    rc = -9
                if rc is not None:
                    _kill_session(p)           # what the cell left in its session
                    log.close()
                    del procs[key]
                    done += 1
                    if rc != 0:
                        failures.append((key, rc))
                        print(f"[dryrun] FAIL rc={rc}: {key}")
                    else:
                        print(f"[dryrun] ok: {key} ({time.time()-t0:.0f}s)")
    finally:
        for p, _, log in procs.values():
            _kill_session(p)
            log.close()
    print(f"[dryrun] finished {done} cells, {len(failures)} failures "
          f"in {time.time()-t_start:.0f}s")
    for f in failures:
        print("  FAILED:", f)
    return 1 if failures else 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--opt-dtype", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the traced local ops, one per line")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--moe-local", action="store_true",
                    help="per-data-shard MoE dispatch (hillclimb variant)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--multi-pod-also", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device of the fake tensors (cpu: the plain route)")
    args = ap.parse_args()

    if args.all:
        raise SystemExit(all_cells_cli(args.jobs, args.out, args.multi_pod_also,
                                       args.timeout, device=args.device))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to trace on the CPU")
    init_fake_world(512)
    try:
        rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       rules_preset=args.rules, grad_accum=args.grad_accum,
                       opt_dtype=args.opt_dtype, remat=args.remat,
                       variant=args.variant, out_dir=args.out, save_hlo=args.save_hlo,
                       probes=not args.no_probes, device=args.device,
                       rule_overrides={"moe_dispatch": "local"} if args.moe_local else None)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    skip = ("memory", "probe_detail")
    print(json.dumps({k: v for k, v in rec.items() if k not in skip}, indent=2))
    print("memory:", json.dumps(rec["memory"], indent=2))


if __name__ == "__main__":
    main()
