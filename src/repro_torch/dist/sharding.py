"""Shape-aware sharding rules: logical axes -> mesh axes -> DTensor placements.

Port of ``repro.dist.sharding``. A :class:`Rules` object is a *preset* (a
logical-axis -> mesh-axis mapping) bound to a concrete mesh, and
``Rules.spec(axes, shape)`` turns the logical axes of one tensor into a
spec, one entry per tensor dim in the form of JAX's ``PartitionSpec``
(None, a mesh-axis name, or a tuple of names), with the JAX package's three
invariants:

* **divisibility** — a mesh axis (or mesh-axis product) is only assigned to a
  dim it divides evenly; otherwise the dim stays replicated and the mesh axis
  remains available for a later dim (*fall-through*, e.g. ``kv_heads=2`` can't
  take ``model=16`` so ``head_dim`` picks it up);
* **tuple-target prefixes** — a mapping value like ``("pod", "data")`` means
  "shard over as long a prefix of these axes as fits": the full product if it
  divides, else a shorter prefix, else nothing. Axes absent from the mesh
  (or of size 1) are dropped first, so the same preset works on single-pod
  and multi-pod meshes;
* **no mesh-axis reuse** — within one spec every mesh axis appears at most
  once.

:func:`placements` turns a spec into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh``, laying shards out across
devices as JAX's ``NamedSharding`` does: a tuple target shards its tensor dim
over those mesh dims with the first name the most major.

The module also carries the execution context (``use_rules`` /
``active_rules`` / ``current_mesh``), the ``constrain`` annotation (the
identity outside a context, so single-device paths and every exported
program are untouched), and the ParamSpec-tree derivations
``abstract_state`` (meta tensors) and ``param_shardings`` (placements), with
:func:`distribute_tree` to lay a tree out from rank 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

# a mapping value: replicate / one mesh axis / a prefix-tuple of mesh axes
Target = Union[None, str, Tuple[str, ...]]
# one spec entry per tensor dim, as a PartitionSpec holds them
Spec = Tuple[Target, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    name: str
    mapping: Dict[str, Any]
    mesh_axes: Tuple[str, ...]
    mesh_axis_sizes: Dict[str, int]

    # ------------------------------------------------------------------- spec
    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
        """Spec for a tensor with the given logical axes and shape."""
        if len(axes) != len(shape):
            raise ValueError(f"rank mismatch: axes {axes} vs shape {shape}")
        used: set = set()
        return tuple(self._assign(name, int(dim), used) for name, dim in zip(axes, shape))

    def _assign(self, name: Optional[str], dim: int, used: set):
        target = self.mapping.get(name) if name is not None else None
        if target is None:
            return None
        if isinstance(target, str):
            target = (target,)
        # drop axes the mesh doesn't have (or that are trivial / already taken)
        avail = [ax for ax in target
                 if self.mesh_axis_sizes.get(ax, 1) > 1 and ax not in used]
        for k in range(len(avail), 0, -1):
            prefix = avail[:k]
            prod = 1
            for ax in prefix:
                prod *= self.mesh_axis_sizes[ax]
            if dim % prod == 0:
                used.update(prefix)
                return prefix[0] if k == 1 else tuple(prefix)
        return None


# ------------------------------------------------------------------- presets
#
# Logical axes in play (see models/layers.py, models/moe.py, transformer.py):
#   activations: batch seq embed ffn vocab heads head_dim kv_seq kv_heads
#   params:      layers embed ffn vocab heads_flat kv_flat experts expert_ffn
# Mesh axes: pod (cross-DCI pure DP) / data / model.
#
# Non-axis keys (consumed elsewhere): "moe_dispatch" ("global" | "local",
# read by models/moe.py to pick per-data-shard dispatch).

_TRAIN: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "layers": None, "seq": None, "embed": None, "head_dim": None,
    "kv_seq": None,
    "ffn": "model", "heads_flat": "model", "kv_flat": "model",
    "vocab": "model", "heads": "model", "kv_heads": "model",
    "experts": "model", "expert_ffn": "model",
    "moe_dispatch": "global",
}

_SERVE_TP: Dict[str, Any] = {
    "batch": "data",
    "layers": None, "seq": None, "embed": None, "kv_seq": None,
    "ffn": "model", "heads_flat": "model", "kv_flat": "model",
    "vocab": "model", "heads": "model", "kv_heads": "model",
    "head_dim": "model",          # fall-through when kv_heads < model size
    "experts": "model", "expert_ffn": "model",
    "moe_dispatch": "global",
}

PRESETS: Dict[str, Dict[str, Any]] = {
    # training: DP over (pod, data); TP/EP over model; grads reduce over pod+data
    "train": dict(_TRAIN),
    # training with 2D expert parallelism: experts over data, expert mlp over
    # model (the 384-expert Kimi layout — see models/moe.py)
    "train_ep2d": {**_TRAIN, "experts": "data", "expert_ffn": "model"},
    # serving, tensor-parallel weights, data-parallel batch
    "serve_tp": dict(_SERVE_TP),
    # serving for models too big to replicate over data: 2D weight sharding
    "serve_2d": {**_SERVE_TP, "batch": None, "embed": "data",
                 "vocab": ("model", "data")},
    # long-context decode: the KV cache sequence dim is sharded over model and
    # merged with distributed flash decoding (repro_torch.dist.flash_decode)
    "serve_seqkv": {**_SERVE_TP, "kv_seq": "model", "kv_heads": None,
                    "heads": None, "head_dim": None},
}


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(PRESETS))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a ``DeviceMesh``."""
    return tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.mesh.shape)


def make_rules(preset: str, mesh, **overrides) -> Rules:
    """Bind a preset (plus per-run overrides, e.g. ``moe_dispatch="local"``)
    to a concrete mesh."""
    if preset not in PRESETS:
        raise KeyError(f"unknown rules preset {preset!r}; have {preset_names()}")
    mapping = dict(PRESETS[preset])
    mapping.update(overrides)
    names, sizes = mesh_axes(mesh)
    return Rules(preset, mapping, names, dict(zip(names, sizes)))


# ---------------------------------------------------------------- placements

def placements(rules: Rules, mesh, axes: Sequence[Optional[str]],
               shape: Sequence[int]) -> tuple:
    """DTensor placements (one per mesh dim) for a tensor with the given
    logical axes and shape: ``Shard(i)`` on every mesh dim that the spec
    gives tensor dim ``i``, ``Replicate()`` elsewhere.

    A tuple target shards one tensor dim over several mesh dims, the first
    name the most major, as ``NamedSharding`` lays it out. DTensor splits a
    dim over its mesh dims in mesh order, so a tuple in mesh order is plain
    ``Shard``s; a pair against mesh order (``("model", "data")`` on a
    ``(data, model)`` mesh) shards the minor mesh dim first, written as a
    ``_StridedShard`` on the other."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names, sizes = mesh_axes(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for dim, part in enumerate(rules.spec(axes, shape)):
        if part is None:
            continue
        parts = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(p) for p in parts]
        if idx == sorted(idx):
            for j in idx:
                out[j] = Shard(dim)
        elif len(idx) == 2:
            major, minor = idx
            out[minor] = _StridedShard(dim, split_factor=sizes[major])
            out[major] = Shard(dim)
        else:
            raise NotImplementedError(f"spec {part} against mesh order {names}")
    return tuple(out)


# ------------------------------------------------------------------- context

class _Context(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_ctx = _Context()


# DTensor's implicit replication is one flag per process, and leaving its
# context clears it: only the outermost of nested (or concurrent) contexts
# sets and clears it
_REPLICATION = {"depth": 0, "lock": threading.Lock()}


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication
    with _REPLICATION["lock"]:
        _REPLICATION["depth"] += 1
        outermost = _REPLICATION["depth"] == 1
    try:
        with implicit_replication() if outermost else contextlib.nullcontext():
            yield
    finally:
        with _REPLICATION["lock"]:
            _REPLICATION["depth"] -= 1


@contextlib.contextmanager
def use_rules(rules: Optional[Rules], mesh):
    """Activate (rules, mesh) for the dynamic extent, so ``constrain`` calls
    inside model code resolve against them. With a mesh, a plain tensor that
    meets a DTensor in an op counts as replicated (DTensor's implicit
    replication): position ids, masks and rotary tables are made where they
    are used, as under ``jit``. Contexts nest."""
    _ctx.stack.append((rules, mesh))
    try:
        if mesh is None:
            yield
        else:
            with _implicit_replication():
                yield
    finally:
        _ctx.stack.pop()


def active_rules() -> Optional[Rules]:
    return _ctx.stack[-1][0] if _ctx.stack else None


def current_mesh():
    return _ctx.stack[-1][1] if _ctx.stack else None


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:             # the single-device paths: no import, no lookup
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(x: torch.Tensor, mesh):
    """A tensor every rank holds whole, as a DTensor (a DTensor as it is)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_shape_and_offset(shape: Sequence[int], mesh, target: Sequence) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` laid out as ``target`` on ``mesh``. DTensor's helper computes
    the offsets with small index tensors (torch 2.13); they are made with
    every dispatch mode off, so that under the dry run's fake tensors they
    stay real and the counter does not count them."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return compute_local_shape_and_global_offset(tuple(shape), mesh, list(target))


def pad_sharded(x, shape: Sequence[int], target: tuple, mesh):
    """``x`` (a DTensor, or a tensor every rank holds whole) zero-padded at
    the end of each dim to ``shape`` and laid out as ``target``, with no
    collective beyond gathering the dims that grow (DTensor has no padding
    rule for a sharded dim): each rank builds its own shard of the result
    and copies in the part of ``x`` that falls in it."""
    from torch.distributed.tensor import DTensor, Replicate

    shape = tuple(int(c) for c in shape)
    grow = [d for d in range(len(shape)) if x.shape[d] != shape[d]]
    src_pl = [Replicate() if p.is_shard() and p.dim in grow else p for p in target]
    src = replicated(x, mesh).redistribute(mesh, src_pl).to_local()
    local_shape, offset = local_shape_and_offset(shape, mesh, target)
    out = src.new_zeros(local_shape)
    dst_idx, src_idx = [], []
    for d in range(len(shape)):
        if d in grow:                     # src holds all of x's extent on this dim
            n = max(0, min(offset[d] + local_shape[d], x.shape[d]) - offset[d])
            dst_idx.append(slice(0, n))
            src_idx.append(slice(offset[d], offset[d] + n))
        else:
            dst_idx.append(slice(None))
            src_idx.append(slice(None))
    out[tuple(dst_idx)] = src[tuple(src_idx)]
    return DTensor.from_local(out, mesh, list(target), run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def unflatten_last(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` [..., prod(dims)] reshaped to [..., *dims] (a head split). A
    DTensor sharded on its last dim over mesh dims whose size the first new
    dim does not divide (24 heads over 16 ranks) is gathered along that dim
    first: DTensor refuses to split such a dim, where XLA reshards it."""
    shape = (*x.shape[:-1], *dims)
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last, ways = x.dim() - 1, 1
        for p, size in zip(x.placements, x.device_mesh.shape):
            if p.is_shard(last):
                ways *= size
        if dims[0] % ways:
            x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(last) else p
                                               for p in x.placements])
    return x.reshape(shape)


def grad_laid_out(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; a DTensor passed through a redistribution to its own
    placements, whose backward lays the incoming gradient out as ``x`` is
    laid out. A gradient that arrives as a partial sum over the model axis
    (the input gradient of a projection sharded along its contracted dim)
    is all-reduced there, where XLA reduces it, and not carried on into the
    products of the layer below, which DTensor would then run on gathered,
    whole weights."""
    if is_dtensor(x):
        x = x.redistribute(x.device_mesh, x.placements)
    return x


def flatten_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., a, b] reshaped to [..., a * b] (heads merged), its
    gradient laid out as the result is (:func:`grad_laid_out`): a gradient
    sharded along the merged dim in a way the heads do not divide (the
    output projection's, 24 heads over 16 ranks) could not be split back
    into heads."""
    return grad_laid_out(x.reshape(*x.shape[:-2], -1))


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Sharding annotation by logical axis names. The identity (returns ``x``
    itself) outside a ``use_rules`` context; inside one, ``x`` redistributed
    to the spec's placements (a plain tensor counts as replicated). A spec
    that shards nothing leaves ``x`` alone, as the JAX package's does."""
    rules, mesh = active_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"constrain rank mismatch: {axes} vs {tuple(x.shape)}")
    if all(part is None for part in rules.spec(axes, x.shape)):
        return x        # a replicated constraint would *forbid* sharding
    target = placements(rules, mesh, axes, x.shape)
    x = replicated(x, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


# ----------------------------------------------------- ParamSpec derivations

def _is_param_spec(leaf) -> bool:
    # duck-typed to avoid importing repro_torch.models.layers
    return (hasattr(leaf, "shape") and hasattr(leaf, "dtype")
            and hasattr(leaf, "axes") and hasattr(leaf, "init"))


def abstract_state(specs):
    """ParamSpec tree -> meta tensors of the same shapes and dtypes (no
    allocation)."""
    from repro_torch import pytree
    return pytree.tree_map(lambda s: torch.empty(tuple(s.shape), dtype=s.dtype, device="meta"),
                           specs, is_leaf=_is_param_spec)


def param_shardings(specs, rules: Rules, mesh):
    """ParamSpec tree -> a tree of placements (one tuple per leaf)."""
    from repro_torch import pytree
    return pytree.tree_map(lambda s: placements(rules, mesh, s.axes, s.shape),
                           specs, is_leaf=_is_param_spec)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def distribute_tree(tree, shardings, mesh, device=None, src_rank: Optional[int] = 0):
    """Lay out each tensor of ``tree`` as ``shardings`` (a tree of placements,
    as :func:`param_shardings` gives) says: rank ``src_rank``'s values are
    scattered, so the ranks hold one tensor whatever each had; with
    ``src_rank=None`` each rank keeps its own slice of what it holds (no
    collective: every rank read the same file). A plain leaf goes to
    ``device`` first (one leaf at a time); a DTensor leaf is redistributed."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import pytree

    def put(x, pl):
        if is_dtensor(x):
            return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
        if device is not None:
            x = x.to(device)
        return distribute_tensor(x, mesh, list(pl), src_data_rank=src_rank)

    return pytree.tree_map(lambda pl, x: put(x, pl), shardings, tree, is_leaf=_is_placements)


def full_tree(tree):
    """Every DTensor leaf of ``tree`` gathered whole (a collective: every
    rank calls it); plain tensors as they are."""
    from repro_torch import pytree
    return pytree.tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)
