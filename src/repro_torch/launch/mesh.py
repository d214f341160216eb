"""Device meshes over a ``torch.distributed`` world (port of
``repro.launch.mesh``).

:func:`init_world` starts the process group and picks its backend, and says
which one it picked:

* ``nccl`` when each rank has a CUDA card of its own;
* ``gloo`` when the ranks run on the CPU;
* ``gloo`` with host staging when the ranks share a card. NCCL refuses two
  ranks on one device. gloo takes CUDA tensors, but its functional
  all-gather, which DTensor's redistributions call, crashed the process on
  the H100 (``tools/gloo_probe.py``), so the port stages DTensor's
  collectives of CUDA tensors through host memory itself
  (:func:`install_host_staging`) and counts what they move.

:func:`make_mesh` lays a ``DeviceMesh`` with named axes over the world.

:func:`make_production_mesh` lays the reference's production mesh, (16, 16)
over ``("data", "model")`` or (2, 16, 16) over ``("pod", "data", "model")``,
over the first 256 or 512 ranks of the world. The dry run
(``repro_torch.launch.dryrun``) lays it over :func:`init_fake_world`'s world:
``torch.distributed``'s fake process group, in which this one process is
rank 0 of 256 or 512 ranks and no collective sends anything.
"""
from __future__ import annotations

import datetime
from typing import Callable, Sequence

import torch


def pick_backend(device: str, world_size: int) -> str:
    """The backend for ``world_size`` ranks on ``device`` ("cpu" or "cuda")."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


# The functional collectives DTensor's redistributions call. gloo's CUDA
# path crashed the process on the first of them on the H100
# (``tools/gloo_probe.py``); all four are staged, so that every byte DTensor
# moves is counted in one place (gloo's own CUDA path copies through host
# memory too).
STAGED_OPS = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
              "all_to_all_single")
_STAGING = []


def install_host_staging(log: Callable[[str], None] = print) -> None:
    """Replace the CUDA kernels of :data:`STAGED_OPS` (``_c10d_functional``)
    by ones that run the op's CPU kernel on a host copy and copy the result
    back, counting each call in ``dist.collectives.WIRE`` (once per
    process). The plain ``torch.distributed`` calls are not affected."""
    if _STAGING:
        return
    from repro_torch.dist.collectives import WIRE, nbytes

    lib = torch.library.Library("_c10d_functional", "IMPL")
    functional = torch.ops._c10d_functional

    def staged(name, wire):
        op = getattr(functional, name)

        def run(input, *args):
            out = functional.wait_tensor(op(input.cpu(), *args))
            WIRE.add(name + " (staged)", wire(input, out))
            return out.to(input.device)
        return run

    impls = {"all_gather_into_tensor": staged("all_gather_into_tensor",
                                              lambda i, o: nbytes(o)),
             "all_reduce": staged("all_reduce", lambda i, o: 2 * nbytes(i)),
             "reduce_scatter_tensor": staged("reduce_scatter_tensor", lambda i, o: nbytes(i)),
             "all_to_all_single": staged("all_to_all_single",
                                         lambda i, o: nbytes(i) + nbytes(o))}
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "overriding a previously registered kernel"
        for name in STAGED_OPS:
            lib.impl(name, impls[name], "CUDA")
    _STAGING.append(lib)
    log(f"[mesh] staging {', '.join(STAGED_OPS)} of CUDA tensors through host memory")


def init_world(rank: int, world_size: int, *, store_path: str, device: str = "cuda",
               timeout_s: float = 300.0, log: Callable[[str], None] = print) -> str:
    """Start the default process group over a ``FileStore`` at
    ``store_path`` (a file every rank can reach; no port is opened) with
    :func:`pick_backend`'s choice, which is logged and returned. On CUDA the
    rank's device is ``cuda:(rank % device_count)``."""
    import torch.distributed as dist

    backend = pick_backend(device, world_size)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    shared = torch.device(device).type == "cuda" and backend == "gloo"
    if rank == 0:
        why = ("one CUDA card per rank" if backend == "nccl" else
               f"{world_size} ranks share {torch.cuda.device_count()} CUDA card(s)" if shared
               else "ranks on the CPU")
        log(f"[mesh] backend {backend} ({why})")
    if shared:
        install_host_staging(log if rank == 0 else (lambda _s: None))
    return backend


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    initialised world (ranks laid out row-major, as ``jax.make_mesh`` lays
    out devices), with the custom ops' DTensor sharding rules registered."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    ops.register_op_shardings()
    return init_device_mesh(torch.device(device).type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def init_fake_world(world_size: int) -> None:
    """Start ``torch.distributed``'s fake process group (backend ``"fake"``
    over a ``FakeStore``): this process is rank 0 of ``world_size`` ranks,
    no other process is started and no collective sends anything. Tear it
    down with ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh: (16, 16) over ``("data", "model")``,
    or with ``multi_pod`` (2, 16, 16) over ``("pod", "data", "model")``
    (``pod`` an outer pure data-parallel axis), laid row-major over ranks
    0..255 or 0..511 of the initialised world (:func:`init_fake_world`'s for
    the dry run), with the custom ops' DTensor sharding rules registered."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels import ops
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() < n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    ops.register_op_shardings()
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def mesh_tag(mesh) -> str:
    return "x".join(f"{n}{int(s)}" for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape))
