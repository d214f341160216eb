"""Which collectives gloo runs on CUDA tensors when several ranks share one
card, and which DTensor redistributions survive: one 4-process world per
probe (a crash kills its world, not the next probe).

    python3 tools/gloo_probe.py cuda      # on the GPU machine
    python3 tools/gloo_probe.py           # on the CPU

Each probe prints ``PROBE <name> ok`` (or ``ERR ...``) from rank 0, and
``WORLD <name> rcs [...]`` gives the four ranks' exit codes (-11: the rank
died of a segmentation fault). ``--staged`` runs the DTensor probes with
``repro_torch.launch.mesh``'s host staging installed, as the port's mesh
runs them.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

RAW = ["init", "cpu_all_reduce", "all_reduce", "broadcast", "all_gather_list",
       "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
       "raw_scatter_world", "raw_all_gather_subgroup"]
FUNCTIONAL = ["funcol_all_gather_world", "funcol_all_gather_subgroup",
              "funcol_reduce_scatter_world", "funcol_all_to_all_world"]
DTENSOR = ["dt_distribute_1d", "dt_local_then_gather_1d", "dt_shard_to_rep",
           "dt_partial_to_rep", "dt_partial_to_shard", "dt_shard0_to_shard1"]
WORLD = 4


def rank_main(rank: int, store_path: str, dev: str, name: str, staged: bool) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.ones(1, device="cuda")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD)
    if staged:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
        from repro_torch.launch.mesh import install_host_staging
        install_host_staging(log=lambda s: None)
    d = torch.device(dev)
    x = torch.ones(8, device=d) * (rank + 1)

    def pair_group():
        g1, g2 = dist.new_group([0, 1]), dist.new_group([2, 3])
        return g1 if rank < 2 else g2

    if name == "init":
        dist.barrier()
    elif name == "cpu_all_reduce":
        dist.all_reduce(x.cpu())
    elif name == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        assert float(y[0]) == 10
    elif name == "broadcast":
        dist.broadcast(x.clone(), 0)
    elif name == "all_gather_list":
        dist.all_gather([torch.empty_like(x) for _ in range(WORLD)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(8 * WORLD, device=d), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(2, device=d), x)
    elif name == "all_to_all_single":
        dist.all_to_all_single(torch.empty(8, device=d), x)
    elif name == "raw_scatter_world":
        chunks = list(torch.arange(8., device=d).chunk(WORLD)) if rank == 0 else None
        dist.scatter(torch.empty(2, device=d), chunks, src=0)
    elif name == "raw_all_gather_subgroup":
        dist.all_gather_into_tensor(torch.empty(16, device=d), x, group=pair_group())
    elif name == "funcol_all_gather_world":
        funcol.all_gather_tensor(x, 0, dist.group.WORLD).sum().item()
    elif name == "funcol_all_gather_subgroup":
        funcol.all_gather_tensor(x, 0, pair_group()).sum().item()
    elif name == "funcol_reduce_scatter_world":
        funcol.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD).sum().item()
    elif name == "funcol_all_to_all_world":
        funcol.all_to_all_single(x, None, None, dist.group.WORLD).sum().item()
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                              distribute_tensor)
        if name == "dt_distribute_1d":
            mesh = init_device_mesh(dev, (WORLD,))
            distribute_tensor(torch.arange(8., device=d), mesh, [Shard(0)]).to_local().sum()
        elif name == "dt_local_then_gather_1d":
            mesh = init_device_mesh(dev, (WORLD,))
            DTensor.from_local(x[:2], mesh, [Shard(0)]).full_tensor().sum().item()
        else:
            mesh = init_device_mesh(dev, (2, 2), mesh_dim_names=("data", "model"))
            t = torch.arange(64., device=d).reshape(8, 8)
            src, dst = {"dt_shard_to_rep": ([Shard(0), Shard(1)], [Replicate(), Replicate()]),
                        "dt_partial_to_rep": ([Replicate(), Partial()],
                                              [Replicate(), Replicate()]),
                        "dt_partial_to_shard": ([Replicate(), Partial()],
                                                [Replicate(), Shard(0)]),
                        "dt_shard0_to_shard1": ([Replicate(), Shard(0)],
                                                [Replicate(), Shard(1)])}[name]
            if any(isinstance(p, Partial) for p in src):
                a = DTensor.from_local(t / 2, mesh, src)
            else:
                a = distribute_tensor(t, mesh, src)
            got = a.redistribute(mesh, dst).full_tensor()
            assert torch.equal(got.cpu(), t.cpu()), name
    if dev == "cuda":
        torch.cuda.synchronize()
    if rank == 0:
        print("PROBE", name, "ok", flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    dev = "cuda" if "cuda" in sys.argv[1:] else "cpu"
    staged = "--staged" in sys.argv[1:]
    print("torch", torch.__version__, "CUDA", torch.version.cuda, "| device", dev,
          "| staged", staged, flush=True)
    for name in (DTENSOR if staged else RAW + FUNCTIONAL + DTENSOR):
        store = os.path.join(tempfile.mkdtemp(), "store")
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), store, dev, name,
                                   str(int(staged))], stderr=subprocess.PIPE, text=True)
                 for r in range(WORLD)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append("timeout")
        tail = [line for line in procs[0].stderr.read().splitlines()
                if "Warning" not in line and "return func" not in line][-2:]
        print("WORLD", name, "rcs", rcs, f"{time.time() - t0:.1f}s", " | ".join(tail)[:400],
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        try:
            rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
                      sys.argv[6] == "1")
        except Exception as e:
            if sys.argv[2] == "0":
                print("PROBE", sys.argv[5], "ERR", type(e).__name__,
                      str(e)[:300].replace("\n", " "), flush=True)
            sys.exit(1)
        sys.exit(0)
    sys.exit(main())
