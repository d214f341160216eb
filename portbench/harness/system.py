"""The system under test, and the only module of the benchmark that imports
the program: ``repro_torch``'s ``Gateway`` with one deployed function.

The configuration file's cut is registered with the port under the file's
name (its depth and ``rope_theta`` on the port's registered architecture,
whose widths must equal the file's), deployed with weights made on the
device from the run's seed, and every host's tiers are filled by warm-up
invocations before the window opens."""
from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
from concurrent.futures import Future, wait

import numpy as np


def arch_config(cfg: dict, reduced: bool = False):
    """The port's ``ArchConfig`` of configuration file ``cfg``: its
    registered architecture (``port_arch``) cut to the file's depth and given
    the file's ``rope_theta``; raises where a width differs from the file's.
    ``reduced``: the port's own tiny cut of it, as ``deploy`` of a reduced
    spec builds it (the CPU tests)."""
    from repro_torch.configs.base import get_config
    cut = dataclasses.replace(get_config(cfg["port_arch"]), name=cfg["name"],
                              n_layers=cfg["num_hidden_layers"],
                              rope_theta=float(cfg["rope_theta"]))
    run = cut.reduced() if reduced else cut
    want = {"d_model": cfg["hidden_size"], "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg["num_key_value_heads"], "d_ff": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"], "n_layers": cfg["num_hidden_layers"],
            "tie_embeddings": cfg["tie_word_embeddings"], "dtype": cfg["serve_dtype"],
            "resolved_head_dim": cfg["hidden_size"] // cfg["num_attention_heads"]}
    got = {k: getattr(run, k) for k in want}
    if got != want:
        raise ValueError(f"{cfg['name']}: the port runs {got}, the file states {want}")
    return cut


class System:
    def __init__(self, cfg: dict, workload: dict, seed: int, device: str,
                 reduced: bool = False) -> None:
        from repro_torch.configs.base import register
        from repro_torch.core import FunctionSpec, Gateway
        cut = arch_config(cfg, reduced)
        register(cfg["name"])(lambda: cut)
        fn = cfg["function"]
        self.spec = FunctionSpec(arch=cfg["name"], batch_size=fn["batch_size"],
                                 prompt_len=fn["prompt_len"],
                                 decode_steps=fn["decode_steps"], reduced=reduced, seed=seed)
        self.device = device
        self.work_dir = tempfile.mkdtemp(prefix="portbench_")
        gw = workload["gateway"]
        self.gw = Gateway(n_hosts=gw["n_hosts"], slots_per_host=gw["slots_per_host"],
                          mode="cold", work_dir=self.work_dir, device=device)
        self.dep = self.gw.deploy(self.spec)
        self.name = self.spec.name
        self.threads_before = None
        threads = workload.get("intra_op_threads")
        if threads is not None:
            import torch
            self.threads_before = torch.get_num_threads()
            torch.set_num_threads(int(threads))

    def invoke(self, tokens: np.ndarray, label: str) -> Future:
        return self.gw.invoke_async(self.name, tokens, label=label)

    def warm_up(self, tokens: np.ndarray, min_waves: int = 2, max_waves: int = 4) -> int:
        """Send waves of as many invocations as the gateway has slots, at
        least ``min_waves``, until every host's program and chunk tiers hold
        the image. The first wave fills the tiers from the store; the
        window's boots all restore from the tiers, a path that the second
        wave is the first to run, on every slot's thread at the highest
        concurrency the window reaches. Returns the invocations sent."""
        hosts = self.gw.cluster.hosts
        slots = sum(h.n_slots for h in hosts)
        key = self.dep.program_key()
        sent = 0
        for wave in range(max_waves):
            futs = [self.invoke(tokens, "warmup") for _ in range(slots)]
            wait(futs)
            for f in futs:
                f.result()                        # a failed warm-up fails the run
            sent += len(futs)
            if wave + 1 >= min_waves and all(
                    h.cache.programs.contains(key) and h.cache.snapshots.contains(key)
                    for h in hosts):
                return sent
        raise RuntimeError(f"after {sent} warm-up invocations a host's tiers still miss "
                           f"the image {key}")

    def timeline(self, label: str):
        tls = self.gw.recorder.timelines(label)
        return tls[0] if tls else None

    def counters(self) -> dict:
        from repro_torch.core import compile_cache
        from repro_torch.kernels import ops
        res = self.gw.resilience_summary()
        return {"launches": ops.launch_counts(),
                "package_cache": dict(compile_cache.counters()),
                "hedges": self.gw.dispatcher.hedges_launched,
                "retries": res["retries"], "attempts": res["attempts"],
                "deploy_s": self.dep.build_s, "image_bytes": self.dep.image.manifest.snapshot_bytes}

    def close(self) -> None:
        """Stop the gateway and free what it held on the device."""
        import torch
        self.gw.shutdown()
        self.gw = self.dep = None
        gc.collect()
        if self.threads_before is not None:
            torch.set_num_threads(self.threads_before)
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        shutil.rmtree(self.work_dir, ignore_errors=True)


