#!/usr/bin/env python3
"""Where a compiled serve program rounds otherwise than the eager one, on one
CUDA GPU.

    python3 tools/compiled_rounding.py [--device cpu --reduced]

On ``chip_smoke.py``'s xlstm deployment (xlstm-1.3b at full width, one
period of 8 blocks, batch 4, prompt 512, 2 decode steps; random weights from
the spec's seed, as deploy makes them; the prompt ``example_tokens(seed=1)``):

1. every aten op of the head program's graph (prefill and first token), its
   first call's inputs captured from an eager run of the exported graph,
   compiled alone by Inductor (``torch.compile``) and held against eager:
   bit-identical or not, the elements that differ, the largest difference;
   under ``compile_cache.AOTI_OPTIONS`` and, for an op that differs, with
   each of Inductor's ``eager_numerics`` options this torch has turned on;
2. the head program compiled by ``compile_cache.compile_package``, with and
   without those options: its prefill logits against eager's (bit-identical,
   rel L2, first-token agreement); and the serve program with them: its tokens
   against eager's on the prompt;
3. the compiled-package cache key of the serve program traced on the weights
   (as deploy traces it) and on fake tensors after an eager run (as
   ``TraceCompile`` does): which parts differ, and the first differing line.

The first line is the card's name and power limit. It needs one CUDA device
and a host compiler for AOTInductor (``chip_smoke.inductor_toolchain``
picks it), and exits non-zero without a device. ``--device cpu --reduced``
runs the same steps on the CPU at the reduced xlstm config (batch 2, prompt
16), to check the script itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# ops that only move, view or check their input: nothing to round
SKIP = ("getitem", "_assert_tensor_metadata", "view", "reshape", "select", "slice",
        "unsqueeze", "squeeze", "expand", "permute", "transpose", "numpy_T", "alias",
        "detach", "unbind", "stack", "cat", "full", "zeros", "new_zeros", "empty",
        "arange", "copy_", "clone", "repro_torch")


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def first_diff(a: str, b: str) -> str:
    for i, (x, y) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != y:
            return f"line {i}: {x.strip()[:200]!r} vs {y.strip()[:200]!r}"
    return f"lengths {len(a.splitlines())} vs {len(b.splitlines())}"


def plain(x):
    """``x`` with fx's immutable containers as lists and dicts, and its
    tensors cloned."""
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x.clone() if hasattr(x, "clone") else x


def main() -> int:
    import numpy as np
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reduced", action="store_true")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("compiled_rounding: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from torch._inductor import config as inductor_config
    from torch.utils import _pytree

    from repro_torch.configs import get_config, register
    from repro_torch.core import compile_cache
    from repro_torch.core.artifact import FunctionSpec
    from repro_torch.core.boot import export_on_fakes
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.deploy import make_head_fn, make_serve_fn
    from repro_torch.kernels import _cuda
    from repro_torch.models import build_model

    def config_items() -> dict:
        return {k: repr(v) for k, v in inductor_config.get_config_copy().items()}

    if device.type == "cuda":
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip())
    numerics = sorted(k for k in inductor_config.get_config_copy()
                      if k.startswith("eager_numerics."))
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} | eager_numerics options: "
        f"{numerics}")
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="compiled_rounding_"))
    compile_cache.enable_inductor_disk_cache(work / "inductor")
    try:
        if device.type == "cuda":
            log(chip_smoke.inductor_toolchain(torch, work))
            _cuda.build()
            _cuda.library()
        xlstm = get_config("xlstm-1.3b")
        register(chip_smoke.XLSTM_ARCH)(lambda: dataclasses.replace(
            xlstm, n_layers=chip_smoke.XLSTM_PERIODS * xlstm.ssm.slstm_every))
        spec = FunctionSpec(**chip_smoke.XLSTM_SPEC)
        if args.reduced:
            spec = FunctionSpec(arch="xlstm-1.3b", reduced=True, batch_size=2, prompt_len=16,
                                decode_steps=2)
        cfg = get_config(spec.arch)
        cfg = cfg.reduced() if spec.reduced else cfg
        model = build_model(cfg, max_seq=spec.prompt_len + spec.decode_steps)
        params = model.init(torch.Generator(device=device).manual_seed(spec.seed))
        shape = (spec.batch_size, spec.prompt_len)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, shape, dtype=np.int32)).to(device)
        zero = torch.zeros(shape, dtype=torch.int32, device=device)
        head_fn, serve_fn = make_head_fn(model, spec), make_serve_fn(model, spec)

        # ---- 3 first: deploy's trace happens before any eager run
        real = torch.export.export(make_serve_fn(model, spec), (params, zero))
        with inductor_config.patch(compile_cache.compile_options()):
            parts_real = compile_cache.package_key_parts(real)
            config_real = config_items()
        del real

        # ---- 1: single ops
        head = torch.export.export(head_fn, (params, tokens))
        sig = head.graph_signature.input_specs
        user = iter(_pytree.tree_leaves(((params, tokens), {})))
        flat = [next(user) if s.kind.name == "USER_INPUT" else
                (head.constants.get(s.target) if s.target in head.constants
                 else head.state_dict[s.target]) for s in sig]
        picked = {}

        class Capture(torch.fx.Interpreter):
            def run_node(self, n):
                name = str(n.target)
                if n.op == "call_function" and name not in picked and \
                        not any(k in name for k in SKIP):
                    args, kwargs = self.fetch_args_kwargs_from_env(n)
                    picked[name] = (n.target, plain((args, kwargs)))
                return super().run_node(n)

        with torch.inference_mode():
            Capture(head.graph_module).run(*flat)
        del head, flat
        log(f"head graph: {len(picked)} ops to hold against eager: {sorted(picked)}")

        def compiled_alone(target, args, kwargs, options):
            leaves, spec_ = _pytree.tree_flatten((args, kwargs))
            where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

            def fn(*ts):
                vals = list(leaves)
                for i, t in zip(where, ts):
                    vals[i] = t
                a, k = _pytree.tree_unflatten(vals, spec_)
                return target(*a, **k)

            torch._dynamo.reset()
            with inductor_config.patch(options):
                return torch.compile(fn, backend="inductor", fullgraph=True, dynamic=False)(
                    *[leaves[i] for i in where])

        def compare(got, want) -> str:
            got, want = _pytree.tree_leaves(got), _pytree.tree_leaves(want)
            out = []
            for g, w in zip(got, want):
                if not isinstance(w, torch.Tensor):
                    continue
                if w.dtype.is_floating_point:
                    d = (g.float() - w.float()).abs()
                    out.append(f"{tuple(w.shape)} {w.dtype}: bit-identical {torch.equal(g, w)}, "
                               f"{int((g != w).sum())} of {w.numel()} differ, max |diff| "
                               f"{d.max().item():.3g}")
                else:
                    out.append(f"{tuple(w.shape)} {w.dtype}: equal {torch.equal(g, w)}")
            return "; ".join(out)

        base = dict(compile_cache.AOTI_OPTIONS)
        eager_opts = dict(base, **{k: True for k in numerics})
        with torch.inference_mode():
            for name, (target, (args, kwargs)) in sorted(picked.items()):
                want = target(*args, **kwargs)
                got = compiled_alone(target, args, kwargs, base)
                line = compare(got, want)
                log(f"{name} alone, compile_package's options: {line}")
                if "bit-identical False" in line and numerics:
                    for k in numerics + ["all"]:
                        opts = eager_opts if k == "all" else dict(base, **{k: True})
                        log(f"{name} alone, + {k}: "
                            f"{compare(compiled_alone(target, args, kwargs, opts), want)}")
        del picked
        torch._dynamo.reset()

        # ---- 2: the programs through compile_package
        with torch.inference_mode():
            _, want_logits, _ = head_fn(params, tokens)
            want_tokens = serve_fn(params, tokens)
            want_zero = serve_fn(params, zero)
        variants = [("compile_package's options", {})]
        if numerics:
            variants.append(("+ every eager_numerics option", {k: True for k in numerics}))
        for label, extra in variants:
            with inductor_config.patch(extra):
                t = time.perf_counter()
                program = CompileCache.load_package(compile_cache.compile_package(
                    torch.export.export(head_fn, (params, tokens)), disable_caches=True))
                log(f"head program, {label}: compile {time.perf_counter() - t:.1f} s")
            with torch.inference_mode():
                _, got, _ = program(params, tokens)
            g, w = got.float(), want_logits.float()
            agree = (g.argmax(-1) == w.argmax(-1)).float().mean().item()
            log(f"head program, {label}: prefill logits bit-identical "
                f"{torch.equal(got, want_logits)}, rel_l2 {chip_smoke.rel_l2(g, w):.4g}, max "
                f"|diff| {(g - w).abs().max().item():.3g}, first-token agreement {agree:.2f}")
            del program
        if numerics:
            with inductor_config.patch({k: True for k in numerics}):
                t = time.perf_counter()
                program = CompileCache.load_package(compile_cache.compile_package(
                    torch.export.export(serve_fn, (params, zero)), disable_caches=True))
                log(f"serve program, + every eager_numerics option: compile "
                    f"{time.perf_counter() - t:.1f} s")
            with torch.inference_mode():
                got, got_zero = program(params, tokens), program(params, zero)
            log(f"serve program, + every eager_numerics option: tokens equal eager's on the "
                f"prompt {torch.equal(got, want_tokens)} ({got.tolist()} vs "
                f"{want_tokens.tolist()}), on zeros {torch.equal(got_zero, want_zero)}")
            del program

        # ---- 3: the trace on fakes after eager runs
        dep = types.SimpleNamespace(device=device, abstract_params=model.param_specs,
                                    abstract_tokens_for=lambda rows: shape, serve_fn=serve_fn,
                                    model=model, spec=spec)
        with inductor_config.patch(compile_cache.compile_options()):
            parts_fake = compile_cache.package_key_parts(export_on_fakes(dep))
            config_fake = config_items()
        differ = [k for k in parts_real if parts_real[k] != parts_fake[k]]
        log(f"package key, weights vs fakes: parts that differ {differ}" + "".join(
            f" | {k}: {first_diff(parts_real[k], parts_fake[k])}" for k in differ if k != "config"))
        if "config" in differ:
            log("Inductor options that changed between the two traces: " + "; ".join(
                f"{k}: {config_real.get(k)!r} -> {config_fake.get(k)!r}"[:300]
                for k in sorted(set(config_real) | set(config_fake))
                if config_real.get(k) != config_fake.get(k)))
    finally:
        compile_cache.disable_inductor_disk_cache()
        shutil.rmtree(work, ignore_errors=True)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
