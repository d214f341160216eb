#!/usr/bin/env python3
"""Run the PyTorch port's cold-start serve path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, compute capability; then build the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc.
2. Kernels vs plain: each kernel against its plain PyTorch version on CUDA
   tensors, at the serve path's shapes and at edge cases (ragged lengths,
   q_offset, bidirectional, length 0 and S, NaN past length), with
   kernel / plain / library times (CUDA events) and the least time the card
   could take (``bound_ms``).
3. Path: ``deploy`` full-width llama3.2-3b (bf16, 28 layers, random weights
   from the spec's seed) on the GPU, then serve 3 cold requests through the
   ``unikernel`` driver (boot -> run -> exit), counting kernel launches; time
   each boot track alone; then hold the kernel path's prefill logits and the
   plain path's, on the same weights, against the plain path in float32.
4. A ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA device and the repository around it (it imports
``src/repro_torch``); without either it exits non-zero before printing a
result.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12            # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12              # f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}

SPEC = dict(arch="llama3.2-3b", reduced=False, batch_size=4, prompt_len=512, decode_steps=16)
N_REQUESTS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- phase 2

def check_flash(torch, F, fa, ref, gen, case, timed: bool):
    B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").to(dt)
    out = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    exp = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    err = (out.float() - exp.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
    row = {"case": list(case), "max_abs_err": err, "ok": ok}
    if timed:
        pairs = sum(min(max(q_offset + i + 1, 0), Skv) if causal else Skv for i in range(Sq))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * B * Hq * D * pairs, rate)
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset), 50)
        row["plain_ms"] = time_ms(torch, lambda: ref.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 50)
    return row


def check_decode(torch, F, da, ref, gen, case, timed: bool):
    B, S, Hq, Hkv, D, lengths, dtype = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lengths):            # cache slots past length hold NaN
        kc[b, n:] = float("nan")
        vc[b, n:] = float("nan")
    out = da.decode_attention(q, kc, vc, length)
    exp = ref.decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    err = (out.float() - exp.float()).abs().max().item()
    zero_rows_exact = all(bool((out[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
    ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype] and zero_rows_exact
    row = {"case": [B, S, Hq, Hkv, D, list(lengths), dtype], "max_abs_err": err, "ok": ok}
    if timed:
        live = sum(min(n, S) for n in lengths)
        nbytes = (2 * q.numel() + 2 * live * Hkv * D) * q.element_size() + 4 * B
        rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * Hq * D * live, rate)
        row["ms"] = time_ms(torch, lambda: da.decode_attention(q, kc, vc, length), 200)
        row["plain_ms"] = time_ms(torch, lambda: ref.decode_attention(q, kc, vc, length), 20)
        mask = (torch.arange(S, device="cuda")[None, :] < length[:, None])[:, None, None, :]
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)
    return row


# ------------------------------------------------------------------------ main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch import pytree
    from repro_torch.core.artifact import FunctionSpec
    from repro_torch.core.boot import streamed_device_put
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.deploy import deploy
    from repro_torch.core.drivers import UnikernelDriver
    from repro_torch.core.metrics import Timeline, now
    from repro_torch.core.snapshot import SnapshotStore
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {kind} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"capability {cap[0]}.{cap[1]} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"kernels: {lib_path} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc in this run: {_cuda.build_seconds:.2f} s)")

    # ---- phase 2: kernels vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_main = (4, 512, 512, 24, 8, 128, True, 0, "bfloat16")
    flash_cases = [flash_main,
                   (2, 77, 77, 24, 8, 128, True, 0, "bfloat16"),      # ragged
                   (2, 64, 192, 24, 8, 128, True, 128, "bfloat16"),   # q_offset
                   (2, 128, 128, 24, 8, 128, False, 0, "bfloat16"),   # bidirectional
                   (1, 96, 96, 6, 3, 64, True, 0, "bfloat16"),
                   (2, 200, 200, 4, 2, 32, True, 0, "float32"),
                   (2, 130, 130, 24, 8, 128, False, 0, "float32")]
    decode_main = (4, 528, 24, 8, 128, [528, 528, 528, 528], "bfloat16")
    decode_cases = [decode_main,
                    (4, 528, 24, 8, 128, [0, 528, 300, 517], "bfloat16"),
                    (3, 100, 4, 4, 32, [1, 0, 100], "bfloat16"),
                    (2, 264, 24, 8, 128, [1, 200], "float32"),
                    (2, 64, 8, 2, 64, [64, 17], "float32")]
    results = {}
    for name, check, cases, main_case, mod in (
            ("flash_attention", check_flash, flash_cases, flash_main, fa),
            ("decode_attention", check_decode, decode_cases, decode_main, da)):
        rows = [check(torch, F, mod, ref, gen, c, timed=(c is main_case)) for c in cases]
        for r in rows:
            log(f"{name} {r['case']}: max_abs_err {r['max_abs_err']:.3g} "
                f"{'ok' if r['ok'] else 'FAIL'}")
        main = rows[0]
        log(f"{name} at the path's shape: kernel_ms {main['ms']:.4f} plain_ms "
            f"{main['plain_ms']:.4f} library_ms {main['library_ms']:.4f} bound_ms "
            f"{main['bound_ms']:.4f} ({main['bound_by']})")
        bad = [r["case"] for r in rows if not r["ok"]]
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version on {bad}")
        results[name] = main

    # ---- phase 3: the serve path, full width
    spec = FunctionSpec(**SPEC)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        dep = deploy(spec, CompileCache(work / "programs"), SnapshotStore(work / "snapshots"),
                     str(work), device="cuda")
        m = dep.image.manifest
        cfg = dep.model.cfg
        log(f"deploy {spec.name}: {time.perf_counter() - t0:.1f} s | {m.param_count} params | "
            f"program {m.program_bytes} B | snapshot {m.snapshot_bytes} B | "
            f"{cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}")
        tokens = torch.from_numpy(dep.example_tokens(seed=1)).cuda()
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": cfg.n_layers * spec.decode_steps}
        driver = UnikernelDriver()
        ops.reset_launch_counts()
        for r in range(N_REQUESTS):
            before = ops.launch_counts()
            tl = Timeline()
            tl.t_start_begin = now()
            ex = driver.start(dep, tl)
            tl.t_exec_begin = now()
            out = ex.run(tokens, timeline=tl)
            tl.t_done = now()
            after = ops.launch_counts()
            grew = {k: after[k] - before[k] for k in after}
            stages = " ".join(f"{k} {v:.3f}" for k, v in tl.stage_s.items())
            log(f"request {r + 1}: boot [{stages}] t_boot_wall {tl.t_boot_wall:.3f} s | "
                f"execution {tl.execution:.3f} s | launches {grew} | tokens {out.tolist()}")
            if grew != want:
                raise AssertionError(f"launches per request {grew}, expected {want}")
            if tuple(out.shape) != (spec.batch_size, spec.decode_steps) \
                    or out.dtype != torch.int32 or not bool(((out >= 0) &
                                                            (out < cfg.vocab_size)).all()):
                raise AssertionError(f"bad output {out.shape} {out.dtype}")
            if r < N_REQUESTS - 1:
                driver.finish(dep, ex)
        launches = ops.launch_counts()

        # each boot track alone, to see what the overlap hides (the last
        # executor keeps its weights meanwhile)
        key = dep.image.key
        t0 = now()
        host = dep.snapshots.load_host(key)
        t1 = now()
        dev = streamed_device_put(host, "cuda")
        t2 = now()
        del host, dev
        t3 = now()
        dep.load_program()
        t4 = now()
        log(f"tracks alone: weights restore_weights_host {t1 - t0:.3f} s + device_put "
            f"{t2 - t1:.3f} s ({m.snapshot_bytes / (t2 - t1) / 1e9:.2f} GB/s) | program "
            f"fetch+deserialize {t4 - t3:.3f} s")

        # Same weights (the last executor's): the kernel path, the plain path,
        # and the plain path in float32 as the reference. Two bf16 paths drift
        # apart over 28 layers by bf16 rounding alone, so the gate is that the
        # kernel path is no less accurate than the plain bf16 path: its
        # relative L2 error against the f32 logits is at most twice the plain
        # path's. A wrong kernel would be off by orders of magnitude.
        params = ex.params
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"), dep.model.max_seq)
        batch = {"tokens": tokens}
        with torch.inference_mode():
            lk, _ = dep.model.prefill(params, batch, capacity=spec.prompt_len)
            with ops.impl_scope("plain"):
                lp, _ = dep.model.prefill(params, batch, capacity=spec.prompt_len)
                out_plain = dep.serve_fn(params, tokens)
                params32 = pytree.tree_map(lambda t: t.float(), params)
                l32, _ = model32.prefill(params32, batch, capacity=spec.prompt_len)
                del params32
        driver.finish(dep, ex)
        lk, lp = lk.float(), lp.float()

        def rel_l2(a, b) -> float:
            return ((a - b).norm() / b.norm()).item()

        err_k, err_p = rel_l2(lk, l32), rel_l2(lp, l32)
        ak, ap = lk.argmax(-1), lp.argmax(-1)
        gaps = [(lp[r, ap[r]] - lp[r, ak[r]]).item() for r in range(lp.shape[0]) if ak[r] != ap[r]]
        log(f"prefill logits vs the f32 plain path: rel_l2 kernel path {err_k:.4g}, plain bf16 "
            f"path {err_p:.4g} (gate: kernel <= 2 x plain) | kernel vs plain bf16: "
            f"max_abs_err {(lk - lp).abs().max().item():.4g} (max |logit| "
            f"{lp.abs().max().item():.4g}), rel_l2 {rel_l2(lk, lp):.4g} | first-token "
            f"agreement {(ak == ap).float().mean().item():.3f} (plain-logit gap where they "
            f"differ: {gaps}) | greedy-token agreement {(out_plain == out).float().mean().item():.3f}")
        if not (bool(torch.isfinite(lk).all()) and err_k <= 2.0 * err_p):
            raise AssertionError("kernel path's prefill logits are less accurate than the plain "
                                 "path's")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- phase 4: report
    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:33"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:35")}
    kernels = []
    for name, r in results.items():
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
