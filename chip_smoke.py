#!/usr/bin/env python3
"""Run the PyTorch port's cold-start serve path (llama3.2-3b, xlstm-1.3b and
jamba-1.5-large) and its continuous-batching decode tier on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, compute capability, SM count and maximum SM clock; then build
   the hand-written kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   and log what ptxas reports (registers, shared memory, spills) for the
   flash, mLSTM, decode and paged decode kernels.
2. Kernels vs plain: each kernel against its plain PyTorch version on CUDA
   tensors, at the paths' shapes and at edge cases (ragged lengths,
   q_offset, bidirectional, length 0 and S, NaN past length, jamba's 64/8
   heads for flash and decode and the decode tier's admit (B = 1) for
   flash, timed too; for flash also rows that fill no 64-row block, Skv no
   multiple of the key tile, a diagonal tile partly visible at q_offset, MHA
   and bf16 at D = 32, and the host cost of its TMA tensor maps; for both
   decode kernels every group size of the registered configs (G = 5, 6, 7,
   12 at D = 128 in bf16 and f32), two row tiles of heads (G = 17), lengths
   at the edges of the 64-key splits, a rerun bit-identical, and the plain
   version in the kernels' split order beside the plain one; for the paged
   kernel also a second page layout, bit-identical, NaN in the null and
   unmapped pages, f32, MQA/GQA at D=64, page sizes 8 and 32, and in every
   case bit-identical to the contiguous kernel on the same logical cache;
   for the mLSTM kernel padding, S shorter than a chunk, a carried
   state, f32, the reduced dims (with a carried state in bf16), large input
   gates and S one step past one and two chunks; for the selective
   scan ragged S, S = 1, S past a chunk, a carried state, f32, the reduced
   dims, a channel count that is no multiple of the block, and decays that
   underflow to 0), with kernel / plain / library times (CUDA events
   around back-to-back calls: ``ms``, ``plain_ms``, ``library_ms``), the
   device alone (``device_ms``, ``library_device_ms``: 200 calls captured
   in one CUDA graph and replayed), the wrapper's host time per call
   (``host_us``), and the least time the card could take (``bound_ms``;
   for the scan the larger of its bytes and its exponentials at the SM
   clock).
3. Path: ``deploy`` full-width llama3.2-3b (bf16, its depth cut to 8 of
   28 layers for the time limit, random weights from the spec's seed) on the
   GPU, then serve 2 cold requests through the ``unikernel`` driver (boot ->
   run -> exit), counting kernel launches; time each boot track alone; then
   hold every kernel call of a kernel-path prefill against its plain version
   on the same inputs, and the kernel path's prefill logits and the plain
   path's, on the same weights, against the plain path in float32 (its
   weights read from the snapshot once the executor has exited).
3b. Decode tier, on phase 3's deployment: ``ensure_decode(slots=8,
   page_size=16)`` (export, save, load, verify the admit and step
   programs), then a ``DecodeScheduler`` on a one-host ``Cluster`` serves 12
   requests of 512 prompt tokens submitted in one burst, budgets cycling
   through 16, 3, 7, 16, 1, 5; checks every budget, one boot and one
   cool-down, and launches (flash = L x admits, paged = L x steps, no
   contiguous decode); then holds one admit call (its logits and the K/V it
   wrote) and one step call, each replayed on clones of the pool it saw
   mid-run, kernel route and plain route, against the plain route in float32.
3c. The xlstm serve path, after llama's deployment is freed: ``deploy``
   full-width xlstm-1.3b (bf16, its depth cut to 2 of 6 periods of 7 mLSTM
   + 1 sLSTM for the time limit, random weights from the spec's seed), then
   phase 3's checks: 3 cold requests (14 mLSTM launches each, no
   attention), each boot track alone,
   every mLSTM call of a kernel-path prefill against its plain version, and
   the prefill-logit gate against the plain path in float32.
3d. The jamba serve path, after xlstm's deployment is freed: ``deploy``
   full-width jamba-1.5-large cut to one period of 8 layers (7 Mamba + 1
   attention, MoE on every other layer) and 4 of its 16 experts (top-2),
   16.2 B parameters, 32.5 GB in bf16; then phase 3's checks: 2 cold requests
   (7 selective-scan, 1 flash and 16 decode launches each), each boot track
   alone, every scan and flash call of a kernel-path prefill against its
   plain version, and the prefill-logit gate. Each path logs its peak device
   memory, and the free disk and host memory before its deploy.
4. A ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA device and the repository around it (it imports
``src/repro_torch``); without either it exits non-zero before printing a
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
MUFU_PER_CLOCK_PER_SM = 16          # exponentials (ex2) per clock per SM, Hopper
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
GRAPH_CALLS = 200                   # wrapper calls captured in one CUDA graph (device_ms)

LLAMA_LAYERS = 8                    # of 28: the llama paths' depth, cut for the time limit
LLAMA_ARCH = f"llama3.2-3b:{LLAMA_LAYERS}L"
SPEC = dict(arch=LLAMA_ARCH, reduced=False, batch_size=4, prompt_len=512, decode_steps=16)
XLSTM_PERIODS = 2                   # of 6: the xlstm path's depth, cut for the time limit
XLSTM_ARCH = f"xlstm-1.3b:{XLSTM_PERIODS}P"
XLSTM_SPEC = dict(SPEC, arch=XLSTM_ARCH)
LLAMA_REQUESTS = 2                  # 3 before the xlstm phase; cut for the time limit
XLSTM_REQUESTS = 3
# jamba-1.5-large at full width, cut to one period of 8 layers (7 Mamba + 1
# attention) and 4 of its 16 experts (top-2 kept) to fit one card twice over
JAMBA_ARCH = "jamba-1.5-large-398b:8L4E"
JAMBA_SPEC = dict(SPEC, arch=JAMBA_ARCH)
JAMBA_REQUESTS = 2
# mLSTM outputs, and every kernel call of a path's prefill, are held against
# the plain version by max |got - want| / max(1, max |want|), since an mLSTM
# row whose normaliser is small is large: bf16 outputs within 2e-2, f32
# outputs (the mLSTM state among them) within 1e-4
SCALED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
DECODE_SLOTS, PAGE_SIZE = 8, 16
DECODE_BUDGETS = [16, 3, 7, 16, 1, 5]
N_DECODE_REQUESTS = 12


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


def graph_ms(torch, fn, calls: int = GRAPH_CALLS, replays: int = 3) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph (their allocations come from the graph's pool), the graph replayed
    ``replays`` times between CUDA events, so no host time is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def host_us(torch, fn, calls: int = GRAPH_CALLS) -> float:
    """Host time per call of ``fn`` (the wrapper's checks, allocations and
    launches) with the device left to run behind."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def timings(torch, kernel, iters: int, plain, plain_iters: int, library=None) -> dict:
    """A timed row's times: ``ms`` (CUDA events around ``iters`` back-to-back
    wrapper calls), ``device_ms`` (graph replay), the wrapper's ``host_us``,
    ``plain_ms``, and the one PyTorch call's ``library_ms`` and
    ``library_device_ms`` (None where there is none)."""
    row = {"ms": time_ms(torch, kernel, iters), "device_ms": graph_ms(torch, kernel),
           "host_us": host_us(torch, kernel), "plain_ms": time_ms(torch, plain, plain_iters)}
    row["library_ms"] = None if library is None else time_ms(torch, library, iters)
    row["library_device_ms"] = None if library is None else graph_ms(torch, library)
    return row


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def ptxas_lines(lib_path, sources=("flash_attention.cu", "mlstm.cu", "decode_attention.cu",
                                    "paged_decode_attention.cu")) -> list:
    """The ``ptxas -v`` lines (entry, registers, shared memory, spills) of
    ``sources`` in the build log next to the library."""
    path = Path(lib_path).parent / "build.log"
    if not path.exists():
        return ["no build.log beside the library"]
    out, keep = [], False
    for line in path.read_text().splitlines():
        if line.startswith("== "):
            keep = any(src in line for src in sources)
            if keep:
                out.append(line)
        elif keep and any(w in line for w in ("Compiling entry", "registers", "spill")):
            out.append(line.strip())
    return out


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
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row.update(timings(
            torch, lambda: fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset), 50,
            lambda: ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset), 5,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=True)))
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
    again = da.decode_attention(q, kc, vc, length)
    exp = ref.decode_attention(q, kc, vc, length)
    split_order = ref.decode_attention_splits(q, kc, vc, length)
    torch.cuda.synchronize()
    err = (out.float() - exp.float()).abs().max().item()
    split_err = (out.float() - split_order.float()).abs().max().item()
    zero_rows_exact = all(bool((out[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
    rerun_bitwise = bool(torch.equal(out, again))
    ok = bool(torch.isfinite(out).all()) and max(err, split_err) <= TOL[dtype] and \
        zero_rows_exact and rerun_bitwise
    row = {"case": [B, S, Hq, Hkv, D, list(lengths), dtype], "max_abs_err": err,
           "vs_split_order_max_abs_err": split_err, "rerun_bitwise": rerun_bitwise, "ok": ok}
    if timed:
        live = sum(min(n, S) for n in lengths)
        nbytes = (2 * q.numel() + 2 * live * Hkv * D) * q.element_size() + 4 * B
        rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * Hq * D * live, rate)
        mask = (torch.arange(S, device="cuda")[None, :] < length[:, None])[:, None, None, :]
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        row.update(timings(
            torch, lambda: da.decode_attention(q, kc, vc, length), 200,
            lambda: ref.decode_attention(q, kc, vc, length), 20,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True)))
    return row


def paged_layout(torch, kc, vc, lengths, page_size, null_fill, perm_seed):
    """Scatter a logical cache [B, S, Hkv, D] into a page pool [1 + B*S/ps, ps,
    Hkv, D] under page ids permuted by ``perm_seed`` (None: in order). Each row
    maps ceil(len / ps) pages; its other table entries and the null page 0
    hold ``null_fill``. Returns (k_pages, v_pages, table)."""
    B, S, Hkv, D = kc.shape
    mp = S // page_size
    P = 1 + B * mp
    ids = torch.arange(1, P)
    if perm_seed is not None:
        ids = ids[torch.randperm(P - 1, generator=torch.Generator().manual_seed(perm_seed))]
    kp = torch.full((P, page_size, Hkv, D), null_fill, dtype=kc.dtype, device="cuda")
    vp = torch.full_like(kp, null_fill)
    table = torch.zeros((B, mp), dtype=torch.int32)
    for b, n in enumerate(lengths):
        live = -(-min(n, S) // page_size)
        pages = ids[b * mp:b * mp + live]
        table[b, :live] = pages.to(torch.int32)
        kp[pages.cuda()] = kc[b].reshape(mp, page_size, Hkv, D)[:live]
        vp[pages.cuda()] = vc[b].reshape(mp, page_size, Hkv, D)[:live]
    return kp, vp, table.cuda()


def check_paged(torch, F, pda, da, ref, gen, case, timed: bool):
    """The paged kernel against its plain version; the same logical cache under
    another page layout, and through the contiguous decode kernel, must give
    bit-identical output; NaN past each length (in the last page, in unmapped
    pages and in the null page) must not leak; length-0 rows are exactly 0."""
    B, page_size, mp, Hq, Hkv, D, lengths, dtype = case
    dt = getattr(torch, dtype)
    S = mp * page_size
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    for b, n in enumerate(lengths):            # logical positions past length hold NaN
        kc[b, n:] = float("nan")
        vc[b, n:] = float("nan")
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kp, vp, table = paged_layout(torch, kc, vc, lengths, page_size, float("nan"), 1)
    kp2, vp2, table2 = paged_layout(torch, kc, vc, lengths, page_size, float("nan"), None)
    out = pda.paged_decode_attention(q, kp, vp, table, length)
    out2 = pda.paged_decode_attention(q, kp2, vp2, table2, length)
    exp = ref.paged_decode_attention(q, kp, vp, table, length)
    torch.cuda.synchronize()
    err = (out.float() - exp.float()).abs().max().item()
    layout_bitwise = bool(torch.equal(out, out2))
    # the two kernels share one split and merge whose order depends only on
    # logical positions, so the paged kernel must give the contiguous one's bits
    contig = da.decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    vs_contiguous_bitwise = bool(torch.equal(out, contig))
    zero_rows_exact = all(bool((out[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
    ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype] and zero_rows_exact \
        and layout_bitwise and vs_contiguous_bitwise
    row = {"case": [B, page_size, mp, Hq, Hkv, D, list(lengths), dtype], "max_abs_err": err,
           "layout_bitwise": layout_bitwise, "vs_contiguous_bitwise": vs_contiguous_bitwise,
           "vs_contiguous_max_abs_err": (out.float() - contig.float()).abs().max().item(),
           "ok": ok}
    if timed:
        live = sum(min(n, S) for n in lengths)
        nbytes = (2 * q.numel() + 2 * live * Hkv * D) * q.element_size() + 4 * (table.numel() + B)
        rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * Hq * D * live, rate)
        # no one PyTorch call computes it: a gather of the chains, then masked SDPA
        mask = (torch.arange(S, device="cuda")[None, :] < length[:, None])[:, None, None, :]
        tl = table.long()

        def library():
            kg = kp[tl].reshape(B, S, Hkv, D).transpose(1, 2)
            vg = vp[tl].reshape(B, S, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask,
                                                  enable_gqa=True)
        row.update(timings(
            torch, lambda: pda.paged_decode_attention(q, kp, vp, table, length), 200,
            lambda: ref.paged_decode_attention(q, kp, vp, table, length), 20, library))
    return row


def flat_tensors(x) -> list:
    return [x] if hasattr(x, "dtype") else [t for y in x for t in flat_tensors(y)]


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1.0)).item()


def check_mlstm(torch, mk, ref, gen, case, timed: bool):
    """The mLSTM kernel against ``ref.mlstm_chunked``. Gates are drawn like the
    model's: i ~ N(0, 1) (x ``i_scale``), f ~ N(0, 1) + 3 (``f_bias``). With
    ``split``, the kernel runs the first ``split`` steps, then the rest from
    the state it returned, against one long plain pass."""
    B, S, H, Dk, Dv, dtype, i_scale, split = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, Dk, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, H, Dk, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, H, Dv, generator=gen, device="cuda").to(dt)
    ig = i_scale * torch.randn(B, S, H, generator=gen, device="cuda")
    fg = torch.randn(B, S, H, generator=gen, device="cuda") + 3.0
    if split:
        h1, st = mk.mlstm(q[:, :split].contiguous(), k[:, :split].contiguous(),
                          v[:, :split].contiguous(), ig[:, :split], fg[:, :split])
        h2, state = mk.mlstm(q[:, split:].contiguous(), k[:, split:].contiguous(),
                             v[:, split:].contiguous(), ig[:, split:], fg[:, split:], st)
        h = torch.cat([h1, h2], dim=1)
    else:
        h, state = mk.mlstm(q, k, v, ig, fg)
    exp_h, exp_state = ref.mlstm_chunked(q, k, v, ig, fg)
    torch.cuda.synchronize()
    err_h = scaled_err(h, exp_h)
    err_state = [scaled_err(a, b) for a, b in zip(state, exp_state)]
    finite = bool(torch.isfinite(h).all()) and all(bool(torch.isfinite(t).all()) for t in state)
    ok = finite and err_h <= SCALED_TOL[dtype] and max(err_state) <= SCALED_TOL["float32"]
    row = {"case": list(case), "max_abs_err": (h.float() - exp_h.float()).abs().max().item(),
           "max_abs_err_C_n_m": [(a - b).abs().max().item() for a, b in zip(state, exp_state)],
           "scaled_err_h": err_h, "scaled_err_C_n_m": err_state, "ok": ok}
    if timed:
        c = 64                                    # the kernel's chunk
        nchunks = -(-S // c)
        nbytes = (q.numel() + k.numel() + v.numel() + h.numel()) * q.element_size() + \
            4 * (ig.numel() + fg.numel() + sum(t.numel() for t in state))
        flops = 2.0 * (2 * c * c * Dk + c * c * Dv + 2 * c * Dk * Dv) * nchunks * B * H
        rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, rate)
        # no single PyTorch call computes the chunkwise mLSTM: no library time
        row.update(timings(torch, lambda: mk.mlstm(q, k, v, ig, fg), 20,
                           lambda: ref.mlstm_chunked(q, k, v, ig, fg), 3))
    return row


def check_scan(torch, F, ss, ref, gen, case, timed: bool, exp_per_s: float):
    """The selective-scan kernel against ``ref.selective_scan``. Inputs are
    drawn like the model's: x, b, c ~ N(0, 1) in ``dtype``; dt =
    softplus(N(0, 1)) x ``dt_scale`` in f32 (a scale of 1e4 underflows every
    decay to 0); a_log = log(1..Ds) + 0.1 N(0, 1) (the S4D-real init, jittered);
    d_skip ~ N(0, 1). With ``split``, the kernel runs the first ``split``
    steps, then the rest from the state it returned, against one long plain
    pass. ``exp_per_s`` is the card's rate of exponentials (special-function
    units), for the bound."""
    B, S, Di, Ds, dtype, split, dt_scale = case
    dt_ = getattr(torch, dtype)
    x = torch.randn(B, S, Di, generator=gen, device="cuda").to(dt_)
    dt = F.softplus(torch.randn(B, S, Di, generator=gen, device="cuda")) * dt_scale
    a_log = torch.log(torch.arange(1, Ds + 1, device="cuda", dtype=torch.float32)) + \
        0.1 * torch.randn(Di, Ds, generator=gen, device="cuda")
    b = torch.randn(B, S, Ds, generator=gen, device="cuda").to(dt_)
    c = torch.randn(B, S, Ds, generator=gen, device="cuda").to(dt_)
    d_skip = torch.randn(Di, generator=gen, device="cuda")
    if split:
        y1, h1 = ss.selective_scan(x[:, :split], dt[:, :split], a_log, b[:, :split],
                                   c[:, :split], d_skip)
        y2, h = ss.selective_scan(x[:, split:], dt[:, split:], a_log, b[:, split:],
                                  c[:, split:], d_skip, h1)
        y = torch.cat([y1, y2], dim=1)
    else:
        y, h = ss.selective_scan(x, dt, a_log, b, c, d_skip)
    exp_y, exp_h = ref.selective_scan(x, dt, a_log, b, c, d_skip)
    torch.cuda.synchronize()
    err_y, err_h = scaled_err(y, exp_y), scaled_err(h, exp_h)
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    ok = finite and y.dtype == x.dtype and err_y <= SCALED_TOL[dtype] and \
        err_h <= SCALED_TOL["float32"]
    row = {"case": list(case), "max_abs_err": (y.float() - exp_y.float()).abs().max().item(),
           "max_abs_err_h": (h - exp_h).abs().max().item(), "scaled_err_y": err_y,
           "scaled_err_h": err_h, "ok": ok}
    if timed:
        nbytes = sum(t.numel() * t.element_size() for t in (x, dt, a_log, b, c, d_skip, y, h))
        exps = float(B * S * Di * Ds)
        row["bound_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_exp_ms"] = exps / exp_per_s * 1e3
        row["bound_ms"], row["bound_by"] = bound(nbytes, exps, exp_per_s)
        # no single PyTorch call computes the selective scan: no library time
        row.update(timings(torch, lambda: ss.selective_scan(x, dt, a_log, b, c, d_skip), 50,
                           lambda: ref.selective_scan(x, dt, a_log, b, c, d_skip), 3))
    return row


# -------------------------------------------------------------------- phase 3b

CAPTURE_STEP = 4                    # the step whose inputs the numeric gate replays
CAPTURE_ADMIT = 8                   # the admit it replays: a backfill beside live rows


def decode_tier(torch, dep) -> dict:
    """Phase 3b: the continuous-batching decode tier at full width on ``dep``.
    Returns the kernel launches of the burst."""
    import numpy as np
    from repro_torch import pytree
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.decode import DecodeConfig, DecodeScheduler
    from repro_torch.core.deploy import make_admit_fn, make_step_fn
    from repro_torch.core.metrics import Recorder, now
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg, spec = dep.model.cfg, dep.spec
    L = cfg.n_layers
    t0 = now()
    bundle = dep.ensure_decode(DECODE_SLOTS, PAGE_SIZE)
    pool_gb = 2 * L * bundle.n_pages * bundle.page_size * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2 / 1e9
    log(f"ensure_decode: {now() - t0:.1f} s [" +
        " ".join(f"{k} {v:.2f}" for k, v in bundle.build_s.items()) +
        f"] | slots {bundle.slots} page_size {bundle.page_size} max_pages "
        f"{bundle.max_pages} n_pages {bundle.n_pages} | pools {pool_gb:.3f} GB")

    # Observe the bundle's two programs without changing them: each call's
    # device-synchronised wall time, and a copy of the inputs and logits of
    # one mid-run call of each for the numeric gates.
    calls = {"admit": [], "step": []}
    at = {"admit": CAPTURE_ADMIT, "step": CAPTURE_STEP}
    captured = {"admit": {}, "step": {}}

    def observed(kind, program):
        def run(params, *args):
            cap = captured[kind]
            take = len(calls[kind]) == at[kind]
            if take:
                cap["params"] = params
                cap["args"] = [a.clone() for a in args]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = program(params, *args)
            torch.cuda.synchronize()
            calls[kind].append(time.perf_counter() - t)
            if take:
                cap["logits"] = out[0].clone()
            return out
        return run

    sched = DecodeScheduler(dep, Cluster(n_hosts=1), Recorder(),
                            DecodeConfig(slots=DECODE_SLOTS, page_size=PAGE_SIZE))
    sched.bundle = dataclasses.replace(bundle, admit=observed("admit", bundle.admit),
                                       step=observed("step", bundle.step))
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (N_DECODE_REQUESTS, 1, spec.prompt_len), dtype=np.int32)
    budgets = [DECODE_BUDGETS[i % len(DECODE_BUDGETS)] for i in range(N_DECODE_REQUESTS)]
    ops.reset_launch_counts()
    t0 = now()
    futs = [sched.submit(p, max_new=b, label=f"decode{i}")
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    outs = [f.result(900) for f in futs]
    t_served = now()
    sched.close()
    launches = ops.launch_counts()

    s = sched.summary()
    tl = sched.recorder.timelines("decode0")[0]
    stages = " ".join(f"{k} {v:.3f}" for k, v in tl.stage_s.items())
    admit_s, step_s = sum(calls["admit"]), sum(calls["step"])
    loop_s = t_served - t0 - tl.t_boot_wall
    log(f"decode tier: {N_DECODE_REQUESTS} requests, budgets {budgets} | boot [{stages}] "
        f"t_boot_wall {tl.t_boot_wall:.3f} s | served in {t_served - t0:.3f} s "
        f"(boot excluded: {loop_s:.3f} s) | admits {sched.admits} x "
        f"{1e3 * admit_s / max(len(calls['admit']), 1):.2f} ms | steps {sched.steps} x "
        f"{1e3 * step_s / max(len(calls['step']), 1):.2f} ms = "
        f"{len(calls['step']) / step_s if step_s else 0.0:.1f} steps/s | host rest of the loop "
        f"{loop_s - admit_s - step_s:.3f} s | tokens {int(s['tokens_generated'])} | occupancy "
        f"{s['occupancy']:.3f} | pages high-water {int(s['pages_high_water'])} of "
        f"{bundle.n_pages - 1} | admit waits {int(s['admit_waits'])} | boots {int(s['boots'])} "
        f"cooldowns {int(s['cooldowns'])} | launches {launches}")
    for i, (b, out) in enumerate(zip(budgets, outs)):
        if out.shape != (b,) or out.dtype != np.int32 or not ((out >= 0) &
                                                              (out < cfg.vocab_size)).all():
            raise AssertionError(f"decode request {i}: {out!r}, expected {b} tokens")
    if s["boots"] != 1 or s["cooldowns"] != 1:
        raise AssertionError(f"boots {s['boots']} cooldowns {s['cooldowns']}, expected 1 and 1")
    want = {"flash_attention": L * sched.admits, "decode_attention": 0,
            "paged_decode_attention": L * sched.steps, "mlstm": 0, "selective_scan": 0}
    if launches != want or sched.admits != N_DECODE_REQUESTS:
        raise AssertionError(f"decode tier launches {launches} (admits {sched.admits}, "
                             f"steps {sched.steps}), expected {want}")

    # Numeric gates, as for the prefill logits: one admit and one step program
    # call, each on clones of the pool it saw mid-run, by the kernel route and
    # the plain route, each against the plain route in float32 on the same
    # inputs (one boot, so both calls saw the same weights). The admit is held
    # by its logits and by the K/V it wrote into the prompt's pages, the step
    # by its live rows' logits.
    params = captured["step"]["params"]
    tokens_a, kp_a, vp_a, ids = captured["admit"]["args"]
    prompt_pages = ids[:-(-spec.prompt_len // bundle.page_size)].long()
    kp, vp, table, pos, tok = captured["step"]["args"]
    live = (table != 0).any(dim=1)

    def replay_admit(admit, prm, k, v):
        with torch.inference_mode():
            lg, k, v = admit(prm, tokens_a, k.clone(), v.clone(), ids)
            return [lg.float(), k[:, prompt_pages].float(), v[:, prompt_pages].float()]

    def replay_step(step, prm, k, v):
        with torch.inference_mode():
            return [step(prm, k.clone(), v.clone(), table, pos, tok)[0][live].float()]

    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), dep.model.max_seq)
    gates = {}
    for kind, replay, program, program32, (k, v) in (
            ("admit", replay_admit, bundle.admit,
             make_admit_fn(model32, bundle.max_pages, bundle.page_size), (kp_a, vp_a)),
            ("step", replay_step, bundle.step, make_step_fn(model32), (kp, vp))):
        got_k = replay(program, params, k, v)
        with ops.impl_scope("plain"):
            got_p = replay(program, params, k, v)
            params32 = pytree.tree_map(lambda t: t.float(), params)
            got_32 = replay(program32, params32, k.float(), v.float())
            del params32
        gates[kind] = {
            "err_k": [rel_l2(a, b) for a, b in zip(got_k, got_32)],
            "err_p": [rel_l2(a, b) for a, b in zip(got_p, got_32)],
            "finite": all(bool(torch.isfinite(a).all()) for a in got_k),
            "agree": (got_k[0].argmax(-1) == got_p[0].argmax(-1)).float().mean().item(),
            "max_abs": (got_k[0] - got_p[0]).abs().max().item(),
            "run_equal": bool(torch.equal(
                captured[kind]["logits"].float()[live if kind == "step" else slice(None)],
                got_k[0]))}
    # the host's share of a step: logits to the host and the greedy argmax
    t = time.perf_counter()
    for _ in range(20):
        np.argmax(captured["step"]["logits"].float().cpu().numpy(), axis=-1)
    host_ms = (time.perf_counter() - t) / 20 * 1e3

    # information, not gated: greedy tokens of the dense per-request path
    same_tok = same_req = 0
    with torch.inference_mode():
        for p, b, out in zip(prompts, budgets, outs):
            lg, cache = dep.model.prefill(params, {"tokens": torch.from_numpy(p).cuda()},
                                          capacity=spec.prompt_len + spec.decode_steps)
            dense = []
            for _ in range(b):
                nxt = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
                dense.append(int(nxt[0, 0]))
                lg, cache = dep.model.decode(params, cache, nxt)
            same_tok += sum(int(x == y) for x, y in zip(out.tolist(), dense))
            same_req += int(out.tolist() == dense)
    where = {"admit": f"admit {CAPTURE_ADMIT} (logits, prompt K, prompt V)",
             "step": f"step {CAPTURE_STEP} ({int(live.sum())} live rows' logits)"}
    for kind, g in gates.items():
        log(f"decode {where[kind]} vs the f32 plain path: rel_l2 kernel route "
            f"{[float(f'{e:.4g}') for e in g['err_k']]}, plain bf16 route "
            f"{[float(f'{e:.4g}') for e in g['err_p']]} (gate: kernel <= 2 x plain) | kernel vs "
            f"plain bf16 logits: max_abs_err {g['max_abs']:.4g}, argmax agreement "
            f"{g['agree']:.3f} | replay equals the run's logits: {g['run_equal']}")
    log(f"decode host side: logits to host + argmax {host_ms:.3f} ms per step | greedy "
        f"agreement with the dense per-request path: tokens {same_tok / sum(budgets):.3f}, "
        f"requests {same_req}/{len(budgets)}")
    for kind, g in gates.items():
        if not (g["finite"] and all(k <= 2.0 * p for k, p in zip(g["err_k"], g["err_p"]))):
            raise AssertionError(f"kernel route's decode {kind} outputs are less accurate than "
                                 "the plain route's")
    return launches


# ------------------------------------------------------------- phases 3 and 3c

KERNEL_MODULES = ("fa", "da", "pda", "mk", "ss")  # the kernel modules ``ops`` calls


@contextlib.contextmanager
def recorded_kernel_calls(ops):
    """While open, every kernel wrapper that ``ops`` calls keeps each call's
    (name, module, args, kwargs, output) in the yielded list."""
    calls, saved = [], []
    for attr in KERNEL_MODULES:
        module = getattr(ops, attr)
        name = module.__name__.rsplit(".", 1)[1]
        wrapper = getattr(module, name)

        def run(*args, _name=name, _module=module, _wrapper=wrapper, **kwargs):
            out = _wrapper(*args, **kwargs)
            calls.append((_name, _module, args, kwargs, out))
            return out
        saved.append((module, name, wrapper))
        setattr(module, name, run)
    try:
        yield calls
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)


def check_recorded_calls(torch, calls) -> None:
    """Each recorded kernel call against its plain version on the same inputs:
    every output within the phase-2 tolerance of its dtype, scaled by
    max(1, max |plain|)."""
    worst = {}
    with torch.inference_mode():
        for name, module, args, kwargs, out in calls:
            want = getattr(module, name + "_plain")(*args, **kwargs)
            errs = [(scaled_err(g, w), SCALED_TOL[str(g.dtype).replace("torch.", "")])
                    for g, w in zip(flat_tensors(out), flat_tensors(want))]
            n, err, bad = worst.get(name, (0, 0.0, 0))
            worst[name] = (n + 1, max([err] + [e for e, _ in errs]),
                           bad + sum(e > tol for e, tol in errs))
    torch.cuda.synchronize()
    log("kernel calls of a kernel-path prefill vs their plain versions on the same inputs: " +
        ", ".join(f"{k}: {n} calls, worst scaled error {e:.3g}" for k, (n, e, _) in worst.items()))
    failed = {k: bad for k, (_, _, bad) in worst.items() if bad}
    if not worst or failed:
        raise AssertionError(f"kernel calls disagree with their plain versions: {failed or 'none'}")

def memory_line(torch, work) -> str:
    """Free disk under ``work``, available host memory, the card's peak."""
    avail = next((int(line.split()[1]) * 1024 for line in
                  Path("/proc/meminfo").read_text().splitlines()
                  if line.startswith("MemAvailable:")), 0)
    return (f"disk free {shutil.disk_usage(work).free / 1e9:.1f} GB | host MemAvailable "
            f"{avail / 1e9:.1f} GB | device max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def serve_path(torch, spec, work, n_requests, want_per_request):
    """Deploy ``spec`` on the GPU, serve ``n_requests`` cold requests through the
    ``unikernel`` driver (boot -> run -> exit) with the kernel launches of
    each request equal to ``want_per_request(cfg, spec)``, time each boot
    track alone, then, on the last executor's weights, hold every kernel
    call of a kernel-path prefill against its plain version and the kernel
    path's prefill logits against the plain path in float32. The float32
    weights are read from the snapshot after the executor has exited, so the
    card never holds both copies. Returns (deployment, launches of the
    requests)."""
    from repro_torch import pytree
    from repro_torch.core.boot import streamed_device_put
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.deploy import deploy
    from repro_torch.core.drivers import UnikernelDriver
    from repro_torch.core.metrics import Timeline, now
    from repro_torch.core.snapshot import SnapshotStore
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    log(f"before deploy {spec.name}: {memory_line(torch, work)}")
    t0 = time.perf_counter()
    dep = deploy(spec, CompileCache(work / "programs"), SnapshotStore(work / "snapshots"),
                 str(work), device="cuda")
    m = dep.image.manifest
    cfg = dep.model.cfg
    log(f"deploy {spec.name}: {time.perf_counter() - t0:.1f} s [" +
        " ".join(f"{k} {v:.2f}" for k, v in dep.build_s.items()) +
        f"] | {m.param_count} params | program {m.program_bytes} B | snapshot "
        f"{m.snapshot_bytes} B | "
        f"{cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype} | "
        f"{memory_line(torch, work)}")
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(dep.example_tokens(seed=1)).cuda()
    want = want_per_request(cfg, spec)
    driver = UnikernelDriver()
    ops.reset_launch_counts()
    for r in range(n_requests):
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
        nodes = f" | program graph {len(ex.program.graph.nodes)} nodes" if r == 0 else ""
        log(f"request {r + 1}: boot [{stages}] t_boot_wall {tl.t_boot_wall:.3f} s | "
            f"execution {tl.execution:.3f} s | launches {grew} | tokens {out.tolist()}{nodes}")
        if grew != want:
            raise AssertionError(f"launches per request {grew}, expected {want}")
        if tuple(out.shape) != (spec.batch_size, spec.decode_steps) \
                or out.dtype != torch.int32 or not bool(((out >= 0) &
                                                        (out < cfg.vocab_size)).all()):
            raise AssertionError(f"bad output {out.shape} {out.dtype}")
        if r < n_requests - 1:
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
        f"fetch+deserialize {t4 - t3:.3f} s | requests and tracks alone: "
        f"{memory_line(torch, work)}")
    torch.cuda.reset_peak_memory_stats()

    # Same weights (the last executor's, and the snapshot they came from):
    # the kernel path, the plain path, and the plain path in float32 as the
    # reference. Two bf16 paths drift apart over the layers by bf16 rounding
    # alone, so the gate is that the kernel path is no less accurate than the
    # plain bf16 path: its relative L2 error against the f32 logits is at
    # most twice the plain path's. A wrong kernel would be off by orders of
    # magnitude, except where the stack loses the f32 logits in bf16 by
    # itself (xlstm's random-weight blocks, all 48 of them): there the
    # per-call check carries the kernels' correctness.
    params = ex.params
    batch = {"tokens": tokens}
    with torch.inference_mode(), recorded_kernel_calls(ops) as calls:
        lk, _ = dep.model.prefill(params, batch, capacity=spec.prompt_len)
    check_recorded_calls(torch, calls)
    del calls
    with torch.inference_mode(), ops.impl_scope("plain"):
        lp, _ = dep.model.prefill(params, batch, capacity=spec.prompt_len)
        out_plain = dep.serve_fn(params, tokens)
    del params
    driver.finish(dep, ex)
    gc.collect()
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), dep.model.max_seq)
    with torch.inference_mode(), ops.impl_scope("plain"):
        params32 = pytree.tree_map(lambda t: t.to("cuda").float(),
                                   dep.snapshots.load_host(key))
        l32, _ = model32.prefill(params32, batch, capacity=spec.prompt_len)
        del params32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gates, f32 reference included: {memory_line(torch, work)}")
    lk, lp = lk.float(), lp.float()

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
    return dep, launches


def register_jamba() -> None:
    from repro_torch.configs import get_config, register
    cfg = get_config("jamba-1.5-large-398b")
    register(JAMBA_ARCH)(lambda: dataclasses.replace(
        cfg, n_layers=cfg.ssm.attn_every, moe=dataclasses.replace(cfg.moe, n_experts=4)))


def jamba_launches(cfg, spec) -> dict:
    """Per serve request: one flash and K decode launches per attention layer,
    one scan launch per Mamba layer (its prefill)."""
    P = cfg.n_layers // cfg.ssm.attn_every
    return {"flash_attention": P, "decode_attention": P * spec.decode_steps,
            "paged_decode_attention": 0, "mlstm": 0,
            "selective_scan": P * (cfg.ssm.attn_every - 1)}


# ------------------------------------------------------------------------ main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch.configs import get_config, register
    from repro_torch.core.artifact import FunctionSpec
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as mk
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import DECODE_CHUNK as CHUNK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"], check=True,
                                  capture_output=True, text=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_per_s = MUFU_PER_CLOCK_PER_SM * n_sm * sm_mhz * 1e6
    log(f"device: {kind} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"capability {cap[0]}.{cap[1]} | {n_sm} SMs, max SM clock {sm_mhz:.0f} MHz "
        f"(exponentials: {MUFU_PER_CLOCK_PER_SM} per clock per SM = {exp_per_s:.4g}/s) | "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"kernels: {lib_path} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc in this run: {_cuda.build_seconds:.2f} s)")
    for line in ptxas_lines(lib_path):
        log(f"ptxas: {line}")

    # ---- phase 2: kernels vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_main = (4, 512, 512, 24, 8, 128, True, 0, "bfloat16")
    jamba_flash = (4, 512, 512, 64, 8, 128, True, 0, "bfloat16")    # jamba's prefill, timed too
    jamba_decode = (4, 528, 64, 8, 128, [528] * 4, "bfloat16")      # jamba's decode, timed too
    flash_admit = (1, 512, 512, 24, 8, 128, True, 0, "bfloat16")    # the decode tier's admit, timed
    flash_cases = [flash_main,
                   flash_admit,
                   (2, 77, 77, 24, 8, 128, True, 0, "bfloat16"),      # ragged
                   (2, 64, 192, 24, 8, 128, True, 128, "bfloat16"),   # q_offset
                   (2, 128, 128, 24, 8, 128, False, 0, "bfloat16"),   # bidirectional
                   (1, 96, 96, 6, 3, 64, True, 0, "bfloat16"),
                   (2, 200, 200, 4, 2, 32, True, 0, "float32"),
                   (2, 130, 130, 24, 8, 128, False, 0, "float32"),
                   jamba_flash,
                   (2, 100, 100, 64, 8, 128, True, 0, "float32"),
                   # the wgmma kernel's tiling: rows (Sq G) that fill no whole 64-row
                   # CTA, Skv no multiple of the 64-key tile, a diagonal tile partly
                   # visible at q_offset, MHA at D = 128, and the mma.sync kernel's
                   # D = 32 in bf16
                   (2, 45, 45, 24, 8, 128, True, 0, "bfloat16"),
                   (2, 100, 150, 24, 8, 128, False, 0, "bfloat16"),
                   (2, 64, 100, 24, 8, 128, True, 36, "bfloat16"),
                   (2, 130, 130, 8, 8, 128, True, 0, "bfloat16"),
                   (1, 33, 70, 64, 8, 128, True, 37, "bfloat16"),
                   (2, 77, 77, 4, 2, 32, True, 0, "bfloat16")]
    decode_main = (4, 528, 24, 8, 128, [528, 528, 528, 528], "bfloat16")
    decode_cases = [decode_main,
                    (4, 528, 24, 8, 128, [0, 528, 300, 517], "bfloat16"),
                    (3, 100, 4, 4, 32, [1, 0, 100], "bfloat16"),
                    (2, 264, 24, 8, 128, [1, 200], "float32"),
                    (2, 64, 8, 2, 64, [64, 17], "float32"),
                    jamba_decode,
                    (4, 528, 64, 8, 128, [528, 513, 0, 520], "bfloat16"),
                    (2, 300, 64, 8, 128, [0, 299], "float32")]
    # every group size of the registered configs (G = 5, 6, 7, 12 at D = 128:
    # qwen2.5-32b, qwen2-vl-2b, arctic-480b, starcoder2-3b) at lengths 1, one
    # split less one, one split, one split and one, and S; G = 17 (two row
    # tiles of 16 heads) and whisper's G = 1 at D = 64
    split_lengths = [1, CHUNK - 1, CHUNK, CHUNK + 1, 528]
    decode_cases += [(5, 528, hq, hkv, 128, split_lengths, dtype)
                     for dtype in ("bfloat16", "float32")
                     for hq, hkv in ((40, 8), (12, 2), (56, 8), (24, 2))]
    decode_cases += [(3, 200, 34, 2, 64, [200, 0, 77], "bfloat16"),
                     (3, 200, 34, 2, 64, [200, 0, 77], "float32"),
                     (3, 100, 16, 16, 64, [1, 64, 100], "bfloat16"),
                     (2, 2100, 24, 8, 128, [2100, 1500], "bfloat16")]   # 33 splits
    # B, page_size, max_pages, Hq, Hkv, D, lengths, dtype; the first is the
    # decode tier's shape (8 slots, 33 pages of 16 = 528 positions)
    paged_cases = [(8, 16, 33, 24, 8, 128, [528] * 8, "bfloat16"),
                   (8, 16, 33, 24, 8, 128, [0, 1, 16, 17, 300, 528, 527, 33], "bfloat16"),
                   (8, 16, 33, 24, 8, 128, [5, 0, 0, 528, 100, 64, 2, 511], "float32"),
                   (3, 8, 5, 8, 1, 64, [0, 40, 9], "bfloat16"),             # MQA, D=64
                   (4, 16, 6, 8, 2, 64, [96, 3, 0, 50], "float32"),         # GQA, D=64
                   (2, 4, 7, 4, 4, 32, [28, 13], "bfloat16")]
    paged_cases += [(5, 16, 33, hq, hkv, 128, split_lengths, dtype)
                    for dtype in ("bfloat16", "float32")
                    for hq, hkv in ((40, 8), (12, 2), (56, 8), (24, 2))]
    paged_cases += [(4, 32, 17, 24, 8, 128, [1, CHUNK - 1, CHUNK + 1, 544], "bfloat16"),
                    (4, 8, 66, 24, 8, 128, [1, CHUNK, 100, 528], "bfloat16"),
                    (3, 8, 25, 34, 2, 64, [200, 0, 77], "bfloat16")]
    # B, S, H, Dk, Dv, dtype, i_scale, split; the first is xlstm-1.3b's prefill
    mlstm_cases = [(4, 512, 4, 512, 1024, "bfloat16", 1.0, 0),
                   (2, 100, 4, 512, 1024, "bfloat16", 1.0, 0),       # padding
                   (2, 1, 4, 512, 1024, "bfloat16", 1.0, 0),         # S < chunk
                   (2, 7, 4, 512, 1024, "bfloat16", 1.0, 0),
                   (2, 512, 4, 512, 1024, "bfloat16", 1.0, 200),     # carried state
                   (2, 150, 2, 512, 1024, "float32", 1.0, 64),
                   (2, 130, 4, 32, 64, "float32", 1.0, 0),           # the reduced dims
                   (2, 70, 4, 32, 64, "bfloat16", 1.0, 33),
                   (2, 192, 4, 512, 1024, "bfloat16", 30.0, 0),      # large input gates
                   (2, 65, 4, 512, 1024, "bfloat16", 1.0, 0),        # one step past a chunk
                   (2, 129, 4, 512, 1024, "bfloat16", 1.0, 0),
                   (2, 200, 2, 32, 64, "bfloat16", 1.0, 129)]        # reduced dims, carried
    # B, S, Di, Ds, dtype, split, dt_scale; the first is jamba-1.5-large's prefill
    scan_cases = [(4, 512, 16384, 16, "bfloat16", 0, 1.0),
                  (2, 100, 16384, 16, "bfloat16", 0, 1.0),        # ragged S
                  (2, 1, 16384, 16, "bfloat16", 0, 1.0),          # S = 1
                  (2, 77, 4096, 16, "bfloat16", 0, 1.0),          # S past a chunk, odd
                  (2, 512, 16384, 16, "bfloat16", 200, 1.0),      # carried state
                  (2, 150, 4096, 16, "float32", 64, 1.0),         # f32 x
                  (2, 130, 256, 8, "float32", 0, 1.0),            # the reduced dims
                  (2, 70, 256, 8, "bfloat16", 33, 1.0),
                  (2, 64, 1000, 16, "bfloat16", 0, 1.0),          # Di not a multiple of 128
                  (2, 96, 1000, 4, "float32", 0, 1.0),
                  (2, 64, 2048, 16, "float32", 0, 1e4)]           # every decay underflows to 0
    # what encoding the flash kernel's three TMA tensor maps costs the host per call
    qm = torch.empty(flash_main[:2] + flash_main[3:4] + flash_main[5:6], dtype=torch.bfloat16,
                     device="cuda")
    km = torch.empty(flash_main[:1] + flash_main[2:3] + flash_main[4:6], dtype=torch.bfloat16,
                     device="cuda")
    map_us = _cuda.library().repro_flash_tensor_map_us(
        qm.data_ptr(), km.data_ptr(), km.data_ptr(), *flash_main[:6], 1000)
    log(f"flash tensor maps at the path's shape: {map_us:.3f} us of host time per call "
        "to encode q, k, v (mean of 1000)")
    del qm, km
    timed_extra = {id(jamba_flash): "jamba's shape", id(jamba_decode): "jamba's shape",
                   id(flash_admit): "the decode tier's admit shape"}
    results = {}
    for name, check, cases in (
            ("flash_attention",
             lambda c, t: check_flash(torch, F, fa, ref, gen, c, t), flash_cases),
            ("decode_attention",
             lambda c, t: check_decode(torch, F, da, ref, gen, c, t), decode_cases),
            ("paged_decode_attention",
             lambda c, t: check_paged(torch, F, pda, da, ref, gen, c, t), paged_cases),
            ("mlstm", lambda c, t: check_mlstm(torch, mk, ref, gen, c, t), mlstm_cases),
            ("selective_scan",
             lambda c, t: check_scan(torch, F, ss, ref, gen, c, t, exp_per_s), scan_cases)):
        rows = [check(c, i == 0 or id(c) in timed_extra) for i, c in enumerate(cases)]
        for r in rows:
            extra = "".join(f" {k} {r[k]}" for k in ("layout_bitwise", "vs_contiguous_bitwise",
                                                     "vs_contiguous_max_abs_err",
                                                     "vs_split_order_max_abs_err",
                                                     "rerun_bitwise",
                                                     "max_abs_err_C_n_m", "scaled_err_h",
                                                     "scaled_err_C_n_m", "max_abs_err_h",
                                                     "scaled_err_y")
                            if k in r)
            log(f"{name} {r['case']}: max_abs_err {r['max_abs_err']:.3g}{extra} "
                f"{'ok' if r['ok'] else 'FAIL'}")
        main = rows[0]
        for c, r in zip(cases, rows):
            if "ms" not in r:
                continue
            library = "none (no single PyTorch call)" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f} library_device_ms {r['library_device_ms']:.4f}"
            split = "".join(f" {k} {r[k]:.4f}" for k in ("bound_bytes_ms", "bound_exp_ms")
                            if k in r)
            where = "the path's shape" if r is main else f"{timed_extra[id(c)]} {r['case']}"
            log(f"{name} at {where}: kernel_ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} "
                f"host_us {r['host_us']:.1f} plain_ms {r['plain_ms']:.4f} "
                f"library_ms {library} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}){split}")
        bad = [r["case"] for r in rows if not r["ok"]]
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version on {bad}")
        results[name] = main

    register(LLAMA_ARCH)(lambda: dataclasses.replace(get_config("llama3.2-3b"),
                                                     n_layers=LLAMA_LAYERS))
    xlstm = get_config("xlstm-1.3b")
    register(XLSTM_ARCH)(lambda: dataclasses.replace(
        xlstm, n_layers=XLSTM_PERIODS * xlstm.ssm.slstm_every))
    register_jamba()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        # ---- phase 3: the llama serve path, full width
        dep, launches = serve_path(
            torch, FunctionSpec(**SPEC), work / "llama", LLAMA_REQUESTS,
            lambda cfg, spec: {"flash_attention": cfg.n_layers,
                               "decode_attention": cfg.n_layers * spec.decode_steps,
                               "paged_decode_attention": 0, "mlstm": 0, "selective_scan": 0})
        # ---- phase 3b: the decode tier on the same deployment
        launches_3b = decode_tier(torch, dep)
        del dep
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work / "llama", ignore_errors=True)

        # ---- phase 3c: the xlstm serve path, full width, 2 of 6 periods
        _, launches_3c = serve_path(
            torch, FunctionSpec(**XLSTM_SPEC), work / "xlstm", XLSTM_REQUESTS,
            lambda cfg, spec: {"flash_attention": 0, "decode_attention": 0,
                               "paged_decode_attention": 0,
                               "mlstm": cfg.n_layers - cfg.n_layers // cfg.ssm.slstm_every,
                               "selective_scan": 0})
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work / "xlstm", ignore_errors=True)

        # ---- phase 3d: the jamba serve path, full width, one period
        _, launches_3d = serve_path(
            torch, FunctionSpec(**JAMBA_SPEC), work / "jamba", JAMBA_REQUESTS, jamba_launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- phase 4: report
    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:33"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:35"),
               "paged_decode_attention": (
                   "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/paged_decode_attention.py:40"),
               "mlstm": ("src/repro_torch/kernels/csrc/mlstm.cu",
                         "src/repro/kernels/mlstm.py:31"),
               "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                                  "src/repro/kernels/selective_scan.py:26")}
    kernels = []
    for name, r in results.items():
        by_path = {"serve": launches[name], "decode_tier": launches_3b[name],
                   "xlstm_serve": launches_3c[name], "jamba_serve": launches_3d[name]}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"{name} was never launched on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"], "host_us": r["host_us"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "library_device_ms": r["library_device_ms"]})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
