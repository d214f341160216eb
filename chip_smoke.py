#!/usr/bin/env python3
"""Run the PyTorch port's cold-start serve path (llama3.2-3b through the
Gateway, under each driver of the paper's start-path taxonomy, in warm mode,
and coalesced into bucket programs under forecast-driven pre-boot; the other
nine architectures), its continuous-batching decode tier and its
single-device training path, and its multi-device layer as four ranks
sharing the card, on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, run in the order 1, 2, 3t, 3m, 3, 3b, 3e, 3f, 3g, 3c, 3d, 3r, 4 (3t
and 3m beside the early build of phase 3's programs); any failure raises and
the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, compute capability, SM count and maximum SM clock; then build
   the hand-written kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   and log what ptxas reports (registers, shared memory, spills) for the
   flash, mLSTM, decode and paged decode kernels; then AOTInductor's
   toolchain: Triton's version and a host compiler that links an OpenMP
   shared object (``inductor_toolchain``). Every deploy of the run compiles
   its serve-path programs (the serve program, its head/tail split, the
   bucket programs) with AOTInductor through one compile cache under the
   run's work directory (``enable_inductor_disk_cache``); every path's
   launches are those of its compiled program (``compiled_launches``).
   Before phase 1's kernel build, a background build (``chip_smoke.py
   --precompile``, ``EARLY_GROUPS``) compiles phase 3's llama programs into
   that cache beside phases 1 and 2. From phase 3 on, two more
   (``PRECOMPILE_GROUPS``) compile the serve, head and tail programs of the
   deploys of phases 3g, 3c and 3d from their shapes into that cache
   (``repro_torch.core.deploy.precompile``), beside phases 3-3f; those
   deploys then read the packages back (their lines log the cache lookups)
   and still verify them. The end of the run logs each build's seconds and
   fails if a build failed.
2. Kernels vs plain: each kernel against its plain PyTorch version on CUDA
   tensors, at the paths' shapes and at edge cases (ragged lengths,
   q_offset, bidirectional, length 0 and S, NaN past length, jamba's 64/8
   heads for flash and decode, the coalesced path's bucket programs (B = 8
   and 16; B = 16 timed) for both, and the decode tier's admit (B = 1) for
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
   underflow to 0; for flash also phase 3g's shapes: whisper's encoder,
   bidirectional over 1500 frames at 16/16 heads of 64, its cross-attention
   of 128 tokens against 1500 frames, and G = 5, 6, 7, 12 at D = 128, causal
   at 512 and at a ragged length; for decode whisper's cross decode over
   1500 frames; four of them timed; phase 3m's local shapes, timed: decode
   at serve_tp's 2 rows of 12/4 heads over 516 positions, and the decode
   kernel's stats entry at serve_seqkv's 2 rows of one 16,384-position
   shard, full and holding the second shard's lengths, and with empty
   shards), with kernel / plain / library times (CUDA events
   around back-to-back calls: ``ms``, ``plain_ms``, ``library_ms``), the
   device alone (``device_ms``, ``library_device_ms``: 200 calls captured
   in one CUDA graph and replayed), the wrapper's host time per call
   (``host_us``), and the least time the card could take (``bound_ms``;
   for the scan the larger of its bytes and its exponentials at the SM
   clock).
3. Path, through the port's control plane: ``Gateway(n_hosts=2,
   slots_per_host=2, mode="cold", hedging=False, scheduler=
   SchedulerConfig(snapshot_tier_bytes=4 << 30), decode=DecodeConfig(slots=8,
   page_size=16, max_new=16))`` on the GPU; ``gw.deploy`` full-width
   llama3.2-3b (bf16, 2 decode steps, its depth cut to 1 of 28 layers for
   the time limit, random weights from
   the spec's seed: program, v2 chunked snapshot, decode bundle); then
   request 1 (the store path), request 2 (the same host: program and tree
   memos, no deserialize), a burst of 4 through ``gw.invoke_many``
   (concurrent boots on one card, over both hosts), request 1's host killed
   and request 7 served on the survivor, and ``gw.noop()``. Each request
   logs its host, boot stages, ``t_boot_wall`` and execution (the burst
   also how long calls of a shared loaded package waited for each other); every
   request's tokens equal request 1's, and each makes L flash and L x (K - 1)
   decode launches. Then the tier counters (``placement_summary``,
   ``resilience_summary``), each boot track alone (weights from the chunk
   store, device copy, program), the compiled program's execution beside
   the eager program's (their tokens must be equal), every kernel call of a kernel-path
   prefill against its plain version, and the kernel path's prefill logits
   and the plain path's, on the snapshot's weights, against the plain path
   in float32.
3b. Decode tier, on phase 3's gateway: the decode scheduler ``gw.deploy``
   built (``ensure_decode(slots=8, page_size=16)``: export, save, load,
   verify the admit and step programs) serves 12 requests of 512 prompt
   tokens submitted in one burst through ``gw.invoke_decode_async``,
   budgets cycling through 16, 3, 7, 16, 1, 5; then the decode loop closes;
   checks every budget and ``gw.decode_summary``, one boot and one
   cool-down, and launches (flash = L x admits, paged = L x steps, no
   contiguous decode); then holds one admit call (its logits and the K/V it
   wrote) and one step call, each replayed on clones of the pool it saw
   mid-run, kernel route and plain route, against the plain route in
   float32.
3e. Driver taxonomy, on phase 3's gateway and deployment (no second
   deploy; the deployment's head/tail split must be verified,
   ``split_ok``): each driver of ``ALL_DRIVERS`` (process, fork, unikernel,
   unikernel_stream, paused, warm, cold_jit_cached, cold_jit) serves 2
   requests through ``gw.invoke(..., driver=name)``: cold_jit_cached 1
   after ``enable_inductor_disk_cache`` (it re-traces on fake tensors and
   reads the package deploy compiled from the compile cache, else raises,
   its ``compile`` part under a quarter of cold_jit's; the
   trace's package-key parts are logged against deploy's), cold_jit 2
   submitted together (every cache off, a cache hit raises; how long one
   compile waited for the other is logged); each logs ``trace`` /
   ``compile`` / ``load`` and its cache lookups; then
   ``unikernel`` and ``unikernel_stream`` one request each on a host added
   for it (``gw.cluster.add_host()``, the other hosts held down: a first
   boot from the store). Each request logs its stages, ``t_boot_wall``,
   startup, execution (and TTFR for the streamed driver); every request's
   tokens equal phase 3's request 1 and each makes L flash and L x (K - 1)
   decode launches; the streamed first boot runs the head (``restore_stream_head``,
   ``deserialize_program_bg``, TTFR below its ``t_boot_wall``). Then a
   one-host ``Gateway(mode="warm")`` on the same image, its tiers filled by
   a cold request: request 1 a pool miss,
   request 2 a pool hit, the warm scaler's per-host residency beside the
   cold gateway's zero, until the idle timeout expires its pools; then both
   gateways' ``shutdown()``, which must leave no non-daemon thread and the
   device memory allocated within 64 MiB of its value before the phase.
3f. Coalescing and forecast-driven pre-boot, after phase 3e's gateways are
   shut down: ``Gateway(n_hosts=2, slots_per_host=2, mode="cold",
   hedging=False, batching=BatchingConfig(buckets=(1, 2, 4)),
   forecast=ForecastConfig(model="ewma", ...), scheduler=
   SchedulerConfig(snapshot_tier_bytes=4 << 30))``; ``gw.deploy``
   full-width llama3.2-3b cut to 1 of 28 layers (phase 3's function in an
   image of its own: the base program and the bucket programs at 8 and 16
   rows, each one's export, compile, save, load and verify seconds logged); a burst
   of 8 distinct seeded prompts and a pair through ``gw.invoke_many``
   (batches of 16, 16 and 8 rows: each logs its host, boot stages and
   execution; ``batching_summary``; fewer boots than requests; L flash + L
   x K decode launches per batch; each member's tokens are its rows of the
   bucket program's output, its prefill logits pass the f32-referenced
   gate, and every kernel call of those prefills matches its plain version;
   token agreement with the per-request path is logged, not gated, beside
   each member's rows of the bucket's prefill and decode steps against its
   own 4-row run on the same tokens); a ramp of single requests rising from
   0.5 to 4 per second over 10 s, then quiet (at least one request rides a
   parked planner boot; ``forecast_summary``: planned = claimed + expired +
   parked; a cool-down to pool target 0; a host's program tier
   prefetched); the learned forecaster fitted on the card and on the CPU on
   seeded windows of a diurnal + burst rate (loss falls, predictions >= 0
   and within 1e-3 relative of the CPU fit); ``shutdown()`` (no non-daemon
   thread left, device memory within 64 MiB of before the phase).
3g. The remaining families at published widths, after phase 3f's gateway is
   shut down: kimi-k2-1t-a32b cut to 2 of 61 layers (its first-k-dense
   ``head`` layer and one MoE layer) and 16 of 384 experts (3.76 B
   parameters) and qwen2-vl-2b cut to 2 of 28 layers (tokens only, M-RoPE
   text positions) through ``deploy`` and the ``unikernel`` driver called
   directly (v1 snapshot, 2 decode steps): 2 cold requests each, the split
   verified, both requests' tokens equal each other and the eager
   program's, and the compiled head's prefill logits pass the f32 gate;
   then eagerly through the serve function's body (prefill + 16
   greedy decode steps): olmo-1b, qwen2.5-32b and starcoder2-3b at 2
   layers, arctic-480b at 2 layers and 8 of 128 experts, qwen2-vl-2b at 2
   layers with 256 vision patches, and whisper-medium at its full 24 + 24
   layers on 1500 frames and a 128-token prompt. Each family logs its line,
   peak device memory and free disk; launches per request are 2 flash +
   the compiled program's decode calls for the deployed pair, 2 flash + 2 K
   decode eagerly (whisper 72 flash + 48 K decode); every kernel call of a
   kernel-path prefill matches its plain version, the prefill-logit gate
   holds against float32, and device memory comes back within 64 MiB after
   each family.
3c. The xlstm serve path, after phase 3g: ``deploy``
   (v1 snapshot; the ``unikernel`` driver called directly) full-width
   xlstm-1.3b (bf16, its depth cut to 1 of 6 periods of 7 mLSTM + 1 sLSTM
   for the time limit, random weights from the spec's seed), then the
   serve-path checks: 2 cold requests (7 mLSTM launches each, no
   attention; the split verified, every request's tokens equal request 1's;
   the eager program's are logged, and each served token is held against
   the plain path in float32 fed the served tokens: its f32 logit at most
   4 x the plain bf16 path's largest logit error below the row's maximum,
   since the random-weight xlstm stack turns the compiled glue's other
   roundings into other greedy tokens), each boot track alone, every mLSTM call of a
   kernel-path prefill against its plain version, and the prefill-logit gate (the
   kernel path's and the compiled head program's) against the plain path in
   float32.
3d. The jamba serve path, after xlstm's deployment is freed: ``deploy``
   full-width jamba-1.5-large cut to one period of 8 layers (7 Mamba + 1
   attention, MoE on every other layer) and 4 of its 16 experts (top-2),
   16.2 B parameters, 32.5 GB in bf16; then the same checks: 2 cold requests
   (7 selective-scan, 1 flash and 1 decode launches each), each boot track
   alone, every scan and flash call of a kernel-path prefill against its
   plain version, and the prefill-logit gate. Each path logs its peak device
   memory, and the free disk and host memory before its deploy.
3t. Training on one card, after phase 2: full-width
   llama3.2-3b cut to 2 of 28 layers (595,344,384 parameters, bf16, the
   config's own remat ``full``). A gradient gate first: one micro-batch
   [4, 512] of ``Model.loss`` and its gradients
   (``repro_torch.train.step.loss_and_grads``) on the kernel route and on
   the plain route, each against the plain route in float32 on the same
   weights: the kernel route's loss error at most 2 x the plain bf16 route's
   plus 1e-4 x |loss|, each leaf's gradient error (relative L2 against
   max(its norm, 1e-3 x the whole gradient's)) at most 2 x the plain route's
   plus 1e-3, every flash call against its plain version, and 2 x L flash
   launches (the forward and remat's recompute) and no other. Then the
   plain flash VJP's time per call at B=4, S=512, 24/8 heads beside SDPA's
   backward. Then the port's ``Trainer`` (``TrainerConfig(seq_len=512,
   global_batch=8, grad_accum=2)``, ``AdamWConfig(peak_lr=1e-3, warmup=2,
   total_steps=8)``, f32 moments): an uninterrupted 8-step run; a run to
   step 4 with ``ckpt_every=4`` into a checkpoint directory and a fresh
   ``Trainer`` that resumes there (its first step is 4) and runs on to 8.
   The loss falls (step 7 below step 0), the resumed final loss is within
   5e-3 relative of the uninterrupted run's (whether it is bit-exact is
   logged, and if it is not, the ops PyTorch flags as nondeterministic), and
   each step makes 2 x L x 2 flash launches; each step's seconds and
   tokens/s, the median step, peak memory and each checkpoint's bytes and
   seconds are logged, then the directory is deleted. Then two AdamW updates
   with int8 moments of the trained attention and final-norm leaves on the
   card against the same on the CPU (``q`` within 1, ``scale`` within 1e-6
   relative); the trained weights saved into a ``SnapshotStore`` and loaded
   back, with the eager prefill logits on them bit-identical to those on the
   in-memory weights (the promotion of a just-trained model); and
   xlstm-1.3b's gradient gate at full width, 1 of 6 periods (2 x 7 mLSTM
   launches). Device memory comes back within 64 MiB of before the phase.
   Between the resumed run and the int8 moments, phase 3r's card check
   (b): the same cell (B=8, [4, 512] micro-batches, f32 moments, remat
   ``full``) dry-run on fake tensors on one device
   (``repro_torch.launch.dryrun``), then one more step of the resumed
   trainer on the card under the dry run's counter: the FLOPs must be
   equal, the collective bytes 0 on both, and the predicted peak (the
   arguments plus the trace's peak of live allocations) within 1.25x of
   ``max_memory_allocated`` over the step (with the arguments) either way;
   the counted FLOPs over the median step give the achieved TFLOP/s. The
   step's flash launches are the ``dryrun_anchor`` path.
3m. The multi-device layer (``repro_torch.dist``), after phase 3t: four
   ``chip_smoke.py --mesh-rank R`` processes on the one card in a gloo world
   over a ``FileStore`` (DTensor's collectives of CUDA tensors staged
   through host memory, every byte counted), a (data=2, model=2) mesh, and
   five cells: (a) ``serve_tp``, llama at 2 layers, B=4, a 512-token
   prompt, 4 forced decode steps; (b) ``serve_seqkv``, a 32,768-position
   cache cut across both model ranks and a 16,400-token prompt, 4 steps,
   every rank launching the decode kernel's stats entry; (c) a kimi-k2 MoE
   layer (16 of 384 experts) with the local dispatch against the global one;
   (e) the int8 all-reduce of 50,334,720 f32 elements, 8 rounds with error
   feedback; (d) phase 3t's training for 2 steps, then a run to step 1
   resumed on a (data=4,) mesh. Gates, on rank 0: (a) and (b) each step's
   logits no further from the single-device f32 plain path than 2 x the
   single-device bf16 kernel path's; (c) the mesh's global and local
   dispatches each within 2 x the single-device bf16 global dispatch's error
   against f32, aux within 1e-4 of both; (d) the final loss within 1e-3 of
   phase 3t's at the same step and the resumed run's within 1e-3 of the
   mesh run's (one update moves it 4.4e-3), and each parameter leaf of both
   runs after 2 steps no further from phase 3t's than 0.25 x what those
   steps moved it; (e) each round within amax / 127. A rank that fails,
   outlives 480 s or leaves no result fails the run; the ranks' peak device
   memory, summed, stays under 70 GB. Each rank logs per cell its wall,
   peak memory, launches and collective calls and bytes.
3r. The dry run, in a ``chip_smoke.py --dryrun`` process started after
   phase 3g and collected after phase 3d (the traces are host work):
   ``torch.distributed``'s fake process group of 512 ranks in that one
   process (nothing sent) and three cells traced on fake tensors at
   published widths: llama3.2-3b
   ``train_4k`` on the (16, 16) mesh with its probes, qwen2.5-32b
   ``decode_32k`` under ``serve_tp``, and kimi-k2 ``train_4k`` on the
   (2, 16, 16) mesh without probes, cut to 2 of its 61 layers. One line
   per cell: its per-device FLOPs, bytes accessed, collectives by kind and
   bytes per device against the card's memory. A cell that does not trace,
   counts no FLOPs or (training) no collective fails the run; the process
   group is torn down after.
4. A ``kernels`` JSON line (launches per path, phase 3t's among them; flash
   and decode also at the 16-row bucket's shape and phase 3g's timed
   shapes); then Inductor's compile workers are shut down and every
   process the run left (its descendants, adopted orphans among them: the
   script is a child subreaper, and the members of the sessions it
   started) is killed and reaped, ``processes left: 0`` is logged (a
   process still there fails the run, named by pid and command line; a
   failing run is reaped the same way), and the last line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA device and the repository around it (it imports
``src/repro_torch``); without either it exits non-zero before printing a
result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12            # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12              # f32 outside the tensor cores
MUFU_PER_CLOCK_PER_SM = 16          # exponentials (ex2) per clock per SM, Hopper
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
GRAPH_CALLS = 200                   # wrapper calls captured in one CUDA graph (device_ms)

LLAMA_LAYERS = 1                    # of 28: phases 3, 3b and 3e's depth, cut for the time limit
LLAMA_ARCH = f"llama3.2-3b:{LLAMA_LAYERS}L"
# 2 decode steps in the deployed programs (cut from 16 for AOTInductor's
# compile time, which grows with the unrolled steps). At 4, a projection, not
# a run: the runs at 4 stopped at xlstm's token check 1,049 and 1,027 s in,
# before jamba's path; 811 s to the end of phase 3g, about 237 s of xlstm,
# and jamba's 231 s at 2 steps give about 1,280 s, over the 1,200 s limit
SPEC = dict(arch=LLAMA_ARCH, reduced=False, batch_size=4, prompt_len=512, decode_steps=2)
COALESCE_LAYERS = 1                 # of 28: phase 3f's depth, cut for the time limit
COALESCE_ARCH = f"llama3.2-3b:{COALESCE_LAYERS}L"
COALESCE_SPEC = dict(SPEC, arch=COALESCE_ARCH)
XLSTM_PERIODS = 1                   # of 6: the xlstm path's depth, cut for the time limit
XLSTM_ARCH = f"xlstm-1.3b:{XLSTM_PERIODS}P"
XLSTM_SPEC = dict(SPEC, arch=XLSTM_ARCH)
XLSTM_REQUESTS = 2
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
DECODE_MAX_NEW = 16                 # the decode tier's budget cap (33 pages of 16 hold 512 + 16)
DECODE_BUDGETS = [16, 3, 7, 16, 1, 5]
N_DECODE_REQUESTS = 12

# phase 2 at the shapes phase 3g gives the kernels: whisper's encoder
# (bidirectional, 1500 frames, 16/16 heads of 64) and its cross-attention (a
# 128-token decoder prompt against 1500 frames), qwen2.5-32b's prefill (G =
# 5); flash at every other group size of the families (G = 6, 7, 12: qwen2-vl,
# arctic, starcoder2), causal at 512 and at a ragged length; whisper's cross
# decode (every step reads all 1500 frames). The four named ones are timed.
WHISPER_ENC_FLASH = (4, 1500, 1500, 16, 16, 64, False, 0, "bfloat16")
WHISPER_CROSS_FLASH = (4, 128, 1500, 16, 16, 64, False, 0, "bfloat16")
QWEN32_FLASH = (4, 512, 512, 40, 8, 128, True, 0, "bfloat16")
WHISPER_CROSS_DECODE = (4, 1500, 16, 16, 64, [1500] * 4, "bfloat16")
FAMILY_FLASH_CASES = [WHISPER_ENC_FLASH, WHISPER_CROSS_FLASH, QWEN32_FLASH,
                      (2, 77, 77, 40, 8, 128, True, 0, "bfloat16")]
FAMILY_FLASH_CASES += [case for hq, hkv in ((12, 2), (56, 8), (24, 2))
                       for case in ((4, 512, 512, hq, hkv, 128, True, 0, "bfloat16"),
                                    (2, 77, 77, hq, hkv, 128, True, 0, "bfloat16"))]
FAMILY_DECODE_CASES = [WHISPER_CROSS_DECODE]
FAMILY_TIMED = {id(WHISPER_ENC_FLASH): "whisper's encoder",
                id(WHISPER_CROSS_FLASH): "whisper's cross-attention",
                id(QWEN32_FLASH): "qwen2.5-32b's prefill",
                id(WHISPER_CROSS_DECODE): "whisper's cross decode"}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------- process hygiene
#
# The run starts processes of its own (the background builds, the mesh
# ranks, each in a session of its own) and Inductor starts compile workers
# for the in-process compiles; a grandchild whose parent died would be
# reparented away from the script. The script is therefore a child
# subreaper: orphans of its descendants come back to it. Before its last
# line, and on the way out of a failing run, it shuts Inductor's compile
# workers down, kills and reaps every process left, and checks that none is.

PR_SET_CHILD_SUBREAPER = 36
SESSIONS = set()                    # sessions the run started (their leaders' pids)


def become_subreaper() -> None:
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def child_pids(pid: int) -> list:
    """``pid``'s children, from ``/proc/<pid>/task/*/children``."""
    out = []
    for path in Path(f"/proc/{pid}/task").glob("*/children"):
        with contextlib.suppress(OSError):
            out += [int(c) for c in path.read_text().split()]
    return out


def descendants(pid: int) -> set:
    seen, todo = set(), [pid]
    while todo:
        for child in child_pids(todo.pop()):
            if child not in seen:
                seen.add(child)
                todo.append(child)
    return seen


def session_members(sessions) -> set:
    """Every process whose session (``/proc/*/stat`` field 6) is one of
    ``sessions``."""
    out = set()
    for path in Path("/proc").iterdir():
        if not path.name.isdigit():
            continue
        with contextlib.suppress(OSError, ValueError, IndexError):
            fields = (path / "stat").read_text().rsplit(")", 1)[1].split()
            if int(fields[3]) in sessions:
                out.add(int(path.name))
    return out


def processes_left(sessions=SESSIONS) -> dict:
    """{pid: command line} of the script's descendants and of every process
    in a session it started (itself excluded)."""
    me = os.getpid()
    out = {}
    for pid in sorted((descendants(me) | session_members(sessions)) - {me}):
        with contextlib.suppress(OSError):
            out[pid] = Path(f"/proc/{pid}/cmdline").read_bytes().replace(
                b"\0", b" ").decode(errors="replace").strip() or "(exited, not reaped)"
    return out


def reap_children(sessions=SESSIONS, wait_s: float = 10.0) -> None:
    """Shut Inductor's compile workers down, then kill every process left
    (descendants and the members of the run's sessions) and reap every
    child, adopted orphans included, until none is left or ``wait_s``
    passes."""
    inductor = sys.modules.get("torch._inductor.async_compile")
    if inductor is not None and hasattr(inductor, "shutdown_compile_workers"):
        with contextlib.suppress(Exception):
            inductor.shutdown_compile_workers()
    deadline = time.monotonic() + wait_s
    while True:
        left = processes_left(sessions)
        for pid in left:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, signal.SIGKILL)
        while True:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
        if not left or time.monotonic() > deadline:
            return
        time.sleep(0.05)


def leave_nothing_running(run) -> int:
    """Run ``run()`` (-> an exit code, or the last line's object) as a child
    subreaper; reap what it left, on success and on failure; on success
    raise if any process is left (naming each), else log ``processes left:
    0`` and print the last line."""
    become_subreaper()
    try:
        result = run()
    except BaseException:
        reap_children()
        left = processes_left()
        log(f"processes left after the failure: {len(left)} {left}")
        raise
    reap_children()
    left = processes_left()
    if left:
        raise RuntimeError("processes left running: " + "; ".join(
            f"pid {pid}: {cmd}" for pid, cmd in left.items()))
    log("processes left: 0")
    if isinstance(result, dict):
        print(json.dumps(result), flush=True)
        return 0
    return result


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


def compiled_launches(dep, eager: dict, bucket_rows=None) -> dict:
    """Kernel launches per request of ``dep``'s compiled serve program (at
    ``bucket_rows`` rows, None: the deploy shape): ``eager``, the eager
    program's (one decode launch per attention layer and step), with the
    decode count its package calls. The last step's logits feed no token, so
    AOTInductor may drop that step's decode in the layers whose output only
    they use (every layer's for llama; fewer where later steps of the graph
    write state, as jamba's Mamba steps and Kimi's cache writes do). Raises
    if the package
    calls another number of flash kernels, or more decode kernels than the
    eager program or fewer than its last step's."""
    from repro_torch.core.compile_cache import package_op_calls
    calls = package_op_calls(dep.fetch_program_payload(bucket_rows))
    n_flash = calls.count("repro_torch::flash_attention")
    n_dec = calls.count("repro_torch::decode_attention")
    layers = eager["decode_attention"] // dep.spec.decode_steps
    if n_flash != eager["flash_attention"] or \
            not eager["decode_attention"] - layers <= n_dec <= eager["decode_attention"]:
        raise AssertionError(f"the compiled program calls flash {n_flash} and decode {n_dec} "
                             f"times, against the eager program's {eager}")
    return {**eager, "decode_attention": n_dec}


def llama_launches(cfg, spec) -> dict:
    """Per request of the eager llama program: one flash and K decode
    launches per layer."""
    return {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * spec.decode_steps,
            "decode_attention_stats": 0, "paged_decode_attention": 0, "mlstm": 0,
            "selective_scan": 0}


def execution_line(torch, program, serve_fn, params, tokens, reps: int = 3,
                   strict: bool = False) -> str:
    """The compiled program's execution beside the eager ``serve_fn`` on the
    same weights and tokens: the best of ``reps`` device-synchronised runs
    of each after one warm-up, and whether their tokens are equal (with
    ``strict``, raise if they are not)."""
    times, outs = {}, {}
    with torch.inference_mode():
        for label, fn in (("compiled", program), ("eager", serve_fn)):
            outs[label] = fn(params, tokens)
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(reps):
                t = time.perf_counter()
                fn(params, tokens)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t)
            times[label] = best
    if strict and not torch.equal(outs["compiled"], outs["eager"]):
        raise AssertionError(f"the compiled program's tokens {outs['compiled'].tolist()} differ "
                             f"from the eager program's {outs['eager'].tolist()}")
    return (f"execution: compiled program {times['compiled']:.4f} s, eager serve_fn "
            f"{times['eager']:.4f} s (best of {reps}) | tokens equal "
            f"{torch.equal(outs['compiled'], outs['eager'])}")


def inductor_toolchain(torch, work) -> str:
    """Check what AOTInductor needs on this machine before any compile:
    Triton, and a host compiler that links an OpenMP shared object (the
    wrapper's link line always carries ``-fopenmp -lgomp`` for g++). The
    compiler Inductor picks (``CXX``) is tried first, then every ``g++`` on
    ``PATH``; the first that links is given to Inductor
    (``torch._inductor.config.cpp.cxx``, and ``CXX`` for its workers). None:
    raise. Returns the log line."""
    import triton
    from torch._inductor import config as inductor_config
    from torch._inductor import cpp_builder

    src = work / "omp_probe.cpp"
    src.write_text("int f(int n) { int s = 0;\n#pragma omp parallel for reduction(+:s)\n"
                   "for (int i = 0; i < n; ++i) s += i; return s; }\n")
    chosen = cpp_builder.get_cpp_compiler()
    path_gxx = [str(Path(d) / "g++") for d in os.environ.get("PATH", "").split(os.pathsep)
                if d and (Path(d) / "g++").is_file()]
    tried = []
    for cxx in dict.fromkeys([chosen] + path_gxx):
        r = subprocess.run([cxx, "-shared", "-fPIC", "-fopenmp", str(src), "-o",
                            str(work / "omp_probe.so"), "-lgomp"], capture_output=True,
                           text=True)
        tried.append(f"{cxx}: {'links' if r.returncode == 0 else r.stderr.strip()[:120]}")
        if r.returncode == 0:
            inductor_config.cpp.cxx = (None, cxx)
            os.environ["CXX"] = cxx
            return (f"Inductor: Triton {triton.__version__} | host compiler {cxx} (Inductor's "
                    f"own pick {chosen}) | tried: " + "; ".join(tried) +
                    f" | compile threads {inductor_config.compile_threads}")
    raise RuntimeError("no host compiler links an OpenMP shared object: " + "; ".join(tried))


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


def check_decode_stats(torch, da, ref, gen, case, timed: bool):
    """The decode kernel's stats entry against ``ref.decode_attention(...,
    return_stats=True)``: m (natural-log units) and l of the live rows within
    the scaled tolerance, acc / l within the decode tolerance, and every row
    of length 0 exactly (NEG_INF, 0, 0)."""
    B, S, Hq, Hkv, D, lengths, dtype = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lengths):            # cache slots past length hold NaN
        kc[b, n:] = float("nan")
        vc[b, n:] = float("nan")
    m, l, acc = da.decode_attention_stats(q, kc, vc, length)
    again = da.decode_attention_stats(q, kc, vc, length)
    em, el, ea = ref.decode_attention(q, kc, vc, length, return_stats=True)
    torch.cuda.synchronize()
    live = torch.tensor([n > 0 for n in lengths], device="cuda")
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    want = ea / torch.where(el == 0, 1.0, el)[..., None]
    err = (out - want).abs().max().item()
    m_err = scaled_err(m[live], em[live]) if bool(live.any()) else 0.0
    l_err = scaled_err(l[live] / el[live].clamp_min(1e-30), torch.ones_like(el[live])) \
        if bool(live.any()) else 0.0
    empty_exact = all(bool((m[b] == ref.NEG_INF).all() and (l[b] == 0).all() and
                           (acc[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
    rerun_bitwise = all(bool(torch.equal(a, b)) for a, b in zip((m, l, acc), again))
    ok = all(bool(torch.isfinite(t).all()) for t in (m, l, acc)) and err <= TOL[dtype] and \
        m_err <= SCALED_TOL["float32"] and l_err <= SCALED_TOL["float32"] and \
        empty_exact and rerun_bitwise
    row = {"case": [B, S, Hq, Hkv, D, list(lengths), dtype], "max_abs_err": err,
           "scaled_err_m": m_err, "rel_err_l": l_err, "empty_rows_exact": empty_exact,
           "rerun_bitwise": rerun_bitwise, "ok": ok}
    if timed:
        n_live = sum(min(n, S) for n in lengths)
        nbytes = (q.numel() + 2 * n_live * Hkv * D) * q.element_size() + \
            4 * (2 * B * Hq + B * Hq * D) + 4 * B
        rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * Hq * D * n_live, rate)
        # no single PyTorch call returns the unnormalised stats
        row.update(timings(
            torch, lambda: da.decode_attention_stats(q, kc, vc, length), 200,
            lambda: ref.decode_attention(q, kc, vc, length, return_stats=True), 20))
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


def decode_tier(torch, gw, dep) -> dict:
    """Phase 3b: the continuous-batching decode tier at full width, the
    decode scheduler that ``gw.deploy`` built for ``dep``, fed through
    ``gw.invoke_decode_async``; ends by closing the decode loop (the gateway
    stays up for phase 3e). Returns the kernel launches of the burst."""
    import numpy as np
    from repro_torch import pytree
    from repro_torch.core.deploy import make_admit_fn, make_step_fn
    from repro_torch.core.metrics import now
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg, spec = dep.model.cfg, dep.spec
    L = cfg.n_layers
    sched = gw.decoders[dep.name]
    bundle = sched.bundle
    pool_gb = 2 * L * bundle.n_pages * bundle.page_size * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2 / 1e9
    log(f"ensure_decode (in gw.deploy): {sum(bundle.build_s.values()):.1f} s [" +
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

    sched.bundle = dataclasses.replace(bundle, admit=observed("admit", bundle.admit),
                                       step=observed("step", bundle.step))
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (N_DECODE_REQUESTS, 1, spec.prompt_len), dtype=np.int32)
    budgets = [DECODE_BUDGETS[i % len(DECODE_BUDGETS)] for i in range(N_DECODE_REQUESTS)]
    ops.reset_launch_counts()
    t0 = now()
    futs = [gw.invoke_decode_async(dep.name, p, max_new=b, label=f"decode{i}")
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    outs = [f.result(900) for f in futs]
    t_served = now()
    sched.close()                           # the decode loop: drain, cool to zero
    sched.bundle = bundle                   # the observers hold the captured weights
    launches = ops.launch_counts()

    s = gw.decode_summary(dep.name)
    if s["requests"] != N_DECODE_REQUESTS or s["tokens_generated"] != sum(budgets):
        raise AssertionError(f"gw.decode_summary: {s}")
    tl = gw.recorder.timelines("decode0")[0]
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
            "decode_attention_stats": 0,
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
                                          capacity=spec.prompt_len + sched.default_max_new)
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


def serve_path(torch, spec, work, n_requests, want_per_request, tokens_gate="eager"):
    """Deploy ``spec`` on the GPU, serve ``n_requests`` cold requests through the
    ``unikernel`` driver (boot -> run -> exit) with the kernel launches of
    each request equal to ``want_per_request(cfg, spec)``, hold the served
    tokens against the eager program's (``tokens_gate="eager"``: equal, or
    raise) or against the plain path in float32 fed the same tokens
    (``"f32"``: ``served_token_gate``), time each boot track alone, then, on
    the last executor's weights, hold every kernel call of a kernel-path
    prefill against its plain version and the kernel path's prefill logits
    against the plain path in float32. The float32 weights are read from the
    snapshot after the executor has exited, so the card never holds both
    copies. Returns (deployment, launches of the requests)."""
    from repro_torch.core import compile_cache
    from repro_torch.core.boot import streamed_device_put
    from repro_torch.core.compile_cache import CompileCache, package_op_calls
    from repro_torch.core.deploy import deploy
    from repro_torch.core.drivers import UnikernelDriver
    from repro_torch.core.metrics import Timeline, now
    from repro_torch.core.snapshot import SnapshotStore
    from repro_torch.kernels import ops

    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    log(f"before deploy {spec.name}: {memory_line(torch, work)}")
    t0 = time.perf_counter()
    lookups = dict(compile_cache.counters())
    dep = deploy(spec, CompileCache(work / "programs"), SnapshotStore(work / "snapshots"),
                 str(work), device="cuda")
    lookups = {k.replace("aoti_package_cache_", "package "): v - lookups.get(k, 0)
               for k, v in compile_cache.counters().items() if v - lookups.get(k, 0)}
    m = dep.image.manifest
    cfg = dep.model.cfg
    log(f"deploy {spec.name}: {time.perf_counter() - t0:.1f} s [" +
        " ".join(f"{k} {v:.2f}" for k, v in dep.build_s.items()) +
        f"] | cache lookups {lookups} | {m.param_count} params | program "
        f"{m.program_bytes} B | snapshot "
        f"{m.snapshot_bytes} B | split_ok {dep.split_ok} | "
        f"{cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype} | "
        f"{memory_line(torch, work)}")
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(dep.example_tokens(seed=1)).cuda()
    want = compiled_launches(dep, want_per_request(cfg, spec))
    if not dep.split_ok:
        raise AssertionError(f"deploy {spec.name}: the head/tail split was not verified")
    driver = UnikernelDriver()
    ops.reset_launch_counts()
    first = None
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
        nodes = f" | package: {len(package_op_calls(dep.fetch_program_payload()))} " \
            "custom-op calls" if r == 0 else ""
        log(f"request {r + 1}: boot [{stages}] t_boot_wall {tl.t_boot_wall:.3f} s | "
            f"execution {tl.execution:.3f} s | launches {grew} | tokens {out.tolist()}{nodes}")
        if grew != want:
            raise AssertionError(f"launches per request {grew}, expected {want}")
        if tuple(out.shape) != (spec.batch_size, spec.decode_steps) \
                or out.dtype != torch.int32 or not bool(((out >= 0) &
                                                        (out < cfg.vocab_size)).all()):
            raise AssertionError(f"bad output {out.shape} {out.dtype}")
        first = out if first is None else first
        if not torch.equal(out, first):
            raise AssertionError(f"request {r + 1}'s tokens differ from request 1's")
        if r < n_requests - 1:
            driver.finish(dep, ex)
    launches = ops.launch_counts()
    with torch.inference_mode():
        eager = dep.serve_fn(ex.params, tokens)
    # The compiled glue's row reductions round otherwise than eager's kernels
    # (tools/compiled_rounding.py). Where the stack keeps that below a
    # greedy choice the served tokens equal the eager program's; xlstm's
    # random-weight blocks turn any rounding into other tokens (its two eager
    # bf16 paths, kernel and plain, agree on 1 of 4 first tokens), so its
    # served tokens are held against the f32 plain path instead.
    differ = (eager != first).nonzero().tolist()
    log(f"every request's tokens equal request 1's; the eager program's equal them: "
        f"{not differ}" + (f" (eager {eager.tolist()}; (row, step) that differ {differ})"
                           if differ else "") + f" | gate: {tokens_gate}")
    if differ and tokens_gate == "eager":
        raise AssertionError(f"the eager program's tokens {eager.tolist()} differ from the "
                             f"served ones {first.tolist()}")

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
    program = dep.load_program()
    t4 = now()
    log(f"tracks alone: weights restore_weights_host {t1 - t0:.3f} s + device_put "
        f"{t2 - t1:.3f} s ({m.snapshot_bytes / (t2 - t1) / 1e9:.2f} GB/s) | program "
        f"fetch+deserialize {t4 - t3:.3f} s | requests and tracks alone: "
        f"{memory_line(torch, work)}")
    log(execution_line(torch, program, dep.serve_fn, ex.params, tokens))
    del program
    torch.cuda.reset_peak_memory_stats()

    prefill_gates(torch, dep, [ex.params], tokens, out, work,
                  release=lambda: driver.finish(dep, ex), steps=tokens_gate == "f32")
    return dep, launches


def prefill_gates(torch, dep, held, tokens, out, work, release, steps=False) -> None:
    """Same weights (``held``, a one-item list the gates take the weights
    out of, and the snapshot they came from): the kernel
    path, the plain path, and the plain path in float32 as the reference.
    Two bf16 paths drift apart over the layers by bf16 rounding alone, so the
    gate is that the kernel path, and the compiled head program (prefill and
    first token, AOTInductor's glue around the kernels) when the deployment
    has one, are no less accurate than the plain bf16 path: each one's
    relative L2 error against the f32 logits is at most twice the plain
    path's. A wrong kernel would be off by orders of magnitude, except
    where the stack loses the f32 logits in bf16 by itself (xlstm's
    random-weight blocks, all 48 of them): there the per-call check carries
    the kernels' correctness. ``release()`` drops the caller's hold on the
    bf16 weights before the f32 ones are read from the snapshot, so the card
    never holds both; ``out`` are the tokens the path served. With ``steps``
    the plain paths, bf16 and f32, also run the serve loop fed ``out``, and
    ``served_token_gate`` holds each served token against them."""
    from repro_torch import pytree
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    spec, cfg, key = dep.spec, dep.model.cfg, dep.image.key
    params = held.pop()
    batch = {"tokens": tokens}
    with torch.inference_mode(), recorded_kernel_calls(ops) as calls:
        lk, _ = dep.model.prefill(params, batch, capacity=spec.prompt_len)
    check_recorded_calls(torch, calls)
    del calls
    lc = None
    if dep.split_ok:
        head = dep.cache.load_program(dep.head_program_key())
        with torch.inference_mode():
            _, lc, _ = head(params, tokens)
        del head
    cap, n_fed = spec.prompt_len + spec.decode_steps, spec.decode_steps - 1
    with torch.inference_mode(), ops.impl_scope("plain"):
        lp, _ = dep.model.prefill(params, batch, capacity=spec.prompt_len)
        out_plain = dep.serve_fn(params, tokens)
        sp = step_logits(torch, dep.model, params, tokens, cap, n_fed, out)[0] if steps else None
    del params
    release()
    gc.collect()
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), dep.model.max_seq)
    with torch.inference_mode(), ops.impl_scope("plain"):
        params32 = pytree.tree_map(lambda t: t.to("cuda").float(),
                                   dep.snapshots.load_host(key))
        l32, _ = model32.prefill(params32, batch, capacity=spec.prompt_len)
        s32 = step_logits(torch, model32, params32, tokens, cap, n_fed, out)[0] if steps \
            else None
        del params32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gates, f32 reference included: {memory_line(torch, work)}")
    logit_gate(torch, lk, lp, l32, out, out_plain)
    if steps:
        served_token_gate(out, sp, s32)
    if lc is not None:
        lc, lp = lc.float(), lp.float()
        err_c, err_p = rel_l2(lc, l32), rel_l2(lp, l32)
        log(f"compiled head program's prefill logits vs the f32 plain path: rel_l2 "
            f"{err_c:.4g}, plain bf16 path {err_p:.4g} (gate: compiled <= 2 x plain) | vs the "
            f"eager kernel path: rel_l2 {rel_l2(lc, lk.float()):.4g}, first-token agreement "
            f"{(lc.argmax(-1) == lk.float().argmax(-1)).float().mean().item():.3f}")
        if not (bool(torch.isfinite(lc).all()) and err_c <= 2.0 * err_p):
            raise AssertionError("the compiled program's prefill logits are less accurate than "
                                 "the plain path's")


def served_token_gate(out, lp, l32) -> None:
    """Each token a compiled program served (``out`` [B, K]) against the plain
    path in float32 fed the same tokens: ``l32[k]`` are the logits token ``k``
    is chosen from (the prefill's, then each decode step's), ``lp[k]`` the
    plain bf16 path's. The served token's f32 logit must lie at most 4 e below
    that row's f32 maximum, e the plain bf16 path's largest logit error on
    the row: a path whose logits stay within 2 e of the f32 ones (the
    repo's "at most twice the plain path's error") can pick no token further
    down, while wrong decode glue picks tokens whole units below it."""
    checked, bad = [], []
    for k in range(out.shape[1]):
        for b in range(out.shape[0]):
            e = (lp[k][b] - l32[k][b]).abs().max().item()
            gap = (l32[k][b].max() - l32[k][b][out[b, k]]).item()
            checked.append((k, b, round(gap, 5), round(4 * e, 5)))
            if not gap <= 4 * e:
                bad.append(checked[-1])
    log(f"served tokens vs the f32 plain path fed them: (step, row, f32 logit gap below the "
        f"maximum, bound 4 x the plain bf16 path's largest logit error) {checked}")
    if bad:
        raise AssertionError(f"served tokens the f32 logits rank too low: {bad}")


def logit_gate(torch, lk, lp, l32, out, out_plain) -> None:
    """The kernel path's prefill logits ``lk`` no less accurate against the
    plain path in float32 (``l32``) than the plain bf16 path's ``lp``: rel_l2
    at most twice as large; ``out`` and ``out_plain`` are the two paths'
    greedy tokens (their agreement is logged, not gated: near-ties)."""
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


# ---------------------------------------------------------------- phase 3

GATEWAY_BURST = 4                   # requests of phase 3's concurrent burst
GATEWAY_REQUESTS = 3 + GATEWAY_BURST  # request 1, request 2, the burst, request 7


def gateway_path(torch, spec, work):
    """Phase 3: llama's serve path through the port's Gateway on two hosts.

    Deploy (program + v2 chunked snapshot + the decode bundle), then request 1
    (the store path), request 2 (the same host: program and tree memos), a
    burst of ``GATEWAY_BURST`` over both hosts (concurrent boots on one
    card), request 1's host killed and request 7 served on the survivor, and
    a noop. Every request's tokens equal request 1's, and each request makes
    L flash launches and the decode launches its package calls
    (``compiled_launches``: L x (K - 1) for llama). Then
    each boot track alone, the compiled program's execution beside the eager
    ``serve_fn``, and the prefill gates on the snapshot's weights. Returns
    (gateway, deployment, launches of the requests); the gateway stays up for
    phase 3b."""
    import numpy as np
    from repro_torch.core import FunctionSpec, Gateway, compile_cache
    from repro_torch.core.blobstore import delta_restore
    from repro_torch.core.boot import streamed_device_put
    from repro_torch.core.decode import DecodeConfig
    from repro_torch.core.metrics import now
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import ops

    spec = FunctionSpec(**spec)
    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    log(f"before deploy {spec.name}: {memory_line(torch, work)}")
    # A chunk tier refuses a snapshot larger than itself, and then every boot
    # pays the store path and the tree memo never hits: 4 GiB holds the
    # snapshot at up to 12 layers (8 layers: 2.40 GB, over the default
    # SchedulerConfig.snapshot_tier_bytes = 2 << 30).
    gw = Gateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                 scheduler=SchedulerConfig(snapshot_tier_bytes=4 << 30),
                 decode=DecodeConfig(slots=DECODE_SLOTS, page_size=PAGE_SIZE,
                                     max_new=DECODE_MAX_NEW),
                 work_dir=str(work))
    t0 = time.perf_counter()
    dep = gw.deploy(spec)
    m, cfg, name, key = dep.image.manifest, dep.model.cfg, dep.name, dep.image.key
    blobs = gw.blobs.stats()
    log(f"deploy {name} through the Gateway: {time.perf_counter() - t0:.1f} s (decode bundle "
        f"included) [" + " ".join(f"{k} {v:.2f}" for k, v in dep.build_s.items()) +
        f"] | {m.param_count} params | program {m.program_bytes} B | v2 snapshot "
        f"{m.snapshot_bytes} B in {m.extra['snapshot_chunks']} chunks of "
        f"{m.extra['chunk_bytes']} B (store: {int(blobs['chunks'])} chunks, "
        f"{int(blobs['bytes'])} B, {int(blobs['dedup_hits'])} dedup hits) | split_ok "
        f"{dep.split_ok} | {cfg.n_layers} "
        f"layers d_model "
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} {cfg.dtype} | "
        f"{memory_line(torch, work)}")

    # observe, without changing them, which host served each request and how
    # many program deserializes each step paid
    hosts, deserialized = {}, [0]
    handle, deserialize = gw.agent.handle, gw.cache.deserialize_program

    def observed_handle(host, dep_, tokens_, driver_name, tl, *args, **kwargs):
        hosts[id(tl)] = host.host_id
        return handle(host, dep_, tokens_, driver_name, tl, *args, **kwargs)

    def counted_deserialize(payload):
        deserialized[0] += 1
        return deserialize(payload)

    gw.agent.handle = observed_handle
    gw.cache.deserialize_program = counted_deserialize

    tokens = dep.example_tokens(seed=1)
    want = compiled_launches(dep, llama_launches(cfg, spec))
    first = {}

    def served(label, outs, launched, n_deser):
        """Log and check every request of one step of the phase."""
        tls = gw.recorder.timelines(label)
        if len(tls) != len(outs):
            raise AssertionError(f"{label}: {len(tls)} timelines for {len(outs)} requests")
        for i, (tl, out) in enumerate(zip(tls, outs)):
            stages = " ".join(f"{k} {v:.3f}" for k, v in tl.stage_s.items())
            log(f"{label}{f'[{i}]' if len(tls) > 1 else ''}: host {hosts[id(tl)]} | boot "
                f"[{stages}] t_boot_wall {tl.t_boot_wall:.3f} s | execution "
                f"{tl.execution:.3f} s | e2e {tl.e2e:.3f} s | bytes fetched "
                f"{int(tl.bytes_fetched)} deduped {int(tl.bytes_deduped)} | tokens "
                f"{out.tolist() if not first else 'as request 1'}")
            if out.shape != (spec.batch_size, spec.decode_steps) or out.dtype != np.int32 \
                    or not ((out >= 0) & (out < cfg.vocab_size)).all():
                raise AssertionError(f"{label}: bad output {out.shape} {out.dtype}")
            first.setdefault("tokens", out)
            if not np.array_equal(out, first["tokens"]):
                raise AssertionError(f"{label}: tokens differ from request 1's")
        grew = {k: launched[k] for k in want}
        if grew != {k: v * len(outs) for k, v in want.items()}:
            raise AssertionError(f"{label}: launches {grew}, expected {want} x {len(outs)}")
        log(f"{label}: launches {grew} | program deserializes {n_deser}")
        return tls

    def step(label, run):
        before, n0 = ops.launch_counts(), deserialized[0]
        outs = run()
        after = ops.launch_counts()
        return served(label, outs, {k: after[k] - before[k] for k in after},
                      deserialized[0] - n0)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (tl1,) = step("request 1", lambda: [gw.invoke(name, tokens, label="request 1", timeout=900)])
    (tl2,) = step("request 2", lambda: [gw.invoke(name, tokens, label="request 2", timeout=900)])
    if hosts[id(tl2)] != hosts[id(tl1)] or {"fetch_program_cached", "restore_weights_cached"} \
            - set(tl2.stage_s) or deserialized[0] != 1:
        raise AssertionError(f"request 2 missed the host's memos: host {hosts[id(tl2)]} "
                             f"stages {list(tl2.stage_s)}, {deserialized[0]} deserializes")
    compile_cache.PROGRAM_WAITS.reset()
    step("burst", lambda: gw.invoke_many(name, [tokens] * GATEWAY_BURST, label="burst",
                                          timeout=900))
    waits = compile_cache.PROGRAM_WAITS.summary()
    log(f"burst: calls of a loaded package {waits['calls']}, waiting for another call of it "
        f"{waits['total_s']:.4f} s in all, {waits['max_s']:.4f} s at most")
    killed = hosts[id(tl1)]
    gw.cluster.kill_host(killed)
    (tl7,) = step("request 7", lambda: [gw.invoke(name, tokens, label="request 7", timeout=900)])
    if hosts[id(tl7)] == killed:
        raise AssertionError(f"request 7 landed on the killed host {killed}")
    log(f"host {killed} killed -> next request still served on host {hosts[id(tl7)]}")
    t = now()
    gw.noop()
    log(f"noop: {1e3 * (now() - t):.3f} ms")
    launches = ops.launch_counts()
    gw.agent.handle = handle
    gw.cache.deserialize_program = deserialize

    placement = gw.placement_summary()
    for hid, h in placement["hosts"].items():
        log(f"placement host {hid} (alive {h['alive']}): program tier hits "
            f"{int(h['program']['hits'])} misses {int(h['program']['misses'])} bytes "
            f"{int(h['program']['bytes'])} | chunk tier snapshots {int(h['snapshot']['items'])} "
            f"chunks {int(h['snapshot']['chunks'])} bytes {int(h['snapshot']['bytes'])} tree hits "
            f"{int(h['snapshot']['hits'])} misses {int(h['snapshot']['misses'])} | peer fetches "
            f"{h['peer_fetches']} ({h['bytes_from_peer']} B) store fetches {h['store_fetches']} "
            f"({h['bytes_from_store']} B) peer serves {h['peer_serves']}")
    res = gw.resilience_summary()
    log("resilience: " + json.dumps({k: res[k] for k in ("submitted", "attempts", "retries",
                                                         "retries_denied", "breakers")}))
    log(f"gateway phase: residency {gw.residency_summary()} | {memory_line(torch, work)}")

    # each boot track alone: the weights from the global chunk store (no
    # host tier), their device copy, and the program's fetch + deserialize
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    tree, stats = delta_restore(dep.snapshots, key)
    t1 = now()
    dev = streamed_device_put(tree, "cuda")
    t2 = now()
    del tree
    program = dep.load_program()
    t3 = now()
    log(f"tracks alone: weights from the chunk store {t1 - t0:.3f} s ({stats.t_store_s:.3f} s "
        f"reading and checking {m.extra['snapshot_chunks']} chunks) + device_put "
        f"{t2 - t1:.3f} s ({m.snapshot_bytes / (t2 - t1) / 1e9:.2f} GB/s, pageable) | program "
        f"fetch+deserialize {t3 - t2:.3f} s | {memory_line(torch, work)}")
    log(execution_line(torch, program, dep.serve_fn, dev, torch.from_numpy(tokens).cuda(),
                       strict=True))
    del program
    prefill_gates(torch, dep, [dev], torch.from_numpy(tokens).cuda(),
                  torch.from_numpy(first["tokens"]).cuda(), work, release=lambda: None)
    del dev
    return gw, dep, launches, first["tokens"]


# -------------------------------------------------------------------- phase 3e

TAXONOMY_REQUESTS = 2               # requests per driver in phase 3e, cut from 3 for the time limit
# re-trace + compile boots: cold_jit_cached once (it must read the package
# deploy compiled), cold_jit twice at once (whole compiles with every cache
# off; the second waits for the first)
RETRACE_REQUESTS = {"cold_jit_cached": 1, "cold_jit": 2}
MEMORY_SLACK = 64 << 20             # device memory allowed to stay allocated after 3e


def tensor_bytes(torch) -> int:
    """Device memory held by tensors. PyTorch keeps a cuBLAS workspace for
    every (thread, stream) that ran a matmul, for the life of the process,
    and phase 3e's new host threads add some: they are dropped first, so the
    number counts what the port holds."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def driver_taxonomy(torch, gw, dep, want_tokens, inductor_cache) -> dict:
    """Phase 3e: the paper's driver taxonomy on phase 3's llama deployment,
    through ``gw.invoke(..., driver=name)``.

    Each driver of ``ALL_DRIVERS`` serves ``TAXONOMY_REQUESTS`` requests in
    that order (the two cold_jit drivers ``RETRACE_REQUESTS``: before
    cold_jit_cached's, ``enable_inductor_disk_cache(inductor_cache)``, the
    directory deploy compiled through, and the package-key parts of a trace
    on fakes logged against those deploy recorded; each re-trace + compile
    boot logs its ``trace`` / ``compile`` / ``load`` parts and its
    compile-cache lookups; the cold_jit_cached boot must read deploy's
    package, cold_jit's two requests go together, must hit nothing, and log
    how long one build waited for the other), then
    ``unikernel`` and ``unikernel_stream`` one request each on a host added
    for it (the other hosts held down meanwhile, so it is a first boot on an
    empty-tier host, from the store). Every request gives phase 3's request-1
    tokens and makes the launches of ``compiled_launches``; the streamed first
    boot runs the head program (``restore_stream_head``, TTFR below its own
    ``t_boot_wall``). Then a ``Gateway(mode="warm")`` serving the same image
    (its stores shared: no second deploy): a pool miss, a pool hit, and the
    warm scaler's residency beside the cold gateway's zero, until its idle
    timeout expires the pools. Ends with both gateways' ``shutdown()``: no
    non-daemon thread left, and device memory back within ``MEMORY_SLACK``
    of its value before the phase. Returns the kernel launches of the
    phase's requests."""
    import concurrent.futures
    import threading

    import numpy as np
    from torch._dynamo.utils import counters
    from repro_torch.core import Gateway, compile_cache
    from repro_torch.core.boot import export_on_fakes
    from repro_torch.core.drivers import ALL_DRIVERS
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import ops

    allocated0 = tensor_bytes(torch)
    cfg, spec, name = dep.model.cfg, dep.spec, dep.name
    tokens = dep.example_tokens(seed=1)
    want = compiled_launches(dep, llama_launches(cfg, spec))
    log(f"phase 3e on {name}: split_ok {dep.split_ok} (head reads {len(dep.head_leaves)} "
        f"leaves) | first-use order {dep.first_use_order} | device memory allocated "
        f"{allocated0} B")
    if not dep.split_ok:
        raise AssertionError("llama's deployment published no verified head/tail split")

    hosts = {}
    handle = gw.agent.handle

    def observed_handle(host, dep_, tokens_, driver_name, tl, *args, **kwargs):
        hosts[id(tl)] = host.host_id
        return handle(host, dep_, tokens_, driver_name, tl, *args, **kwargs)

    def cache_counts() -> dict:
        return {**{f"inductor {k}": v for k, v in counters["inductor"].items()
                   if "cache" in k},
                **{f"package {k[len('aoti_package_cache_'):]}": v
                   for k, v in compile_cache.counters().items()}}

    def serve(driver, label, gateway=gw, alone=True):
        """One request; with ``alone`` False others run beside it, and its
        launch counts (process-wide) are checked by the caller."""
        before, cached0 = ops.launch_counts(), cache_counts()
        out = gateway.invoke(name, tokens, driver=driver, label=label, timeout=900)
        after = ops.launch_counts()
        grew = {k: after[k] - before[k] for k in after}
        lookups = {k: v - cached0.get(k, 0) for k, v in cache_counts().items()
                   if v != cached0.get(k, 0)}
        seen_lookups[label] = lookups
        (tl,) = gateway.recorder.timelines(label)
        if driver == "unikernel_stream":        # the tail's stages land in the background
            t_wait = time.perf_counter()
            while "deserialize_program_bg" not in tl.stage_s and \
                    time.perf_counter() - t_wait < 300:
                time.sleep(0.01)
        stages = " ".join(f"{k} {v:.3f}" for k, v in tl.stage_s.items())
        ttfr = f" | TTFR {tl.ttfr:.3f} s" if driver == "unikernel_stream" else ""
        log(f"{label}: host {hosts.get(id(tl), '-')} | boot [{stages}] t_boot_wall "
            f"{tl.t_boot_wall:.3f} s | startup {tl.startup:.3f} s | execution "
            f"{tl.execution:.3f} s{ttfr} | e2e {tl.e2e:.3f} s | launches {grew}")
        if out.shape != want_tokens.shape or not np.array_equal(out, want_tokens):
            raise AssertionError(f"{label}: tokens {out.tolist()} differ from request 1's")
        if alone and grew != want:
            raise AssertionError(f"{label}: launches {grew}, expected {want}")
        if driver.startswith("cold_jit"):
            # async_compile_cache_hit counts Triton kernels met twice within
            # one compile (its in-memory table starts empty each compile)
            log(f"{label}: trace {tl.stage_s['trace']:.3f} s, compile "
                f"{tl.stage_s['compile']:.3f} s, load {tl.stage_s['load']:.3f} s | cache "
                f"lookups {lookups}")
            hits = {k: v for k, v in lookups.items()
                    if k in ("package hit", "inductor fxgraph_cache_hit")}
            if driver == "cold_jit" and hits:
                raise AssertionError(f"{label} read a compile cache: {hits}")
        return tl

    def on_new_host(driver):
        """One request on a host added for it, the other hosts held down."""
        new = gw.cluster.add_host()
        held = [h for h in gw.cluster.hosts if h.alive and h is not new]
        for h in held:
            h.kill()
        try:
            tl = serve(driver, f"{driver} on new host {new.host_id}")
        finally:
            for h in held:
                h.revive()
        c = gw.placement_summary()["hosts"][new.host_id]
        path = "peer" if c["peer_fetches"] else "store"
        log(f"{driver} on new host {new.host_id}: the {path} path (peer fetches "
            f"{c['peer_fetches']}, {c['bytes_from_peer']} B; store fetches "
            f"{c['store_fetches']}, {c['bytes_from_store']} B; partial restores "
            f"{c['partial_restores']})")
        return tl

    gw.agent.handle = observed_handle
    def at_once(driver, n):
        """``n`` requests of ``driver`` submitted together; logs how long their
        compiles waited for each other's (``compile_cache.COMPILE_WAITS``)."""
        compile_cache.COMPILE_WAITS.reset()
        before = ops.launch_counts()
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            tls = [f.result() for f in [pool.submit(serve, driver, f"{driver} request {r + 1}",
                                                    alone=False) for r in range(n)]]
        after = ops.launch_counts()
        grew = {k: after[k] - before[k] for k in after}
        if grew != {k: v * n for k, v in want.items()}:
            raise AssertionError(f"{driver}'s {n} requests: launches {grew}, expected {want} x {n}")
        w = compile_cache.COMPILE_WAITS.summary()
        log(f"{driver}: {n} requests at once: {w['calls']} builds (trace + compile), waiting "
            f"for another's {w['total_s']:.3f} s in all, {w['max_s']:.3f} s at most | compile "
            f"parts {[round(tl.stage_s['compile'], 3) for tl in tls]}")
        return tls

    ops.reset_launch_counts()
    compile_s, seen_lookups = {}, {}
    try:
        for driver in ALL_DRIVERS:
            n = RETRACE_REQUESTS.get(driver, TAXONOMY_REQUESTS)
            if driver == "cold_jit_cached":
                compile_cache.enable_inductor_disk_cache(inductor_cache)
                deployed = dep.image.manifest.extra["package_key_parts"]
                traced = compile_cache.aoti_package_key_parts(export_on_fakes(dep))
                log("package key of a trace on fake tensors against the one deploy compiled: "
                    f"parts that differ {[k for k in deployed if deployed[k] != traced.get(k)]}")
            if driver == "cold_jit":
                tls = at_once(driver, n)
            else:
                tls = [serve(driver, f"{driver} request {r + 1}") for r in range(n)]
            if driver == "cold_jit_cached":
                for r in range(n):
                    label = f"{driver} request {r + 1}"
                    if seen_lookups[label].get("package hit") != 1:
                        raise AssertionError(f"{label} did not read the package deploy "
                                             f"compiled: {seen_lookups[label]}")
            if driver.startswith("cold_jit"):
                compile_s[driver] = [tl.stage_s["compile"] for tl in tls]
        if not max(compile_s["cold_jit_cached"]) < 0.25 * min(compile_s["cold_jit"]):
            raise AssertionError(f"cold_jit_cached's compile parts are not well under "
                                 f"cold_jit's: {compile_s}")
        on_new_host("unikernel")
        tl = on_new_host("unikernel_stream")
        if "restore_stream_head" not in tl.stage_s or "deserialize_program_bg" not in \
                tl.stage_s or not 0.0 < tl.ttfr < tl.t_boot_wall:
            raise AssertionError(f"the streamed first boot did not run the head program ahead "
                                 f"of its tail: stages {list(tl.stage_s)}, TTFR {tl.ttfr}, "
                                 f"t_boot_wall {tl.t_boot_wall}")
    finally:
        gw.agent.handle = handle
    launches = ops.launch_counts()
    log(f"phase 3e: launches {launches} | cold gateway residency {gw.residency_summary()} | "
        f"per-host resident bytes (cold scaler) {gw.placement_summary()['per_host_resident_bytes']}")

    # the incumbent: a warm gateway serving the same image
    # One host, its tiers filled by a cold request first: the pool miss then
    # boots from them well inside the warm scaler's 2 s arrival window, so
    # the scaler's next tick keeps the pooled executor for request 2 (after
    # a miss from the store, 5-6 s, its target had fallen to 0 and a tick
    # could expire the executor before request 2 arrived)
    wgw = Gateway(n_hosts=1, slots_per_host=2, mode="warm", hedging=False,
                  scheduler=SchedulerConfig(snapshot_tier_bytes=4 << 30),
                  work_dir=gw.work_dir, device=dep.device)
    wgw.deployments[name] = dep                 # phase 3's image, its stores shared
    try:
        before = ops.launch_counts()
        serve("unikernel", "warm gateway tier fill", wgw)
        miss = serve("warm", "warm gateway request 1", wgw)
        hit = serve("warm", "warm gateway request 2", wgw)
        if "pool_checkout" not in hit.stage_s:
            raise AssertionError(f"the warm gateway's second request missed its pool: "
                                 f"{list(hit.stage_s)}")
        warm_res = wgw.placement_summary()["per_host_resident_bytes"]
        cold_res = gw.placement_summary()["per_host_resident_bytes"]
        log(f"warm gateway: request 1 {'hit' if 'pool_checkout' in miss.stage_s else 'miss'}, "
            f"request 2 hit | target {wgw.scaler.target(name)} | per-host resident bytes: "
            f"warm {warm_res}, cold {cold_res}")
        if not sum(warm_res.values()) or any(cold_res.values()):
            raise AssertionError("warm residency should be > 0 and cold residency 0")
        t_idle = time.perf_counter()
        while wgw.scaler.resident_nbytes(wgw.cluster) and time.perf_counter() - t_idle < 120:
            time.sleep(0.1)
        log(f"warm gateway: pools expired by the idle timeout after {time.perf_counter() - t_idle:.2f} "
            f"s | residency {wgw.residency_summary()}")
        after = ops.launch_counts()
        launches = {k: launches[k] + after[k] - before[k] for k in launches}
    finally:
        wgw.shutdown()
    threads = set(threading.enumerate())
    gw.shutdown()
    t_join = time.perf_counter()
    while time.perf_counter() - t_join < 30:
        alive = [t.name for t in threading.enumerate() if not t.daemon
                 and t is not threading.main_thread()]
        if not alive:
            break
        time.sleep(0.05)
    log(f"gw.shutdown(): threads before {len(threads)}, non-daemon threads left {alive} | "
        f"residency after flushing pools and donors {gw.residency_summary()}")
    if alive:
        raise AssertionError(f"gw.shutdown() left non-daemon threads alive: {alive}")
    allocated1 = tensor_bytes(torch)
    log(f"phase 3e: device memory allocated before {allocated0} B, after {allocated1} B "
        f"(difference {allocated1 - allocated0} B, allowed {MEMORY_SLACK} B)")
    if abs(allocated1 - allocated0) > MEMORY_SLACK:
        raise AssertionError("phase 3e left device memory allocated")
    return launches


# -------------------------------------------------------------------- phase 3f

COALESCE_BUCKETS = (1, 2, 4)        # request-count buckets: 4, 8 and 16 token rows
# a window wide enough that a burst submitted in one loop lands in full
# batches (the JAX package's tests take the same)
COALESCE_WINDOW_S = 0.02
COALESCE_BURST = 8                  # distinct prompts in one burst: two batches of 4
COALESCE_PAIR = 2                   # then two more: one batch in the 8-row bucket
RAMP_S = 10.0                       # single requests at a rate rising over this long
RAMP_RPS = (0.5, 4.0)               # from, to
QUIET_WAIT_S = 40.0                 # how long the quiet may take to cool the pool down
FORECAST_SPEC = dict(model="ewma", bucket_s=1.0, horizon_s=2.0, plan_interval_s=0.5,
                     season_period_s=8.0, season_buckets=8, preboot_ttl_s=4.0,
                     max_preboots_per_tick=2, cool_rate_threshold=0.5)
FIT_EPOCHS = 20                     # the learned forecaster's fit, card and CPU
FIT_RTOL = 1e-3                     # card predictions vs the CPU fit's


def ramp_times(duration: float, rps: tuple) -> list:
    """Arrival offsets of single requests whose rate rises linearly from
    ``rps[0]`` to ``rps[1]`` over ``duration`` seconds."""
    times, t = [], 0.0
    while t < duration:
        times.append(t)
        t += 1.0 / (rps[0] + (rps[1] - rps[0]) * t / duration)
    return times


def rate_windows(np, window: int, horizon: int, seed: int = 7, n_buckets: int = 4096):
    """Seeded training windows for the learned forecaster: Poisson counts per
    bucket of a diurnal rate (period 256 buckets, 20 +- 16 per bucket) with
    bursts (+60 for 8 buckets at 24 random starts). Returns (X [n, window],
    y [n]): each window's next ``horizon`` buckets' mean rate."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_buckets)
    rate = 20.0 * (1.0 + 0.8 * np.sin(2 * np.pi * t / 256.0))
    for start in rng.integers(0, n_buckets - 8, 24):
        rate[start:start + 8] += 60.0
    counts = rng.poisson(rate).astype(np.float32)
    n = n_buckets - window - horizon
    X = np.stack([counts[i:i + window] for i in range(n)])
    y = np.asarray([counts[i + window:i + window + horizon].mean() for i in range(n)],
                   dtype=np.float32)
    return X, y


def step_logits(torch, model, params, tokens, capacity: int, steps: int, forced=None):
    """The kernel path's logits of the serve program's loop on ``tokens``:
    the prefill's, then each decode step's, each [B, V] in float32. The
    step after logits ``k`` is fed ``forced[:, k]`` when given, else their
    argmax, as the program does. Returns (logits list of ``steps`` + 1, the
    fed tokens [B, steps])."""
    from repro_torch.models.transformer import split_cache, split_layers

    p = {**params, "stack": split_layers(params["stack"])}
    logits, cache = model.prefill(p, {"tokens": tokens}, capacity=capacity)
    cache = {**cache, "inner": split_cache(model.cfg, cache["inner"])}
    out, fed = [logits.float()], []
    for k in range(steps):
        tok = forced[:, k:k + 1] if forced is not None else \
            torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        logits, cache = model.decode(p, cache, tok)
        out.append(logits.float())
        fed.append(tok[:, 0])
    return out, torch.stack(fed, dim=1)


def steps_log(torch, dep, params, tokens, batch, rows: int, i: int) -> None:
    """Log, for each member of ``batch``, its rows of the bucket's decode
    steps against its own ``rows``-row run fed the same tokens (see
    ``member_gates``)."""
    spec = dep.spec
    cap = spec.prompt_len + spec.decode_steps
    bucket, fed = step_logits(torch, dep.model, params, tokens, cap, spec.decode_steps)
    for m in range(batch["n"]):
        r = slice(m * rows, (m + 1) * rows)
        own, _ = step_logits(torch, dep.model, params, tokens[r], cap, spec.decode_steps,
                             forced=fed[r])
        same = [bool(torch.equal(bk[r], ok)) for bk, ok in zip(bucket, own)]
        until = "at every step" if all(same) else \
            f"until step {same.index(False)} (0: the prefill)"
        worst = max(rel_l2(bk[r], ok) for bk, ok in zip(bucket, own))
        flips = []
        for k, (bk, ok) in enumerate(zip(bucket[:-1], own[:-1])):
            a, b_ = bk[r].argmax(-1), ok.argmax(-1)
            for row in (a != b_).nonzero().flatten().tolist():
                flips.append((k, row, round((ok[row, b_[row]] - ok[row, a[row]]).item(), 5)))
        log(f"batch {i + 1} member {m + 1} ({batch['padded_rows']} rows): decode steps vs its "
            f"own {rows}-row run on the same fed tokens (kernel path, no gate): logits "
            f"bit-identical {until}"
            f" | max rel_l2 over the {len(bucket)} logits {worst:.4g} | greedy choices that "
            f"differ (step, row, logit gap) {flips}")


def member_gates(torch, dep, batches, work, device="cuda") -> None:
    """Each member of each coalesced batch against the f32 reference: the
    kernel path's prefill logits of the stacked bucket tokens, sliced to the
    member's rows, no less accurate than the plain bf16 path's (rel L2 at most
    2x), and every kernel call of those prefills against its plain version.
    Beside each member's gate it logs how far its rows of the bucket's
    prefill are from the kernel path's prefill of its own prompt alone (the
    per-request program's shape, ``batch_size`` rows): of the plain bf16
    error's order if the two shapes only round differently, far above it if
    a bucket laid a member's rows out wrong. The same comparison follows the
    decode steps, the member alone fed the bucket's greedy tokens: the first
    step whose logits differ, the largest rel L2 over the steps, and each
    greedy choice the two shapes make differently with its logit gap."""
    from repro_torch import pytree
    from repro_torch.core.boot import streamed_device_put
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    spec, cfg, key = dep.spec, dep.model.cfg, dep.image.key
    host = dep.snapshots.load_host(key)
    params = streamed_device_put(host, device)
    rows = spec.batch_size
    lk, lp, alone = [], [], []
    with torch.inference_mode():
        for i, b in enumerate(batches):
            tokens = torch.from_numpy(b["tokens"]).to(device)
            with recorded_kernel_calls(ops) as calls:
                lk.append(dep.model.prefill(params, {"tokens": tokens},
                                            capacity=spec.prompt_len)[0].float())
            check_recorded_calls(torch, calls)
            del calls
            alone.append([dep.model.prefill(params, {"tokens": tokens[m * rows:(m + 1) * rows]},
                                            capacity=spec.prompt_len)[0].float()
                          for m in range(b["n"])])
            steps_log(torch, dep, params, tokens, b, rows, i)
            with ops.impl_scope("plain"):
                lp.append(dep.model.prefill(params, {"tokens": tokens},
                                            capacity=spec.prompt_len)[0].float())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), dep.model.max_seq)
    l32 = []
    with torch.inference_mode(), ops.impl_scope("plain"):
        params32 = pytree.tree_map(lambda t: t.to(device).float(), host)
        for b in batches:
            tokens = torch.from_numpy(b["tokens"]).to(device)
            l32.append(model32.prefill(params32, {"tokens": tokens},
                                       capacity=spec.prompt_len)[0])
        del params32
    gc.collect()
    torch.cuda.empty_cache()
    for i, b in enumerate(batches):
        for m in range(b["n"]):
            r = slice(m * rows, (m + 1) * rows)
            err_k, err_p = rel_l2(lk[i][r], l32[i][r]), rel_l2(lp[i][r], l32[i][r])
            own = alone[i][m]
            log(f"batch {i + 1} member {m + 1} ({b['padded_rows']} rows): prefill logits vs "
                f"the f32 plain path: rel_l2 kernel path {err_k:.4g}, plain bf16 path "
                f"{err_p:.4g} (gate: kernel <= 2 x plain) | vs its own {rows}-row prefill "
                f"(kernel path, no gate): rel_l2 {rel_l2(lk[i][r], own):.4g}, max_abs_err "
                f"{(lk[i][r] - own).abs().max().item():.4g}, bit-identical "
                f"{bool(torch.equal(lk[i][r], own))}, argmax agreement "
                f"{(lk[i][r].argmax(-1) == own.argmax(-1)).float().mean().item():.2f}")
            if not (bool(torch.isfinite(lk[i][r]).all()) and err_k <= 2.0 * err_p):
                raise AssertionError(f"batch {i + 1} member {m + 1}: kernel path's prefill "
                                     "logits are less accurate than the plain path's")
    log(f"member gates: {memory_line(torch, work)}")


def coalesced_path(torch, work, device="cuda") -> dict:
    """Phase 3f: the coalescer's bucket programs and the forecast planner on
    llama at ``COALESCE_LAYERS`` layers, through ``Gateway(batching=...,
    forecast=...)``.

    Deploy (base program + bucket programs at 8 and 16 rows); a burst of
    ``COALESCE_BURST`` distinct prompts and a pair after it through
    ``gw.invoke_many`` (fewer boots than requests; each batch makes L flash and
    L x (K - 1) decode launches; each member's rows are the bucket program's rows
    for it, and its prefill logits pass the f32-referenced gate); a ramp of
    single requests at a rising rate, then quiet (a request rides a parked
    planner boot; planned = claimed + expired; a cool-down is published; a
    host's program tier was prefetched); the learned forecaster fitted on the
    card and on the CPU (loss falls, predictions >= 0 and equal within
    ``FIT_RTOL``); ``shutdown()`` (no non-daemon thread left, device memory
    back within ``MEMORY_SLACK`` of its value before the phase). Returns the
    kernel launches of the phase's requests."""
    import threading

    import numpy as np
    from repro_torch.core import BatchingConfig, ForecastConfig, FunctionSpec, Gateway
    from repro_torch.core.boot import streamed_device_put
    from repro_torch.core.forecast import LearnedForecaster, RateHistory
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.simclock import REAL
    from repro_torch.kernels import ops

    allocated0 = tensor_bytes(torch)
    spec = FunctionSpec(**COALESCE_SPEC)   # phase 3's function, in an image of its own
    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    log(f"before deploy {spec.name}: {memory_line(torch, work)} | device memory allocated "
        f"{allocated0} B")
    gw = Gateway(n_hosts=2, slots_per_host=2, mode="cold", hedging=False,
                 batching=BatchingConfig(buckets=COALESCE_BUCKETS,
                                         min_window_s=COALESCE_WINDOW_S),
                 forecast=ForecastConfig(**FORECAST_SPEC),
                 scheduler=SchedulerConfig(snapshot_tier_bytes=4 << 30), work_dir=str(work),
                 device=device)
    batches, lock = [], threading.Lock()
    handle_batch = gw.agent.handle_batch

    def observed_batch(host, dep_, batch, driver_name, tl, *args, **kwargs):
        out = handle_batch(host, dep_, batch, driver_name, tl, *args, **kwargs)
        with lock:
            batches.append({"host": host.host_id, "n": batch.n_requests,
                            "bucket": batch.bucket, "padded_rows": batch.padded_rows,
                            "tokens": batch.tokens, "tl": tl})
        return out

    gw.agent.handle_batch = observed_batch
    try:
        t0 = time.perf_counter()
        dep = gw.deploy(spec)
        cfg, name, m = dep.model.cfg, dep.name, dep.image.manifest
        log(f"deploy {name} with buckets {COALESCE_BUCKETS}: {time.perf_counter() - t0:.1f} s "
            f"[" + " ".join(f"{k} {v:.2f}" for k, v in dep.build_s.items()) + "]" +
            f" | {m.param_count} params | snapshot {m.snapshot_bytes} B | {cfg.n_layers} layers "
            f"{cfg.dtype} | {memory_line(torch, work)}")
        want = compiled_launches(dep, llama_launches(cfg, spec))
        for rows in (b * spec.batch_size for b in COALESCE_BUCKETS[1:]):
            if compiled_launches(dep, llama_launches(cfg, spec), rows) != want:
                raise AssertionError(f"the {rows}-row bucket program launches other kernels "
                                     "than the base program")
        ops.reset_launch_counts()

        # ---- the burst, then a pair: coalesced into bucket programs
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, (spec.batch_size, spec.prompt_len),
                                dtype=np.int32) for _ in range(COALESCE_BURST + COALESCE_PAIR)]
        outs = gw.invoke_many(name, prompts[:COALESCE_BURST], label="burst", timeout=900)
        outs += gw.invoke_many(name, prompts[COALESCE_BURST:], label="pair", timeout=900)
        burst_launches = ops.launch_counts()
        for i, b in enumerate(batches):
            tl = b["tl"]
            stages = " ".join(f"{k} {v:.3f}" for k, v in tl.stage_s.items())
            log(f"batch {i + 1}: {b['n']} requests in bucket {b['bucket']} ({b['padded_rows']} "
                f"rows) on host {b['host']} | boot [{stages}] t_boot_wall {tl.t_boot_wall:.3f} "
                f"s | execution {tl.execution:.3f} s")
        summary = gw.batching_summary()
        log(f"batching_summary: {json.dumps(summary)}")
        n_req = COALESCE_BURST + COALESCE_PAIR
        if summary["requests"] != n_req or not summary["batches"] < n_req:
            raise AssertionError(f"coalescing did not engage: {summary}")
        if sorted(b["padded_rows"] for b in batches) != [8, 16, 16]:
            shapes = [(b["n"], b["padded_rows"]) for b in batches]
            raise AssertionError(f"batch compositions {shapes}, expected two batches of 16 "
                                 "rows and one of 8")
        if {k: burst_launches[k] for k in want} != {k: v * len(batches) for k, v in want.items()}:
            raise AssertionError(f"launches {burst_launches}, expected {want} per batch x "
                                 f"{len(batches)}")
        # every member's rows are the bucket program's rows for it
        params = streamed_device_put(dep.snapshots.load_host(dep.image.key), device)
        by_prompt = {p.tobytes(): o for p, o in zip(prompts, outs)}
        with torch.inference_mode():
            for b in batches:
                program = dep.load_program(bucket_rows=b["padded_rows"])
                direct = program(params, torch.from_numpy(b["tokens"]).to(device)).cpu().numpy()
                for mi in range(b["n"]):
                    r = slice(mi * spec.batch_size, (mi + 1) * spec.batch_size)
                    got = by_prompt[b["tokens"][r].tobytes()]
                    if got.shape != (spec.batch_size, spec.decode_steps) or \
                            not np.array_equal(got, direct[r]):
                        raise AssertionError("a member's tokens are not its rows of the bucket "
                                             "program's output")
        del params, program
        agree = []
        for i, p in enumerate(prompts):
            single = np.asarray(gw.dispatcher.submit(dep, p, "unikernel",
                                                     label="per-request").result(900))
            agree.append(float((single == outs[i]).mean()))
        log(f"members' tokens equal their rows of the bucket programs' outputs; token agreement "
            f"with the per-request path (no gate, bf16 near-ties): {agree}")
        launches = burst_launches
        member_gates(torch, dep, batches, work, device)

        # ---- the ramp, then quiet: forecast-driven pre-boots and cool-down
        planner = gw.planner
        offsets = ramp_times(RAMP_S, RAMP_RPS)
        before = ops.launch_counts()
        futs, t_start = [], time.perf_counter()
        for off in offsets:
            delay = t_start + off - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futs.append(gw.invoke_async(name, prompts[len(futs) % len(prompts)], label="ramp"))
        # at the last arrival the predicted rate is high: the cool-down that
        # counts is one published after it
        cooldowns0, target0 = planner.cooldowns, planner.pool_target(name)
        t_last = time.perf_counter() - t_start
        for f in futs:
            f.result(900)
        t_ramp = time.perf_counter() - t_start
        t_quiet = time.perf_counter()
        while time.perf_counter() - t_quiet < QUIET_WAIT_S and not (
                planner.cooldowns > cooldowns0 and planner.parked_count() == 0):
            time.sleep(0.1)
        t_quiet = time.perf_counter() - t_quiet
        after = ops.launch_counts()
        launches = {k: launches[k] + after[k] - before[k] for k in launches}
        tls = gw.recorder.timelines("ramp")
        claimed = [tl for tl in tls if tl.planner_preboot]
        fsum = gw.forecast_summary()
        placement = gw.placement_summary()
        def secs(values) -> str:
            return ", ".join(f"{v:.3f}" for v in values)

        log(f"ramp: {len(offsets)} requests, the last submitted at {t_last:.2f} s (pool target "
            f"{target0}), all served at {t_ramp:.2f} s, rising {RAMP_RPS[0]} -> {RAMP_RPS[1]} rps "
            f"| e2e {secs(tl.e2e for tl in tls)} s | {len(claimed)} rode a parked planner boot "
            f"(startup {secs(tl.startup for tl in claimed[:8])} s; the parked boots' t_boot_wall "
            f"{secs(tl.t_boot_wall for tl in claimed[:8])} s) | the others' startup "
            f"{secs([tl.startup for tl in tls if not tl.planner_preboot][:8])} s | quiet "
            f"{t_quiet:.2f} s until the cool-down | pool target {planner.pool_target(name)}")
        log(f"forecast_summary: {json.dumps(fsum)} | prefetched per host " +
            json.dumps({h: e["prefetched"] for h, e in placement["hosts"].items()}))
        if not claimed:
            raise AssertionError("no request rode a parked planner pre-boot")
        if fsum["preboots_planned"] != fsum["preboots_claimed"] + fsum["preboots_expired"] + \
                fsum["preboots_parked"]:
            raise AssertionError(f"pre-boots leaked: {fsum}")
        if not (target0 and planner.cooldowns > cooldowns0 and planner.pool_target(name) == 0):
            raise AssertionError(f"no cool-down was published on quiet: {fsum}")
        if not any(e["prefetched"] for e in placement["hosts"].values()):
            raise AssertionError("the planner prefetched no host's program tier")
    finally:
        gw.agent.handle_batch = handle_batch

    # ---- the learned forecaster, fitted on the card and on the CPU
    fcfg = ForecastConfig(**{**FORECAST_SPEC, "model": "learned"})
    X, y = rate_windows(np, fcfg.window, int(fcfg.horizon_s / fcfg.bucket_s))
    held, Xt, yt = X[-64:], X[:-64], y[:-64]
    fits = {}
    for where in (device, "cpu"):
        fc = LearnedForecaster(fcfg, RateHistory(fcfg, REAL), device=where)
        t = time.perf_counter()
        losses = fc.fit(Xt, yt, epochs=FIT_EPOCHS)
        fits[where] = (losses, np.asarray([fc.predict_window(w) for w in held]),
                        time.perf_counter() - t)
        del fc
    (lc, pc, tc), (lh, ph, th) = fits[device], fits["cpu"]
    rel = float(np.max(np.abs(pc - ph) / np.maximum(np.abs(ph), 1e-6)))
    log(f"learned forecaster: {len(Xt)} windows x {FIT_EPOCHS} epochs on the card in "
        f"{tc:.2f} s (CPU {th:.2f} s) | loss {lc[0]:.4f} -> {lc[-1]:.4f} (CPU {lh[0]:.4f} -> "
        f"{lh[-1]:.4f}) | held-out predictions {pc[:4].round(3).tolist()}... min "
        f"{pc.min():.4f} | max relative difference from the CPU fit {rel:.3g} "
        f"(gate {FIT_RTOL})")
    if not (lc[-1] < lc[0] and (pc >= 0).all() and rel <= FIT_RTOL):
        raise AssertionError("the learned forecaster's fit on the card failed its gates")

    # ---- shutdown
    gw.shutdown()
    t_join = time.perf_counter()
    while time.perf_counter() - t_join < 30:
        alive = [t.name for t in threading.enumerate() if not t.daemon
                 and t is not threading.main_thread()]
        allocated1 = tensor_bytes(torch)
        if not alive and abs(allocated1 - allocated0) <= MEMORY_SLACK:
            break
        time.sleep(0.1)
    log(f"phase 3f gw.shutdown(): non-daemon threads left {alive} | parked "
        f"{gw.planner.parked_count()} | device memory allocated before {allocated0} B, after "
        f"{allocated1} B (allowed {MEMORY_SLACK} B) | launches {launches}")
    if alive:
        raise AssertionError(f"gw.shutdown() left non-daemon threads alive: {alive}")
    if abs(allocated1 - allocated0) > MEMORY_SLACK:
        raise AssertionError("phase 3f left device memory allocated")
    return launches


def register_xlstm() -> None:
    from repro_torch.configs import get_config, register
    cfg = get_config("xlstm-1.3b")
    register(XLSTM_ARCH)(lambda: dataclasses.replace(
        cfg, n_layers=XLSTM_PERIODS * cfg.ssm.slstm_every))


def register_jamba() -> None:
    from repro_torch.configs import get_config, register
    cfg = get_config("jamba-1.5-large-398b")
    register(JAMBA_ARCH)(lambda: dataclasses.replace(
        cfg, n_layers=cfg.ssm.attn_every, moe=dataclasses.replace(cfg.moe, n_experts=4)))


def jamba_launches(cfg, spec) -> dict:
    """Per serve request of the eager program: one flash and K decode
    launches per attention layer, one scan launch per Mamba layer (its
    prefill)."""
    P = cfg.n_layers // cfg.ssm.attn_every
    return {"flash_attention": P, "decode_attention": P * spec.decode_steps,
            "decode_attention_stats": 0, "paged_decode_attention": 0, "mlstm": 0,
            "selective_scan": P * (cfg.ssm.attn_every - 1)}


# -------------------------------------------------------------------- phase 3g

# the remaining families at their published widths, depth (and experts) cut
# for one card and the time limit: registered name -> (arch, decoder layers
# kept, experts kept or None)
FAMILY_CUTS = {"kimi-k2-1t-a32b:2L16E": ("kimi-k2-1t-a32b", 2, 16),
               "qwen2-vl-2b:2L": ("qwen2-vl-2b", 2, None),
               "olmo-1b:2L": ("olmo-1b", 2, None),
               "qwen2.5-32b:2L": ("qwen2.5-32b", 2, None),
               "starcoder2-3b:2L": ("starcoder2-3b", 2, None),
               "arctic-480b:2L8E": ("arctic-480b", 2, 8)}
# through deploy and the unikernel driver (v1 snapshot), 2 cold requests
# each, at 2 decode steps (as every deployed program: the compile time)
FAMILY_DEPLOYED = ("kimi-k2-1t-a32b:2L16E", "qwen2-vl-2b:2L")
FAMILY_REQUESTS = 2
FAMILY_DEPLOY_STEPS = 2
# eagerly through the serve function's body (prefill + K greedy decode
# steps); True: with the frontend stub's inputs (patches, frames)
FAMILY_EAGER = (("olmo-1b:2L", False), ("qwen2.5-32b:2L", False),
                ("starcoder2-3b:2L", False), ("arctic-480b:2L8E", False),
                ("qwen2-vl-2b:2L", True), ("whisper-medium", True))
WHISPER_PROMPT = 128                # decoder prompt; + K stays under its 448 positions
EAGER_STEPS = 16                    # decode steps of the eagerly served families


def register_families() -> None:
    from repro_torch.configs import get_config, register
    for name, (arch, layers, experts) in FAMILY_CUTS.items():
        cfg = get_config(arch)
        cut = dataclasses.replace(cfg, n_layers=layers)
        if experts is not None:
            cut = dataclasses.replace(cut, moe=dataclasses.replace(cfg.moe, n_experts=experts))
        register(name)(lambda cut=cut: cut)


def family_launches(cfg, steps: int) -> dict:
    """Per request: one flash launch per encoder layer and per decoder
    attention (self, and whisper's cross), one decode launch per decoder
    attention and step."""
    per_token = 2 * cfg.n_layers if cfg.enc_dec else cfg.n_layers
    return {"flash_attention": cfg.n_encoder_layers + per_token,
            "decode_attention": per_token * steps, "decode_attention_stats": 0,
            "paged_decode_attention": 0, "mlstm": 0, "selective_scan": 0}


def config_line(cfg) -> str:
    moe = (f" | {cfg.moe.n_experts} experts top-{cfg.moe.top_k} width {cfg.moe.d_ff_expert}"
           f" shared {cfg.moe.n_shared_experts} first_k_dense {cfg.moe.first_k_dense}"
           f" dense_residual {cfg.moe.dense_residual}" if cfg.moe else "")
    enc = f" | {cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq}" \
        if cfg.enc_dec else ""
    return (f"{cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads} hd {cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab "
            f"{cfg.vocab_size} {cfg.norm} {cfg.act} rope {cfg.rope}{moe}{enc}")


def eager_family(torch, arch, frontend: bool, work) -> dict:
    """One family through the serve function's body, eagerly on the card:
    random bf16 weights from seed 0, B x prompt tokens from seed 1 (and the
    frontend stub's inputs from seed 2), prefill + K greedy decode steps with
    the launches of ``family_launches``; then every kernel call of a
    kernel-path prefill against its plain version and the prefill-logit gate
    against the plain path in float32 on the same weights. Returns the
    launches of the served request."""
    import numpy as np
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.frontends import synth_frontend

    cfg = get_config(arch)
    B, K = SPEC["batch_size"], EAGER_STEPS
    prompt = WHISPER_PROMPT if cfg.enc_dec else SPEC["prompt_len"]
    log(f"before {arch} (eager{', frontend inputs' if frontend else ''}): "
        f"{memory_line(torch, work)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, max_seq=prompt + K)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, prompt), dtype=np.int32)).cuda()
    batch = {"tokens": tokens}
    if frontend:
        batch.update(synth_frontend(cfg, B, prompt, torch.Generator(device="cuda").manual_seed(2)))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    def serve():
        logits, cache = model.prefill(params, batch, capacity=prompt + K)
        toks = []
        for _ in range(K):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits, cache = model.decode(params, cache, tok)
            toks.append(tok[:, 0])
        return torch.stack(toks, dim=1)

    before = ops.launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        out = serve()
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
    grew = {k: v - before[k] for k, v in ops.launch_counts().items()}
    n_params = sum(t.numel() for t in pytree.leaves(params))
    inputs = ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items())
    log(f"family {arch}: {n_params} params | {config_line(cfg)} | inputs {inputs} | init "
        f"{t_init:.2f} s | serve (prefill + {K} decode steps) {t_serve:.3f} s | launches "
        f"{grew} | tokens {out.tolist()} | {memory_line(torch, work)}")
    want = family_launches(cfg, K)
    if grew != want:
        raise AssertionError(f"{arch}: launches {grew}, expected {want}")
    if tuple(out.shape) != (B, K) or out.dtype != torch.int32 or \
            not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: bad output {out.shape} {out.dtype}")

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), recorded_kernel_calls(ops) as calls:
        lk, _ = model.prefill(params, batch, capacity=prompt)
    check_recorded_calls(torch, calls)
    del calls
    with torch.inference_mode(), ops.impl_scope("plain"):
        lp, _ = model.prefill(params, batch, capacity=prompt)
        out_plain = serve()
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"), prompt + K)
        params32 = pytree.tree_map(lambda t: t.float(), params)
        l32, _ = model32.prefill(params32, batch, capacity=prompt)
        del params32
    log(f"{arch} gates, f32 reference included: {memory_line(torch, work)}")
    logit_gate(torch, lk, lp, l32, out, out_plain)
    return grew


def family_paths(torch, work, specs) -> dict:
    """Phase 3g: the remaining families at published widths. Kimi (its
    first-k-dense ``head`` layer and one MoE layer) and qwen2-vl (tokens
    only, M-RoPE text positions) through ``deploy`` and the ``unikernel``
    driver, as phases 3c and 3d; olmo, qwen2.5-32b, starcoder2, arctic,
    qwen2-vl with patches and whisper (frames, full depth) eagerly through
    the serve function's body. After each, device memory back within
    ``MEMORY_SLACK`` of before it. ``specs``: :func:`deployed_specs`.
    Returns the launches of each path."""
    launches = {}

    def settle(label: str, allocated0: int) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        allocated1 = tensor_bytes(torch)
        log(f"phase 3g {label}: device memory allocated before {allocated0} B, after "
            f"{allocated1} B (allowed difference {MEMORY_SLACK} B)")
        if abs(allocated1 - allocated0) > MEMORY_SLACK:
            raise AssertionError(f"phase 3g {label} left device memory allocated")

    for arch in FAMILY_DEPLOYED:
        label = arch.split(":")[0] + " deploy"
        allocated0 = tensor_bytes(torch)
        folder = work / arch.replace(":", "_")
        dep, launches[label] = serve_path(
            torch, specs[arch], folder, FAMILY_REQUESTS,
            lambda cfg, spec: family_launches(cfg, spec.decode_steps))
        del dep
        shutil.rmtree(folder, ignore_errors=True)
        settle(label, allocated0)
    for arch, frontend in FAMILY_EAGER:
        label = arch.split(":")[0] + (" eager with frontend inputs" if frontend else " eager")
        allocated0 = tensor_bytes(torch)
        launches[label] = eager_family(torch, arch, frontend, work)
        settle(label, allocated0)
    return launches


# -------------------------------------------------------------------- phase 3t

# full-width llama3.2-3b cut to 2 of its 28 layers (595,344,384 parameters):
# two, so that the stacked [L, ...] leaves and per-layer remat are exercised
TRAIN_LAYERS = 2
TRAIN_ARCH = f"llama3.2-3b:{TRAIN_LAYERS}L"
# micro-batches of [4, 512]: phase 2's main flash shape
TRAIN = dict(seq_len=512, global_batch=8, grad_accum=2, steps=8, ckpt_every=4, log_every=1,
             seed=0)
TRAIN_OPT = dict(peak_lr=1e-3, warmup=2, total_steps=8)
TRAIN_RESUME_RTOL = 5e-3            # tests/test_trainer.py's bound on a resumed run's loss
# the gradient gate: the kernel route's loss error against the float32 plain
# route at most 2 x the bf16 plain route's plus LOSS_GATE_FLOOR x |loss|; each
# leaf's gradient error relative to max(its norm, GRAD_GATE_FLOOR x the whole
# gradient's norm) at most 2 x the bf16 plain route's plus GRAD_GATE_FLOOR (a
# leaf whose gradient is near zero is held to the floor, not to its own norm)
LOSS_GATE_FLOOR = 1e-4
GRAD_GATE_FLOOR = 1e-3
REFERENCE = {}                      # the uninterrupted run's losses and params, for phase 3m


def register_train() -> None:
    from repro_torch.configs import get_config, register
    register(TRAIN_ARCH)(lambda: dataclasses.replace(get_config("llama3.2-3b"),
                                                     n_layers=TRAIN_LAYERS))


def keep_params_after(trainer, steps: int) -> None:
    """Make ``trainer`` keep a device copy of its params after ``steps``
    steps in ``REFERENCE["params"]`` (a flat list; the update writes in
    place, so the copy is taken as the step returns)."""
    from repro_torch import pytree
    inner, calls = trainer._step, [0]

    def step(*args):
        out = inner(*args)
        calls[0] += 1
        if calls[0] == steps:
            REFERENCE["params"] = [t.detach().clone() for t in pytree.leaves(out[0])]
        return out
    trainer._step = step


def micro_batch(torch, cfg):
    """The trainer's first micro-batch of step 0: tokens [4, 513] on the card."""
    from repro_torch.data import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                                  global_batch=TRAIN["global_batch"], seed=TRAIN["seed"])
    rows = TRAIN["global_batch"] // TRAIN["grad_accum"]
    return {"tokens": torch.from_numpy(pipe.batch_dict(0)["tokens"][:rows]).cuda()}


def grad_gate(torch, arch, want: dict) -> dict:
    """One micro-batch's loss and gradients of ``arch`` (bf16, the config's
    own remat) on the kernel route and on the plain route, each against the
    plain route in float32 on the same weights; every kernel call of the
    kernel route against its plain version. The kernel route's launches must
    equal ``want`` (forward plus remat's recompute). Returns them."""
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.layers import is_spec
    from repro_torch.train.step import loss_and_grads
    cfg = get_config(arch)
    model = build_model(cfg, max_seq=TRAIN["seq_len"])
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = micro_batch(torch, cfg)
    n_params = sum(p.numel() for p in pytree.leaves(params))
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with recorded_kernel_calls(ops) as calls:
        gk, mk = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_recorded_calls(torch, calls)
    del calls
    t0 = time.perf_counter()
    with ops.impl_scope("plain"):
        gp, mp = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"), TRAIN["seq_len"])
        params32 = pytree.tree_map(lambda p: p.float(), params)
        del params
        g32, m32 = loss_and_grads(model32, params32, batch)
    del params32
    loss32 = m32["loss"].item()
    err_k, err_p = abs(mk["loss"].item() - loss32), abs(mp["loss"].item() - loss32)
    paths = [p for p, _ in pytree.flatten_with_paths(model.param_specs(), is_leaf=is_spec)]
    norm = torch.linalg.vector_norm
    floor = GRAD_GATE_FLOOR * math.sqrt(sum(norm(g).item() ** 2 for g in g32))
    rows, bad = [], []
    for path, a, b, w in zip(paths, gk, gp, g32):
        den = max(norm(w).item(), floor)
        rk = norm(a.float() - w).item() / den
        rp = norm(b.float() - w).item() / den
        rows.append((rk, rp, path))
        if rk > 2 * rp + GRAD_GATE_FLOOR:
            bad.append(path)
    rows.sort(reverse=True)
    log(f"phase 3t gradient gate {arch}: {n_params} parameters, remat {cfg.remat}, "
        f"micro-batch {tuple(batch['tokens'].shape)} | loss kernel {mk['loss'].item():.6f} "
        f"plain {mp['loss'].item():.6f} f32 {loss32:.6f} (errors {err_k:.3g} / {err_p:.3g}; "
        f"aux {mk['aux'].item():.3g}, zloss {mk['zloss'].item():.4g}) | loss + grads "
        f"{t_kernel:.2f} s kernel, {t_plain:.2f} s plain | launches {launches}")
    log(f"phase 3t gradient gate {arch}: per-leaf gradient error vs f32 (relative L2, "
        f"floor {GRAD_GATE_FLOOR} x |g| = {floor:.3g}), worst three kernel / plain: " +
        "; ".join(f"{p} {rk:.3g} / {rp:.3g}" for rk, rp, p in rows[:3]) +
        f" | largest kernel / plain ratio "
        f"{max(rk / max(rp, 1e-30) for rk, rp, _ in rows):.3f}")
    del gk, gp, g32
    if err_k > 2 * err_p + LOSS_GATE_FLOOR * abs(loss32) or bad:
        raise AssertionError(f"{arch}: the kernel route's loss or gradients are further "
                             f"from f32 than 2 x the plain route's: loss {err_k} vs {err_p}, "
                             f"leaves {bad}")
    if launches != want:
        raise AssertionError(f"{arch}: a micro-batch launched {launches}, not {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def nondeterminism(torch, model, params, batch) -> str:
    """Whether two backward passes of one micro-batch give bit-identical
    gradients, and the ops PyTorch flags as nondeterministic on that path
    (``use_deterministic_algorithms(warn_only=True)``)."""
    import warnings
    from repro_torch.train.step import loss_and_grads
    g1, _ = loss_and_grads(model, params, batch)
    g2, _ = loss_and_grads(model, params, batch)
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    del g1, g2
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss_and_grads(model, params, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have")[0].split(". ")[0][:120]
                      for w in caught if "determinis" in str(w.message)})
    return f"two backward passes bit-identical {same}; flagged by torch: {flagged or 'none'}"


def int8_on_card(torch, sub) -> None:
    """Two AdamW updates with int8 moments of ``sub`` (bf16 leaves on the
    card) under seeded gradients, on the card and on the CPU: every ``q``
    within 1 and every ``scale`` within 1e-6 relative."""
    from repro_torch import pytree
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.optim.adamw import _is_mom_leaf
    gen = torch.Generator(device="cuda").manual_seed(4)
    grads = [pytree.tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=gen,
                                                          device="cuda"), sub)
             for _ in range(2)]
    opt = AdamW(AdamWConfig(**TRAIN_OPT, state_dtype="int8"))
    card, card_state = sub, opt.init(sub)
    host = pytree.tree_map(lambda t: t.cpu(), sub)
    host_state = opt.init(host)
    for g in grads:
        card, card_state, _ = opt.update(g, card_state, card)
        host, host_state, _ = opt.update(pytree.tree_map(lambda t: t.cpu(), g), host_state,
                                         host)
    dq, ds = 0, 0.0
    for key in ("m", "v"):
        for c, h in zip(pytree.leaves(card_state[key], is_leaf=_is_mom_leaf),
                        pytree.leaves(host_state[key], is_leaf=_is_mom_leaf)):
            dq = max(dq, (c["q"].cpu().int() - h["q"].int()).abs().max().item())
            ds = max(ds, ((c["scale"].cpu() - h["scale"]).abs() / h["scale"].abs()).max().item())
    same = all(torch.equal(c.cpu(), h) for c, h in zip(pytree.leaves(card), pytree.leaves(host)))
    n = sum(t.numel() for t in pytree.leaves(sub))
    log(f"phase 3t int8 moments, 2 AdamW updates of {n} parameters on the card vs the "
        f"CPU: q max difference {dq} (bound 1), scale max relative difference {ds:.3g} "
        f"(bound 1e-6); bf16 params bit-identical {same}")
    if dq > 1 or ds > 1e-6:
        raise AssertionError(f"int8 moments on the card differ from the CPU's: q {dq}, "
                             f"scale {ds}")


def median_step(trainer) -> float:
    """The median step of ``trainer``'s run after its first (NaN for one)."""
    after = sorted(h["dt"] for h in trainer.history[1:])
    return after[len(after) // 2] if after else float("nan")


def run_line(label, trainer) -> str:
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    steps = ", ".join(f"{h['step']}: loss {h['loss']:.5f} {h['dt']:.3f} s "
                      f"{tokens / h['dt']:.0f} tok/s" for h in trainer.history)
    return (f"phase 3t {label}: {steps} | median step after the first "
            f"{median_step(trainer):.4f} s")



def dryrun_anchor(torch, trainer, state, step_s: float, smi: str, work) -> dict:
    """Phase 3r (b), the card check: phase 3t's cell dry-run on fake tensors
    on one device (``run_cell(..., single_device=True)``), then one extra
    step of phase 3t's trainer on the card under the same counter. FLOPs
    must equal, collective bytes be 0 on both, and the predicted peak be
    within ``ANCHOR_PEAK_RATIO`` of the card's (the arguments plus
    ``max_memory_allocated`` above what the step started with). Logs the
    achieved rate, the counted FLOPs over phase 3t's median step. Returns
    the step's kernel launches."""
    from repro_torch import pytree
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    shape = ShapeSpec(f"train_{TRAIN['seq_len']}", TRAIN["seq_len"], TRAIN["global_batch"],
                      "train")
    t0 = time.perf_counter()
    rec = dryrun.run_cell(TRAIN_ARCH, shape.name, shape=shape, single_device=True,
                          grad_accum=TRAIN["grad_accum"], opt_dtype="float32", probes=False,
                          out_dir=str(work / "dryrun"), device="cuda")
    t_fake = time.perf_counter() - t0
    params, opt_state = state["params"], state["opt_state"]
    batch = trainer._batch(TRAIN["steps"])
    args = pytree.leaves(params) + pytree.leaves(opt_state) + list(batch.values())
    arg_bytes = sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                     for t in args}.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counter = dryrun.CostCounter()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with counter:
        out = trainer._step(params, opt_state, batch)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base + arg_bytes
    del out, batch, args
    coll = counter.collectives_record()
    ratio = rec["bytes_per_device"] / peak
    rate = counter.flops / step_s
    log(f"phase 3r card check, {TRAIN_ARCH} {shape.name} (B={TRAIN['global_batch']}, "
        f"grad_accum {TRAIN['grad_accum']}, f32 moments, remat {rec['remat']}): fake trace "
        f"{t_fake:.2f} s ({rec['ops']} local ops, {rec['vjp_replays']} VJPs replayed); the card's "
        f"step under the counter {t_step:.2f} s | FLOPs fake {rec['flops_per_device']:.0f}, card "
        f"{counter.flops} (equal {rec['flops_per_device'] == counter.flops}) | collective bytes "
        f"fake {rec['collectives']['total']}, card {coll['total']} | arguments fake "
        f"{rec['memory']['argument_size_in_bytes']} B, card {arg_bytes} B | peak fake "
        f"{rec['bytes_per_device']} B (temp {rec['memory']['temp_size_in_bytes']}), card {peak} B "
        f"(max_memory_allocated), ratio {ratio:.4f} (bound {ANCHOR_PEAK_RATIO}) | launches "
        f"{launches}")
    log(f"phase 3r achieved rate: {counter.flops:.4g} FLOPs a step over phase 3t's median step "
        f"{step_s:.4f} s = {rate / 1e12:.2f} TFLOP/s, {100 * rate / BF16_FLOP_PER_S:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 | {smi}")
    problems = []
    if rec["flops_per_device"] != counter.flops:
        problems.append(f"FLOPs fake {rec['flops_per_device']} != card {counter.flops}")
    if rec["collectives"]["total"] != 0 or coll["total"] != 0:
        problems.append("collective bytes on one device")
    if not 1 / ANCHOR_PEAK_RATIO <= ratio <= ANCHOR_PEAK_RATIO:
        problems.append(f"peak ratio {ratio:.4f}")
    if launches["flash_attention"] == 0:
        problems.append("no flash launch")
    if problems:
        raise AssertionError("phase 3r card check: " + "; ".join(problems))
    return launches


def train_path(torch, F, work, smi: str) -> dict:
    """Phase 3t: training on one card through the port's ``Trainer``: the
    llama gradient gate, an uninterrupted run, a run stopped at a checkpoint
    and resumed in a fresh ``Trainer``, the int8 moments on the card against
    the CPU, the promotion of the trained weights into a snapshot, and the
    xlstm gradient gate. Returns the kernel launches by path."""
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core.snapshot import SnapshotStore
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    work.mkdir(parents=True, exist_ok=True)
    allocated0 = tensor_bytes(torch)
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    zero = {k: 0 for k in ops.launch_counts()}
    per_micro = dict(zero, flash_attention=2 * L)            # forward + remat's recompute
    launches = {"llama_train_gate": grad_gate(torch, TRAIN_ARCH, per_micro)}
    log(f"phase 3t before the runs: {memory_line(torch, work)}")

    # ---- the plain flash VJP, the backward the card runs outside any kernel
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(4, 512, 24, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(4, 512, 8, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ops.attention(q, k, v)
    gout = torch.randn_like(out)
    vjp_ms = time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), gout,
                                                        retain_graph=True), 20)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    sdpa_ms = time_ms(torch, lambda: torch.autograd.grad(sdpa, (qt, kt, vt),
                                                         gout.transpose(1, 2),
                                                         retain_graph=True), 20)
    log(f"phase 3t flash backward at B=4, S=512, 24/8 heads, D=128, bf16: the plain VJP "
        f"(recompute of the plain forward + autograd) {vjp_ms:.4f} ms per call; "
        f"scaled_dot_product_attention's backward {sdpa_ms:.4f} ms")
    del q, k, v, out, gout, qt, kt, vt, sdpa

    # ---- the fault-tolerant runs
    tcfg = TrainerConfig(**TRAIN)
    ocfg = AdamWConfig(**TRAIN_OPT)
    ckpt_dir = work / "ckpt"
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    full = Trainer(cfg, tcfg, ocfg, device="cuda", log=lambda s: None)
    keep_params_after(full, MESH_TRAIN["steps"])
    full.run()
    t_full = time.perf_counter() - t0
    REFERENCE["params"] = [t.cpu() for t in REFERENCE["params"]]
    log(run_line("uninterrupted run", full) + f" | wall {t_full:.1f} s")
    t0 = time.perf_counter()
    half = Trainer(cfg, dataclasses.replace(tcfg, steps=TRAIN["ckpt_every"]), ocfg,
                   ckpt_dir=str(ckpt_dir), device="cuda", log=log)
    half.run()
    t_half = time.perf_counter() - t0
    log(run_line(f"run to step {TRAIN['ckpt_every']}", half) + f" | wall {t_half:.1f} s")
    t0 = time.perf_counter()
    resumed = Trainer(cfg, tcfg, ocfg, ckpt_dir=str(ckpt_dir), device="cuda", log=log)
    out = resumed.run()
    t_res = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches["llama_train"] = ops.launch_counts()
    log(run_line("resumed run", resumed) + f" | wall {t_res:.1f} s (restore included)")
    peak = torch.cuda.max_memory_allocated()
    saves = half.ckpt.saves + resumed.ckpt.saves
    log("phase 3t checkpoints: " + "; ".join(
        f"step {s['step']} {s['bytes']} B, host copy {s['copy_s']:.2f} s, write "
        f"{s['write_s']:.2f} s" for s in saves) + f" | peak device memory {peak / 1e9:.2f} GB "
        f"| launches {launches['llama_train']}")
    a, b = full.history[-1]["loss"], resumed.history[-1]["loss"]
    REFERENCE["train_losses"] = [h["loss"] for h in full.history]
    log(f"phase 3t resumed final loss {b!r} vs uninterrupted {a!r}: relative "
        f"{abs(a - b) / abs(a):.3g} (bound {TRAIN_RESUME_RTOL}); bit-exact {a == b}")
    if a != b:
        model, params = resumed.model, out["params"]
        log(f"phase 3t nondeterminism: "
            f"{nondeterminism(torch, model, params, micro_batch(torch, cfg))}")
    n_steps = TRAIN["steps"] + TRAIN["steps"]              # 8 uninterrupted, 4 + 4 resumed
    want = dict(zero, flash_attention=n_steps * TRAIN["grad_accum"] * 2 * L)
    problems = []
    if resumed.history[0]["step"] != TRAIN["ckpt_every"]:
        problems.append(f"the resumed run started at {resumed.history[0]['step']}")
    if not full.history[TRAIN["steps"] - 1]["loss"] < full.history[0]["loss"]:
        problems.append("the loss did not fall")
    if abs(a - b) > TRAIN_RESUME_RTOL * abs(a):
        problems.append(f"resumed final loss {b} vs {a}")
    if launches["llama_train"] != want:
        problems.append(f"launches {launches['llama_train']}, not {want}")
    if problems:
        raise AssertionError("phase 3t: " + "; ".join(problems))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"phase 3t checkpoint directory deleted: {memory_line(torch, work)}")

    # ---- phase 3r (b): this cell's dry run against one more step on the card
    launches["dryrun_anchor"] = dryrun_anchor(torch, resumed, out, median_step(full), smi,
                                              work)

    # ---- the int8 moments on the card against the same updates on the CPU
    params = out["params"]
    del full, half, resumed, out
    int8_on_card(torch, {"attn": params["stack"]["layers"]["attn"], "final": params["final"]})

    # ---- promotion: the trained weights as a snapshot, restored and served
    model = build_model(cfg, max_seq=TRAIN["seq_len"])
    tokens = micro_batch(torch, cfg)["tokens"][:, :TRAIN["seq_len"]]
    store = SnapshotStore(work / "promoted")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    nbytes = store.save("llama-trained", params)
    t_save = time.perf_counter() - t0
    restored = pytree.tree_map(lambda t: t.to("cuda"), store.load_host("llama-trained"))
    t_load = time.perf_counter() - t0 - t_save
    with torch.inference_mode():
        want_logits, _ = model.prefill(params, {"tokens": tokens})
        got_logits, _ = model.prefill(restored, {"tokens": tokens})
    torch.cuda.synchronize()
    launches["llama_train_promote"] = ops.launch_counts()
    same = torch.equal(want_logits, got_logits)
    log(f"phase 3t promotion: snapshot of the trained weights {nbytes} B (save {t_save:.2f} "
        f"s, load_host + to the card {t_load:.2f} s); prefill logits on the restored weights "
        f"bit-identical to the in-memory weights' {same} | launches "
        f"{launches['llama_train_promote']}")
    del params, restored, want_logits, got_logits, model
    shutil.rmtree(work / "promoted", ignore_errors=True)
    if not same:
        raise AssertionError("the promoted snapshot's prefill logits differ")
    if launches["llama_train_promote"] != dict(zero, flash_attention=2 * L):
        raise AssertionError(f"promotion launches {launches['llama_train_promote']}")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- xlstm: one micro-batch's gradient gate at full width, 1 of 6 periods
    xcfg = get_config(XLSTM_ARCH)
    n_mlstm = xcfg.n_layers - xcfg.n_layers // xcfg.ssm.slstm_every
    launches["xlstm_train_gate"] = grad_gate(torch, XLSTM_ARCH, dict(zero, mlstm=2 * n_mlstm))

    allocated1 = tensor_bytes(torch)
    log(f"phase 3t: device memory allocated before {allocated0} B, after {allocated1} B "
        f"(difference {allocated1 - allocated0} B, allowed {MEMORY_SLACK} B)")
    if allocated1 - allocated0 > MEMORY_SLACK:
        raise AssertionError("phase 3t left device memory allocated")
    return launches


# -------------------------------------------------------------------- phase 3m

MESH_RANKS = 4                      # rank processes, all on the one card
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_BUDGET_S = 150.0               # the phase's share of the run's time limit
MESH_TIMEOUT_S = 480                # a rank that runs longer fails the run
MESH_COLLECTIVE_TIMEOUT_S = 300     # a collective that waits longer raises in its rank
MESH_MEMORY_LIMIT = 70e9            # the ranks' peak device memory, summed
# (a) serve_tp: llama3.2-3b at 2 of 28 layers (phase 3t's cut), B=4, a
# 512-token prompt, 4 decode steps (cut from 16: a step of the mesh takes
# about 1.2 s, its collectives staged through host memory); (b) serve_seqkv: decode_32k's cache of
# 32,768 positions and a 16,400-token prompt, so that both model shards hold
# keys (the boundary is at 16,384), 4 decode steps
MESH_TP = dict(batch=4, prompt=512, steps=4)
MESH_SEQKV = dict(batch=4, capacity=32768, prompt=16400, steps=4)
# (c) one kimi-k2 MoE layer at published widths, 16 of its 384 experts
# (phase 3g's cut), B=4, S=512; capacity_factor 64 gives every expert room
# for every token (C = T), so the capacity never binds
MESH_MOE = dict(experts=16, batch=4, seq=512, capacity_factor=64.0)
# (e) int8 all-reduce of a 50,334,720-element f32 tensor, 8 rounds
MESH_ALLREDUCE = dict(numel=50_334_720, rounds=8)
# (d) phase 3t's configuration for 2 steps, then a run to step 1 resumed on
# a (data=4,) mesh to step 2 (cut from 8, 4 and 8: a step of the mesh takes
# 11-20 s, its gradients reduced through host memory)
MESH_TRAIN = dict(steps=2, resume_at=1)
# (d)'s gates. The loss at step 1, after one update at lr 5e-4, against the
# single-device run's (and the resumed run's against the uninterrupted
# one's): at most 1e-3 relative, where one update moves it 4.4e-3 (12.305607
# -> 12.251320 on the card), so a mesh step that leaves the parameters as
# they were fails. Each parameter leaf after both steps, gathered on rank 0:
# ||mesh - single|| at most MESH_PARAM_BOUND x ||single - init||, what the
# single-device run's two steps moved it (a lost update reads 1).
MESH_TRAIN_RTOL = 1e-3
MESH_PARAM_BOUND = 0.25


def mesh_logits(torch, model, params, toks, prompt: int, capacity: int, steps: int):
    """Last-position prefill logits and each forced decode step's logits
    (every step feeds the next token of ``toks``), gathered whole, f32,
    with the seconds of the prefill and of each step."""
    def whole(x):
        return (x.full_tensor() if hasattr(x, "full_tensor") else x).float()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, capacity=capacity)
    outs = [whole(logits)]
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    for t in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode(params, cache, toks[:, prompt + t:prompt + t + 1])
        outs.append(whole(logits))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return outs, times


def mesh_gate(torch, got, kernel, f32, label: str) -> dict:
    """The f32 gate: at every step the mesh path's logits no further from
    the single-device f32 plain path than 2 x the single-device bf16 kernel
    path's (rel_l2); greedy agreement with the kernel path logged."""
    err_m = [rel_l2(a, c) for a, c in zip(got, f32)]
    err_k = [rel_l2(b, c) for b, c in zip(kernel, f32)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean()) for a, b in zip(got, kernel)]
    ok = all(bool(torch.isfinite(a).all()) for a in got) and \
        all(m <= 2.0 * k for m, k in zip(err_m, err_k))
    return {"label": label, "ok": ok, "err_mesh": err_m, "err_kernel": err_k,
            "greedy_agreement": agree}


def mesh_serve_cell(torch, ctx, preset: str, batch: int, prompt: int, capacity: int,
                    steps: int) -> dict:
    """Cells (a) and (b): the llama's prefill and forced decode steps under
    ``preset`` on the (data, model) mesh, against the single-device paths on
    rank 0."""
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import distribute_tree, make_rules, param_shardings, use_rules
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    mesh, rank = ctx["mesh"], ctx["rank"]
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, max_seq=capacity)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rules = make_rules(preset, mesh)
    t0 = time.perf_counter()
    # every rank drew the same weights from the seed: each keeps its own slice
    dp = distribute_tree(params, param_shardings(model.param_specs(), rules, mesh), mesh,
                         src_rank=None)
    t_dist = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt + steps), generator=gen,
                         device="cuda")
    def run():
        with torch.no_grad(), use_rules(rules, mesh):
            return mesh_logits(torch, model, dp, toks, prompt, capacity, steps)
    out = ctx["measure"](run)
    got, times = out.pop("result")
    del dp
    out.update(distribute_s=t_dist, prefill_s=times[0], step_s=times[1:])
    if rank == 0:                       # the single-device references, not counted
        with torch.no_grad():
            kernel, _ = mesh_logits(torch, model, params, toks, prompt, capacity, steps)
            m32 = build_model(dataclasses.replace(cfg, dtype="float32"), max_seq=capacity)
            p32 = pytree.tree_map(lambda t: t.float(), params)
            with ops.impl_scope("plain"):
                f32, _ = mesh_logits(torch, m32, p32, toks, prompt, capacity, steps)
        out["gate"] = mesh_gate(torch, got, kernel, f32, preset)
        del p32, kernel, f32
    return out


def mesh_moe_cell(torch, ctx) -> dict:
    """Cell (c): one kimi-k2 MoE layer under ``train``, the local dispatch
    against the global one on the same tokens and weights."""
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import distribute_tree, make_rules, param_shardings, use_rules
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import init_tree
    mesh, rank = ctx["mesh"], ctx["rank"]
    base = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            n_experts=MESH_MOE["experts"]))
    specs = moe_mod.moe_specs(cfg, torch.bfloat16)
    p = init_tree(specs, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model, generator=gen,
                     device="cuda")).to(torch.bfloat16)
    cf = MESH_MOE["capacity_factor"]
    ys, out = {}, {}
    for disp in ("global", "local"):
        rules = make_rules("train", mesh, moe_dispatch=disp)
        dp = distribute_tree(p, param_shardings(specs, rules, mesh), mesh, src_rank=None)

        def run():
            with torch.no_grad(), use_rules(rules, mesh):
                y, aux = moe_mod.moe_forward(cfg, dp, x, capacity_factor=cf)
                y = y.full_tensor().float()
                aux = aux.full_tensor() if hasattr(aux, "full_tensor") else aux
                return y, float(aux)
        r = ctx["measure"](run)
        ys[disp] = r.pop("result")
        out[disp] = r
        del dp
    if rank == 0:                       # the single-device references, not counted
        p32 = pytree.tree_map(lambda t: t.float(), p)
        with torch.no_grad():
            y_sd, aux_sd = moe_mod.moe_forward(cfg, p, x, capacity_factor=cf)
            y32, _ = moe_mod._moe_forward_global(dataclasses.replace(cfg, dtype="float32"),
                                                 p32, x.float(), cf)
        err_sd = rel_l2(y_sd.float(), y32.float())
        err_g, err_l = rel_l2(ys["global"][0], y32.float()), rel_l2(ys["local"][0], y32.float())
        aux_d = abs(ys["global"][1] - ys["local"][1])
        aux_sd_d = abs(ys["global"][1] - float(aux_sd))
        out["gate"] = {"label": "moe",
                       "ok": err_g <= 2.0 * err_sd and err_l <= 2.0 * err_sd and
                       aux_d <= 1e-4 and aux_sd_d <= 1e-4,
                       "err_single_device": err_sd, "err_global": err_g, "err_local": err_l,
                       "aux_diff": aux_d, "aux_diff_single_device": aux_sd_d,
                       "aux": ys["global"][1]}
        del p32, y_sd, y32
    return out


def param_errors(torch, params, want, init) -> list:
    """Per leaf (``want``, ``init``: flat lists, or None off rank 0): (path,
    ||p - want||, ||want - init||, ||want||), ``params`` gathered whole on
    every rank (a collective), compared on rank 0 only."""
    from repro_torch import pytree
    from repro_torch.dist.sharding import is_dtensor
    rows = []
    for i, (path, t) in enumerate(pytree.flatten_with_paths(params)):
        whole = (t.full_tensor() if is_dtensor(t) else t).float()
        if want is not None:
            w = want[i].float()
            rows.append((path, float((whole - w).norm()), float((w - init[i].float()).norm()),
                         float(w.norm())))
        del whole
    return rows


def param_gate(rows) -> dict:
    """``rows`` of ``param_errors`` against ``MESH_PARAM_BOUND``, with the
    worst leaf, the largest relative error and the smallest no-update
    reading (relative L2 of the initial params) logged."""
    ratio = [(num / den if den else (0.0 if num == 0 else math.inf), path)
             for path, num, den, _ in rows]
    moved = [den / norm for _, _, den, norm in rows if den]
    return {"ok": all(num <= MESH_PARAM_BOUND * den for _, num, den, _ in rows),
            "worst_share_of_update": max(ratio), "bound": MESH_PARAM_BOUND,
            "max_rel_l2": max(num / norm for _, num, _, norm in rows if norm),
            "min_rel_l2_no_update": min(moved) if moved else None,
            "leaves_unmoved": sum(1 for _, _, den, _ in rows if not den)}


def mesh_train_cell(torch, ctx) -> dict:
    """Cell (d): phase 3t's run on the (data, model) mesh, then a run to
    step 1 and its resumption on a (data=4,) mesh over the same ranks; the
    losses and, leaf by leaf, the params after both steps against the
    single-device run's."""
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    mesh, rank, work = ctx["mesh"], ctx["rank"], ctx["work"]
    cfg = get_config(TRAIN_ARCH)
    tcfg, ocfg = TrainerConfig(**TRAIN), AdamWConfig(**TRAIN_OPT)
    steps, resume_at = MESH_TRAIN["steps"], MESH_TRAIN["resume_at"]
    ckpt = str(work / "ckpt")
    runs = {}

    def trainer(m, steps, ckpt_dir=None):
        return Trainer(cfg, dataclasses.replace(tcfg, steps=steps), ocfg, ckpt_dir=ckpt_dir,
                       mesh=m, rules=make_rules("train", m), log=lambda s: None,
                       device="cuda")

    def run(tr):
        out = tr.run()
        return [(h["step"], h["loss"], h["dt"]) for h in tr.history], out["params"]

    want = init = None
    if rank == 0:                       # the single-device run's params after `steps` steps
        want = torch.load(work / "ref_params.pt", map_location="cuda")
        init = pytree.leaves(build_model(cfg, max_seq=tcfg.seq_len).init(
            torch.Generator(device="cuda").manual_seed(tcfg.seed)))
    errs = {}
    for name, m, n, ckpt_dir in (("full", mesh, steps, None), ("half", mesh, resume_at, ckpt),
                                 ("resumed_data4", None, steps, ckpt)):
        if m is None:
            m = make_mesh((MESH_RANKS,), ("data",))
        tr = trainer(m, n, ckpt_dir)
        runs[name] = ctx["measure"](lambda: run(tr))
        runs[name]["result"], params = runs[name]["result"]
        if n == steps:
            errs[name] = param_errors(torch, params, want, init)
        if rank == 0 and ckpt_dir:
            runs.setdefault("saves", []).extend(tr.ckpt.saves)
        del tr, params
    del want, init
    dist.barrier()
    if rank == 0:
        a = runs["full"]["result"][-1][1]
        b = runs["resumed_data4"]["result"][-1][1]
        ref = ctx["train_ref_losses"][steps - 1]    # the single-device run at the same step
        gates = {name: param_gate(rows) for name, rows in errs.items()}
        runs["gate"] = {"label": "train", "full_vs_single_device": abs(a - ref) / abs(ref),
                        "resumed_vs_full": abs(a - b) / abs(a), "bound": MESH_TRAIN_RTOL,
                        "bit_exact_resume": a == b, "bit_exact_single_device": a == ref,
                        "single_device": ref, "params": gates,
                        "ok": abs(a - ref) <= MESH_TRAIN_RTOL * abs(ref) and
                        abs(a - b) <= MESH_TRAIN_RTOL * abs(a) and
                        runs["resumed_data4"]["result"][0][0] == resume_at and
                        all(g["ok"] for g in gates.values())}
    return runs


def mesh_allreduce_cell(torch, ctx) -> dict:
    """Cell (e): the int8 all-reduce (mean) over the 4 ranks with error
    feedback, the same tensor each round: each round's error against the
    exact mean at most 1/127 of the largest amax; the time-averaged
    result's error logged."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import (ErrorFeedback, compressed_allreduce,
                                              dequantize_int8, ef_compress)
    rank = ctx["rank"]
    gen = torch.Generator(device="cuda").manual_seed(10 + rank)
    x = torch.randn(MESH_ALLREDUCE["numel"], generator=gen, device="cuda")
    exact = x.clone()
    dist.all_reduce(exact)
    exact /= dist.get_world_size()

    def rounds():
        ef, errs, amaxes, total = ErrorFeedback.init(x), [], [], torch.zeros_like(x)
        for _ in range(MESH_ALLREDUCE["rounds"]):
            q, scale, ef = ef_compress(x, ef)
            sent = dequantize_int8(q, scale)
            amax = sent.abs().amax()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            got = compressed_allreduce(sent)
            total += got
            errs.append(float((got - exact).abs().max()))
            amaxes.append(float(amax))
        avg_err = float((total / MESH_ALLREDUCE["rounds"] - exact).abs().max())
        return errs, amaxes, avg_err
    out = ctx["measure"](rounds)
    errs, amaxes, avg_err = out.pop("result")
    out.update(errs=errs, amax=max(amaxes), time_avg_err=avg_err,
               ok=all(e <= a / 127.0 for e, a in zip(errs, amaxes)))
    return out


def name_failing_ops() -> None:
    """Make an op that DTensor's sharding propagation refuses name itself
    and its arguments' placements in the error (the card's torch differs
    from the CPU tests')."""
    from torch.distributed.tensor import _sharding_prop
    prop = _sharding_prop.ShardingPropagator
    inner = prop.propagate_op_sharding_non_cached

    def propagate(self, op_schema, *args, **kwargs):
        try:
            return inner(self, op_schema, *args, **kwargs)
        except Exception as e:
            e.add_note(f"DTensor refused {op_schema}")
            raise

    prop.propagate_op_sharding_non_cached = propagate


def mesh_rank_main(rank: int, work: str) -> int:
    """``chip_smoke.py --mesh-rank R WORK``: one rank of phase 3m; its
    results and launch counts go to ``WORK/rank_R.json``."""
    import traceback
    work = Path(work)
    result = {"rank": rank, "ok": False, "cells": {}}
    try:
        import torch
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.dist.collectives import WIRE
        from repro_torch.kernels import _cuda, ops
        from repro_torch.launch.mesh import init_world, make_mesh
        register_train()
        _cuda.library()
        name_failing_ops()
        t0 = time.perf_counter()
        lines = []
        result["backend"] = init_world(rank, MESH_RANKS, store_path=str(work / "store"),
                                       device="cuda", timeout_s=MESH_COLLECTIVE_TIMEOUT_S,
                                       log=lines.append)
        result["log"] = lines
        mesh = make_mesh(MESH_SHAPE, MESH_AXES)
        result["init_s"] = time.perf_counter() - t0
        ref = json.loads((work / "ref.json").read_text())

        def measure(fn):
            import torch.distributed as dist
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()            # what this rank no longer holds, to the others
            dist.barrier()
            ops.reset_launch_counts()
            WIRE.reset()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return {"result": r, "wall_s": time.perf_counter() - t,
                    "launches": ops.launch_counts(), "wire": WIRE.summary(),
                    "peak_bytes": torch.cuda.max_memory_allocated()}

        ctx = {"rank": rank, "mesh": mesh, "work": work, "measure": measure,
               "train_ref_losses": ref["train_losses"]}
        cells = result["cells"]
        wanted = ref.get("cells") or MESH_CELLS
        out_path = work / f"rank_{rank}.json"

        class Cells(dict):                  # each finished cell is on disk at once
            def __setitem__(self, key, value):
                super().__setitem__(key, value)
                out_path.write_text(json.dumps(result, default=str))
        cells = result["cells"] = Cells()
        if "serve_tp" in wanted:
            cells["serve_tp"] = mesh_serve_cell(torch, ctx, "serve_tp", MESH_TP["batch"],
                                                MESH_TP["prompt"],
                                                MESH_TP["prompt"] + MESH_TP["steps"],
                                                MESH_TP["steps"])
        if "serve_seqkv" in wanted:
            cells["serve_seqkv"] = mesh_serve_cell(
                torch, ctx, "serve_seqkv", MESH_SEQKV["batch"], MESH_SEQKV["prompt"],
                MESH_SEQKV["capacity"], MESH_SEQKV["steps"])
        if "moe" in wanted:
            cells["moe"] = mesh_moe_cell(torch, ctx)
        if "allreduce" in wanted:
            cells["allreduce"] = mesh_allreduce_cell(torch, ctx)
        if "train" in wanted:
            cells["train"] = mesh_train_cell(torch, ctx)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        result["ok"] = True
    except BaseException:
        result["error"] = traceback.format_exc()
        print(result["error"], file=sys.stderr, flush=True)
    (work / f"rank_{rank}.json").write_text(json.dumps(result, default=str))
    return 0 if result["ok"] else 1


MESH_CELLS = ("serve_tp", "serve_seqkv", "moe", "allreduce", "train")


def mesh_path(torch, work: Path, train_ref_losses, train_ref_params=None,
              cells=MESH_CELLS) -> dict:
    """Phase 3m: four rank processes of this script on the one card, a
    gloo world over a FileStore in ``work`` (DTensor's collectives staged
    through host memory), a (data=2, model=2) mesh, and cells (a)-(e).
    Any rank that fails, outlives ``MESH_TIMEOUT_S`` or leaves no result
    fails the run. Returns the kernel launches per path, summed over ranks."""
    work.mkdir(parents=True, exist_ok=True)
    log(f"phase 3m: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB of device "
        f"memory ({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved) as the ranks start")
    (work / "ref.json").write_text(json.dumps({"train_losses": list(train_ref_losses),
                                               "cells": list(cells)}))
    if train_ref_params is not None:
        torch.save(train_ref_params, work / "ref_params.pt")
    t0 = time.perf_counter()
    procs = []
    for r in range(MESH_RANKS):
        out = open(work / f"rank_{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                        "--mesh-rank", str(r), str(work)], stdout=out,
                                       stderr=subprocess.STDOUT, start_new_session=True), out))
        SESSIONS.add(procs[-1][0].pid)
    failed = []
    try:
        for r, (proc, _) in enumerate(procs):
            left = max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t0))
            try:
                if proc.wait(timeout=left) != 0:
                    failed.append(f"rank {r} exited {proc.returncode}")
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} ran past {MESH_TIMEOUT_S} s")
    finally:
        for proc, out in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            out.close()
    wall = time.perf_counter() - t0
    results = []
    for r in range(MESH_RANKS):
        path = work / f"rank_{r}.json"
        if not path.exists():
            failed.append(f"rank {r} left no result")
            continue
        res = json.loads(path.read_text())
        results.append(res)
        if not res["ok"]:
            walls = {k: round(v.get("wall_s", 0.0), 2) for k, v in res["cells"].items()}
            failed.append(f"rank {r} (cells done: {walls}): {res.get('error', '')[-6000:]}")
    if failed:
        tails = "\n".join(f"--- rank {r} log tail:\n" +
                          (work / f"rank_{r}.log").read_text()[-2500:] for r in range(MESH_RANKS))
        raise AssertionError("phase 3m: " + "\n".join(failed) + "\n" + tails)
    for line in results[0].get("log", []):
        log(line)
    log(f"phase 3m: {MESH_RANKS} ranks on one card, mesh {dict(zip(MESH_AXES, MESH_SHAPE))}, "
        f"backend {results[0]['backend']} | wall {wall:.1f} s (budget {MESH_BUDGET_S:.0f} s) | "
        "rank start-up " + ", ".join(f"{r['init_s']:.1f}" for r in results) + " s")

    def parts(cell_result):
        """The measured runs of one rank's cell: (name, measurement)."""
        if "wall_s" in cell_result:
            return [("", cell_result)]
        return [(k, v) for k, v in cell_result.items() if isinstance(v, dict) and "wall_s" in v]

    launches, problems, peaks = {}, [], [0] * MESH_RANKS
    for cell in cells:
        first = results[0]["cells"][cell]
        total = {}
        for res in results:
            c = res["cells"][cell]
            for name, m in parts(c):
                peaks[res["rank"]] = max(peaks[res["rank"]], m["peak_bytes"])
                for k, v in m["launches"].items():
                    total[k] = total.get(k, 0) + v
                extra = ""
                if "step_s" in c:
                    extra = (f" | distribute {c['distribute_s']:.2f} s, prefill "
                             f"{c['prefill_s']:.3f} s, decode steps "
                             f"{[round(t, 4) for t in c['step_s']]}")
                log(f"phase 3m {cell}{' ' + name if name else ''} rank {res['rank']}: wall "
                    f"{m['wall_s']:.2f} s | peak device memory {m['peak_bytes'] / 1e9:.2f} GB | "
                    f"launches { {k: v for k, v in m['launches'].items() if v} } | "
                    f"collectives {m['wire']}{extra}")
        launches["mesh_" + cell] = total
        if cell == "train":
            for name in ("full", "half", "resumed_data4"):
                log(f"phase 3m train {name}: " + ", ".join(
                    f"step {s} loss {loss:.6f} ({dt:.3f} s)" for s, loss, dt in
                    first[name]["result"]))
            log("phase 3m train checkpoints: " + "; ".join(
                f"step {s['step']} {s['bytes']} B, host copy (gather included) "
                f"{s['copy_s']:.2f} s, write {s['write_s']:.2f} s" for s in first["saves"]))
        if cell == "allreduce":
            log(f"phase 3m allreduce: {MESH_ALLREDUCE['numel']} f32 elements, "
                f"{MESH_ALLREDUCE['rounds']} rounds with error feedback | per-round max error "
                f"{[f'{e:.3g}' for e in first['errs']]} (bound amax/127 = "
                f"{first['amax'] / 127:.4g}) | time-averaged result's error "
                f"{first['time_avg_err']:.3g}")
            if not all(res["cells"][cell]["ok"] for res in results):
                problems.append("allreduce error past amax/127")
        if "gate" in first:
            log(f"phase 3m {cell} gate: " + json.dumps(first["gate"]))
            if not first["gate"]["ok"]:
                problems.append(f"{cell} gate failed")
        if cell == "serve_seqkv":
            stats = [res["cells"][cell]["launches"]["decode_attention_stats"]
                     for res in results]
            if min(stats) == 0:
                problems.append(f"serve_seqkv: a rank launched no stats kernel {stats}")
    peak = sum(peaks)
    log(f"phase 3m: peak device memory per rank {[round(p / 1e9, 2) for p in peaks]} GB, "
        f"summed {peak / 1e9:.2f} GB (limit {MESH_MEMORY_LIMIT / 1e9:.0f} GB) | the gloo "
        "collectives went through host memory: their times say nothing of NVLink")
    if peak > MESH_MEMORY_LIMIT:
        problems.append(f"peak device memory {peak} B over {MESH_MEMORY_LIMIT}")
    if cells == MESH_CELLS and not (launches["mesh_serve_tp"]["flash_attention"] and
                                    launches["mesh_serve_tp"]["decode_attention"] and
                                    launches["mesh_train"]["flash_attention"]):
        problems.append(f"the mesh paths launched {launches}")
    if problems:
        raise AssertionError("phase 3m: " + "; ".join(problems))
    return launches


# -------------------------------------------------------------------- phase 3r

# (arch, shape, multi-pod, probes): the dry run's cells on a 512-rank fake
# world at published widths: llama and qwen2.5-32b at their full depths,
# kimi-k2 cut to its first two layers (the dense one and one MoE layer with
# all 384 experts) for the phase's 60 s: its 61 layers took 65.9 s alone
DRYRUN_KIMI_LAYERS = 2
DRYRUN_KIMI_ARCH = f"kimi-k2-1t-a32b:{DRYRUN_KIMI_LAYERS}L"
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", False, True),
                ("qwen2.5-32b", "decode_32k", False, False),
                (DRYRUN_KIMI_ARCH, "train_4k", True, False))
DRYRUN_WORLD = 512
ANCHOR_PEAK_RATIO = 1.25            # the card check's bound on predicted / measured peak


def dryrun_path(torch, work) -> None:
    """Phase 3r (a): trace ``DRYRUN_CELLS`` on a fake world of
    ``DRYRUN_WORLD`` ranks in this process (``repro_torch.launch.dryrun``;
    the world starts no process and sends nothing), one line per cell with its
    per-device counts and its bytes per device against the card's memory;
    the process group is torn down after. A cell that does not trace, counts
    no FLOPs, or (training) no collective fails the run."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, register
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world
    register(DRYRUN_KIMI_ARCH)(lambda: dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                                                           n_layers=DRYRUN_KIMI_LAYERS))
    init_fake_world(DRYRUN_WORLD)
    try:
        for arch, shape, multi_pod, probes in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, probes=probes,
                                  out_dir=str(work), device="cuda")
            wall = time.perf_counter() - t0
            mem, coll = rec["memory"], rec["collectives"]
            ndev = rec["n_devices"]
            probe = ""
            if "costs_per_device" in rec:
                probe = (f" | probes ({rec['probe_s']:.1f} s): FLOPs/device "
                         f"{rec['costs_per_device']['flops']:.4g}, collective bytes "
                         f"{rec['costs_per_device']['collectives']['coll_total']:.4g}")
            log(f"phase 3r {arch} {shape} on {rec['mesh']} of a {DRYRUN_WORLD}-rank fake world "
                f"({rec['rules']}, grad_accum {rec['grad_accum']}, {rec['opt_dtype']} moments, "
                f"remat {rec['remat']}): {wall:.1f} s (trace {rec['lower_s']:.1f} s, "
                f"{rec['ops']} local ops, {rec['vjp_replays']} VJPs and {rec['scan_replays']} "
                f"micro-batches replayed) | FLOPs/device "
                f"{rec['flops_per_device']:.4g} (analytic {rec['analytic_flops_global']['executed'] / ndev:.4g}) "
                f"| bytes accessed/device {rec['bytes_accessed_per_device']:.4g} | collectives "
                f"{coll['count']} calls, {coll['total']} B (" + ", ".join(
                    f"{k} {coll[k]}" for k in dryrun.COLLECTIVES) + f"){probe} | per device: "
                f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB + peak temp "
                f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB = {rec['bytes_per_device'] / 1e9:.3f} "
                f"GB of the card's {rec['device_memory_bytes'] / 1e9:.2f} GB "
                f"(fits {rec['fits_device_memory']})")
            if rec["flops_per_device"] <= 0:
                raise AssertionError(f"phase 3r {arch} {shape}: no FLOPs counted")
            if shape.startswith("train") and coll["count"] == 0:
                raise AssertionError(f"phase 3r {arch} {shape}: no collective")
    finally:
        dist.destroy_process_group()

DRYRUN_TIMEOUT_S = 600              # how long the end of the run waits for phase 3r


def start_dryrun(work):
    """Start phase 3r (a) as ``chip_smoke.py --dryrun WORK``, in a session
    of its own, its output in ``WORK.log``: the traces are host work, and
    run beside phases 3c and 3d. Returns it in ``start_builds``' form."""
    work.mkdir(parents=True, exist_ok=True)
    path = work.with_suffix(".log")
    with open(path, "w") as out:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dryrun",
                                 str(work)], stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    SESSIONS.add(proc.pid)
    log(f"phase 3r started (pid {proc.pid})")
    return ("r", ("dryrun",), proc, path, time.perf_counter())


def finish_dryrun(dry, t_run: float) -> None:
    """Wait for phase 3r, log its lines, and raise if it failed."""
    _, _, proc, path, t0 = dry
    rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith("phase 3r"):
            log(line)
    log(f"phase 3r: exit {rc}, {t0 - t_run:.1f} s into the run to "
        f"{time.perf_counter() - t_run:.1f} s (collected)")
    if rc != 0:
        raise RuntimeError(f"phase 3r exited {rc}:\n" + text[-4000:])


def dryrun_main(work: str) -> int:
    """``chip_smoke.py --dryrun WORK``: phase 3r (a), records under WORK."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    dryrun_path(torch, Path(work))
    log(f"phase 3r: the three cells in {time.perf_counter() - t0:.1f} s")
    return 0


# ------------------------------------------------- the background build

# The deploys of phases 3g, 3c and 3d compile their serve, head and tail
# programs in two build processes started with phase 3, each group in order
# of use: their compiles overlap phases 3-3f, and each deploy reads the
# packages back from the shared compiled-package cache (or waits on a
# package's lock while its build is still compiling it).
PRECOMPILE_GROUPS = (("kimi-k2-1t-a32b:2L16E", JAMBA_ARCH), ("qwen2-vl-2b:2L", XLSTM_ARCH))
# phase 3's llama programs compile in a build of their own, started before
# phase 1's kernel build, so that their compile runs beside phases 1 and 2;
# phase 3's deploy reads them back (or waits on their locks)
EARLY_GROUPS = ((LLAMA_ARCH,),)
BUILD_TIMEOUT_S = 600               # how long the end of the run waits for a build


def register_llama() -> None:
    from repro_torch.configs import get_config, register
    for arch, layers in ((LLAMA_ARCH, LLAMA_LAYERS), (COALESCE_ARCH, COALESCE_LAYERS)):
        register(arch)(lambda layers=layers: dataclasses.replace(get_config("llama3.2-3b"),
                                                                 n_layers=layers))


def deployed_specs() -> dict:
    """The specs the phases after 3f deploy, by arch (their configs are
    registered first)."""
    from repro_torch.core.artifact import FunctionSpec
    register_llama()
    register_families()
    register_xlstm()
    register_jamba()
    return {**{arch: FunctionSpec(**dict(SPEC, arch=arch, decode_steps=FAMILY_DEPLOY_STEPS))
               for arch in FAMILY_DEPLOYED},
            LLAMA_ARCH: FunctionSpec(**SPEC),
            XLSTM_ARCH: FunctionSpec(**XLSTM_SPEC), JAMBA_ARCH: FunctionSpec(**JAMBA_SPEC)}


def start_builds(work, groups, first: int = 0) -> list:
    """Start one ``chip_smoke.py --precompile`` process per group of
    ``groups`` (numbered from ``first``), each in a session of its own (so
    its compile workers stop with it), its output in a file under ``work``;
    they inherit the Inductor cache directory. Returns [(group, process, log
    path, start)]."""
    builds = []
    for i, group in enumerate(groups, start=first):
        path = work / f"build{i}.log"
        with open(path, "w") as out:
            proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                     "--precompile", *group], stdout=out,
                                    stderr=subprocess.STDOUT, start_new_session=True)
        SESSIONS.add(proc.pid)
        builds.append((i, group, proc, path, time.perf_counter()))
        log(f"background build {i}: {', '.join(group)} (pid {proc.pid})")
    return builds


def stop_builds(builds) -> None:
    """Kill every process of each build's session that still runs."""
    for _, _, proc, _, _ in builds:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_builds(builds, t_run: float) -> None:
    """Wait for the builds, log each spec's trace and compile seconds, and
    raise if a build failed."""
    for i, group, proc, path, t0 in builds:
        rc = proc.wait(timeout=BUILD_TIMEOUT_S)
        lines = [json.loads(line) for line in path.read_text().splitlines()
                 if line.startswith('{"precompiled"')]
        for r in lines:
            log(f"background build {i} {r.pop('precompiled')}: done "
                f"{t0 - t_run + r.pop('t_s'):.1f} s into the run | cache lookups "
                f"{r.pop('lookups')} [" + " ".join(f"{k} {v:.2f}" for k, v in r.items()) + "]")
        if rc != 0 or len(lines) != len(group):
            raise RuntimeError(f"background build {i} exited {rc} after {len(lines)} of "
                               f"{len(group)} specs:\n" + path.read_text()[-4000:])


def precompile_main(names) -> int:
    """``chip_smoke.py --precompile ARCH...``: compile each named spec of
    :func:`deployed_specs` into the compiled-package cache that
    ``TORCHINDUCTOR_CACHE_DIR`` names, under the run's settings (TF32 off,
    the same host compiler), and print one JSON line per spec."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import compile_cache
    from repro_torch.core.deploy import precompile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as probe:
        inductor_toolchain(torch, Path(probe))
    specs = deployed_specs()
    for name in names:
        before = dict(compile_cache.counters())
        times = precompile(specs[name], "cuda")
        lookups = {k.replace("aoti_package_cache_", "package "): v - before.get(k, 0)
                   for k, v in compile_cache.counters().items() if v - before.get(k, 0)}
        print(json.dumps({"precompiled": name, "t_s": time.perf_counter() - t0,
                          "lookups": lookups, **times}), flush=True)
    reap_children(set())                # this build's compile workers
    return 0


# ------------------------------------------------------------------------ main

def main(mesh_only=False):
    """The whole run -> the last line's object (or an exit code: 1 without a
    card). ``mesh_only`` (``--mesh-only [CELL...]``, for work on
    phase 3m): phase 1, phase 2's decode rows, phase 3t's uninterrupted run
    as the reference and phase 3m (those cells), then exit with no result
    line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as mk
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import DECODE_CHUNK as CHUNK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.perf_counter()

    def phase_done(label: str) -> None:
        log(f"{label} done: {time.perf_counter() - t_run:.1f} s into the run")

    builds = []
    if not mesh_only:
        from repro_torch.core import compile_cache
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        atexit.register(shutil.rmtree, work, ignore_errors=True)
        # one compile cache for every deploy of the run (and cold_jit_cached)
        inductor_cache = work / "inductor"
        compile_cache.enable_inductor_disk_cache(inductor_cache)
        log(f"Inductor cache directory {inductor_cache}")
        builds = start_builds(work, EARLY_GROUPS)

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
    with tempfile.TemporaryDirectory() as probe:
        log(inductor_toolchain(torch, Path(probe)))
    if not mesh_only:
        # Inductor checks, once per process, which vector ISAs the host
        # compiler builds (a test build per ISA, tens of seconds) at its first
        # compile or package load: done beside phase 2, phase 3's first load
        # of the early build's package does not wait for it
        from torch._inductor import cpu_vec_isa
        threading.Thread(target=cpu_vec_isa.valid_vec_isa_list, name="vec-isa",
                         daemon=True).start()

    # ---- phase 2: kernels vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_main = (4, 512, 512, 24, 8, 128, True, 0, "bfloat16")
    jamba_flash = (4, 512, 512, 64, 8, 128, True, 0, "bfloat16")    # jamba's prefill, timed too
    jamba_decode = (4, 528, 64, 8, 128, [528] * 4, "bfloat16")      # jamba's decode, timed too
    flash_admit = (1, 512, 512, 24, 8, 128, True, 0, "bfloat16")    # the decode tier's admit, timed
    # the coalesced path's bucket programs (phase 3f): 8 and 16 rows, the
    # largest timed
    flash_bucket = (16, 512, 512, 24, 8, 128, True, 0, "bfloat16")
    decode_bucket = (16, 528, 24, 8, 128, [528] * 16, "bfloat16")
    flash_cases = [flash_main,
                   flash_admit,
                   flash_bucket,
                   (8, 512, 512, 24, 8, 128, True, 0, "bfloat16"),
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
                   (2, 77, 77, 4, 2, 32, True, 0, "bfloat16")] + FAMILY_FLASH_CASES
    decode_main = (4, 528, 24, 8, 128, [528, 528, 528, 528], "bfloat16")
    decode_cases = [decode_main,
                    decode_bucket,
                    (8, 528, 24, 8, 128, [528] * 8, "bfloat16"),
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
    decode_cases += FAMILY_DECODE_CASES
    # phase 3m (a)'s local shape: serve_tp puts batch on data and heads on
    # model, so each rank decodes 2 rows of 12/4 heads against 516 positions
    decode_tp_local = (2, 516, 12, 4, 128, [516, 513], "bfloat16")
    decode_cases.append(decode_tp_local)
    # the stats entry at phase 3m (b)'s local shape: serve_seqkv puts batch on
    # data and the 32,768-position cache on model, so each rank holds 2 rows
    # of 16,384 positions; the first shard full, the second's lengths over
    # the decode steps; then empty shards and odd shapes
    stats_cases = [(2, 16384, 24, 8, 128, [16384] * 2, "bfloat16"),
                   (2, 16384, 24, 8, 128, [16, 20], "bfloat16"),
                   (2, 16384, 24, 8, 128, [0, 0], "bfloat16"),
                   (4, 16384, 24, 8, 128, [16, 17, 0, 20], "bfloat16"),
                   (3, 100, 4, 4, 32, [1, 0, 100], "bfloat16"),
                   (2, 264, 24, 8, 128, [1, 200], "float32"),
                   (3, 200, 34, 2, 64, [200, 0, 77], "float32")]
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
                   id(flash_admit): "the decode tier's admit shape",
                   id(flash_bucket): "the 16-row bucket's shape",
                   id(decode_bucket): "the 16-row bucket's shape",
                   id(decode_tp_local): "phase 3m serve_tp's local shape", **FAMILY_TIMED}
    results, bucket_rows, family_rows = {}, {}, {}
    for name, check, cases in (
            ("flash_attention",
             lambda c, t: check_flash(torch, F, fa, ref, gen, c, t), flash_cases),
            ("decode_attention",
             lambda c, t: check_decode(torch, F, da, ref, gen, c, t), decode_cases),
            ("decode_attention_stats",
             lambda c, t: check_decode_stats(torch, da, ref, gen, c, t), stats_cases),
            ("paged_decode_attention",
             lambda c, t: check_paged(torch, F, pda, da, ref, gen, c, t), paged_cases),
            ("mlstm", lambda c, t: check_mlstm(torch, mk, ref, gen, c, t), mlstm_cases),
            ("selective_scan",
             lambda c, t: check_scan(torch, F, ss, ref, gen, c, t, exp_per_s), scan_cases)):
        if mesh_only and name not in ("decode_attention", "decode_attention_stats"):
            continue
        rows = [check(c, i == 0 or id(c) in timed_extra) for i, c in enumerate(cases)]
        for r in rows:
            extra = "".join(f" {k} {r[k]}" for k in ("scaled_err_m", "rel_err_l",
                                                     "empty_rows_exact",
                                                     "layout_bitwise", "vs_contiguous_bitwise",
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
        row_keys = ("case", "max_abs_err", "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms")
        for c, r in zip(cases, rows):
            if c is flash_bucket or c is decode_bucket:
                bucket_rows[name] = {k: r[k] for k in row_keys}
            if id(c) in FAMILY_TIMED:
                family_rows.setdefault(name, {})[FAMILY_TIMED[id(c)]] = {
                    k: r[k] for k in row_keys}

    phase_done("phase 2")
    register_llama()
    register_train()
    if mesh_only:
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import Trainer, TrainerConfig
        ref_losses, ref_params = [], None
        if "train" in mesh_only:
            full = Trainer(get_config(TRAIN_ARCH), TrainerConfig(**TRAIN),
                           AdamWConfig(**TRAIN_OPT), device="cuda", log=lambda s: None)
            keep_params_after(full, MESH_TRAIN["steps"])
            full.run()
            log(run_line("single-device reference run", full))
            ref_losses = [h["loss"] for h in full.history]
            ref_params = [t.cpu() for t in REFERENCE.pop("params")]
            del full
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as mesh_work:
            mesh_path(torch, Path(mesh_work), ref_losses, ref_params, mesh_only)
        phase_done("phase 3m")
        return 0
    specs = deployed_specs()
    dry = None
    try:
        # ---- phases 3t and 3m first: eager work on the card, beside the early
        # build compiling phase 3's programs
        # ---- phase 3t: training on the card, llama at 2 of 28 layers, then xlstm
        launches_3t = train_path(torch, F, work / "train", smi)
        phase_done("phase 3t")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- phase 3m: the multi-device layer, 4 ranks on the one card
        launches_3m = mesh_path(torch, work / "mesh", REFERENCE["train_losses"],
                                REFERENCE.pop("params"))
        phase_done("phase 3m")
        gc.collect()
        torch.cuda.empty_cache()

        builds += start_builds(work, PRECOMPILE_GROUPS, first=len(EARLY_GROUPS))
        # ---- phase 3: the llama serve path, full width, through the Gateway
        gw, dep, launches, first_tokens = gateway_path(torch, SPEC, work / "llama")
        phase_done("phase 3")
        # ---- phase 3b: the decode tier on the same deployment, same Gateway
        launches_3b = decode_tier(torch, gw, dep)
        phase_done("phase 3b")
        # ---- phase 3e: every driver on the same deployment, then warm mode
        launches_3e = driver_taxonomy(torch, gw, dep, first_tokens, inductor_cache)
        phase_done("phase 3e")
        del gw, dep
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work / "llama", ignore_errors=True)

        # ---- phase 3f: coalescing and forecast-driven pre-boot, 1 of 28 layers
        launches_3f = coalesced_path(torch, work / "coalesced")
        phase_done("phase 3f")
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work / "coalesced", ignore_errors=True)

        # ---- phase 3g: the remaining families at published widths
        launches_3g = family_paths(torch, work / "families", specs)
        phase_done("phase 3g")
        shutil.rmtree(work / "families", ignore_errors=True)
        # ---- phase 3r (a) in a process of its own, beside phases 3c and 3d
        dry = start_dryrun(work / "dryrun")

        # ---- phase 3c: the xlstm serve path, full width, 1 of 6 periods
        _, launches_3c = serve_path(
            torch, specs[XLSTM_ARCH], work / "xlstm", XLSTM_REQUESTS,
            lambda cfg, spec: {"flash_attention": 0, "decode_attention": 0,
                               "decode_attention_stats": 0, "paged_decode_attention": 0,
                               "mlstm": cfg.n_layers - cfg.n_layers // cfg.ssm.slstm_every,
                               "selective_scan": 0}, tokens_gate="f32")
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work / "xlstm", ignore_errors=True)
        phase_done("phase 3c")

        # ---- phase 3d: the jamba serve path, full width, one period
        _, launches_3d = serve_path(
            torch, specs[JAMBA_ARCH], work / "jamba", JAMBA_REQUESTS, jamba_launches)
        phase_done("phase 3d")
        finish_builds(builds, t_run)
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work / "jamba", ignore_errors=True)

        # ---- phase 3r (a): the dry run of three cells on a 512-rank fake world
        finish_dryrun(dry, t_run)
        phase_done("phase 3r")
    finally:
        stop_builds(builds)
        if dry is not None:
            stop_builds([dry])
        compile_cache.disable_inductor_disk_cache()
        shutil.rmtree(work, ignore_errors=True)

    # ---- phase 4: report
    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:33"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:35"),
               "decode_attention_stats": ("src/repro_torch/kernels/csrc/decode_attention.cu",
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
                   "driver_taxonomy": launches_3e[name], "coalesced": launches_3f[name],
                   "xlstm_serve": launches_3c[name], "jamba_serve": launches_3d[name],
                   **{path: counts[name] for path, counts in launches_3g.items()},
                   **{path: counts[name] for path, counts in launches_3t.items()},
                   **{path: counts[name] for path, counts in launches_3m.items()}}
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
        if name in bucket_rows:
            kernels[-1]["at_bucket_16"] = bucket_rows[name]
        if name in family_rows:
            kernels[-1]["at_family_shapes"] = family_rows[name]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--precompile"]:
        sys.exit(precompile_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_main(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-only"]:
        sys.exit(leave_nothing_running(
            lambda: main(mesh_only=tuple(sys.argv[2:]) or MESH_CELLS)))
    sys.exit(leave_nothing_running(main))
