#!/usr/bin/env python3
"""Time the PyTorch port's selective-scan kernel on one CUDA GPU, for one
checkout's kernel, at jamba-1.5-large's shapes.

    python3 tools/scan_compare.py [--root DIR] [--parts] [--sass] [--label NAME]

For each shape it prints one JSON line: ``device_ms`` (200 wrapper calls
captured in one CUDA graph and replayed, no host time in it), ``ms`` (CUDA
events around 200 back-to-back calls), the wrapper's ``host_us`` per call,
the kernel's error against ``ref.selective_scan`` (``scaled_err_y``,
``scaled_err_h``), and the bounds of ``chip_smoke.scan_bound``: the bytes
(``bound_bytes_ms``), every exponential on the special-function units
(``bound_exp_sfu_ms``) and the SFU + FP32 floor (``bound_exp_ms``), with
``bound_ms`` the larger of the bytes and that floor. Shapes: jamba's prefill
(B=4, S=512, Di=16384, Ds=16, bf16), one row of it (B=1) and Di=4096 at B=4.

``--root DIR`` imports ``DIR/src/repro_torch`` instead of this checkout's,
so an unpacked parent commit can be timed beside it (run the two in turns
in one session on one card: parent, change, change, parent). ``--parts``
also builds patched copies of that checkout's scan kernel under
``build/variants/`` and times them: each exponential replaced by a multiply
(is the SFU the limit?), the x and dt loads replaced by values made in
registers (is it memory?), B and C read once a stage, each layout of lanes
a channel and each depth of the load ring. The patched outputs are not
results, only their times are read (their errors are printed all the same).
A variant whose texts are not in the kernel's source stops the run. ``--sass`` prints each scan kernel's registers and
spills (``ptxas -v``, from the build log) and a count of its SASS
instructions by opcode (``cuobjdump -sass``).

It needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"jamba prefill": (4, 512, 16384, 16), "one row": (1, 512, 16384, 16),
          "Di = 4096": (4, 512, 4096, 16)}

# name -> [(text in selective_scan.cu, its replacement)]
VARIANTS = {
    "ex2 -> multiply": [
        ("float decay(float x) { return ex2_ftz(x); }",
         "float decay(float x) { return x * 0.015625f; }")],
    "x, dt loads -> registers": [
        ("      const float dtv = dts[r * WC + cl];\n"
         "      const float xv = to_float(xs[r * WC + cl]);",
         "      const float dtv = __int_as_float(0x3f000000 | ((cl ^ (t0 + r)) << 8));\n"
         "      const float xv = __int_as_float(0x3f800000 | ((t0 + r) << 10));"),
        ("if (lane + 32 * j < NDT) {", "if (false) {"),
        ("if (lane + 32 * j < NX) {", "if (false) {")],
    "B, C read once a stage": [
        ("      load_states(bs + r * DS + s0, bv);\n      load_states(cs + r * DS + s0, cv);",
         "      load_states(bs + s0, bv);\n      load_states(cs + s0, cv);")],
    "2 lanes a channel everywhere": [
        ("  const bool one_lane = static_cast", "  const bool one_lane = false && static_cast")],
    "1 lane a channel everywhere": [
        ("  const bool one_lane = static_cast", "  const bool one_lane = true || static_cast")],
    "2 lanes: 8 steps a stage, 3 stages": [
        ("struct Ring<2> { static constexpr int STEPS = 16, STAGES = 2,",
         "struct Ring<2> { static constexpr int STEPS = 8, STAGES = 3,")],
    "1 lane: 16 steps a stage, 2 stages": [
        ("struct Ring<1> { static constexpr int STEPS = 8, STAGES = 3,",
         "struct Ring<1> { static constexpr int STEPS = 16, STAGES = 2,")],
    "1 lane: ring of 2 stages": [
        ("struct Ring<1> { static constexpr int STEPS = 8, STAGES = 3,",
         "struct Ring<1> { static constexpr int STEPS = 8, STAGES = 2,")],
    "1 lane: ring of 4 stages": [
        ("struct Ring<1> { static constexpr int STEPS = 8, STAGES = 3,",
         "struct Ring<1> { static constexpr int STEPS = 8, STAGES = 4,")],
    "y summed in 4 parts": [
        ("      float acc0 = 0.f, acc1 = 0.f;",
         "      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;"),
        ("        if (s & 1) acc1 = fmaf(h[s], cv[s], acc1);\n"
         "        else acc0 = fmaf(h[s], cv[s], acc0);",
         "        if ((s & 3) == 0) acc0 = fmaf(h[s], cv[s], acc0);\n"
         "        else if ((s & 3) == 1) acc1 = fmaf(h[s], cv[s], acc1);\n"
         "        else if ((s & 3) == 2) acc2 = fmaf(h[s], cv[s], acc2);\n"
         "        else acc3 = fmaf(h[s], cv[s], acc3);"),
        ("      float yv = acc0 + acc1;", "      float yv = (acc0 + acc1) + (acc2 + acc3);")],
}


def scan_inputs(torch, F, gen, B, S, Di, Ds):
    """chip_smoke.check_scan's inputs in bf16, dt_scale 1."""
    x = torch.randn(B, S, Di, generator=gen, device="cuda").bfloat16()
    dt = F.softplus(torch.randn(B, S, Di, generator=gen, device="cuda"))
    a_log = torch.log(torch.arange(1, Ds + 1, device="cuda", dtype=torch.float32)) + \
        0.1 * torch.randn(Di, Ds, generator=gen, device="cuda")
    b = torch.randn(B, S, Ds, generator=gen, device="cuda").bfloat16()
    c = torch.randn(B, S, Ds, generator=gen, device="cuda").bfloat16()
    d_skip = torch.randn(Di, generator=gen, device="cuda")
    return x, dt, a_log, b, c, d_skip


def sass_counts(lib_path: Path, nvcc: str) -> dict:
    """Opcode counts of each scan kernel in the library's SASS, keyed by its
    mangled name."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1) if "scan_kernel" in head.group(1) else None
            if name:
                out[name] = collections.Counter()
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and op:
            out[name][op.group(1)] += 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in out.items()}


def clocks_under_load(torch, call, seconds: float = 3.0) -> dict:
    """The SM clock (MHz) and power (W) nvidia-smi reads every 50 ms while
    ``call`` runs back to back for ``seconds``: median and range."""
    import statistics
    import time
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    calls = 0
    try:
        time.sleep(0.5)
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(50):
                call()
            calls += 50
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    samples = [[float(v) for v in line.split(",")] for line in out.splitlines()
               if line.count(",") == 1 and "N/A" not in line]
    mhz = [a for a, _ in samples[10:-2]] or [0.0]          # past the idle half second
    watts = [b for _, b in samples[10:-2]] or [0.0]
    return {"calls": calls, "sm_mhz_median": statistics.median(mhz),
            "sm_mhz_range": [min(mhz), max(mhz)], "power_w_median": statistics.median(watts),
            "power_w_max": max(watts), "samples": len(samples)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", default="",
                    help="with --parts, the variants whose names hold one of these "
                         "comma-separated words")
    ap.add_argument("--clocks", action="store_true",
                    help="also run jamba's shape for 3 s with nvidia-smi sampling the SM "
                         "clock and the power")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_compare: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))                 # chip_smoke's timing helpers and bounds
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels import selective_scan as ss

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"], check=True,
                                  capture_output=True, text=True).stdout.split()[0])
    sm_clocks_per_s = torch.cuda.get_device_properties(0).multi_processor_count * sm_mhz * 1e6
    label = args.label or str(args.root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {name: scan_inputs(torch, F, gen, *shape) for name, shape in SHAPES.items()}
    want = {name: ref.selective_scan(*inp) for name, inp in inputs.items()}

    def row(name: str, **extra) -> dict:
        inp = inputs[name]
        y, h = ss.selective_scan(*inp)
        wy, wh = want[name]
        B, S, Di, Ds = SHAPES[name]
        nbytes = sum(t.numel() * t.element_size() for t in (*inp, y, h))
        call = lambda: ss.selective_scan(*inp)    # noqa: E731
        return {"label": label, "card": card, "kernel": "selective_scan", "shape": name,
                **extra, "scaled_err_y": cs.scaled_err(y, wy), "scaled_err_h": cs.scaled_err(h, wh),
                "device_ms": cs.graph_ms(torch, call),
                "ms": cs.time_ms(torch, call, cs.GRAPH_CALLS),
                "host_us": cs.host_us(torch, call),
                **cs.scan_bound(float(B * S * Di * Ds), nbytes, sm_clocks_per_s)}

    def sass(variant=None) -> None:
        lib_path = _cuda.build()
        print(json.dumps({"label": label, "variant": variant,
                          "ptxas": cs.ptxas_lines(lib_path, ("selective_scan.cu",)),
                          "sass_opcodes": sass_counts(lib_path, _cuda._nvcc())}), flush=True)

    for name in SHAPES:
        print(json.dumps(row(name)), flush=True)
    if args.clocks:
        print(json.dumps({"label": label, "card": card, "shape": "jamba prefill",
                          **clocks_under_load(torch, lambda: ss.selective_scan(
                              *inputs["jamba prefill"]))}), flush=True)
    if args.sass:
        sass()
    if args.parts:
        original = _cuda.CSRC
        source = (original / "selective_scan.cu").read_text()
        only = [w for w in args.only.split(",") if w]
        for variant, patches in VARIANTS.items():
            if only and not any(w in variant for w in only):
                continue
            missing = [a for a, _b in patches if a not in source]
            if missing:
                print(f"scan_compare: variant {variant!r}: not in selective_scan.cu: "
                      f"{missing[0]!r}", file=sys.stderr)
                return 1
            d = ROOT / "build" / "variants" / re.sub(r"[^A-Za-z0-9]+", "_", variant)
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(original, d)
            src = source
            for a, b in patches:
                src = src.replace(a, b)
            (d / "selective_scan.cu").write_text(src)
            _cuda.CSRC, _cuda._lib = d, None
            try:
                _cuda.library()
            except RuntimeError as e:              # a variant that does not build is reported
                print(json.dumps({"label": label, "variant": variant,
                                  "build_failed": str(e)[-2000:]}), flush=True)
                continue
            for name in SHAPES:
                print(json.dumps(row(name, variant=variant)), flush=True)
            if args.sass:
                sass(variant)
        _cuda.CSRC, _cuda._lib = original, None
    return 0


if __name__ == "__main__":
    sys.exit(main())
