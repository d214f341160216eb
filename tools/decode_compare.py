#!/usr/bin/env python3
"""Time the PyTorch port's decode and paged-decode kernels on one CUDA GPU,
for one checkout's kernels, at the paths' shapes.

    python3 tools/decode_compare.py [--root DIR] [--parts] [--host] [--stats]
                                    [--label NAME]

For each shape it prints one JSON line: ``device_ms`` (200 wrapper calls
captured in one CUDA graph and replayed, no host time in it), the wrapper's
``host_us`` per call, ``ms`` (CUDA events around 200 back-to-back calls) and
the same three for the one PyTorch call that computes the function
(``scaled_dot_product_attention`` with a length mask; for the paged kernel a
gather of the page chains first). Shapes: llama3.2-3b's decode (B=4, S=528,
24/8 heads, D=128, bf16), jamba-1.5-large's (64/8 heads), and the decode
tier's paged step (8 slots, 33 pages of 16, 24/8 heads).

``--root DIR`` imports ``DIR/src/repro_torch`` instead of this checkout's,
so an unpacked parent commit can be timed beside it (run the two in turns
in one session on one card: parent, change, change, parent). ``--parts``
also builds patched copies of this checkout's decode kernel under
``build/variants/`` and times them at llama's and jamba's shapes: without
the merge kernel, with a split kernel that exits at once, and with both, so
the split kernel, the merge and the launch floor can be told apart (the
patched outputs are not results; only their times are read). ``--host``
also times, at llama's shape, the host cost of each step of this
checkout's decode wrapper alone (2000 calls each, the device left to run
behind). ``--stats`` times the decode kernel's stats entry instead, at
phase 3m serve_seqkv's local shard (B=2, S=16,384, 24/8 heads, D=128,
bf16), at one row of a 32,768-position shard and at 16/8 heads of D=64:
``device_ms``, ``host_us``, ``ms``, and each of its kernels' device time per
call from ``torch.profiler`` (the split kernel, the merge), so an unpacked
parent's entry can be timed beside this checkout's.

It needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_compare: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))                 # chip_smoke's timing helpers
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    label = args.label or str(args.root)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def cache(B, S, Hq, Hkv, D):
        q = torch.randn(B, Hq, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").bfloat16()
        return q, k, v, torch.full((B,), S, dtype=torch.int32, device="cuda")

    def times(kernel, library) -> dict:
        return {"device_ms": cs.graph_ms(torch, kernel), "host_us": cs.host_us(torch, kernel),
                "ms": cs.time_ms(torch, kernel, CALLS),
                "library_device_ms": cs.graph_ms(torch, library),
                "library_host_us": cs.host_us(torch, library),
                "library_ms": cs.time_ms(torch, library, CALLS)}

    rows = []
    if args.stats:
        for name, shape in (("serve_seqkv local", (2, 16384, 24, 8, 128)),
                            ("one row of 32,768", (1, 32768, 24, 8, 128)),
                            ("16/8 heads at D=64", (2, 16384, 16, 8, 64))):
            q, k, v, n = cache(*shape)
            entry = lambda: da.decode_attention_stats(q, k, v, n)   # noqa: E731
            rows.append({"kernel": "decode_attention_stats", "shape": name,
                         "device_ms": cs.graph_ms(torch, entry),
                         "host_us": cs.host_us(torch, entry),
                         "ms": cs.time_ms(torch, entry, CALLS),
                         "parts_device_ms": cs.kernel_parts_ms(torch, entry)})
            del q, k, v
        for r in rows:
            print(json.dumps({"label": label, "card": card, **r}), flush=True)
        return 0
    contiguous = {"llama": cache(4, 528, 24, 8, 128), "jamba": cache(4, 528, 64, 8, 128)}
    for name, (q, k, v, n) in contiguous.items():
        S = k.shape[1]
        mask = (torch.arange(S, device="cuda")[None, :] < n[:, None])[:, None, None, :]
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        rows.append({"kernel": "decode_attention", "shape": name, **times(
            lambda: da.decode_attention(q, k, v, n),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True))})
    B, ps, mp, Hq, Hkv, D = 8, 16, 33, 24, 8, 128
    q, k, v, n = cache(B, mp * ps, Hq, Hkv, D)
    kp, vp, table = cs.paged_layout(torch, k, v, [mp * ps] * B, ps, 0.0, 1)
    mask = (torch.arange(mp * ps, device="cuda")[None, :] < n[:, None])[:, None, None, :]
    tl = table.long()

    def gathered():
        kg = kp[tl].reshape(B, mp * ps, Hkv, D).transpose(1, 2)
        vg = vp[tl].reshape(B, mp * ps, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask,
                                              enable_gqa=True)
    rows.append({"kernel": "paged_decode_attention", "shape": "decode tier", **times(
        lambda: pda.paged_decode_attention(q, kp, vp, table, n), gathered)})

    if args.parts:
        merge = ("return decode::launch_merge<T>(scratch, length, o, B, Hkv, G, D, NS, S, "
                 "stream);", "(void)o; return cudaSuccess;")
        empty = ("if (!decode::cta_split(length, S, B, Hkv, G, NS, D, scratch, sp)) return;",
                 "return;")
        variants = {"no merge kernel": [merge], "split kernel exits at once": [empty],
                    "both": [merge, empty]}
        original = _cuda.CSRC
        for name, patches in variants.items():
            d = ROOT / "build" / "variants" / name.replace(" ", "_")
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(original, d)
            src = (d / "decode_attention.cu").read_text()
            for a, b in patches:
                if a not in src:
                    raise RuntimeError(f"--parts: {a!r} not in decode_attention.cu")
                src = src.replace(a, b)
            (d / "decode_attention.cu").write_text(src)
            _cuda.CSRC, _cuda._lib = d, None
            _cuda.library()
            for shape, (q, k, v, n) in contiguous.items():
                rows.append({"kernel": "decode_attention", "shape": shape, "variant": name,
                             "device_ms": cs.graph_ms(torch, lambda: da.decode_attention(
                                 q, k, v, n))})
        _cuda.CSRC, _cuda._lib = original, None

    if args.host:
        from repro_torch.kernels.flash_attention import DTYPES, check_cuda_operands
        q, k, v, n = contiguous["llama"]
        B, S, Hkv, D = k.shape
        Hq = q.shape[1]
        lib = _cuda.library()
        o = torch.empty_like(q)
        ns, scratch = da.split_scratch(B, Hq, Hkv, D, S, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        steps = {
            "operand checks": lambda: (check_cuda_operands("d", q, k, v),
                                       da.check_heads("d", Hq, Hkv, D)),
            "lengths to int32 [B]": lambda: torch.as_tensor(
                n, dtype=torch.int32, device=q.device).expand(B).contiguous(),
            "output allocation": lambda: torch.empty_like(q),
            "split scratch allocation": lambda: da.split_scratch(B, Hq, Hkv, D, S, q.device),
            "current stream": lambda: torch.cuda.current_stream(q.device).cuda_stream,
            "C call: split kernel + merge launches": lambda: lib.repro_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), o.data_ptr(),
                scratch.data_ptr(), DTYPES[q.dtype], B, S, Hq, Hkv, D, ns, stream),
            "whole wrapper": lambda: da.decode_attention(q, k, v, n),
        }
        for name, fn in steps.items():
            rows.append({"kernel": "decode_attention", "shape": "llama", "host_step": name,
                         "host_us": cs.host_us(torch, fn, 2000)})

    for r in rows:
        print(json.dumps({"label": label, "card": card, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
