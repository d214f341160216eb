"""Kernels: the decode steps' attention (``csrc/decode_attention.cu``: its
split kernel and the merge behind it) against its roofline: each launch's
bound (``harness.flops.decode_cost``, averaged over the request's decode
steps) over the two kernels' device time."""
from portbench.harness import flops, peaks


def read(run):
    if run.device is None:
        return None
    launches, split_s = run.device.kernels("decode_partial_kernel")
    _, merge_s = run.device.kernels("decode::", "merge_kernel")
    if launches == 0 or split_s <= 0:
        return None
    fn = run.fn
    B = fn["batch_size"]
    lengths = flops.decode_lengths(fn["prompt_len"], fn["decode_steps"])
    per_launch = 0.0
    for n in lengths:
        f, b = flops.decode_cost(B, n, run.arch)
        per_launch += peaks.bound_s(b, f) / len(lengths)
    return 100.0 * launches * per_launch / (split_s + merge_s)
