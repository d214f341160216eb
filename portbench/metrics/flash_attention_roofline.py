"""Kernels: the prefill's flash kernel (``csrc/flash_attention.cu``) against
its roofline: each launch's bound (``harness.flops.flash_cost`` at the
cell's prefill shape, at the card's peaks) over its device time."""
from portbench.harness import flops, peaks


def read(run):
    if run.device is None:
        return None
    launches, secs = run.device.kernels("flash_fwd_")
    if launches == 0 or secs <= 0:
        return None
    fn = run.fn
    f, b = flops.flash_cost(fn["batch_size"], fn["prompt_len"], run.arch)
    return 100.0 * launches * peaks.bound_s(b, f) / secs
