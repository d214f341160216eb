"""Executor: the model FLOPs of the requests whose execution began in the
traced window (``harness.flops.request_flops``, from the shapes), over the
seconds in which a kernel ran on the card, against 989 TFLOP/s bf16."""
from portbench.harness import flops, peaks


def read(run):
    d = run.device
    if d is None or d.kernel_busy_s <= 0:
        return None
    fn = run.fn
    work = run.executions_in_trace() * flops.request_flops(
        run.arch, fn["batch_size"], fn["prompt_len"], fn["decode_steps"])
    if work == 0:
        return None
    return 100.0 * work / (d.kernel_busy_s * peaks.BF16_FLOP_PER_S)
