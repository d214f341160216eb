"""Executor: the median execution (``Timeline.t_done - t_exec_begin``: the
compiled serve program's prefill and decode steps, and the tokens back)."""
from portbench.harness.load import percentile_ms


def read(run):
    return percentile_ms([t.t_done - t.t_exec_begin for t in run.served()], 50)
