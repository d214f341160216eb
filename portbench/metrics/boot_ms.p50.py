"""Boot pipeline: the median boot (``Timeline.t_boot_wall``: the program and
weights tracks, overlapped, to a ready executor)."""
from portbench.harness.load import percentile_ms


def read(run):
    return percentile_ms([t.t_boot_wall for t in run.served()], 50)
