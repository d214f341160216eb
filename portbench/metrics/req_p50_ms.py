"""The median latency of every request due in the window, from the time it
was due to its answer; a request that failed or never came counts as having
taken until waiting stopped. No cell declares it yet: it is the open-loop
cells' metric (a closed loop's latency is its callers over its rate)."""
from portbench.harness.load import percentile_ms


def read(run):
    return percentile_ms(run.latencies(), 50)
