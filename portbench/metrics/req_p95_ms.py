"""The 95th percentile of the latencies ``req_p50_ms`` reads the median of."""
from portbench.harness.load import percentile_ms


def read(run):
    return percentile_ms(run.latencies(), 95)
