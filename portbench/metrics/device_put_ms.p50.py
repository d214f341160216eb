"""Weights track: the median ``DevicePut`` stage (the image streamed from the
host's chunk tier through pinned buffers to the card)."""
from portbench.harness.load import percentile_ms


def read(run):
    return percentile_ms([t.stage_s["device_put"] for t in run.served()
                          if "device_put" in t.stage_s], 50)
