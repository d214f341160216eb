"""Weights track: bytes that ``DevicePut`` moved in the window
(the image, counted from the configuration's shapes, once per request whose
execution began in it), per second of the window, in GB/s."""


def read(run):
    lo, hi = run.t0, run.t0 + run.seconds
    boots = sum(1 for t in run.served() if "device_put" in t.stage_s and lo <= t.t_exec_begin < hi)
    if boots == 0:
        return None
    return boots * run.image_bytes / run.seconds / 1e9
