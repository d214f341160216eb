"""Weights track: the seconds of the traced window in which a host-to-device
copy ran on the card (``DevicePut``'s chunks, overlapped copies counted
once), over the requests answered inside the window, in ms."""


def read(run):
    d = run.device
    answered = len(run.answered_in_window())
    if d is None or d.htod_busy_s <= 0 or answered == 0:
        return None
    return 1e3 * d.htod_busy_s / answered
