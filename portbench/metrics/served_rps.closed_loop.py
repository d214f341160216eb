"""Gateway and dispatcher: requests answered with tokens inside the window,
per second of it, on the host's clock. Set by how fast the host stages the
images, which swings from process to process on a shared host; so it is a
per-layer reading, and the card's time per request is the end-to-end one."""


def read(run):
    return len(run.answered_in_window()) / run.seconds
