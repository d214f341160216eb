"""End to end: the card's time per invocation. The seconds of the traced
window in which any kernel, copy or set ran on the card (the weights'
copies to it and the execution), over the requests answered inside the
window, in ms. Its inverse is the invocations a second that the card
would complete were the host never the bound."""


def read(run):
    d = run.device
    answered = len(run.answered_in_window())
    if d is None or d.busy_s <= 0 or answered == 0:
        return None
    return 1e3 * d.busy_s / answered
