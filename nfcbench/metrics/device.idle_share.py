"""device.idle_share (%, device trace): the share of the window in which
no kernel, copy or memset ran on the card."""


def read(w):
    if w.trace is None or w.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
