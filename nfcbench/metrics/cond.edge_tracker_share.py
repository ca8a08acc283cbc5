"""cond.edge_tracker_share (%, the program's counters): the device
conditioner's host seconds in its carrier-edge tracker (condition_jax's
stats edge_tracker_s, summed by decode_batch), gained in the window,
over the window's wall time.  Nothing where decode_batch keeps no such
counter."""


def read(w):
    if "edge_tracker_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("edge_tracker_s") / w.seconds
