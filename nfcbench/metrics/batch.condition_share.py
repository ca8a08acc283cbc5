"""batch.condition_share (%, the program's counters): decode_batch's host
seconds in the device conditioner, capture by capture (stats
condition_s), gained in the window, over the window's wall time.
Nothing where decode_batch keeps no such counter."""


def read(w):
    if "condition_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("condition_s") / w.seconds
