"""batchmask.condition_share (%, the program's counters): decode_batch's
seconds in the native conditioner in the caller while the mask frontend's
device pass runs, capture by capture (stats native_condition_s), gained
in the window, over the window's wall time.  Nothing where decode_batch
keeps no such counter."""


def read(w):
    if "native_condition_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("native_condition_s") / w.seconds
