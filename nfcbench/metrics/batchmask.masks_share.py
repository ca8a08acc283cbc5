"""batchmask.masks_share (%, the program's counters): decode_batch's
seconds in the mask frontend's device pass, on the thread that runs it
(stats masks_s), gained in the window, over the window's wall time.
Nothing where decode_batch keeps no such counter."""


def read(w):
    if "masks_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("masks_s") / w.seconds
