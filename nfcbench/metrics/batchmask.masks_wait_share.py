"""batchmask.masks_wait_share (%, the program's counters): decode_batch's
seconds with the caller blocked on the mask frontend's device pass after
its own native conditioning ended (stats masks_wait_s): the part of the
pass that the overlap does not hide, gained in the window, over the
window's wall time.  Nothing where decode_batch keeps no such counter."""


def read(w):
    if "masks_wait_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("masks_wait_s") / w.seconds
