"""batch.walk_share (%, the program's counters): decode_batch's host
seconds submitting the walks to its pool and waiting on them to the
pool's shutdown (stats pool_s + walk_wait_s), gained in the window, over
the window's wall time.  Nothing where decode_batch keeps no such
counter."""


def read(w):
    if "walk_wait_s" not in w.stats_close:
        return None
    return 100.0 * (w.delta("pool_s") + w.delta("walk_wait_s")) / w.seconds
