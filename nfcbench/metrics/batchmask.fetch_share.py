"""batchmask.fetch_share (%, the program's counters): the mask engine's
seconds fetching, on the device pass's thread (stats masks_fetch_s: the
counts, the compacted trigger prefixes, the dense rows of the streams
over the compaction cap, the per-capture assembly), gained in the window,
over the window's wall time.  Nothing where decode_batch keeps no such
counter."""


def read(w):
    if "masks_fetch_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("masks_fetch_s") / w.seconds
