"""cond.repair_share (%, the program's counters): the device conditioner's
blocks scanned again (condition_jax's stats repairs) over its blocks of
pass 1 (blocks), both gained in the window.  Nothing where decode_batch
keeps no such counter or no block was conditioned in the window."""


def read(w):
    if "blocks" not in w.stats_close:
        return None
    blocks = w.delta("blocks")
    if blocks <= 0:
        return None
    return 100.0 * w.delta("repairs") / blocks
