"""segmented.repair_share (%, the farm's counters): streams repaired over
streams x segmented windows, both gained in the window; nothing where no
window of the window was segmented."""


def read(w):
    seg = w.delta("seg_dispatches")
    if seg <= 0:
        return None
    return 100.0 * w.delta("repaired_streams") / (w.n_streams * seg)
