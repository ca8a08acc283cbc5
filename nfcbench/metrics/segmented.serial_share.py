"""segmented.serial_share (%, the farm's counters): dispatch windows of
the window that ran on the serial chain (dispatches - seg_dispatches
gained) over all its dispatch windows.  The warm-up holds every
stream's first window, so each window here comes after the first."""


def read(w):
    n = w.delta("dispatches")
    if n <= 0:
        return None
    return 100.0 * (n - w.delta("seg_dispatches")) / n
