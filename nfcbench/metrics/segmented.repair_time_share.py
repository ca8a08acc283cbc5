"""segmented.repair_time_share (%, the farm's counters): the IO thread's
seconds in the segmented engine's repairs, each whole with its own
upload, kernels and fetch (CudaStreamFarm.stats repair_s), gained in the
window, over the window's wall time.  Nothing where the farm keeps no
such counter."""


def read(w):
    if "repair_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("repair_s") / w.seconds
