"""farm.fetch_share (%, the farm's counters): the IO thread's seconds
moving a window's results to the host after its compaction (counts,
trigger prefixes, overflow rows, carry rows) and assembling them
(CudaStreamFarm.stats fetch_s), gained in the window, over the window's
wall time.  Nothing where the farm keeps no such counter."""


def read(w):
    if "fetch_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("fetch_s") / w.seconds
