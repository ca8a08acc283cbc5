"""farm.io_starved_share (%, the farm's counters): seconds the farm's IO
thread sat idle between one device pass and the next (nothing submitted,
plus its wake-up; CudaStreamFarm.stats io_idle_s), gained in the window,
over the window's wall time.  Nothing where the farm keeps no such
counter."""


def read(w):
    if "io_idle_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("io_idle_s") / w.seconds
