"""farm.walk_share (%, the farm's counters): the walk's seconds gained in
the window (CudaStreamFarm.stats walk_s) over the window's wall time."""


def read(w):
    return 100.0 * w.delta("walk_s") / w.seconds
