"""farm.wait_share (%, the farm's counters): seconds the caller waited
for a window's device pass (CudaStreamFarm.stats wait_s), gained in the
window, over the window's wall time."""


def read(w):
    return 100.0 * w.delta("wait_s") / w.seconds
