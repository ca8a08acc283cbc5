"""farm.upload_share (%, the farm's counters): the IO thread's seconds
uploading a window's samples, its halo tail and carried state
(CudaStreamFarm.stats upload_s), gained in the window, over the window's
wall time.  Nothing where the farm keeps no such counter."""


def read(w):
    if "upload_s" not in w.stats_close:
        return None
    return 100.0 * w.delta("upload_s") / w.seconds
