"""farm.walk_stall_share (%, the farm's counters): the share of the walk's
own time that it spent off a CPU (waiting on the interpreter lock or the
scheduler): 100 x (walk_busy_s - walk_cpu_s) / walk_busy_s, both gained
in the window (CudaStreamFarm.stats: each stream's walk in wall seconds
and in its thread's CPU seconds, summed over streams).  Nothing where no
walk ran in the window or the farm keeps no such counter."""


def read(w):
    if "walk_busy_s" not in w.stats_close:
        return None
    busy = w.delta("walk_busy_s")
    if busy <= 0:
        return None
    return 100.0 * (busy - w.delta("walk_cpu_s")) / busy
