"""pipeline.queue_wait_p95 (ms, the program's spans): the 95th percentile
of the time each block taken from the decoder task's queue inside the
window waited there (``task.queued`` spans of
nfclab_torch/runtime/trace.py, put to get, that end inside the window).
The spans are recorded while a profiler records, so a ``--trace 1`` run
has them.  Nothing where the program has no such span."""

import numpy as np


def read(w):
    try:
        from nfclab_torch.runtime import trace
    except ImportError:
        return None
    waits = [s.end - s.start for s in trace.spans(w.t_open, w.t_close)
             if s.name == "task.queued" and w.t_open <= s.end <= w.t_close]
    if not waits:
        return None
    return float(np.percentile(waits, 95)) * 1e3
