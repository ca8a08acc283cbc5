"""pipeline.frame_lag_p95 (ms, host clock): the 95th percentile over every
frame that came back in the window of the time from the hand-over of the
block holding its last sample to its return.

In a closed loop above the program's capacity (the live cells: the
64-block queue is always full) this is about the queue's depth over
``decode_rate`` plus two dispatch windows, so it is read as a per-layer
metric of the entry's queue; a paced cell below capacity would carry
the end-to-end ``frame_lag_p95`` a user feels."""

import numpy as np


def read(w):
    if not w.lags:
        return None
    return float(np.percentile(w.lags, 95)) * 1e3
