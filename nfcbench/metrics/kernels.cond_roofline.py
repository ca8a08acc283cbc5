"""kernels.cond_roofline (%, device trace): the least time the window's
conditioned samples need in the conditioning function
(nfcbench/cond_roofline.py) over the traced time of every
cond_scan_kernel launch in the window, pass 1 and repairs alike (halos
and repairs count as time, not work).  Under decode_batch's defaults
every decoded sample is conditioned once, so the window's decoded
samples are its conditioned ones.  Nothing when the kernel did not run."""

from nfcbench.cond_roofline import cond_least_s

KERNEL = "cond_scan_kernel"


def read(w):
    if w.trace is None:
        return None
    t = sum(s for name, s in w.trace["ops"].items() if KERNEL in name)
    if t <= 0:
        return None
    return 100.0 * cond_least_s(w.drained_close - w.drained_open) / t
