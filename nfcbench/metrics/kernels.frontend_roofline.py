"""kernels.frontend_roofline (%, device trace): the least time the window's
decoded samples need in the fused frontend function with the mask-only
select at the configuration's sample rate (nfcbench/roofline.py) over
the traced time of ff_scan_kernel and
ff_mask_kernel in the window.  Nothing when neither kernel ran."""

from nfcbench.roofline import frontend_least_s

KERNELS = ("ff_scan_kernel", "ff_mask_kernel")


def read(w):
    if w.trace is None:
        return None
    t = sum(s for name, s in w.trace["ops"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    samples = w.drained_close - w.drained_open
    windows = samples // w.window_samples
    rate = int(w.cfg["sample_rate"])
    return 100.0 * frontend_least_s(samples, windows, rate) / t
