"""kernels.batch_mask_roofline (%, device trace): the least time the
window's decoded samples need in the fused frontend function with the
mask-only select at the configuration's sample rate
(nfcbench/roofline.py), over the streams x dispatch windows the mask
engine ran in the window (stats masks_windows), over the traced time of
the kernels named exactly ff_scan_kernel_narrow, ff_scan_kernel and
ff_mask_kernel in the window (a kernel's name is its identifier, without
``void``, template arguments or argument list).  Nothing where
decode_batch keeps no such counter, without a trace, or where none of
the kernels ran."""

import re

from nfcbench.roofline import frontend_least_s

KERNELS = frozenset({"ff_scan_kernel_narrow", "ff_scan_kernel",
                     "ff_mask_kernel"})
_IDENT = re.compile(r"(?:void\s+)?([A-Za-z_][A-Za-z0-9_:]*)")


def kernel_name(op: str) -> str:
    """The identifier of a traced op's name: ``void ff_mask_kernel<32>``
    is ``ff_mask_kernel``."""
    m = _IDENT.match(op)
    return m.group(1) if m else op


def read(w):
    if w.trace is None or "masks_windows" not in w.stats_close:
        return None
    t = sum(s for name, s in w.trace["ops"].items()
            if kernel_name(name) in KERNELS)
    if t <= 0:
        return None
    samples = w.drained_close - w.drained_open
    windows = int(w.delta("masks_windows"))
    rate = int(w.cfg["sample_rate"])
    return 100.0 * frontend_least_s(samples, windows, rate) / t
