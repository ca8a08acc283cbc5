"""kernels.scan_narrow_share (%, the farm's counters): the scan's launches
on ff_scan_kernel_narrow (CudaStreamFarm.stats scan_narrow_launches)
gained in the window, over every launch of the scan gained in it
(scan_launches).  Nothing where the farm keeps no such counter, or where
no scan ran in the window."""


def read(w):
    if "scan_narrow_launches" not in w.stats_close:
        return None
    scans = w.delta("scan_launches")
    if scans <= 0:
        return None
    return 100.0 * w.delta("scan_narrow_launches") / scans
