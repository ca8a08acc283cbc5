"""ctypes binding of the conditioning scan kernel (csrc/conditioner.cu),
in the kernel library that ``kernels.fused.library`` loads.

``CondScanArgs`` mirrors the C structure field for field.  Pointers come
from ``Tensor.data_ptr()``, the stream from PyTorch's current stream; the
launcher queues the kernel and raises if the launch was refused.  It checks
nothing about the tensors: the wrapper in ``dsp/conditioner_kernel.py``
does.
"""

from __future__ import annotations

import ctypes

import torch

from .fused import check, library

# a block serves 32 streams with three warps, one per independent chain
# (envelope + pulse, w1 -> filt -> mdev, avg)
THREADS = 96
MAX_STREAMS = 1 << 27  # 32-bit offsets reach a group of rows

_p = ctypes.c_void_p
_f = ctypes.c_float


class CondScanArgs(ctypes.Structure):
    _fields_ = [
        ("value", _p),
        ("env0", _p), ("w10", _p), ("mdev0", _p), ("avg0", _p),
        ("pulse0", _p), ("clock0", _p),
        ("env", _p), ("w1", _p), ("mdev", _p), ("avg", _p), ("filt", _p),
        ("pulse", _p),
        ("B", ctypes.c_int64), ("T", ctypes.c_int64),
        ("etu", ctypes.c_int32),
        ("enve_w0", _f), ("enve_w1", _f), ("mdev_w0", _f), ("mdev_w1", _f),
        ("mean_w0", _f), ("mean_w1", _f), ("iir_a", _f),
    ]


def launch_scan(value_tm, init, outs, pt):
    """Queue cond_scan_kernel on the current stream.

    value_tm: [T, B] f32; init: (env0, w10, mdev0, avg0, pulse0, clock0)
    [B] rows; outs: (env, w1, mdev, avg, filt, pulse) [T, B]; pt: the
    8-tuple of dsp.frontend._params_tuple."""
    T, B = value_tm.shape
    if B > MAX_STREAMS:
        raise ValueError(f"cond_scan_kernel takes at most {MAX_STREAMS} "
                         f"streams a call, got {B}")
    lib = library()
    a = CondScanArgs()
    a.value = value_tm.data_ptr()
    (a.env0, a.w10, a.mdev0, a.avg0, a.pulse0, a.clock0) = (
        t.data_ptr() for t in init)
    (a.env, a.w1, a.mdev, a.avg, a.filt, a.pulse) = (
        t.data_ptr() for t in outs)
    a.B, a.T = B, T
    a.etu = int(pt[7])
    (a.enve_w0, a.enve_w1, a.mdev_w0, a.mdev_w1, a.mean_w0, a.mean_w1,
     a.iir_a) = (float(p) for p in pt[:7])
    stream = torch.cuda.current_stream(value_tm.device).cuda_stream
    check(lib, lib.nfclab_cond_scan(ctypes.byref(a), value_tm.device.index,
                                    THREADS, stream), "cond_scan")
