"""ctypes binding of the probe kernels (csrc/probes.cu), in the kernel
library that ``kernels.fused.library`` loads.

``CopyProbeArgs`` and ``ProbeArgs`` mirror the C structures field for
field.  Pointers come from ``Tensor.data_ptr()``, the stream from PyTorch's
current stream; the launchers queue the kernel and raise if the launch was
refused.  They check nothing about the tensors: the wrappers in
``experiments/`` do.
"""

from __future__ import annotations

import ctypes

import torch

from .fused import check, library

MAX_NOUT = 32
COPY_THREADS = 256
COPY_BLOCKS_PER_SM = 8   # 2048 threads on every SM, each with a load in flight
PROBE_THREADS = 32       # one warp per block: the lanes spread over the SMs

_p = ctypes.c_void_p
_f = ctypes.c_float


class CopyProbeArgs(ctypes.Structure):
    _fields_ = [
        ("x", _p), ("out", _p * MAX_NOUT), ("scale", _f * MAX_NOUT),
        ("n", ctypes.c_int64), ("nout", ctypes.c_int32),
        ("sweeps", ctypes.c_int32),
    ]


class ProbeArgs(ctypes.Structure):
    _fields_ = [
        ("value", _p),
        ("env", _p), ("filt", _p), ("mdev", _p), ("avg", _p),
        ("mod_depth", _p),
        ("G", ctypes.c_int64), ("T", ctypes.c_int64), ("L", ctypes.c_int64),
        ("etu", ctypes.c_int32), ("silence", _f),
        ("enve_w0", _f), ("enve_w1", _f), ("mdev_w0", _f), ("mdev_w1", _f),
        ("mean_w0", _f), ("mean_w1", _f), ("iir_a", _f),
    ]


def launch_copy(x, outs, scales, sweeps: int):
    """Queue copy_probe_kernel: x and every output contiguous, of one size,
    16-byte aligned; scales the float32 factors."""
    lib = library()
    a = CopyProbeArgs()
    a.x = x.data_ptr()
    for i, (o, s) in enumerate(zip(outs, scales)):
        a.out[i] = o.data_ptr()
        a.scale[i] = s
    a.n, a.nout, a.sweeps = x.numel(), len(outs), sweeps
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(lib, lib.nfclab_copy_probe(ctypes.byref(a), x.device.index,
                                     sms * COPY_BLOCKS_PER_SM, COPY_THREADS,
                                     stream), "copy_probe")


def launch_probe(value, outs, pt, pair: bool):
    """Queue serial_probe_kernel (pair=False) or pair_probe_kernel.

    value: [G, T, L] f32; outs: (env, filt, mdev, avg, mod_depth), each
    [G, T, L]; pt: the 8-tuple of dsp.frontend._params_tuple."""
    lib = library()
    a = ProbeArgs()
    a.value = value.data_ptr()
    (a.env, a.filt, a.mdev, a.avg, a.mod_depth) = (o.data_ptr() for o in outs)
    a.G, a.T, a.L = value.shape
    etu = int(pt[7])
    a.etu, a.silence = etu, float(etu * 10.0)
    (a.enve_w0, a.enve_w1, a.mdev_w0, a.mdev_w1, a.mean_w0, a.mean_w1,
     a.iir_a) = (float(p) for p in pt[:7])
    stream = torch.cuda.current_stream(value.device).cuda_stream
    check(lib, lib.nfclab_cond_probe(ctypes.byref(a), int(pair),
                                     value.device.index, PROBE_THREADS,
                                     stream),
          "pair_probe" if pair else "serial_probe")
