"""ctypes binding of the v2 fused frontend kernels (csrc/fused_v2.cu), in
the kernel library that ``kernels.fused.library`` loads.

``V2Args`` mirrors the C structure field for field; both kernels take it.
Pointers come from ``Tensor.data_ptr()``, the stream from PyTorch's
current stream; the launchers queue the kernel and raise if the launch was
refused.  They check nothing about the tensors: the wrappers in
``experiments/fused_v2.py`` do.
"""

from __future__ import annotations

import ctypes

import torch

from .fused import check, library

SCAN_THREADS = 32   # one warp per block: 440 ring rows of 32 streams, 56 KB
MASK_THREADS = 256

_p = ctypes.c_void_p
_f = ctypes.c_float


class V2Args(ctypes.Structure):
    _fields_ = [
        ("value", _p), ("state_in", _p), ("state_out", _p), ("out", _p),
        ("B", ctypes.c_int64), ("T", ctypes.c_int64),
        ("base", ctypes.c_int32), ("etu", ctypes.c_int32),
        ("silence", _f),
        ("enve_w0", _f), ("enve_w1", _f), ("mdev_w0", _f), ("mdev_w1", _f),
        ("mean_w0", _f), ("mean_w1", _f), ("iir_a", _f),
        ("power_thr", _f), ("a_thr", _f), ("b_min_deep", _f), ("f_thr", _f),
        ("v_thr", _f),
    ]


def _args(out, state_in, state_out, base, nstate):
    lib = library()
    if lib.nfclab_v2_nstate() != nstate:
        raise RuntimeError(
            f"csrc/fused_v2.cu has {lib.nfclab_v2_nstate()} state rows, "
            f"experiments/fused_v2.py {nstate}")
    a = V2Args()
    a.state_in, a.state_out, a.out = (
        t.data_ptr() for t in (state_in, state_out, out))
    _, a.T, a.B = out.shape
    a.base = base
    return lib, a


def launch_scan(value_tm, state_in, state_out, out, base, pt, nstate):
    """Queue v2_scan_kernel: value_tm [T, B]; state_in, state_out
    [nstate, B]; out [15, T, B] (its detect_mask row and the state rows of
    the mask are left to launch_mask)."""
    lib, a = _args(out, state_in, state_out, base, nstate)
    a.value = value_tm.data_ptr()
    etu = int(pt[7])
    a.etu, a.silence = etu, float(etu * 10.0)
    (a.enve_w0, a.enve_w1, a.mdev_w0, a.mdev_w1, a.mean_w0, a.mean_w1,
     a.iir_a) = (float(p) for p in pt[:7])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    check(lib, lib.nfclab_v2_scan(ctypes.byref(a), out.device.index,
                                  SCAN_THREADS, stream), "fused_v2_scan")


def launch_mask(out, state_in, state_out, base, mp, nstate):
    """Queue v2_mask_kernel (mp: float32 mask params): writes the
    detect_mask row of out and the rb / rbv rings and carry rows 5-9 of
    state_out."""
    lib, a = _args(out, state_in, state_out, base, nstate)
    (a.power_thr, a.a_thr, a.b_min_deep, a.f_thr, a.v_thr) = mp
    stream = torch.cuda.current_stream(out.device).cuda_stream
    check(lib, lib.nfclab_v2_mask(ctypes.byref(a), out.device.index,
                                  MASK_THREADS, stream), "fused_v2_mask")
