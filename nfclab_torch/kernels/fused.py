"""ctypes binding of the fused frontend kernels (csrc/fused_frontend.cu),
and the loader of the one kernel library that holds every kernel of the
port (``library``, ``check``).

The structures mirror ``FFScanArgs`` and ``FFMaskArgs`` field for field.
Pointers come from ``Tensor.data_ptr()``, the stream from PyTorch's
current stream; the launchers queue the kernel and raise if the launch was
refused.  They check nothing about the tensors: the wrappers in
``dsp/fused_frontend.py`` do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build

MAX_BV = 8
MAX_Q = 4
MAX_PB = 8
MAX_RATES = 4
MAX_HIST = MAX_BV + 1
SCAN_THREADS = 32   # one warp per block: the rings of 32 streams in smem
MASK_THREADS = 256
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90

_p = ctypes.c_void_p
_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_f = ctypes.c_float


class FFScanArgs(ctypes.Structure):
    _fields_ = [
        ("value", _p), ("state_in", _p), ("state_out", _p), ("deps", _p),
        ("out_mdev", _p), ("out_avg", _p),
        ("out_q", _p * MAX_Q), ("out_p", _p * MAX_PB),
        ("B", _i64), ("T", _i64),
        ("base", _i32), ("etu", _i32),
        ("enve_w0", _f), ("enve_w1", _f), ("mdev_w0", _f), ("mdev_w1", _f),
        ("mean_w0", _f), ("mean_w1", _f), ("iir_a", _f), ("silence", _f),
        ("n_bv", _i32), ("n_q", _i32), ("n_pb", _i32),
        ("bv_w", _i32 * MAX_BV), ("q_w", _i32 * MAX_Q),
        ("pb_lag", _i32 * MAX_PB), ("pb_box", _i32 * MAX_PB),
        ("rv_ring", _i32), ("rf_ring", _i32), ("rq_ring", _i32),
        ("rp_ring", _i32 * MAX_PB),
        ("ring_off", _i32), ("ring_rows", _i32),
        ("hist_off", _i32), ("hist_rows", _i32), ("sums_off", _i32),
    ]


class FFMaskArgs(ctypes.Structure):
    _fields_ = [
        ("value", _p), ("deps", _p), ("state_in", _p), ("state_out", _p),
        ("out_mask", _p), ("out_mod_depth", _p),
        ("B", _i64), ("T", _i64),
        ("n_bv", _i32),
        ("hist_off", _i32 * MAX_HIST), ("hist_len", _i32 * MAX_HIST),
        ("power_thr", _f), ("a_thr", _f), ("b_min_deep", _f), ("f_thr", _f),
        ("v_thr", _f),
        ("n_a", _i32),
        ("a_d", _i32 * MAX_RATES), ("a_gap", _i32 * MAX_RATES),
        ("a_ch", _i32 * MAX_RATES), ("a_hoff", _i32 * MAX_RATES),
        ("a_hlen", _i32 * MAX_RATES), ("a_bit", _i32 * MAX_RATES),
        ("a_p2", _f * MAX_RATES),
        ("n_f", _i32),
        ("f_gap", _i32 * MAX_RATES), ("f_ch", _i32 * MAX_RATES),
        ("f_hoff", _i32 * MAX_RATES), ("f_hlen", _i32 * MAX_RATES),
        ("f_bit", _i32 * MAX_RATES),
        ("f_p2", _f * MAX_RATES),
        ("n_b", _i32),
        ("b_d", _i32 * MAX_RATES), ("b_bit", _i32 * MAX_RATES),
        ("b_hoff", _i32), ("b_hlen", _i32),
        ("v_d", _i32), ("v_gap", _i32), ("v_ch", _i32), ("v_hoff", _i32),
        ("v_hlen", _i32), ("v_bit", _i32),
        ("v_p2", _f),
        ("rows_main", _i32), ("hist_rows", _i32),
    ]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with the argument
    types of every entry point."""
    from .conditioner import CondScanArgs
    from .fused_v2 import V2Args
    from .probes import CopyProbeArgs, ProbeArgs

    lib = ctypes.CDLL(str(build()))
    lib.nfclab_ff_scan.argtypes = [
        ctypes.POINTER(FFScanArgs), ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.nfclab_ff_scan.restype = ctypes.c_int
    lib.nfclab_ff_mask.argtypes = [
        ctypes.POINTER(FFMaskArgs), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nfclab_ff_mask.restype = ctypes.c_int
    lib.nfclab_cond_scan.argtypes = [
        ctypes.POINTER(CondScanArgs), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nfclab_cond_scan.restype = ctypes.c_int
    for name in ("nfclab_v2_scan", "nfclab_v2_mask"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(V2Args), ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nfclab_v2_nstate.argtypes = []
    lib.nfclab_v2_nstate.restype = ctypes.c_int
    lib.nfclab_copy_probe.argtypes = [
        ctypes.POINTER(CopyProbeArgs), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nfclab_copy_probe.restype = ctypes.c_int
    lib.nfclab_cond_probe.argtypes = [
        ctypes.POINTER(ProbeArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nfclab_cond_probe.restype = ctypes.c_int
    lib.nfclab_ff_error_string.argtypes = [ctypes.c_int]
    lib.nfclab_ff_error_string.restype = ctypes.c_char_p
    return lib


def _fill(arr, values):
    for i, v in enumerate(values):
        arr[i] = v


def check(lib, code: int, what: str):
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.nfclab_ff_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _limits(plan):
    # the mask packs 3 A, 2 B, 2 F and 1 V bit (MASK_LAYOUT)
    if (len(plan.bv_widths) > MAX_BV or len(plan.q_widths) > MAX_Q
            or len(plan.pb) > MAX_PB or len(plan.a_rates) > 3
            or len(plan.f_rates) > 2 or len(plan.b_delays) > 2):
        raise ValueError(f"kernel plan exceeds the kernel's limits: {plan}")


def launch_scan(value_tm, state_in, state_out, deps, extra: dict, base: int,
                pt, plan, lay):
    """Queue ff_scan_kernel on the current stream."""
    _limits(plan)
    lib = library()
    T, B = value_tm.shape
    a = FFScanArgs()
    a.value, a.state_in, a.state_out, a.deps = (
        _ptr(value_tm), _ptr(state_in), _ptr(state_out), _ptr(deps))
    a.out_mdev = _ptr(extra.get("deviation"))
    a.out_avg = _ptr(extra.get("average"))
    _fill(a.out_q, [_ptr(extra.get(f"q{w}")) for w in plan.q_widths])
    _fill(a.out_p, [_ptr(extra.get(f"p{lag}x{box}")) for lag, box in plan.pb])
    a.B, a.T, a.base = B, T, base
    etu = int(pt[7])
    a.etu = etu
    (a.enve_w0, a.enve_w1, a.mdev_w0, a.mdev_w1, a.mean_w0, a.mean_w1,
     a.iir_a) = (float(p) for p in pt[:7])
    a.silence = float(etu * 10.0)
    a.n_bv, a.n_q, a.n_pb = (len(plan.bv_widths), len(plan.q_widths),
                             len(plan.pb))
    _fill(a.bv_w, plan.bv_widths)
    _fill(a.q_w, plan.q_widths)
    _fill(a.pb_lag, [lag for lag, _ in plan.pb])
    _fill(a.pb_box, [box for _, box in plan.pb])
    a.rv_ring, a.rf_ring, a.rq_ring = plan.rv_ring, plan.rf_ring, plan.rq_ring
    _fill(a.rp_ring, plan.rp_rings)
    a.ring_off, a.ring_rows = lay.ring_off, lay.ring_rows
    a.hist_off, a.hist_rows = lay.hist_off, lay.hist_rows
    a.sums_off = lay.sums_off
    smem = lay.ring_rows * SCAN_THREADS * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"rings of {lay.ring_rows} rows need {smem} B of shared memory "
            f"per block (limit {SMEM_LIMIT})"
        )
    stream = torch.cuda.current_stream(value_tm.device).cuda_stream
    check(lib, lib.nfclab_ff_scan(ctypes.byref(a), value_tm.device.index,
                                   SCAN_THREADS, smem, stream), "ff_scan")


def launch_mask(deps, value_tm, state_in, state_out, out_mask, out_md, mp,
                plan, lay):
    """Queue ff_mask_kernel on the current stream (mp: float32 mask
    params)."""
    _limits(plan)
    lib = library()
    _, T, B = deps.shape
    a = FFMaskArgs()
    a.value, a.deps, a.state_in, a.state_out = (
        _ptr(value_tm), _ptr(deps), _ptr(state_in), _ptr(state_out))
    a.out_mask, a.out_mod_depth = _ptr(out_mask), _ptr(out_md)
    a.B, a.T = B, T
    nbv = len(plan.bv_widths)
    a.n_bv = nbv
    hlen = [h + 128 for h in plan.h_sizes]
    _fill(a.hist_off, lay.hist_offs)
    _fill(a.hist_len, hlen)
    (a.power_thr, a.a_thr, a.b_min_deep, a.f_thr, a.v_thr) = mp
    a.n_a = len(plan.a_rates)
    for r, (d, gap, p2, widx) in enumerate(plan.a_rates):
        a.a_d[r], a.a_gap[r], a.a_ch[r] = d, gap, widx
        a.a_hoff[r], a.a_hlen[r] = lay.hist_offs[widx], hlen[widx]
        a.a_bit[r], a.a_p2[r] = 1 << r, float(p2)
    a.n_f = len(plan.f_rates)
    for r, (d, gap, p2, widx) in enumerate(plan.f_rates):
        a.f_gap[r], a.f_ch[r] = gap, widx
        a.f_hoff[r], a.f_hlen[r] = lay.hist_offs[widx], hlen[widx]
        a.f_bit[r], a.f_p2[r] = 32 << r, float(p2)
    a.n_b = len(plan.b_delays)
    for r, d in enumerate(plan.b_delays):
        a.b_d[r], a.b_bit[r] = d, 8 << r
    a.b_hoff, a.b_hlen = lay.hist_offs[nbv], hlen[nbv]
    dv, gapv, p2v, widxv = plan.v_rate
    a.v_d, a.v_gap, a.v_ch = dv, gapv, widxv
    a.v_hoff, a.v_hlen = lay.hist_offs[widxv], hlen[widxv]
    a.v_bit, a.v_p2 = 128, float(p2v)
    a.rows_main = T if (out_mask is not None or out_md is not None) else 0
    a.hist_rows = sum(hlen)
    stream = torch.cuda.current_stream(deps.device).cuda_stream
    check(lib, lib.nfclab_ff_mask(ctypes.byref(a), deps.device.index,
                                   MASK_THREADS, stream), "ff_mask")
