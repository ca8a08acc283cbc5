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
# ff_scan_kernel: 32 streams per block, five warps (envelope, filter + q
# boxes, product boxes, raw-value boxes, the producer that stages samples)
SCAN_THREADS = 160
SCAN_STAGES = 4       # staged sample tiles in flight
SCAN_TILE_ROWS = 120  # samples per tile: a multiple of every group size
SCAN_GROUPS = (6, 2, 1)              # instantiated ring-read group sizes
SCAN_COUNTS = ((4, 2, 3), (3, 2, 3))  # instantiated (bv, q, product) counts
SCAN_MAX_STREAMS = 1 << 25           # 32-bit offsets within a tile
# ff_scan_kernel_narrow: 8 streams per block, a lane per (stream, box) in
# the box warps; six warps (envelope, filter, product boxes, q boxes,
# raw-value boxes, the producer)
SCAN_NARROW_THREADS = 192
SCAN_NARROW_STREAMS = 8
SCAN_NARROW_BOXES = 32 // SCAN_NARROW_STREAMS   # box slots of a stream
# ff_mask_kernel: a span of rows and 32 streams per block (16 where the
# plan's rings need it), sixteen consumer warps and four producer warps
# that stage each lag window of a channel into a shared ring
MASK_WARPS = 16
MASK_PRODUCERS = 4
MASK_THREADS = (MASK_WARPS + MASK_PRODUCERS) * 32
MASK_TILE_ROWS = 64      # rows of a sub-tile
MASK_STAGES = 2          # sub-tiles in flight
MASK_SPAN_ROWS = 2048    # rows of a block's span
MASK_STREAMS = (32, 16)  # streams per block, the first whose rings fit
MASK_MAX_WINDOWS = 16
MASK_PAD = 3             # rows after each ring that mirror its first
MASK_COUNTS = (3, 2, 2)  # the A, F and B tests of every plan
MASK_MAX_STREAMS = 1 << 25
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
        ("group", _i32),
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
    lib.nfclab_ff_scan_narrow.argtypes = lib.nfclab_ff_scan.argtypes
    lib.nfclab_ff_scan_narrow.restype = ctypes.c_int
    lib.nfclab_ff_mask.argtypes = [
        ctypes.POINTER(FFMaskArgs), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nfclab_ff_mask.restype = ctypes.c_int
    lib.nfclab_ff_mask_geometry.argtypes = [
        ctypes.POINTER(FFMaskArgs), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.nfclab_ff_mask_geometry.restype = ctypes.c_int
    lib.nfclab_cond_scan.argtypes = [
        ctypes.POINTER(CondScanArgs), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nfclab_cond_scan.restype = ctypes.c_int
    lib.nfclab_v2_scan.argtypes = [
        ctypes.POINTER(V2Args), ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.nfclab_v2_scan.restype = ctypes.c_int
    lib.nfclab_v2_mask.argtypes = [
        ctypes.POINTER(V2Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nfclab_v2_mask.restype = ctypes.c_int
    lib.nfclab_v2_scan_smem.argtypes = []
    lib.nfclab_v2_scan_smem.restype = ctypes.c_int64
    lib.nfclab_v2_nstate.argtypes = []
    lib.nfclab_v2_nstate.restype = ctypes.c_int
    lib.nfclab_v2_mask_geometry.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.nfclab_v2_mask_geometry.restype = ctypes.c_int
    lib.nfclab_v2_mask_smem.argtypes = []
    lib.nfclab_v2_mask_smem.restype = ctypes.c_int64
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


def scan_group(plan) -> int:
    """Steps per ring-read group of ff_scan_kernel for a plan: the largest
    instantiated size no longer than the least box width and lag (a ring
    slot is then never read in the group that rewrites it)."""
    least = min(*plan.bv_widths, *plan.q_widths,
                *(min(lag, box) for lag, box in plan.pb))
    return max(g for g in SCAN_GROUPS if g <= max(least, 1))


def scan_smem(ring_rows: int) -> int:
    """Shared memory of one ff_scan_kernel block: a full and an empty
    mbarrier per stage, the staged tiles and the rings, 32 columns each."""
    return 16 * SCAN_STAGES + 128 * (SCAN_STAGES * SCAN_TILE_ROWS + ring_rows)


def scan_narrow_smem(plan) -> int:
    """Shared memory of one ff_scan_kernel_narrow block: the barriers, the
    [tile rows, 8] stages, and the rv, rq and rf rings and the largest
    product ring, 32 columns each (a box lane keeps its own copy)."""
    rows = plan.rv_ring + plan.rq_ring + plan.rf_ring + max(plan.rp_rings)
    return (16 * SCAN_STAGES
            + 4 * SCAN_STAGES * SCAN_TILE_ROWS * SCAN_NARROW_STREAMS
            + 128 * rows)


def scan_narrow(B: int, plan, sms: int) -> bool:
    """Whether a scan of B streams runs on ff_scan_kernel_narrow: where
    each role's box count fits a stream's box lanes, its rings fit a block,
    and its blocks (8 streams each) fill no more than the card's `sms`
    SMs, one block each: there it measured faster than ff_scan_kernel."""
    fits = (max(len(plan.bv_widths), len(plan.q_widths), len(plan.pb))
            <= SCAN_NARROW_BOXES and scan_narrow_smem(plan) <= SMEM_LIMIT)
    return fits and -(-B // SCAN_NARROW_STREAMS) <= sms


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_scan(value_tm, state_in, state_out, deps, extra: dict, base: int,
                pt, plan, lay) -> bool:
    """Queue the scan on the current stream: ff_scan_kernel_narrow where
    ``scan_narrow`` says so for the card, else ff_scan_kernel.  Returns
    whether the narrow kernel was queued."""
    _limits(plan)
    counts = (len(plan.bv_widths), len(plan.q_widths), len(plan.pb))
    if counts not in SCAN_COUNTS:
        raise ValueError(f"ff_scan_kernel is instantiated for (bv, q, product) "
                         f"box counts {SCAN_COUNTS}, not {counts}")
    T, B = value_tm.shape
    if B > SCAN_MAX_STREAMS:
        raise ValueError(f"ff_scan_kernel takes at most {SCAN_MAX_STREAMS} "
                         f"streams a call, got {B}")
    lib = library()
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
    a.group = scan_group(plan)
    stream = torch.cuda.current_stream(value_tm.device).cuda_stream
    index = value_tm.device.index
    if scan_narrow(B, plan, sm_count(index)):
        check(lib, lib.nfclab_ff_scan_narrow(
            ctypes.byref(a), index, SCAN_NARROW_THREADS,
            scan_narrow_smem(plan), stream), "ff_scan_narrow")
        return True
    smem = scan_smem(lay.ring_rows)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"rings of {lay.ring_rows} rows and {SCAN_STAGES} staged tiles "
            f"need {smem} B of shared memory per block (limit {SMEM_LIMIT})"
        )
    check(lib, lib.nfclab_ff_scan(ctypes.byref(a), index, SCAN_THREADS,
                                   smem, stream), "ff_scan")
    return False


def mask_ring_rows(spread: int) -> int:
    """Ring rows of a lag window of the given spread (lmax - lmin): the
    power of two that holds it and the sub-tiles in flight."""
    p = 1
    while p < spread + MASK_STAGES * MASK_TILE_ROWS:
        p *= 2
    return p


def mask_smem(ring_rows: int, streams: int) -> int:
    """Shared memory of one ff_mask_kernel block: a full and an empty
    mbarrier per stage padded to 16 B, then the rings, `streams` columns
    each."""
    return (2 * MASK_STAGES * 8 + 15) // 16 * 16 + 4 * streams * ring_rows


def mask_lags(plan, want_mask: bool = True, want_md: bool = False) -> dict:
    """The distinct lags ff_mask_kernel reads for a plan and a selection,
    sorted, by channel: the raw boxes 0..n_bv-1, filtered n_bv, envelope
    n_bv + 1, the samples n_bv + 2."""
    nbv = len(plan.bv_widths)
    lags = {}

    def add(ch, *ls):
        lags.setdefault(ch, set()).update(ls)

    if want_mask or want_md:
        add(nbv + 1, 0)
    if want_md:
        add(nbv + 2, 0)
    if want_mask:
        for d, gap, _, w in plan.a_rates:
            add(w, d, d + 1, d + gap)
        for _, gap, _, w in plan.f_rates:
            add(w, 0, 1, gap)
        add(nbv, *plan.b_delays)
        d, gap, _, w = plan.v_rate
        add(w, d, d + gap)
    return {ch: sorted(ls) for ch, ls in sorted(lags.items())}


def mask_windows(lags: dict) -> list:
    """Mirror of the launcher's ff_mask_plan: each channel's sorted lags
    split into windows where that takes the fewest ring rows (of equal
    splits the one with fewer windows, then the first cut mask), in channel
    and lag order, each ring followed by MASK_PAD rows that mirror its
    first.  Returns [(channel, lmin, lmax, ring rows, first ring row)]."""
    out, base = [], 0
    for ch, lag in lags.items():
        n = len(lag)
        best = None
        for cuts in range(1 << (n - 1)):
            ends = [i for i in range(n) if i == n - 1 or (cuts >> i) & 1]
            starts = [0] + [e + 1 for e in ends[:-1]]
            cost = sum(mask_ring_rows(lag[e] - lag[s])
                       for s, e in zip(starts, ends))
            if best is None or (cost, len(ends)) < best[:2]:
                best = (cost, len(ends), starts, ends)
        for s, e in zip(best[2], best[3]):
            rows = mask_ring_rows(lag[e] - lag[s])
            out.append((ch, lag[s], lag[e], rows, base))
            base += rows + MASK_PAD
    return out


def mask_geometry(plan, want_mask: bool = True, want_md: bool = False) -> list:
    """ff_mask_kernel's geometry for a plan and a selection, as the library
    reports it (nfclab_ff_mask_geometry): consumer and producer warps,
    sub-tile rows, stages, span rows, streams per block (0 where the rings
    do not fit at 16), shared memory per block, the window count, then per
    window its channel, least and largest lag, ring rows and first ring
    row."""
    counts = (len(plan.a_rates), len(plan.f_rates), len(plan.b_delays))
    if counts != MASK_COUNTS:
        raise ValueError(f"ff_mask_kernel takes (A, F, B) test counts "
                         f"{MASK_COUNTS}, not {counts}")
    wins = mask_windows(mask_lags(plan, want_mask, want_md))
    rows = sum(w[3] + MASK_PAD for w in wins)
    streams = next((w for w in MASK_STREAMS
                    if mask_smem(rows, w) <= SMEM_LIMIT), 0)
    return [MASK_WARPS, MASK_PRODUCERS, MASK_TILE_ROWS, MASK_STAGES,
            MASK_SPAN_ROWS, streams, mask_smem(rows, streams or 16),
            len(wins), *(x for w in wins for x in w)]


def mask_args(deps, value_tm, state_in, state_out, out_mask, out_md, mp,
              plan, lay) -> FFMaskArgs:
    """FFMaskArgs for a plan: its lags, history sections and mask
    parameters (mp, float32), and the tensors' pointers (each may be
    None)."""
    _limits(plan)
    a = FFMaskArgs()
    a.value, a.deps, a.state_in, a.state_out = (
        _ptr(value_tm), _ptr(deps), _ptr(state_in), _ptr(state_out))
    a.out_mask, a.out_mod_depth = _ptr(out_mask), _ptr(out_md)
    if deps is not None:
        _, a.T, a.B = deps.shape
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
    a.rows_main = a.T if (out_mask is not None or out_md is not None) else 0
    a.hist_rows = sum(hlen)
    return a


def _library_geometry(a, want_mask, want_md, plan) -> list:
    g = (ctypes.c_int32 * 256)()
    n = library().nfclab_ff_mask_geometry(ctypes.byref(a), int(want_mask),
                                          int(want_md), g, 256)
    if n < 0:
        raise ValueError(f"kernel plan exceeds ff_mask_kernel's limits: "
                         f"{plan}")
    return list(g[:n])


def library_mask_geometry(plan, lay, want_mask: bool = True,
                          want_md: bool = False) -> list:
    """ff_mask_kernel's geometry for a plan and a selection as the library
    computes it (nfclab_ff_mask_geometry)."""
    a = mask_args(None, None, None, None, None, None, (0.0,) * 5, plan, lay)
    return _library_geometry(a, want_mask, want_md, plan)


def _overlap(x, y) -> bool:
    a0, b0 = x.data_ptr(), y.data_ptr()
    return a0 < b0 + y.nbytes and b0 < a0 + x.nbytes


def launch_mask(deps, value_tm, state_in, state_out, out_mask, out_md, mp,
                plan, lay):
    """Queue ff_mask_kernel on the current stream (mp: float32 mask
    params).  Raises for a plan outside the kernel's limits or whose lag
    windows do not fit a block at 16 streams, and where state_out overlaps
    state_in (the lookbacks read the input state while the history
    advance writes the output)."""
    B = deps.shape[2]
    if B > MASK_MAX_STREAMS:
        raise ValueError(f"ff_mask_kernel takes at most {MASK_MAX_STREAMS} "
                         f"streams a call, got {B}")
    if _overlap(state_in, state_out):
        raise ValueError("fused_mask needs state_out apart from state_in")
    lib = library()
    a = mask_args(deps, value_tm, state_in, state_out, out_mask, out_md, mp,
                  plan, lay)
    g = _library_geometry(a, out_mask is not None, out_md is not None, plan)
    if g[5] == 0:
        raise ValueError(
            f"the mask's lag windows need {g[6]} B of shared memory per "
            f"block at 16 streams (limit {SMEM_LIMIT}): {g[8:]}")
    stream = torch.cuda.current_stream(deps.device).cuda_stream
    check(lib, lib.nfclab_ff_mask(ctypes.byref(a), deps.device.index,
                                   (g[0] + g[1]) * 32, stream), "ff_mask")
