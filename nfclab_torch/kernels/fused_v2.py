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

from .fused import SMEM_LIMIT, check, library

# v2_scan_kernel: 32 streams per block, six warps (envelope, filter + q
# boxes, product boxes, raw-value boxes, mod_depth, the producer that
# stages samples)
SCAN_THREADS = 192
SCAN_STAGES = 4        # staged sample tiles in flight
SCAN_TILE_ROWS = 96    # samples per tile: whole ring groups (6) and
                       # envelope groups (16)
# the scan's shared rings: the state rings (value 96, filtered 96, squared
# 192, products 8/16/32) each in the power of two at least its size
SCAN_RING_ROWS = 128 + 128 + 256 + 8 + 16 + 32
SCAN_MAX_STREAMS = 1 << 25   # 32-bit offsets within a tile
# v2_mask_kernel: 32 streams and a span of rows per block, sixteen
# consumer warps and four producer warps that stage each channel into a
# shared ring
MASK_WARPS = 16
MASK_PRODUCERS = 4
MASK_THREADS = (MASK_WARPS + MASK_PRODUCERS) * 32
MASK_TILE_ROWS = 64      # rows of a sub-tile
MASK_STAGES = 2          # sub-tiles in flight
MASK_SPAN_ROWS = 2048    # rows of a block's span
# the staged channels: (name, least lag, largest lag, shared ring, state
# ring), the state ring 0 where the channel is never read before the chunk
MASK_CHANNELS = (
    ("envelope", 0, 0, 128, 0),
    ("bv47", 0, 47, 256, 64),
    ("bv24", 0, 117, 256, 128),
    ("bv12", 0, 153, 512, 160),
    ("filtered", 0, 94, 256, 96),
    ("bv94", 378, 473, 256, 474),
)

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


def scan_smem(stages: int | None = None) -> int:
    """Shared memory of one v2_scan_kernel block (SCAN_STAGES stages unless
    given): three mbarriers per stage (full, empty, env tile written)
    padded to 16 B, the staged sample and env tiles and the rings, 32
    columns each."""
    stages = SCAN_STAGES if stages is None else stages
    bars = (3 * stages * 8 + 15) // 16 * 16
    return bars + 128 * (2 * stages * SCAN_TILE_ROWS + SCAN_RING_ROWS)


def launch_scan(value_tm, state_in, state_out, out, base, pt, nstate):
    """Queue v2_scan_kernel: value_tm [T, B]; state_in, state_out
    [nstate, B]; out [15, T, B] (its detect_mask row and the state rows of
    the mask are left to launch_mask)."""
    B = value_tm.shape[1]
    if B > SCAN_MAX_STREAMS:
        raise ValueError(f"v2_scan_kernel takes at most {SCAN_MAX_STREAMS} "
                         f"streams a call, got {B}")
    smem = scan_smem()
    if smem > SMEM_LIMIT:
        raise ValueError(f"{SCAN_STAGES} staged tiles and {SCAN_RING_ROWS} "
                         f"ring rows need {smem} B of shared memory per "
                         f"block (limit {SMEM_LIMIT})")
    lib, a = _args(out, state_in, state_out, base, nstate)
    if lib.nfclab_v2_scan_smem() != smem:
        raise RuntimeError(
            f"csrc/fused_v2.cu needs {lib.nfclab_v2_scan_smem()} B of "
            f"shared memory per scan block, kernels/fused_v2.py {smem}")
    a.value = value_tm.data_ptr()
    etu = int(pt[7])
    a.etu, a.silence = etu, float(etu * 10.0)
    (a.enve_w0, a.enve_w1, a.mdev_w0, a.mdev_w1, a.mean_w0, a.mean_w1,
     a.iir_a) = (float(p) for p in pt[:7])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    check(lib, lib.nfclab_v2_scan(ctypes.byref(a), out.device.index,
                                  SCAN_THREADS, smem, stream),
          "fused_v2_scan")


def mask_geometry() -> list:
    """v2_mask_kernel's geometry as the library reports it
    (nfclab_v2_mask_geometry): consumer and producer warps, sub-tile rows,
    stages, span rows, then per staged channel its least and largest lag,
    shared ring and state ring."""
    return [MASK_WARPS, MASK_PRODUCERS, MASK_TILE_ROWS, MASK_STAGES,
            MASK_SPAN_ROWS,
            *(x for ch in MASK_CHANNELS for x in ch[1:])]


def mask_smem() -> int:
    """Shared memory of one v2_mask_kernel block: two mbarriers per stage
    padded to 16 B, then the rings, 32 columns each."""
    bars = (2 * MASK_STAGES * 8 + 15) // 16 * 16
    return bars + 128 * sum(ch[3] for ch in MASK_CHANNELS)


def library_mask_geometry() -> tuple:
    """(geometry, shared memory) of the library's v2_mask_kernel."""
    lib = library()
    g = (ctypes.c_int32 * 64)()
    n = lib.nfclab_v2_mask_geometry(g, 64)
    return list(g[:n]), lib.nfclab_v2_mask_smem()


def launch_mask(out, state_in, state_out, base, mp, nstate):
    """Queue v2_mask_kernel (mp: float32 mask params): writes the
    detect_mask row of out and the rb / rbv rings and carry rows 5-9 of
    state_out."""
    lib, a = _args(out, state_in, state_out, base, nstate)
    (a.power_thr, a.a_thr, a.b_min_deep, a.f_thr, a.v_thr) = mp
    stream = torch.cuda.current_stream(out.device).cuda_stream
    check(lib, lib.nfclab_v2_mask(ctypes.byref(a), out.device.index,
                                  MASK_THREADS, stream), "fused_v2_mask")
