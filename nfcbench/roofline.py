"""Peaks of the card and the least time the fused frontend's work needs.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the tensor cores.
A run states the card's power limit beside any share of them.

The work is that of the fused frontend FUNCTION with the mask-only
select (``dsp/fused_frontend.run_chunk(..., ("detect_mask",))``), the
same whatever implements it, at the configuration's sample rate:

- bytes: each input sample read once (4 B, float32), the packed detect
  mask written once (1 B), and the carried state read and written once
  per stream and dispatch window (``state_floats(rate)`` float32 each
  way);
- operations per sample, from the function's recurrences and tests
  (counted on ``_scan_plain`` / ``_mask_plain``, each add, multiply,
  divide, compare, select and bit operation one):
  envelope tracker 12 (|v - env| / env, the count, two tests, the
  blend, two selects), the filter 3, deviation 4 and average 3 (carried
  state), the four raw-value boxes 8, the two squared boxes 2 + 4, the
  three product boxes 6 + 6, the power gate 1, NFC-A 3 rates x 8 + 1,
  NFC-F 2 x 8 + 1, NFC-B 2 + 2 x 3, NFC-V 6: 105, at any rate (the
  boxes are running sums, so their widths cost nothing per sample).

What the work does not need (halos, speculation, repairs, compaction, a
second pass over a chunk) is left out, so they lower the share.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12

BYTES_PER_SAMPLE = 4 + 1
FLOPS_PER_SAMPLE = 105

# ISO/IEC 14443 / 15693 carrier, and the tile the carried histories are
# padded by
NFC_FC = 13.56e6
TILE = 128


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def state_floats(rate: int) -> int:
    """The floats of state the function carries per stream at `rate`:
    carry 8, the value, filtered and squared rings, one product ring per
    BPSK (lag, box) pair, one history per box width and the filtered one
    (each padded by a tile), and one running sum per box.  The widths are
    the symbol periods of NFC-A at 106/212/424k (fc/128, fc/64, fc/32 a
    symbol) and of NFC-V (fc/256), in samples: 2109 at 10 MS/s."""
    stu = float(rate) / NFC_FC

    def per(n):
        return int(round(stu * n))

    # NFC-A: (period1, period2, period4) and the delay-detect cascade
    a, delay = [], 0
    for r in range(3):
        p1, p2, p4 = per(128 >> r), per(64 >> r), per(32 >> r)
        a.append((delay, p1, p2, p4))
        delay += p1
    v0, v1, v2 = per(512), per(256), per(128)          # NFC-V
    bv = sorted({x[2] for x in a} | {v2})
    q = sorted({a[0][2], v1})
    pb = sorted((p1, p4) for _, p1, _, p4 in a)
    h_bv = []
    for w in bv:
        need = 1
        for d, p1, p2, _ in a:
            if p2 == w:
                need = max(need, d + p1 - p2, d + 1)
        for _, p1, p2, _ in a[1:]:                      # NFC-F
            if p2 == w:
                need = max(need, p1 - p2, 1)
        if v2 == w:
            need = max(need, v0 + v1 - v2)
        h_bv.append(need)
    h_filt = max(a[0][0], a[1][0])                      # NFC-B's delays
    rings = (_pow2_at_least(max(bv) + 1)
             + _pow2_at_least(max(lag for lag, _ in pb) + 1)
             + _pow2_at_least(max(q) + 1)
             + sum(_pow2_at_least(box + 1) for _, box in pb))
    hist = sum(h + TILE for h in (*h_bv, h_filt))
    return 8 + rings + hist + len(bv) + len(q) + len(pb)


def frontend_least_s(samples: int, stream_windows: int, rate: int) -> float:
    """Least seconds the card needs for `samples` samples at `rate`
    decoded over `stream_windows` (stream, window) pairs: the larger of
    the bytes over the bandwidth and the operations over the float32
    peak."""
    nbytes = (BYTES_PER_SAMPLE * samples
              + 2 * 4 * state_floats(rate) * stream_windows)
    return max(nbytes / PEAK_BYTES_S,
               FLOPS_PER_SAMPLE * samples / PEAK_FLOPS_F32)
