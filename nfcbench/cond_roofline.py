"""The least time the conditioning function's work needs on the card, at
the peaks of ``roofline.py`` (the H100 SXM at 700 W).

The work is that of the conditioning scan FUNCTION
(``dsp/conditioner_kernel.condition_scan``: the chain of NfcTech.cpp:39-68
that ``condition_jax`` runs over a capture), the same whatever implements
it:

- bytes: each sample read once (4 B, float32) and its six outputs written
  once, as ``CondScanArgs`` (``csrc/conditioner.cu``) lays them: env, w1,
  mdev, avg and filt as float32 and the pulse count as int32, 24 B: 28 B
  a sample, which is the 0.561 ms bound of 1024 x 65,536 samples in
  PERF.md's kernel table;
- operations per sample, counted on ``_scan_plain_tm`` (each add,
  multiply, divide, compare, select and logical operation one): the
  pulse count 1, the envelope's test 6 (|v - env| / env against 0.05, the
  count against the silence timeout, their or), its update 3, the
  seeding window 2 and two selects 2, the pulse reset 1, the DC filter 3,
  the deviation 4 and the average 3: 25.

Bytes bound it (28 / 3.35e12 against 25 / 67e12 s a sample).  What the
work does not need (the halo of every block, the blocks scanned again,
each block's initial state) is left out, so it lowers the share.
"""

from __future__ import annotations

from .roofline import PEAK_BYTES_S, PEAK_FLOPS_F32

BYTES_PER_SAMPLE = 4 + 6 * 4
FLOPS_PER_SAMPLE = 25


def cond_least_s(samples: int) -> float:
    """Least seconds the card needs to condition `samples` samples: the
    larger of the bytes over the bandwidth and the operations over the
    float32 peak."""
    return max(BYTES_PER_SAMPLE * samples / PEAK_BYTES_S,
               FLOPS_PER_SAMPLE * samples / PEAK_FLOPS_F32)
