"""A stand-in for the farm's device engines on the CPU, for tests that
drive whole runs: the kernels' plain versions take ~0.15 ms a sample
here.  It reports every sample of a window as a trigger of every kind,
the widest superset the mask contract allows; the walk re-checks each
trigger on the host's float64 conditioning, so the frames are the
program's own.  The farm's counters count as they would."""

from __future__ import annotations

import contextlib

import numpy as np


def _all_triggers(n: int, width: int):
    from nfclab_torch.dsp.fused_frontend import MASK_LAYOUT

    bits = 0
    for _, w in MASK_LAYOUT:
        bits |= w
    rel = np.arange(width, dtype=np.int64)
    return [(rel, np.full(width, bits, np.uint8)) for _ in range(n)]


@contextlib.contextmanager
def engines(monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc

    def chained(blocks, state, base0, pt, mp, cap_div=16, chunk=None,
                sample_rate=10_000_000, lap=None, want_carry=False):
        per = _all_triggers(*blocks.shape)
        if want_carry:
            return per, state, {"pen": None, "end": None}
        return per, state

    def segmented(blocks, carry, pt, mp, segments, **kw):
        return (_all_triggers(*blocks.shape), carry,
                {"repaired_streams": 0, "repair_chunks": 0})

    monkeypatch.setattr(cc, "run_chained_masks", chained)
    monkeypatch.setattr(cc, "run_segmented_masks", segmented)
    monkeypatch.setattr(cc, "chain_state0", lambda *a, **k: None)
    yield
