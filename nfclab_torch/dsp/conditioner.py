"""The device conditioner: block-parallel conditioning, bit-exact via halo
and repair.

Counterpart of ``nfclab/dsp/conditioner.py``.  The reference conditioning
chain (NfcTech.cpp:28-105) is a per-sample scan: a conditional envelope
with a silence-timeout reset, a 1-pole IIR DC filter, and the deviation
and average EMAs.  The IIR and both EMAs forget their initial state within
a few thousand samples, so an overlap-save halo makes interior blocks
exact; the envelope does not always converge (in carrier-off stretches it
updates only on the 10-ETU timeout).  So:

1. pass 1: every block, warmed up over a halo from a canonical guessed
   state, is one stream of one ``condition_scan`` (the CUDA kernel
   ``cond_scan_kernel``; its plain version for a CPU run);
2. verify: a block is exact iff its own state at the sample before its
   first kept one equals the finished state of its predecessor there (the
   state at t determines the future);
3. repair: a block that did not converge is scanned again, as one stream
   from the finished carry.

Block 0 starts from the true initial state, so exactness propagates, and
the result is bit-identical to the sequential C++ oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native.binding import Conditioned
from .conditioner_kernel import condition_scan_tm
from .cuda_channels import resolve_device
from .frontend import _params_tuple

_FINAL = ("env", "mdev", "avg", "filt")  # the outputs Conditioned keeps
_STATE = ("env", "w1", "mdev", "avg", "pulse")  # a block's carried state
_NAMES = ("env", "w1", "mdev", "avg", "filt", "pulse")


def condition_jax(value: np.ndarray, params, block: int = 65536,
                  halo: int = 16384, device="cuda",
                  stats: dict | None = None) -> Conditioned:
    """The device conditioner: bit-exact block-parallel conditioning on
    ``device`` (cuda unless the caller asks for the CPU, where the
    kernel's plain version runs); returns the same ``Conditioned`` arrays
    as the native sequential oracle.

    The name is nfclab's, where this function ran under JAX: the decoder
    (``NfcDecoder(conditioner="jax")``) and ``decode_batch`` select it by
    that name.  nfclab bucketed the block count to a power of two only to
    reuse jitted programs; here the block count is what the capture needs.

    ``stats``, when given, receives ``blocks`` (the streams of pass 1) and
    ``repairs`` (the blocks scanned again)."""
    if block < 1 or halo < 1:
        raise ValueError("block and halo must be at least 1")
    dev = resolve_device(device)
    n = len(value)
    value = np.ascontiguousarray(value, dtype=np.float32)
    pt = _params_tuple(params)

    nb = max(1, -(-n // block))
    padded = nb * block
    starts = np.arange(nb) * block
    scan_starts = np.maximum(starts - halo, 0)
    span = block + halo
    pad_val = torch.from_numpy(
        np.pad(value, (0, padded + halo - n), mode="edge")).to(dev)
    # pass 1 works time-major: block b is stream b of a [span, nb] batch
    first = torch.from_numpy(scan_starts).to(dev)
    blocks = pad_val[torch.arange(span, device=dev)[:, None] + first[None, :]]

    # canonical warm-up init; block 0 gets the true initial state
    first_v = blocks[0]
    env0 = first_v.clone()
    w10 = first_v * 10.0  # steady state of w = v + 0.9 w
    mdev0 = torch.zeros(nb, dtype=torch.float32, device=dev)
    avg0 = first_v.clone()
    pulse0 = torch.zeros(nb, dtype=torch.int32, device=dev)
    clock0 = first.to(torch.int32)
    env0[0] = 0.0
    w10[0] = 0.0
    avg0[0] = 0.0
    outs = dict(zip(_NAMES, condition_scan_tm(
        blocks, env0, w10, mdev0, avg0, pulse0, clock0, pt)))
    del blocks

    # block b keeps rows drop_b .. drop_b + block of its scan
    drop = torch.from_numpy(starts - scan_starts).to(dev)
    rows = drop[None, :] + torch.arange(block, device=dev)[:, None]
    final = {k: outs[k].gather(0, rows).t().reshape(-1) for k in _FINAL}
    # each block's finished state after its last kept sample, and its own
    # state at the sample before its first kept one (block 0 has none)
    end = {k: outs[k].gather(0, rows[-1:])[0].cpu().numpy()
           for k in _STATE}
    before = (drop - 1).clamp(min=0)[None, :]
    bnd = {k: outs[k].gather(0, before)[0].cpu().numpy() for k in _STATE}
    del outs, rows

    repairs = 0
    for b in range(1, nb):
        # bit equality: equal bits give equal futures
        if all(bnd[k][b : b + 1].view(np.int32)
               == end[k][b - 1 : b].view(np.int32) for k in _STATE):
            continue
        s = int(starts[b])
        init = [torch.from_numpy(end[k][b - 1 : b].copy()).to(dev)
                for k in _STATE[:4]]
        init += [torch.from_numpy(end["pulse"][b - 1 : b].copy()).to(dev),
                 torch.tensor([s], dtype=torch.int32, device=dev)]
        rep = dict(zip(_NAMES, condition_scan_tm(
            pad_val[s : s + block, None], *init, pt)))
        for k in _FINAL:
            final[k][s : s + block] = rep[k][:, 0]
        for k in _STATE:
            end[k][b] = rep[k][-1, 0].item()
        repairs += 1
    if stats is not None:
        stats.update(blocks=nb, repairs=repairs)

    env, filt, mdev, avg = (final[k][:n].cpu().numpy()
                            for k in ("env", "filt", "mdev", "avg"))

    # modulation depth on host with strict IEEE ops (NfcTech.cpp:74): this
    # field feeds threshold comparisons in the detectors
    with np.errstate(invalid="ignore", divide="ignore"):
        clamped = np.maximum(np.float32(0.0), np.minimum(value, env))
        mdepth = (env - clamped) / env

    epeak, etime = _edge_tracker(filt, params)
    return Conditioned(value, env, filt, mdev, avg, mdepth, epeak, etime)


def _edge_tracker(filt: np.ndarray, params):
    """Carrier edge peak tracker (NfcTech.cpp:77-92), reconstructed from the
    filtered array: running max of |filtered| above the high threshold, reset
    at low-threshold samples.  Walks only the sparse event samples."""
    rect = np.abs(filt)
    high = rect > np.float32(params.signal_high_threshold)
    low = rect < np.float32(params.signal_low_threshold)
    n = len(filt)

    peak = np.zeros(n, np.float32)
    time = np.zeros(n, np.uint32)
    events = np.flatnonzero(high | low)
    cur_peak = 0.0
    cur_time = 0
    prev_e = 0
    for e in events:
        peak[prev_e:e] = cur_peak
        time[prev_e:e] = cur_time
        if high[e]:
            if rect[e] > cur_peak:
                cur_peak = float(rect[e])
                cur_time = int(e)
        else:
            cur_peak = 0.0
        peak[e] = cur_peak
        time[e] = cur_time
        prev_e = e + 1
    peak[prev_e:] = cur_peak
    time[prev_e:] = cur_time
    return peak, time
