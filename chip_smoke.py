#!/usr/bin/env python3
"""Drive nfclab_torch on one CUDA card, end to end, and check it.

Run from the repository root, on a machine with an NVIDIA GPU, nvcc and
g++:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit); build the CUDA kernels
   from nfclab_torch/csrc with nvcc and print the ptxas register and spill
   lines; build the native host library.
2. Kernels against their plain PyTorch versions, on the card: 1024 streams
   x 2 chunks of 4096 samples with carried state -- the fused frontend
   kernels once with every output and once with detect_mask alone, the
   conditioning kernel from a seeded initial state with non-zero clocks and
   pulse counts; every output and the state must be bit-exact.  The mask
   kernel also at 40 MS/s, on the plain scan's channels (the scan's rings
   do not fit a block above 27 MS/s).
   Conditioning must be bit-exact against the C++ oracle on 8 streams, for
   both kernels.  Then both scans on lanes that put the envelope test on
   its boundary (check_boundary: 2**22 streams each, special values, and
   ragged shapes).  Repeated at 3.2 MS/s.  The experiments/ scans on
   boundary lanes too, the pair probe equal to the serial one there, and
   the v2 mask kernel on crafted outputs whose SD tests sit on their
   boundary (check_mask_boundary).  The fused mask kernel's geometry
   against the binding's for every plan of 0.5-40 MS/s, its refusals, and
   the kernel on crafted channels whose SD tests sit on their boundary, at
   10, 3.2 and 40 MS/s (check_ff_mask_boundary).  The fused kernels at
   the segmented engine's launch shapes (check_segmented_shapes): B = 1
   (a repair), B = 4 (the live path's 1 stream x 4 segments) and B = 48
   (3 streams x 16 segments), lanes after each stream's first from the
   speculative seed state, at base 512.  Then the experiments/
   kernels, bit-exact against their plain versions: the conditioning
   probes at one group x 4096 samples x 2048 lanes (pair equal to serial),
   the copy probe at 1024 x 1024 x 3 outputs, fused_v2 at 1024 x 2 chunks
   of 4096 with carried state.
3. The kernels against their plain versions at the main paths' shape and
   on their inputs: the second [65536, 1024] chunk of the mask path's
   captures, from the state the kernels carried out of the first, at a
   folded clock base (the first [8192, 1024] samples also from fresh
   state at clock 0), and the second 1024 x 65536 chunk with the state
   carried the same way for the conditioning kernel; bit-exact again (the
   mask kernel also with mod_depth), and the conditioning kernel at the
   repair shape (1 x 65536) equal to stream 0 of that run.  Kernel times
   and ns per step on those inputs (CUDA events over 5 launches), the
   repair shape's too, plain times from the comparison;
   the scans' ptxas register and spill lines and shared memory per block,
   the mask kernel's geometry at 10, 3.2 and 40 MS/s.
4. The mask path at full width: chained_batch_masks over 1024 captures of
   2,097,152 samples at 10 MS/s (one production window: 32 chunks of
   65536), the launch counts read around exactly that call and its time
   split by step (its ``stats``: host seconds with no added sync, so the
   kernels count in compact, the step that waits for them).
5. One capture of each synthetic template decoded to frames from the
   device triggers; they must equal the host-frontend frames and the
   bytes the synthesizer wrote.  Then the CLI with --frontend mask.
6. The dense frontend at full width: jitted_frontend(10 MS/s) over 1024
   streams x 65536 samples of the mask path's captures (time per call,
   samples/s, peak memory, conditioning launches per call), held against
   the same call on the CPU on 64 of the streams.
7. The device conditioner on a long capture: condition_jax over 2**23
   samples of the templates with long field-off stretches, bit-exact
   against the C++ oracle with its repair count and the time of its host
   edge tracker (from its stats); then the conditioning
   path -- NfcDecoder(conditioner="jax") over that capture, launch counts
   read around exactly that call -- gives the native frames;
   decode_batch(conditioner="jax") and the CLI with --conditioner jax give
   the native frames of the template WAVs.
8. The experiments/ counterparts at the originals' full widths, each
   through its entry point with launch counts read around that call: the
   copy probe (8192 x 8192, 24 sweeps, 14 outputs; GB/s, which must stay
   under 105% of 3.35 TB/s, beside 24 broadcast torch.mul calls); the
   conditioning probes (65536 samples, 8 chained calls; serial on 2048
   lanes, pair and serial on 16384; ns/step and GS/s; the serial probe
   timed with CUDA events at the pair's shape beside it); bench_v2's v2 and
   prod runs (ms, GS/s, peak memory); the serial probe and the
   conditioning kernel each on the probe's noise and on template lanes
   (2048 x 65536); then each probe kernel against its
   plain version at its shape (pair equal to serial at 16384 lanes) and
   fused_v2's kernels on two 4096 x 16384 chunks with carried state.
9. The live farm, CudaStreamFarm(fetch="mask", k_chunks=32,
   walk_threads=8), fed 262,144 samples at a time through one reused
   buffer, each stream 3 windows of 2,097,152 samples plus a 40,960-sample
   tail: (a) 64 streams in the default configuration (16 segments, 1024
   lanes); (c) the same input with segments=1; (b) 8 streams with a
   200k-400k-sample field-off stretch across a segment boundary of every
   window after the first, with adaptive_segments False (repairs) and
   True (backoff); (c) runs the first 8 of (a)'s streams.  Frames equal
   the host StreamingNfcDecoder's, and on (a) the synthesizer's bytes;
   (c)'s frames equal (a)'s and its
   conditioning rows 0-4 after the last window equal (a)'s segmented
   carry bit for bit.  Wall time, samples/s, the farm's stats, launches
   per window (each run's counts set to 0 just before it) and peak memory.
10. The full-channel device frontend (every output of both fused kernels
   fetched densely): (a) fused_batch_all over 1024 captures x 131,072
   samples (the first two chunks of phase 4's lanes, so carried state
   crosses one chunk boundary): wall time, samples/s, its ``stats`` split
   with the host edge tracker's seconds, peak memory and the launches read
   around exactly that call (2 + 2); the eight Conditioned arrays of 8
   lanes bit for bit against the C++ oracle, and lanes 0-1's nine box
   channels and mask against the card's chained fused_frontend over the
   same two chunks; (b) one capture of each template through
   fused_capture_all, and through fused_capture_channels with native
   conditioning: frames equal the host frontend's and the synthesizer's
   bytes; (c) decode_batch(frontend="fused") with native and with device
   conditioning, decode_cli run --frontend fused and bench_cli --frontend
   fused --conditioner device on the template WAVs give the native
   frames; (d) CudaStreamFarm(fetch="full") on the first 8 of 9a's
   streams and their feeds:
   its final state equals a chained fused_frontend's bit for bit; its
   frames equal the host streaming decoder's frames of phase 9, up to
   sample bounds that move by less than a symbol where the kernels'
   float32 box sums have drifted from the host's float64 ones, and carry the
   synthesizer's bytes; wall time, samples/s, device_s, walk_s, launches
   per feed and peak memory.
11. Live capture (decode_cli live --frontend mask: RadioDecoderTask over a
   one-stream CudaStreamFarm in 4 segments) through the port's mock
   SpyServer (tests/torch_sdr_mocks.py), on one capture of 16,777,216
   samples at 10 MS/s (32 windows of 8 x 65536: lanes of the templates
   back to back, two 200k-400k-sample field-off stretches across
   segment boundaries) served as int16 IQ, I = signal, Q = 0: (a)
   unpaced, the CLI with --frontend mask and with --frontend host in
   subprocesses: equal lines, equal to the host StreamingNfcDecoder over
   iq_to_magnitude of the payload, the synthesizer's bytes in order with
   at most 1% missed, the decoder task "complete" with no error or
   fallback, no sample lost; samples/s from the first raw block to the
   EOF sentinel; (b) the first 2**23 samples paced at 10 MS/s with
   --frontend mask: the publication lag of each frame (median, p99, max)
   and the samples waiting in the decoder's queue at EOF; (c) the capture
   in this process through RadioDecoderTask(frontend="mask") with the
   kernels' counts set to 0 just before it: launches per window, the
   farm's segmented windows, repairs and backoff windows, peak memory,
   and the ms of both kernels over one chunk at B = 1 and B = 4.
12. The ISO7816 logic path (no kernel of its own: logic_event_mask is
   torch operations on the card) on seeded torch_logic_synth lanes at 24
   MS/s with a 4 MHz card clock: (a) logic_event_mask at the logic farm's
   window, [32, 1,048,576, 4] float32, over two windows with the carry
   threaded, bit for bit against device="cpu" on 4 streams and on a
   block of special values; CUDA event ms per call, its bytes bound (17 B
   a sample), peak memory over the input's bytes, the CUDA kernels of one
   call (torch.profiler); (b) one 2**24-sample lane through
   StreamingIsoDecoder with the device and the host frontend, fed 65,536
   at a time: equal frames and index sets, equal to the one-shot
   IsoDecoder's and the synthesizer's bytes; samples/s of each; (c)
   CudaLogicFarm(32, 24 MS/s) over 32 lanes (seeds 5000-5031) of
   2,097,152 samples, fed 262,144 at a time through one reused buffer,
   plain, and the first 16 with the probes permuted under a channel_map
   (CudaLogicFarm(16, ...)): each stream's
   frames equal its lane's one-shot frames and the synthesizer's bytes;
   wall time, samples/s, the IO thread's dispatch seconds and the
   caller's walk seconds (timed from outside the farm), peak memory; (d)
   decode_cli run --json --channel-map on a probe-permuted 8-bit logic WAV
   and decode_cli live logictcp://... in a subprocess against the port's
   MockLogicTcpServer on (b)'s lane: the one-shot decoder's frames, no
   sample lost, samples/s against real time.
13. The live monitor and the reports: (a) SpectrumProcessor (torch.fft,
   cuFFT; no kernel of its own) on the card against device="cpu" on
   seeded IQ at [1024, 2] (FourierTask's block), [4096, 1024, 2] and
   [256, 2048, 2] at 20 MS/s (decimation 2), every window: each row
   within 1e-5 of its maximum, argmax equal; a 1.2 MHz tone peaks at bin
   635 +- 1; CUDA event ms of the batched calls' device work beside their
   bound, wall us a 65,536-pair block (upload, FFT, fetch), peak memory;
   (b) decode_cli live --frontend mask --monitor 0 --json in a subprocess
   on phase 11b's paced samples, the kernels' counts set to 0 just before
   and read just after: this process reads the URL from its stderr and
   polls /data while the capture runs; the page is served, the last
   snapshot holds the last printed frames with the parser's detail trees,
   the spectrum, waterfall, wave and the radio.receiver, radio.decoder,
   fourier and adaptive statuses; the lines equal 11b's; x real time,
   frame lag and the queue at EOF beside 11b's, the signal.fft buffers
   and the seconds in what the monitor adds; (c) decode_cli run --html
   --frontend mask on the template WAVs writes --frontend host's page
   byte for byte, and trace_cli --html on a TRZ of their frames lists the
   same events and data.
14. Sharding (nfclab_torch/shard), in subprocesses: (a) world size 1 on
   NCCL (shard/launch.initialize over a file store) on phase 7's long
   capture: sharded_kernel_channels (both fused kernels, launch counts set
   to 0 just before and read just after) bit for bit against
   fused_capture_channels; the first rows' conditioning (row 0 from clock
   = pulse = -H over its zero halo) against the plain version and row 0's
   body against a fresh stream of the C++ oracle, bit for bit;
   sharded_capture_channels (condition_scan counted) bit for bit against
   a CPU run on the first 2**21 samples; decode_sharded on those samples
   equal to nfclab's frames (SHARD_NFCLAB_FRAMES, pinned against nfclab by
   tests/test_torch_shard.py) and to the walk over the CPU run's channels;
   decode_sharded on the whole capture (counted) against the walk over its
   channels, against phase 7's host frames (the float32 boxes move bounds
   on these noise-free templates: counts) and the walk over its mask
   alone equal to phase 7's host frames; decode_sharded on a noisy lane of
   each template equal to the host's frames but for bounds moved by at
   most 2 samples; (b) two gloo ranks sharing the card
   (tests/torch_dist_child.py): both paths' channels (sha256 digests) and
   the frames equal (a)'s on both ranks; (d) validate_cuda_shard_kernel's
   entry point on the template WAVs, in (a)'s process once its group is
   destroyed; (c) scaling_bench --devices 1 --cuda: step ms,
   samples/s, collective_share, and the fused pair's samples/s a card.
   Each runs alone on the card.
15. The validation and benchmark tools (nfclab_torch/tools), each with
   the kernels' counts set to 0 just before and read just after, on
   seeded inputs in a temporary directory: the template WAVs, four
   torch_synth lanes of 1,048,576 samples at 10 MS/s, each NFC WAV with
   the golden JSON of the host frontend's frames beside it, and three
   8-bit 4-channel logic WAVs at 24 MS/s (sessions of two of nfclab's
   TPDUs and a logic_lane of 2**22 samples).  Each validator's main must
   return 0: (a) validate_fused at nfclab's 2048 x 4096; (b)
   validate_cuda_decode on the template WAVs; (c)
   validate_rate_parametric on the NFC-A 106k template; (d)
   validate_cuda_farm on the lanes (full and mask fetch, k_chunks 4 in 2
   segments, forced repairs, the production 16 segments x 32 chunks on
   a tiled lane); (e) validate_cuda_logic on the logic WAVs, in this
   process and again as python -m in a subprocess.  (f) hw_smoke
   enumerates, then records logicloop://test for 0.3 s to a 4-channel
   WAV.  (g) e2e_bench --reps 1 on the template WAVs in a child process
   (tools_child: its host curve forks before CUDA is initialized):
   link figures, each frontend's
   samples/s and equal frame counts, the curve.  (h) streaming_bench
   --total 2000000 --farm-total 262144 on the NFC-A 106k template: the
   single-stream bench and all six farm configurations of its main.
Depth cut to keep the script inside its time: 9c and 10d ran the first
16 of 9a's 64 streams, phase 7's long capture was cut from 2**25 samples
to 2**24, and 12c's channel-map run takes the first 16 of its 32 lanes
(for phase 13).  For phase 15: phase 9's streams are 3 windows long (4
before), which shortens 9a, 9b, 9c, their host references and 10d; 9c
and 10d run the first 8 of 9a's streams and 9b 8 streams (16 before);
phase 3 compares the plain versions on the timed second chunk only (both
chunks before), since the plain versions' per-step launches set its
time; phase 7's long capture is 2**23 samples (its first 2**21, phase
14's prefix, are unchanged), and 12c's lanes 2 windows long (4 before).
Every check stays.
At the end neither JAX nor nfclab may have been imported.  The line
before the last is the card's name and power limit; the one before it a
JSON object with one entry per kernel (each fused and conditioning
kernel with its launches in every phase-15 tool), the one before that
the farm's launch counts, the one before that the full-channel path's
launch counts, the one before that the live path's readings, the one
before that the logic path's, the one before that the monitor phase's,
the one before that the shard phase's and the one before that the
tools phase's ({"tools": ...}: each tool's seconds, return code and
launches, the link figures, the streaming and farm rates and the chip
host's os.cpu_count).  The last line is {"ok": true, "device": {...}}.
--kernels-only stops after phase 2, for a first call after a kernel
change.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RATE = 10_000_000
STREAMS = 1024            # the JAX engine's lane ceiling
WINDOW = 32 * 65536       # one production window: k_chunks x CHAIN_CHUNK
CHECK_CHUNK = 4096        # chunk of the small bit-exact checks
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores
TPU_KERNEL = "nfclab/dsp/pallas/fused_frontend.py:259"
SOURCE = "nfclab_torch/csrc/fused_frontend.cu"
COND_TPU_KERNEL = "nfclab/dsp/pallas/conditioner_kernel.py:31"
COND_SOURCE = "nfclab_torch/csrc/conditioner.cu"
COND_OPS = 22             # float and counter operations per sample
LONG = 1 << 23            # the long capture of phase 7 (0.84 s, 128 blocks;
                          # 2**24 before phase 15)
FRESH_CMP = 8192          # phase 3: samples of the fresh-state comparison
DENSE_CPU_STREAMS = 64    # streams of phase 6's CPU comparison
V2_SOURCE = "nfclab_torch/csrc/fused_v2.cu"
PROBE_SOURCE = "nfclab_torch/csrc/probes.cu"
V2_TPU_KERNEL = "experiments/fused_v2.py:108"
SERIAL_TPU_KERNEL = "experiments/probe_serial_floor.py:39"
PAIR_TPU_KERNEL = "experiments/probe_pair_spec.py:44"
COPY_TPU_KERNEL = "experiments/membw_probe.py:30"
PROBE_OPS = 25            # float operations per sample of the probes
V2_SCAN_OPS = 50          # per sample: conditioning, mod_depth, 9 boxes
V2_MASK_OPS = 47          # per sample: 5 SD cascades, 2 edges, V, gate
V2_STREAMS, V2_CHUNK = 4096, 16384   # bench_v2's first v2 configuration
BOUNDARY_STREAMS = 1 << 22  # streams of the boundary phase
BOUNDARY_SLICE = 1 << 18    # fused_scan streams a call there (its state is
                            # nstate rows a stream: 2109 at 10 MS/s)
BOUNDARY_V2 = 1 << 18       # v2_scan streams there (1285 state rows each)
BOUNDARY_PROBE = (1 << 20) + 7  # serial_probe lanes there
FARM_STREAMS = 64         # phase 9a: x 16 segments = the 1024-lane policy
FARM_CUT = 8              # 9c and 10d: the first 8 of 9a's streams (16
                          # before phase 15)
FARM_WINDOWS = 3          # full windows a stream, then the tail (4 before
                          # phase 15)
FARM_TAIL = 40_960        # the sub-chunk tail that finish() walks on the host
FARM_FEED = 262_144       # samples a feed
PAUSE_STREAMS = 8         # phase 9b (16 before phase 15)
PAUSE_LEAD = (70_000, 130_000)   # 9b: a pause starts this far before its
PAUSE_LEN = (200_000, 400_000)   # segment boundary and lasts this long


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _same(a, b) -> bool:
    """Bit-level equality, NaN equal to NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _err(a, b) -> float:
    """Largest |a - b| over entries that are not equal (an infinity equals
    itself) and not both NaN; in float64, 2**26 entries at a time."""
    import torch

    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0.0
    for i in range(0, a.numel(), 1 << 26):
        x, y = a[i : i + (1 << 26)].double(), b[i : i + (1 << 26)].double()
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        d = torch.where(same, torch.zeros_like(x), (x - y).abs())
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return worst


def _hold(errs, name, got, want, what):
    """Record the largest error of `name` and raise unless got equals
    want bit for bit."""
    e = _err(got.float(), want.float())
    errs[name] = max(errs[name], e)
    if not _same(got, want):
        raise AssertionError(f"{name} != plain, {what}: max err {e}")


def _params(rate):
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.dsp.cuda_channels import chained_mask_params
    from nfclab_torch.dsp.frontend import _params_tuple

    pt = _params_tuple(SignalParams(rate))
    mp_all = DecoderThresholds().detect_mask_tuple(0.01)
    return pt, mp_all, chained_mask_params(0.01)


def check_kernels(dev, rate, chunk, n_chunks, errs):
    """Each kernel against its plain version on the same inputs, chunk by
    chunk with carried state, for both selections; then the whole
    fused_frontend against fused_frontend_plain.  Above 27 MS/s, where the
    scan's rings do not fit a block (launch_scan refuses the plan), the
    mask kernel alone, on the plain scan's channels.  Returns the
    all-output run's [B, T] outputs (for the oracle check; None without
    the scan) and the input."""
    import torch

    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.kernels import fused as kf
    from torch_synth import mixed_lanes

    pt, mp, _ = _params(rate)
    plan = ff.kernel_plan(rate)
    scan = kf.scan_smem(ff._layout(plan).ring_rows) <= kf.SMEM_LIMIT
    x = torch.from_numpy(mixed_lanes(STREAMS, n_chunks * chunk, seed=5)).to(dev)
    extra_names = set(ff._extra_names(plan))
    outs_all = None
    for select in (None, ("detect_mask",)):
        sel = ff._normalize_select(select, plan)
        keep = tuple(n for n in sel if n in extra_names)
        st_k = torch.zeros(plan.nstate, STREAMS, device=dev)
        st_p = st_k.clone()
        for c in range(n_chunks):
            base = c * chunk
            x_tm = x[:, base : base + chunk].t().contiguous()
            deps_p, extra_p, so_p = ff._scan_plain(x_tm, st_p, base, pt,
                                                   plan, keep)
            if scan:
                deps_k, extra_k, so_k = ff.fused_scan(x_tm, st_k, base, pt,
                                                      plan, keep)
                pairs = [(deps_k, deps_p), (so_k, so_p)]
                pairs += [(extra_k[n], extra_p[n]) for n in keep]
            else:
                pairs = []
            for a, b in pairs:
                errs["fused_scan"] = max(errs["fused_scan"], _err(a, b))
                if not _same(a, b):
                    raise AssertionError(
                        f"fused_scan != plain at {rate} Hz, chunk {c}, "
                        f"select={select}: max err {_err(a, b)}")
            # the mask kernel and its plain version on identical inputs
            so_mk = so_p.clone()
            mk_k = ff.fused_mask(deps_p, x_tm, st_p, so_mk, mp, plan,
                                 "detect_mask" in sel, "mod_depth" in sel)
            mk_p = ff._mask_plain(deps_p, x_tm, st_p, so_p, mp, plan,
                                  "detect_mask" in sel, "mod_depth" in sel)
            for a, b in [(so_mk, so_p)] + [(mk_k[n], mk_p[n]) for n in mk_p]:
                errs["fused_mask"] = max(errs["fused_mask"],
                                         _err(a.float(), b.float()))
                if not _same(a, b):
                    raise AssertionError(
                        f"fused_mask != plain at {rate} Hz, chunk {c}, "
                        f"select={select}")
            st_k, st_p = so_mk, so_p
        torch.cuda.synchronize()
        if not scan:
            log(f"fused_mask == plain (bit-exact) at {rate} Hz, {STREAMS} "
                f"streams x {n_chunks} x {chunk}, select={select}, on the "
                f"plain scan's channels (the scan's rings do not fit a "
                f"block at this rate)")
            continue
        # the public entry point through both kernels vs fully plain
        got, st = None, None
        want, stw = None, None
        outs_k, outs_p = [], []
        for c in range(n_chunks):
            base = c * chunk
            xc = x[:, base : base + chunk]
            got, st = ff.fused_frontend(xc, pt, mask_params=mp, state=st,
                                        base=base, return_state=True,
                                        select=select, sample_rate=rate)
            want, stw = ff.fused_frontend_plain(
                xc, pt, mask_params=mp, state=stw, base=base,
                return_state=True, select=select, sample_rate=rate)
            outs_k.append(got)
            outs_p.append(want)
        for n in sel:
            a = torch.cat([o[n] for o in outs_k], 1)
            b = torch.cat([o[n] for o in outs_p], 1)
            if not _same(a, b):
                raise AssertionError(f"fused_frontend {n} != plain at {rate}")
        if not _same(st, stw):
            raise AssertionError(f"fused_frontend state != plain at {rate}")
        if select is None:
            outs_all = {n: torch.cat([o[n] for o in outs_k], 1) for n in sel}
        log(f"kernels == plain (bit-exact) at {rate} Hz, {STREAMS} streams x "
            f"{n_chunks} x {chunk}, select={select}")
    return x, outs_all


def check_segmented_shapes(dev, errs):
    """The fused kernels against their plain versions at the segmented
    engine's launch shapes (cuda_channels.run_segmented_masks): B = 1, a
    repair, from a carried state; B = 4, the live path's one stream x 4
    segments (decode_cli live --frontend mask); and B = 48, 3 streams x
    16 segments.  Lane 0 of each stream from a carried state and the
    others from the speculative seed (zero but rows 0, 1 and 3: env = avg
    = the halo's first sample, w1 = 10x it).  Two chunks with carried
    state, both at base = the fold modulus, as the engine runs them; the
    mask, the deps and the state bit-exact."""
    import torch

    from nfclab_torch.dsp import fused_frontend as ff
    from torch_synth import mixed_lanes

    pt, _, mp = _params(RATE)
    plan = ff.kernel_plan(RATE)
    base = plan.fold_modulus
    c = CHECK_CHUNK
    for b, S in ((1, 1), (4, 4), (48, 16)):
        x = torch.from_numpy(mixed_lanes(b, 3 * c, seed=40 + b)).to(dev)
        _, carried = ff.fused_frontend_plain(
            x[:, :c], pt, mask_params=mp, return_state=True,
            select=("detect_mask",), sample_rate=RATE)
        st = torch.zeros(plan.nstate, b, device=dev)
        heads = x[:, c]
        st[0] = heads
        st[1] = heads * 10.0
        st[3] = heads
        st[:, 0::S] = carried.t()[:, 0::S]
        st_k, st_p = st, st.clone()
        for k in (1, 2):
            x_tm = x[:, k * c : (k + 1) * c].t().contiguous()
            deps_k, _, so_k = ff.fused_scan(x_tm, st_k, base, pt, plan)
            deps_p, _, so_p = ff._scan_plain(x_tm, st_p, base, pt, plan)
            _hold(errs, "fused_scan", deps_k, deps_p,
                  f"deps at B={b}, chunk {k}")
            so_mk = so_p.clone()
            mk_k = ff.fused_mask(deps_p, x_tm, st_p, so_mk, mp, plan)
            mk_p = ff._mask_plain(deps_p, x_tm, st_p, so_p, mp, plan)
            _hold(errs, "fused_mask", mk_k["detect_mask"],
                  mk_p["detect_mask"], f"detect_mask at B={b}, chunk {k}")
            _hold(errs, "fused_mask", so_mk, so_p, f"state at B={b}")
            # both kernels in turn: the state after the pair
            mk_kk = ff.fused_mask(deps_k, x_tm, st_k, so_k, mp, plan)
            _hold(errs, "fused_scan", so_k, so_p, f"state at B={b}")
            _hold(errs, "fused_mask", mk_kk["detect_mask"],
                  mk_p["detect_mask"], f"chained mask at B={b}")
            st_k, st_p = so_k, so_p
        torch.cuda.synchronize()
        what = {1: "a repair", 4: "the live path: 1 stream x 4 segments",
                48: "3 streams x 16 segments"}[b]
        log(f"kernels == plain (bit-exact) at the segmented engine's shape "
            f"B={b} ({what}) x 2 x {c}, base {base}")


def check_oracle(x, outs_all, rate, lanes=8):
    """Conditioning of the all-output kernel run against the C++ oracle."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.native import condition_exact

    params = SignalParams(rate)
    xs = x[:lanes].cpu().numpy()
    names = {"envelope": "envelope", "filtered": "filtered",
             "deviation": "deviation", "average": "average",
             "mod_depth": "mod_depth"}
    for i in range(lanes):
        c = condition_exact(xs[i], params)
        for out, attr in names.items():
            got = outs_all[out][i].cpu().numpy()
            ref = getattr(c, attr)
            same = (got == ref) | ((got != got) & (ref != ref))
            if not same.all():
                raise AssertionError(
                    f"{out} lane {i} != C++ oracle at {int((~same).sum())} "
                    "samples")
    log(f"conditioning == C++ oracle (bit-exact) on {lanes} lanes at {rate} Hz")


COND_NAMES = ("env", "w1", "mdev", "avg", "filt", "pulse")


def _cond_init(x0, rate, seed):
    """A seeded initial conditioning state for streams whose first sample
    is x0 ([B]): envelope near x0, w1 at its steady state, a small
    deviation, pulse counts up to twice the silence timeout and clocks up
    to three ETU (some streams still in the seeding window)."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams

    etu = SignalParams(rate).elementary_time_unit
    rng = np.random.default_rng(seed)
    b, dev = x0.shape[0], x0.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    env0 = x0 * t(rng.uniform(0.9, 1.1, b).astype(np.float32))
    mdev0 = t(rng.uniform(0.0, 1e-3, b).astype(np.float32))
    pulse0 = t(rng.integers(0, 20 * etu, b).astype(np.int32))
    clock0 = t(rng.integers(0, 3 * etu, b).astype(np.int32))
    return env0, x0 * 10.0, mdev0, x0.clone(), pulse0, clock0


def _cond_carry(outs, clock):
    """The state after the last column of condition_scan's [B, T]
    outputs, for a chunk that starts at `clock`."""
    env, w1, mdev, avg, _, pulse = (o[:, -1].contiguous() for o in outs)
    return env, w1, mdev, avg, pulse, clock


def _cond_compare(got, want, errs, what):
    for name, a, b in zip(COND_NAMES, got, want):
        e = _err(a.float(), b.float())
        errs["condition_scan"] = max(errs["condition_scan"], e)
        if not _same(a, b):
            raise AssertionError(
                f"condition_scan {name} != plain, {what}: max err {e}")


def check_condition_kernel(dev, rate, chunk, n_chunks, errs, lanes=8):
    """cond_scan_kernel against condition_scan_plain on the card: STREAMS
    streams x n_chunks chunks from a seeded initial state with non-zero
    clocks and pulse counts, the state carried from chunk to chunk; the
    chained chunks equal one call over the whole span; and, from a fresh
    state at clock 0, the C++ oracle on `lanes` streams."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.native import condition_exact
    from torch_synth import mixed_lanes

    params = SignalParams(rate)
    pt = _params_tuple(params)
    x = torch.from_numpy(mixed_lanes(STREAMS, n_chunks * chunk,
                                     seed=13)).to(dev)
    init = _cond_init(x[:, 0], rate, seed=17)
    st_k = st_p = init
    parts = []
    for c in range(n_chunks):
        xc = x[:, c * chunk : (c + 1) * chunk]
        got = ck.condition_scan(xc, *st_k, pt)
        want = ck.condition_scan_plain(xc, *st_p, pt)
        _cond_compare(got, want, errs, f"{rate} Hz, chunk {c}")
        parts.append(got)
        st_k = _cond_carry(got, init[5] + (c + 1) * chunk)
        st_p = _cond_carry(want, init[5] + (c + 1) * chunk)
    whole = ck.condition_scan(x, *init, pt)
    chained = [torch.cat([p[i] for p in parts], 1) for i in range(6)]
    _cond_compare(whole, chained, errs, f"{rate} Hz, one call vs chained")
    torch.cuda.synchronize()
    log(f"condition_scan == plain (bit-exact) at {rate} Hz, {STREAMS} "
        f"streams x {n_chunks} x {chunk}, carried state, clocks from "
        f"{int(init[5].min())} to {int(init[5].max())}")

    z = torch.zeros(lanes, dtype=torch.float32, device=dev)
    zi = torch.zeros(lanes, dtype=torch.int32, device=dev)
    env, _, mdev, avg, filt, _ = ck.condition_scan(x[:lanes], z, z, z, z,
                                                   zi, zi, pt)
    xs = x[:lanes].cpu().numpy()
    for i in range(lanes):
        c = condition_exact(xs[i], params)
        for name, a, ref in (("envelope", env, c.envelope),
                             ("filtered", filt, c.filtered),
                             ("deviation", mdev, c.deviation),
                             ("average", avg, c.average)):
            got = a[i].cpu().numpy()
            same = (got.view(np.uint32) == ref.view(np.uint32)) | (
                np.isnan(got) & np.isnan(ref))
            if not same.all():
                raise AssertionError(
                    f"condition_scan {name} lane {i} != C++ oracle at "
                    f"{int((~same).sum())} samples ({rate} Hz)")
    log(f"condition_scan == C++ oracle (bit-exact) on {lanes} lanes at "
        f"{rate} Hz")


def _boundary_state(env0, x0, rate, seed):
    """Carry for boundary lanes: env0 as built, w1 at its steady state,
    a small deviation, the average at v, pulse counts up to twice the
    silence timeout and clocks up to three ETU (some lanes seeding)."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams

    etu = SignalParams(rate).elementary_time_unit
    rng = np.random.default_rng(seed)
    b, dev = x0.shape[0], x0.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    return (env0, x0 * 10.0,
            t(rng.uniform(0.0, 1e-3, b).astype(np.float32)), x0.clone(),
            t(rng.integers(0, 20 * etu, b).astype(np.int32)),
            t(rng.integers(0, 3 * etu, b).astype(np.int32)))


def check_boundary(dev, rate, errs):
    """Both redesigned scans on inputs that put their divide-free envelope
    test on its boundary (torch_synth.boundary_lanes: v = env * (1 +- 0.05)
    moved by -4..4 ulps, env from the subnormals to 3.4e38, special values
    on one lane in 32), bit-exact against their plain versions.
    condition_scan: BOUNDARY_STREAMS + 17 streams x 8 steps, then 1 stream
    (the repair shape), 1001 and 33 streams at ragged lengths, then
    BOUNDARY_STREAMS x 32 with env and v in [2^-61, 2^91] and no special
    value (the positive-envelope groups).  fused_scan
    (state rows 0 and 4 crafted, the rest random): BOUNDARY_STREAMS streams
    in slices of BOUNDARY_SLICE x 8 steps at a clock base 3 below
    plan.fold_modulus, every output kept; then B = 1000 x 250 steps from
    clock 0 (T not a multiple of the staged tile, seeding), 1001 x 5 (B not
    a multiple of 4: 4-byte staging; T below the group size), and 64 x 121
    with a misaligned sample pointer, the last with the mask path's
    selection."""
    import torch

    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp import fused_frontend as ff
    from torch_synth import boundary_lanes

    pt, _, _ = _params(rate)
    # the last case keeps env and v in [2^-61, 2^91], so every warp's
    # groups of 16 steps take the positive-envelope test alone
    for i, (b, t, binades, specials) in enumerate((
            (BOUNDARY_STREAMS + 17, 8, (-149, 128), True),
            (1, 37, (-149, 128), True), (1001, 53, (-149, 128), True),
            (33, 3, (-149, 128), True), (BOUNDARY_STREAMS, 32, (-60, 90),
                                          False))):
        env0, x = (torch.from_numpy(a).to(dev)
                   for a in boundary_lanes(b, t, 40 + i, binades, specials))
        init = _boundary_state(env0, x[:, 0], rate, seed=50 + i)
        got = ck.condition_scan(x, *init, pt)
        want = ck.condition_scan_plain(x, *init, pt)
        _cond_compare(got, want, errs, f"boundary, {b} x {t} at {rate} Hz")
        del env0, x, init, got, want
    torch.cuda.synchronize()
    log(f"condition_scan == plain (bit-exact) on boundary lanes at {rate} "
        f"Hz: {BOUNDARY_STREAMS + 17} x 8, 1 x 37, 1001 x 53, 33 x 3, and "
        f"{BOUNDARY_STREAMS} x 32 with positive envelopes")

    plan = ff.kernel_plan(rate)
    mod = plan.fold_modulus
    keep_all = ff._extra_names(plan)
    gen = torch.Generator(device=dev)
    cases = [(BOUNDARY_SLICE, 8, mod - 3, keep_all, False)] * (
        BOUNDARY_STREAMS // BOUNDARY_SLICE)
    cases += [(1000, 250, 0, keep_all, False), (1001, 5, mod - 2, keep_all,
                                                False),
              (64, 121, 7, (), True)]
    for i, (b, t, base, keep, misaligned) in enumerate(cases):
        env0, x = (torch.from_numpy(a).to(dev)
                   for a in boundary_lanes(b, t, seed=60 + i))
        carry = _boundary_state(env0, x[:, 0], rate, seed=70 + i)
        gen.manual_seed(80 + i)
        st = torch.rand(plan.nstate, b, generator=gen, device=dev) * 1e-2
        for row, val in zip(range(5), carry):
            st[row] = val.float()
        value_tm = x.t().contiguous()
        if misaligned:
            buf = torch.empty(t * b + 1, device=dev)
            buf[1:] = value_tm.reshape(-1)
            value_tm = buf[1:].view(t, b)
        deps_k, extra_k, so_k = ff.fused_scan(value_tm, st, base, pt, plan,
                                              keep)
        deps_p, extra_p, so_p = ff._scan_plain(value_tm, st, base, pt, plan,
                                               keep)
        what = f"boundary, {b} x {t}, base {base} at {rate} Hz"
        _hold(errs, "fused_scan", deps_k, deps_p, what)
        _hold(errs, "fused_scan", so_k, so_p, what)
        for n in keep:
            _hold(errs, "fused_scan", extra_k[n], extra_p[n], f"{n}, {what}")
        del env0, x, carry, st, value_tm, deps_k, extra_k, so_k, deps_p
        del extra_p, so_p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"fused_scan == plain (bit-exact) on boundary lanes at {rate} Hz: "
        f"{BOUNDARY_STREAMS} x 8 at base {mod - 3} in slices of "
        f"{BOUNDARY_SLICE}, 1000 x 250, 1001 x 5, 64 x 121 misaligned")


def check_boundary_experiments(dev, errs):
    """The boundary phase for the two redesigned experiments/ scans, at
    10 MS/s (their only rate), bit-exact against their plain versions.
    v2_scan: state rows 0-4 crafted from boundary lanes (env0, w1, mdev,
    avg, a float silence count up to twice its timeout), the rest random;
    BOUNDARY_V2 + 3 x 13 steps at base 95 (the value and filtered rings
    wrap inside the chunk; T below a group of 16 and not a multiple of 6),
    1001 x 100 ending at the int32 guard, 33 x 5 from clock 0 (T < U,
    seeding), 64 x 1200 at base 190 with every 4th lane 0 for 1050 steps
    (past the silence timeout; the squared ring wraps), and BOUNDARY_V2 x
    32 with positive envelopes and no special value.  serial_probe (zero
    carry): lanes that seed on env0 for 100 steps and then take their
    boundary sample, 2 groups x 999 lanes x 137 steps (a warp across two
    groups, a ragged tail), 1 x 33 x 5 (T below a group), 1 x 2048 x 1200
    with every 4th lane 0 for 1000 steps, and 1 x BOUNDARY_PROBE x 116 with
    positive envelopes."""
    import numpy as np
    import torch

    from nfclab_torch.experiments import fused_v2 as v2
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf
    from torch_synth import boundary_lanes, probe_boundary_lanes

    pt, _, _ = _params(RATE)
    scan_rows = ~v2.mask_state_rows().to(dev)
    top = 2**31 - 2 * v2.RBV_RING
    gen = torch.Generator(device=dev)
    everywhere = (-149, 128)
    for i, (b, t, base, binades, specials, off) in enumerate((
            (BOUNDARY_V2 + 3, 13, 95, everywhere, True, None),
            (1001, 100, top - 100, everywhere, True, None),
            (33, 5, 0, everywhere, True, None),
            (64, 1200, 190, everywhere, True, (100, 1150)),
            (BOUNDARY_V2, 32, 1000, (-60, 90), False, None))):
        env0, x = boundary_lanes(b, t, 90 + i, binades, specials)
        if off is not None:
            x[::4, off[0] : off[1]] = 0.0
        env0, x = torch.from_numpy(env0).to(dev), torch.from_numpy(x).to(dev)
        carry = _boundary_state(env0, x[:, 0], RATE, seed=100 + i)
        gen.manual_seed(110 + i)
        st = torch.rand(v2.NSTATE, b, generator=gen, device=dev) * 1e-2
        for row, val in zip(range(5), carry):
            st[row] = val.float()
        x_tm = x.t().contiguous()
        out_k, so_k = v2.v2_scan(x_tm, st, base, pt)
        out_p, so_p = v2._scan_plain(x_tm, st, base, pt)
        what = f"boundary, {b} x {t}, base {base}"
        _hold(errs, "fused_v2_scan", out_k[:-1], out_p[:-1], what)
        _hold(errs, "fused_v2_scan", so_k[scan_rows], so_p[scan_rows], what)
        del env0, x, carry, st, x_tm, out_k, so_k, out_p, so_p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"fused_v2_scan == plain (bit-exact) on boundary lanes: "
        f"{BOUNDARY_V2 + 3} x 13 at base 95, 1001 x 100 at base {top - 100}, "
        f"33 x 5, 64 x 1200 with zeros, {BOUNDARY_V2} x 32 positive")

    for i, (g, lanes, t, binades, specials, off) in enumerate((
            (2, 999, 137, everywhere, True, None),
            (1, 33, 5, everywhere, True, None),
            (1, 2048, 1200, everywhere, True, (150, 1150)),
            (1, BOUNDARY_PROBE, 116, (-60, 90), False, None))):
        x = probe_boundary_lanes(g * lanes, t, seed=120 + i, binades=binades,
                                 specials=specials, off=off)
        v = torch.from_numpy(np.ascontiguousarray(
            x.reshape(t, g, lanes).transpose(1, 0, 2))).to(dev)
        what = f"boundary, {g} x {t} x {lanes}"
        serial = psf.serial_probe(v)
        for a, w in zip(serial, psf.serial_probe_plain(v)):
            _hold(errs, "serial_probe", a, w, what)
        # the pair probe on the even part: equal to the serial probe there
        # (a causal chain) and to its own plain version
        ve = v[:, : t - t % 2].contiguous()
        for a, w, p in zip(pps.pair_probe(ve), serial,
                           pps.pair_probe_plain(ve)):
            _hold(errs, "pair_probe", a, w[:, : t - t % 2], what)
            _hold(errs, "pair_probe", a, p, what)
        del x, v, ve, serial
    torch.cuda.synchronize()
    log(f"serial_probe == plain and pair_probe == serial_probe == plain "
        f"(bit-exact, pair on the even part) on boundary lanes: 2 x 137 x "
        f"999, 1 x 5 x 33, 1 x 1200 x 2048 with zeros, 1 x 116 x "
        f"{BOUNDARY_PROBE} positive")
    check_mask_boundary(dev, errs)


def check_mask_boundary(dev, errs):
    """v2_mask_kernel on crafted scan outputs whose SD numerators sit on
    their divide-free test's boundary (torch_synth.mask_boundary_out: -2..2
    ulps around p2 * m(y) in every binade of env, signed, special envelopes
    one stream in 16), bit-exact against its plain version, under three
    sets of mask parameters (power_thr -1 and 0, so that zero, negative
    and subnormal envelopes pass the gate and their tests are decided;
    then the defaults): a span boundary and a ragged span (2600 rows), B
    not a multiple of 4 (4-byte staging), T below the largest lag (every
    V lookback before the chunk), clock bases at 0, 95 and the int32
    guard.  First the library's mask geometry against the binding's."""
    import torch

    from nfclab_torch.experiments import fused_v2 as v2
    from nfclab_torch.kernels import fused_v2 as kv
    from torch_synth import mask_boundary_out

    got = kv.library_mask_geometry()
    if got != (kv.mask_geometry(), kv.mask_smem()):
        raise AssertionError(f"v2_mask_kernel geometry {got} != the "
                             f"binding's {kv.mask_geometry()}, "
                             f"{kv.mask_smem()}")
    mrows = v2.mask_state_rows().to(dev)
    top = 2**31 - 2 * v2.RBV_RING
    for i, (case, mp, t, b, base) in enumerate((
            ("a", (-1.0, 0.75, 0.10, 0.50, 0.50), 2600, 8195, 0),
            ("f", (0.0, 0.75, 0.10, 0.50, 0.50), 700, 8192, top - 700),
            ("a", (0.01, 0.75, 0.10, 0.50, 0.50), 300, 4096, 1000),
            ("f", (-1.0, 1.0, 0.10, 0.25, 1.0), 4196, 1024, 95))):
        out, st = (torch.from_numpy(a).to(dev)
                   for a in mask_boundary_out(t, b, 200 + i, case, mp))
        out_k, so_k = out.clone(), torch.zeros_like(st)
        v2.v2_mask(out_k, st, so_k, base, mp)
        so_p = torch.zeros_like(st)
        v2._mask_plain(out, st, so_p, base, mp)
        what = f"mask boundary {case}, {b} x {t}, base {base}, mp {mp}"
        _hold(errs, "fused_v2_mask", out_k[-1], out[-1], what)
        _hold(errs, "fused_v2_mask", so_k[mrows], so_p[mrows], what)
        del out, st, out_k, so_k, so_p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("fused_v2_mask == plain (bit-exact) on SD-boundary outputs: 8195 x "
        "2600, 8192 x 700 at the int32 guard, 4096 x 300, 1024 x 4196; "
        f"geometry {got}")


FF_MASK_RATES = (10_000_000, 3_200_000, 40_000_000)


def check_ff_mask_geometry():
    """ff_mask_kernel's geometry as the library computes it against the
    binding's mirror (kernels/fused.mask_geometry), for every plan from
    0.5 to 40 MS/s and each selection; then a plan outside the kernel's
    limits must be refused, by the binding and by the library's launcher,
    and so must a state_out that is state_in.  Returns {streams per block:
    plans}."""
    import ctypes

    import torch

    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.kernels import fused as kf

    lib = kf.library()
    streams = {}
    for rate in range(500_000, 40_000_001, 100_000):
        plan = ff.kernel_plan(rate)
        lay = ff._layout(plan)
        for sel in ((True, False), (True, True), (False, True),
                    (False, False)):
            got = kf.library_mask_geometry(plan, lay, *sel)
            want = kf.mask_geometry(plan, *sel)
            if got != want:
                raise AssertionError(f"ff_mask_kernel geometry at {rate} Hz, "
                                     f"{sel}: library {got} != binding "
                                     f"{want}")
        w = kf.mask_geometry(plan)[5]   # the mask alone
        streams[w] = streams.get(w, 0) + 1
    # a plan outside the kernel's limits (two NFC-A rates): refused by the
    # binding and by the library's launcher
    plan = ff.kernel_plan(RATE)
    lay = ff._layout(plan)
    odd = plan._replace(a_rates=plan.a_rates[:2])
    dev = torch.device("cuda", 0)
    deps = torch.zeros(len(plan.bv_widths) + 2, 256, 64, device=dev)
    x = torch.zeros(256, 64, device=dev)
    st = torch.zeros(plan.nstate, 64, device=dev)
    so = torch.zeros_like(st)
    mk = torch.empty(256, 64, dtype=torch.uint8, device=dev)
    try:
        kf.launch_mask(deps, x, st, so, mk, None, (0.01,) * 5, odd, lay)
    except ValueError as e:
        log(f"launch_mask refuses a plan it cannot hold: {e}"[:160])
    else:
        raise AssertionError("launch_mask took a plan it cannot hold")
    a = kf.mask_args(deps, x, st, so, mk, None, (0.01,) * 5, odd, lay)
    code = lib.nfclab_ff_mask(ctypes.byref(a), 0, kf.MASK_THREADS,
                              torch.cuda.current_stream(dev).cuda_stream)
    if code == 0:
        raise AssertionError("nfclab_ff_mask queued a plan it cannot hold")
    # state_out over state_in: refused too
    try:
        kf.launch_mask(deps, x, st, st, mk, None, (0.01,) * 5, plan, lay)
    except ValueError:
        pass
    else:
        raise AssertionError("launch_mask took state_out == state_in")
    a = kf.mask_args(deps, x, st, st, mk, None, (0.01,) * 5, plan, lay)
    if lib.nfclab_ff_mask(ctypes.byref(a), 0, kf.MASK_THREADS,
                          torch.cuda.current_stream(dev).cuda_stream) == 0:
        raise AssertionError("nfclab_ff_mask queued state_out == state_in")
    return streams


def check_ff_mask_boundary(dev, errs):
    """ff_mask_kernel against _mask_plain (mask, mod_depth and the history
    rows, bit-exact) on crafted channels whose SD numerators sit on their
    boundary (torch_synth.ff_mask_boundary_deps: -2..2 ulps of p2 m(y),
    and at and inside the edge of the kernel's float32 band, in every
    binade of env, special envelopes, lookbacks before the chunk on the
    boundary too), at 10, 3.2 and 40 MS/s, under power_thr -1, 0 and the
    default: a span boundary with a ragged last span and B not a multiple
    of 4 (4-byte staging), T below the largest lag (every V lookback from
    the history), a 1024-stream case with mask alone.  First the geometry
    (check_ff_mask_geometry)."""
    import torch

    from nfclab_torch.dsp import fused_frontend as ff
    from torch_synth import ff_mask_boundary_deps

    streams = check_ff_mask_geometry()
    cases = (((-1.0, 0.75, 0.10, 0.50, 0.50), 2600, 8195, 0, True),
             ((0.0, 1.0, 0.10, 0.25, 1.0), 300, 4096, 1, True),
             ((0.01, 0.75, 0.10, 0.50, 0.50), 4196, 1024, 0, False),
             ((0.01, 0.75, 0.10, 0.50, 0.50), 700, 2052, 1, True))
    for rate in FF_MASK_RATES:
        plan = ff.kernel_plan(rate)
        hist = torch.zeros(plan.nstate, dtype=torch.bool, device=dev)
        lay = ff._layout(plan)
        hist[lay.hist_off : lay.hist_off + lay.hist_rows] = True
        for i, (mp, t, b, case, md) in enumerate(cases):
            deps, value, st = (
                torch.from_numpy(a).to(dev) for a in ff_mask_boundary_deps(
                    plan, t, b, 300 + i, case, mp))
            so_k, so_p = torch.zeros_like(st), torch.zeros_like(st)
            got = ff.fused_mask(deps, value, st, so_k, mp, plan, True, md)
            want = ff._mask_plain(deps, value, st, so_p, mp, plan, True, md)
            what = (f"ff mask boundary at {rate} Hz, case {case}, {b} x {t}, "
                    f"mp {mp}, mod_depth {md}")
            for n in want:
                _hold(errs, "fused_mask", got[n], want[n], f"{n}, {what}")
            _hold(errs, "fused_mask", so_k[hist], so_p[hist],
                  f"history rows, {what}")
            del deps, value, st, so_k, so_p, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"fused_mask == plain (bit-exact) on SD-boundary channels at "
        f"{FF_MASK_RATES} Hz: 8195 x 2600, 4096 x 300, 1024 x 4196, "
        f"2052 x 700; geometry equal for every plan of 0.5-40 MS/s, streams "
        f"per block {streams}")


def check_condition_main_shape(dev, caps, errs):
    """cond_scan_kernel against its plain version at the main path's
    shape, on its captures: one [65536, 1024] chunk (the second of each
    capture) from the state the kernel carried out of the first, at clock
    65536.  Kernel time on those inputs, plain time from the comparison
    run, and the bound."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import _params_tuple

    pt = _params_tuple(SignalParams(RATE))
    chunk = 65536

    def tm(c):
        return torch.from_numpy(np.stack(
            [cp[c * chunk : (c + 1) * chunk] for cp in caps], 1)).to(dev)

    z = torch.zeros(STREAMS, dtype=torch.float32, device=dev)
    zi = torch.zeros(STREAMS, dtype=torch.int32, device=dev)
    out0 = ck.condition_scan_tm(tm(0), z, z, z, z, zi, zi, pt)
    init = tuple(out0[i][-1].contiguous() for i in (0, 1, 2, 3, 5)) + (
        torch.full((STREAMS,), chunk, dtype=torch.int32, device=dev),)
    del out0
    x1 = tm(1)
    got = ck.condition_scan_tm(x1, *init, pt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ck._scan_plain_tm(x1, init, pt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _cond_compare(got, want, errs, f"{STREAMS} x {chunk}, carried state")
    log(f"condition_scan == plain (bit-exact) at {STREAMS} streams x "
        f"{chunk}, carried state at clock {chunk}")
    # the repair shape: stream 0 alone, against its column of the checked
    # run
    x_one = x1[:, :1].contiguous()
    init_one = tuple(t[:1].contiguous() for t in init)
    one = ck.condition_scan_tm(x_one, *init_one, pt)
    _cond_compare(one, [g[:, :1] for g in got], errs,
                  f"1 x {chunk} against stream 0 of {STREAMS} x {chunk}")
    log(f"condition_scan at 1 x {chunk} == stream 0 of the checked run")
    del got, want, one
    ms = _event_ms(lambda: ck.condition_scan_tm(x1, *init, pt), 5)
    repair_ms = _event_ms(
        lambda: ck.condition_scan_tm(x_one, *init_one, pt), 5)
    # each input read once (4 B/sample and the 24 B initial state of a
    # stream), each output written once (24 B/sample); COND_OPS float and
    # counter operations per sample at the f32 rate
    n = chunk * STREAMS
    return {"cond_ms": ms, "cond_plain_ms": plain_ms,
            "cond_ns_per_step": ms * 1e6 / chunk,
            "cond_repair_ms": repair_ms,
            "cond_repair_ns_per_step": repair_ms * 1e6 / chunk,
            "cond_bound": _bound(28 * n + 24 * STREAMS, COND_OPS * n)}


def _event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_main_shape(dev, caps, errs):
    """Both kernels against their plain versions at the main path's shape,
    on its own inputs with its mask params: the captures' second [65536,
    1024] chunk from the state the kernels carried out of the first, at a
    folded clock base (mod + lo % mod, where the engine's later windows
    start), the mask kernel with detect_mask alone and again with
    mod_depth.  The kernel times are taken on those inputs and the plain
    times come from that comparison.  Fresh state at clock 0 is held on
    the captures' first [FRESH_CMP, 1024] samples.  Returns the times,
    each kernel's bound and the mask's two-kernel floors."""
    import numpy as np
    import torch

    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.kernels import fused as kf

    pt, _, mp = _params(RATE)
    plan = ff.kernel_plan(RATE)
    lay = ff._layout(plan)
    chunk = cc.CHAIN_CHUNK
    mod = plan.fold_modulus
    hist = torch.zeros(plan.nstate, dtype=torch.bool, device=dev)
    hist[lay.hist_off : lay.hist_off + lay.hist_rows] = True

    def tm(lo, n):
        return torch.from_numpy(np.stack([cp[lo : lo + n] for cp in caps],
                                         1)).to(dev)

    def compare(x_tm, st, base, what):
        """Both kernels and their plain versions on x_tm from state st;
        returns the kernels' deps and state, and the plain times."""
        t = {}
        deps_k, _, so_k = ff.fused_scan(x_tm, st, base, pt, plan)
        mk_k = ff.fused_mask(deps_k, x_tm, st, so_k, mp, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deps_p, _, so_p = ff._scan_plain(x_tm, st, base, pt, plan)
        torch.cuda.synchronize()
        t["scan_plain_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mk_p = ff._mask_plain(deps_p, x_tm, st, so_p, mp, plan)
        torch.cuda.synchronize()
        t["mask_plain_ms"] = (time.perf_counter() - t0) * 1e3
        # the scan owns the carry, rings and sums; the mask the histories
        pairs = (("fused_scan", "deps", deps_k, deps_p),
                 ("fused_scan", "state", so_k[~hist], so_p[~hist]),
                 ("fused_mask", "detect_mask", mk_k["detect_mask"],
                  mk_p["detect_mask"]),
                 ("fused_mask", "state", so_k[hist], so_p[hist]))
        for name, part, a, b in pairs:
            e = _err(a.float(), b.float())
            errs[name] = max(errs[name], e)
            if not _same(a, b):
                raise AssertionError(f"{name} {part} != plain on {what}: "
                                     f"max err {e}")
        log(f"kernels == plain (bit-exact) on {what}, "
            "select=('detect_mask',)")
        # the mask kernel with mod_depth too, on the same inputs
        so_md, so_pmd = so_k.clone(), so_p.clone()
        mk_md = ff.fused_mask(deps_k, x_tm, st, so_md, mp, plan, True, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk_pmd = ff._mask_plain(deps_p, x_tm, st, so_pmd, mp, plan, True,
                                True)
        torch.cuda.synchronize()
        t["mask_md_plain_ms"] = (time.perf_counter() - t0) * 1e3
        for part, a, b in (("detect_mask", mk_md["detect_mask"],
                            mk_pmd["detect_mask"]),
                           ("mod_depth", mk_md["mod_depth"],
                            mk_pmd["mod_depth"]),
                           ("state", so_md[hist], so_pmd[hist])):
            _hold(errs, "fused_mask", a, b, f"{part} with mod_depth on {what}")
        log(f"fused_mask == plain (bit-exact) on {what}, "
            "select=('detect_mask', 'mod_depth')")
        return deps_k, so_k, t

    st0 = torch.zeros(plan.nstate, STREAMS, device=dev)
    compare(tm(0, FRESH_CMP), st0, 0,
            f"{STREAMS} streams x {FRESH_CMP}, fresh state at clock 0")
    # the main path's shape: the second [65536, 1024] chunk, from the
    # state the kernels carried out of the first
    x_tm = tm(0, chunk)
    deps_k, _, st_in = ff.fused_scan(x_tm, st0, 0, pt, plan)
    ff.fused_mask(deps_k, x_tm, st0, st_in, mp, plan)
    base = mod + chunk % mod
    x_tm = tm(chunk, chunk)
    deps_k, so_k, t = compare(
        x_tm, st_in, base,
        f"{STREAMS} streams x {chunk}, carried state at base {base}")
    so_t = so_k.clone()
    t["scan_ms"] = _event_ms(
        lambda: ff.fused_scan(x_tm, st_in, base, pt, plan), 5)
    t["scan_ns_per_step"] = t["scan_ms"] * 1e6 / chunk
    # the scan the rule does not take at this shape (ff_scan_kernel_narrow
    # takes up to 8 streams an SM): bit for bit the same, and its time
    narrow = kf.scan_narrow(STREAMS, plan, kf.sm_count(dev.index or 0))
    other = "ff_scan_kernel" if narrow else "ff_scan_kernel_narrow"
    t["scan_kernel"] = "ff_scan_kernel_narrow" if narrow else "ff_scan_kernel"
    rule = kf.scan_narrow
    kf.scan_narrow = lambda *a: not narrow
    try:
        deps_o, _, so_o = ff.fused_scan(x_tm, st_in, base, pt, plan)
        t["scan_other_ms"] = _event_ms(
            lambda: ff.fused_scan(x_tm, st_in, base, pt, plan), 5)
    finally:
        kf.scan_narrow = rule
    _hold(errs, "fused_scan", deps_o, deps_k, f"{other}'s deps")
    _hold(errs, "fused_scan", so_o[~hist], so_k[~hist], f"{other}'s state")
    t["scan_other_kernel"] = other
    t["mask_ms"] = _event_ms(
        lambda: ff.fused_mask(deps_k, x_tm, st_in, so_t, mp, plan), 5)
    t["mask_md_ms"] = _event_ms(
        lambda: ff.fused_mask(deps_k, x_tm, st_in, so_t, mp, plan, True,
                              True), 5)
    t["chunk_mask_ms"] = _event_ms(
        lambda: ff.run_chunk(x_tm, st_in, base, pt, mp, plan,
                             ("detect_mask",)), 5)
    t["chunk_all_ms"] = _event_ms(
        lambda: ff.run_chunk(x_tm, st_in, base, pt, mp, plan,
                             ff._normalize_select(None, plan)), 5)
    # least times for the mask-only function: each input read once, each
    # output written once, and its float ops.  The scan reads the samples
    # and reads and writes the carry, rings and sums; the mask writes the
    # packed mask and reads and writes the histories.  The six dependency
    # channels passed between the two (24 B/sample written, 24 read back)
    # are a cost of the two-kernel design, not of the function.
    n = chunk * STREAMS
    nbv = len(plan.bv_widths)
    state_b = plan.nstate * STREAMS * 4
    hist_b = lay.hist_rows * STREAMS * 4
    scan_ops = 19 + 2 * nbv + 2 + 2 * len(plan.q_widths) + 4 * len(plan.pb)
    mask_ops = (1 + 9 * len(plan.a_rates) + 9 * len(plan.f_rates)
                + 2 * len(plan.b_delays) + 5)
    t["scan_bound"] = _bound(4 * n + 2 * (state_b - hist_b), scan_ops * n)
    t["mask_bound"] = _bound(n + 2 * hist_b, mask_ops * n)
    # the floor of the two-kernel split: the mask kernel reads the n_bv + 2
    # dependency channels once (24 B a sample at 10 MS/s) and writes the
    # mask, 25 B; with mod_depth also the samples in and mod_depth out, 8 B
    # more; and it reads and writes the history rows
    dep_b = 4 * (nbv + 2)
    t["two_kernel_floor_ms"] = _bound((dep_b + 1) * n + 2 * hist_b,
                                      mask_ops * n)[0]
    t["two_kernel_floor_md_ms"] = _bound((dep_b + 9) * n + 2 * hist_b,
                                         (mask_ops + 4) * n)[0]
    t["chunk_mask_bound"] = _bound(5 * n + 2 * state_b,
                                   (scan_ops + mask_ops) * n)
    # the pair with every output selected (the full-channel path): 4 B a
    # sample in, 14 f32 outputs and the mask out (57 B), the state in and
    # out; mod_depth's 4 operations beside the scan's and the mask's
    t["chunk_all_bound"] = _bound(61 * n + 2 * state_b,
                                  (scan_ops + mask_ops + 4) * n)
    return t


SCANS = ("ff_scan_kernel_narrow", "ff_scan_kernel", "cond_scan_kernel",
         "v2_scan_kernel", "serial_probe_kernel", "pair_probe_kernel",
         "v2_mask_kernel", "ff_mask_kernel")


def scan_resources(kbuild) -> dict:
    """Registers, spill bytes and static shared memory of each serial scan
    kernel, from the ptxas lines of the last build (the largest over the
    instantiations of a template)."""
    import re

    res, entry = {}, None
    for ln in kbuild.ptxas_lines():
        if "Compiling entry function" in ln:
            entry = next((k for k in SCANS if k in ln.split("'")[1]), None)
            continue
        if entry is None:
            continue
        r = res.setdefault(entry, {"registers": 0, "spill_bytes": 0,
                                   "static_smem": 0})
        if m := re.search(r"Used (\d+) registers", ln):
            r["registers"] = max(r["registers"], int(m.group(1)))
        if m := re.search(r"(\d+) bytes smem", ln):
            r["static_smem"] = max(r["static_smem"], int(m.group(1)))
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln):
            r["spill_bytes"] = max(r["spill_bytes"], int(m.group(1))
                                   + int(m.group(2)))
    return res


def log_scan_resources(kbuild) -> dict:
    """The ptxas register and spill lines of the serial scans (every
    instantiation of ff_scan_kernel) and their shared memory per block
    (ff_scan_kernel at 10 and 3.2 MS/s); returns scan_resources with each
    scan's shared memory per block and threads per block."""
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.kernels import conditioner as kc
    from nfclab_torch.kernels import fused as kf
    from nfclab_torch.kernels import fused_v2 as kv
    from nfclab_torch.kernels import probes as kp

    entry = None
    for ln in kbuild.ptxas_lines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif entry and any(k in entry for k in SCANS) and (
                "Used" in ln or "spill" in ln):
            log(f"  {entry}: {ln.split(':', 1)[-1].strip()}")
    for rate in (RATE, 3_200_000):
        plan = ff.kernel_plan(rate)
        log(f"  ff_scan_kernel at {rate} Hz: group {kf.scan_group(plan)}, "
            f"{kf.scan_smem(ff._layout(plan).ring_rows)} B of shared memory "
            f"per block of {kf.SCAN_THREADS} threads; ff_scan_kernel_narrow "
            f"{kf.scan_narrow_smem(plan)} B per block of "
            f"{kf.SCAN_NARROW_THREADS}")
    for rate in FF_MASK_RATES:
        g = kf.mask_geometry(ff.kernel_plan(rate), True, True)
        log(f"  ff_mask_kernel at {rate} Hz, mask and mod_depth: {g[5]} "
            f"streams a block of {kf.MASK_THREADS} threads, {g[6]} B of "
            f"shared memory, {g[7]} lag windows (channel, lmin, lmax, rows, "
            f"first row): {g[8:]}")
    res = scan_resources(kbuild)
    dyn = {"ff_scan_kernel_narrow": kf.scan_narrow_smem(ff.kernel_plan(RATE)),
           "ff_scan_kernel": kf.scan_smem(ff._layout(ff.kernel_plan(RATE))
                                          .ring_rows),
           "cond_scan_kernel": 0, "v2_scan_kernel": kv.scan_smem(),
           "serial_probe_kernel": 0, "pair_probe_kernel": 0,
           "v2_mask_kernel": kv.mask_smem(),
           "ff_mask_kernel": kf.mask_geometry(ff.kernel_plan(RATE))[6]}
    threads = {"ff_scan_kernel_narrow": kf.SCAN_NARROW_THREADS,
               "ff_scan_kernel": kf.SCAN_THREADS,
               "cond_scan_kernel": kc.THREADS,
               "v2_scan_kernel": kv.SCAN_THREADS,
               "serial_probe_kernel": kp.SERIAL_THREADS,
               "pair_probe_kernel": kp.PAIR_THREADS,
               "v2_mask_kernel": kv.MASK_THREADS,
               "ff_mask_kernel": kf.MASK_THREADS}
    for k in SCANS:
        r = res.setdefault(k, {"registers": 0, "spill_bytes": 0,
                               "static_smem": 0})
        r["smem_per_block"] = r.pop("static_smem") + dyn[k]
        r["threads_per_block"] = threads[k]
    log(f"  scan resources at {RATE} Hz: {json.dumps(res)}")
    return res


def _bound(nbytes, ops):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_F32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def build_lanes(templates):
    from torch_synth import lane

    caps, reps = [], []
    for i in range(STREAMS):
        x, r = lane(templates[i % len(templates)], WINDOW, seed=1000 + i)
        caps.append(x)
        reps.append(r)
    return caps, reps


def run_main_path(caps):
    """chained_batch_masks over every capture, with its step times; launch
    counts are read around exactly this call."""
    import torch

    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from nfclab_torch.dsp.conditioner_kernel import COND

    steps = {}
    for k in (*ff.KERNELS, COND):
        k.launches = 0
    t0 = time.perf_counter()
    res = cc.chained_batch_masks(caps, RATE, device="cuda", stats=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ff.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    return res, dt, launches, peak, steps


def _frames_key(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def check_decode(caps, reps, res, templates):
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.decoder import NfcDecoder

    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    for i, tp in enumerate(templates):
        t0 = time.perf_counter()
        dev_frames = NfcDecoder().decode(caps[i], RATE, tpu_channels=res[i])
        host_frames = NfcDecoder().decode(caps[i], RATE)
        if _frames_key(dev_frames) != _frames_key(host_frames):
            raise AssertionError(f"{tp.name}: device-mask frames != host")
        data = [f.data for f in dev_frames if f.frame_type in keep]
        if data != tp.sent * reps[i]:
            raise AssertionError(f"{tp.name}: frames != synthesized bytes")
        log(f"decode {tp.name}: {len(dev_frames)} frames, device mask == host "
            f"== synth bytes ({len(res[i]['detect_idx'])} triggers, "
            f"{time.perf_counter() - t0:.2f} s)")


def check_cli(templates):
    from nfclab_torch.io.wav import write_wav

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    wav = out_dir / "nfca_106k.wav"
    write_wav(str(wav), templates[0].samples, RATE)
    lines = {}
    for fe in ("host", "mask"):
        proc = subprocess.run(
            [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
             "--json", "--frontend", fe, str(wav)],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"CLI --frontend {fe} failed:\n{proc.stderr}")
        lines[fe] = proc.stdout.splitlines()
    if not lines["mask"] or lines["mask"] != lines["host"]:
        raise AssertionError("CLI --frontend mask lines != --frontend host")
    log(f"CLI run --frontend mask == --frontend host ({len(lines['mask'])} "
        "lines)")
    return out_dir


COND_CHANNELS = ("envelope", "filtered", "deviation", "average", "mod_depth")


def run_dense_frontend(dev, caps, reps=3):
    """jitted_frontend(10 MS/s) over [STREAMS, 65536] of the captures on
    the card: ms per call (host clock, each call ended by a device sync),
    samples/s, peak memory and conditioning launches per call; then the
    same call on the CPU over DENSE_CPU_STREAMS of the streams.  The
    conditioning channels and mod_depth must be bit-exact; the masks equal
    (their box sums take value prefixes, which accumulate exactly in
    float64 here); the other float channels within 8 float32 ulps of the
    row's input sum (a prefix rounded at a float64 tie; Sum|value| / p2
    for sd_a, which divides its four boxes by the half-symbol width p2,
    10 * Sum filt^2 for the squared and product boxes)."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import nfca_bitrates
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import jitted_frontend

    fn = jitted_frontend(RATE)
    chunk = 65536
    x = torch.from_numpy(np.stack([cp[:chunk] for cp in caps])).to(dev)
    fn(x)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.COND.launches = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(x)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = ck.COND.launches / reps
    peak = torch.cuda.max_memory_allocated()
    nbytes = sum(o.numel() * o.element_size() for o in out.values())
    res = {"ms": dt * 1e3, "samples_per_s": x.numel() / dt,
           "max_memory_allocated_gib": peak / 2**30,
           "output_gib": nbytes / 2**30, "cond_launches_per_call": launches,
           "outputs": len(out)}
    if launches != 1:
        raise AssertionError(f"dense frontend launched the conditioning "
                             f"kernel {launches} times per call")

    k = DENSE_CPU_STREAMS
    t0 = time.perf_counter()
    want = jitted_frontend(RATE, device="cpu")(x[:k].cpu())
    res["cpu_check_s"] = time.perf_counter() - t0
    if list(want) != list(out):
        raise AssertionError("dense frontend keys differ between devices")
    xs = x[:k].cpu().double()
    s_val = xs.abs().sum(1, keepdim=True)
    s_sq = (want["filtered"].double() ** 2).sum(1, keepdim=True) * 10.0
    eps = float(np.finfo(np.float32).eps)
    p2 = {f"sd_a_{br.rate_type}": br.period2 for br in nfca_bitrates(RATE)}
    worst = {}
    for name, w in want.items():
        g = out[name][:k].cpu()
        if g.dtype != w.dtype:
            raise AssertionError(f"dense frontend {name}: dtype {g.dtype} "
                                 f"!= {w.dtype} on the CPU")
        if name in COND_CHANNELS or w.dtype == torch.bool:
            if not _same(g, w):
                raise AssertionError(f"dense frontend {name} != CPU")
            continue
        tol = 8 * eps * (s_val / p2[name] if name in p2 else s_sq)
        d = (g.double() - w.double()).abs()
        worst[name] = float(d.max())
        if bool((d > tol).any()):
            raise AssertionError(f"dense frontend {name} off the CPU beyond "
                                 f"tolerance: max err {worst[name]}")
    res["max_abs_err_tolerance_channels"] = max(worst.values())
    del out, want
    return res


def long_capture(templates, seed=21):
    """(samples, expected polls+listens): LONG samples of the templates in
    turn, each at a seeded gain, then a field-off stretch of 200k-400k
    samples (noise about zero), long enough that the envelope keeps no
    memory a halo can recover, so blocks need repairs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.empty(LONG, np.float32)
    pos, i = 0, 0
    while pos < LONG:
        tp = templates[i % len(templates)]
        i += 1
        seg = tp.samples * np.float32(rng.uniform(0.8, 1.25))
        off = (np.float32(2e-3) * rng.standard_normal(
            int(rng.integers(200_000, 400_000)))).astype(np.float32)
        for part in (seg, off):
            n = min(len(part), LONG - pos)
            x[pos : pos + n] = part[:n]
            pos += n
    return x


def run_conditioner_path(templates, out_dir):
    """Phase 7: condition_jax on the long capture against the C++ oracle,
    then the conditioning path through NfcDecoder(conditioner="jax") with
    the launch counts read around exactly that call; decode_batch and the
    CLI on the template WAVs."""
    import numpy as np

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.native import condition_exact
    from nfclab_torch.runtime.batch import decode_batch
    from nfclab_torch.runtime.decoder import NfcDecoder

    x = long_capture(templates)
    params = SignalParams(RATE)
    stats = {}
    t0 = time.perf_counter()
    cond = condition_jax(x, params, stats=stats)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = condition_exact(x, params)
    wall_native = time.perf_counter() - t0
    for name in ("value", "envelope", "filtered", "deviation", "average",
                 "mod_depth", "edge_peak", "edge_time"):
        a, b = getattr(cond, name), getattr(ref, name)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"condition_jax {name} != C++ oracle on the "
                                 "long capture")
    if stats["repairs"] < 1:
        raise AssertionError("the long capture needed no repair")
    # edge_tracker_s: the host edge tracker's share of condition_jax
    res = {"samples": LONG, "blocks": stats["blocks"],
           "repairs": stats["repairs"], "condition_jax_s": wall,
           "edge_tracker_s": stats["edge_tracker_s"],
           "condition_exact_s": wall_native}
    log(f"condition_jax == C++ oracle (bit-exact, 8 arrays) on {LONG} "
        f"samples: {json.dumps(res)}")

    # the conditioning path, launch counts read around exactly this call
    for kern in (*ff.KERNELS, ck.COND):
        kern.launches = 0
    t0 = time.perf_counter()
    frames = NfcDecoder(conditioner="jax").decode(x, RATE)
    res["decode_jax_s"] = time.perf_counter() - t0
    launches = ck.COND.launches
    if launches <= 0:
        raise AssertionError("condition_scan never ran on the conditioning "
                             "path")
    t0 = time.perf_counter()
    native = NfcDecoder().decode(x, RATE)
    res["decode_native_s"] = time.perf_counter() - t0
    if _frames_key(frames) != _frames_key(native):
        raise AssertionError("NfcDecoder(conditioner='jax') frames != native "
                             "on the long capture")
    res["frames"] = len(frames)
    res["cond_launches"] = launches
    log(f"conditioning path: NfcDecoder(conditioner='jax') == native "
        f"({len(frames)} frames, {launches} condition_scan launches)")

    from nfclab_torch.io.wav import write_wav

    paths = []
    for tp in templates:
        paths.append(str(out_dir / f"{tp.name}.wav"))
        write_wav(paths[-1], tp.samples, RATE)
    want = decode_batch(paths, conditioner="native", pool="thread")
    for kw in ({"conditioner": "jax"}, {"frontend": "mask"}):
        got = decode_batch(paths, pool="thread", **kw)
        for p in paths:
            if _frames_key(got[p]) != _frames_key(want[p]) or not got[p]:
                raise AssertionError(f"decode_batch({kw}) {p} != native")
        log(f"decode_batch({kw}) == native on {len(paths)} template WAVs")

    lines = {}
    for extra in ((), ("--conditioner", "jax"),
                  ("--conditioner", "jax", "--frontend", "mask")):
        proc = subprocess.run(
            [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
             "--json", *extra, paths[0]],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"CLI {extra} failed:\n{proc.stderr}")
        lines[extra] = proc.stdout.splitlines()
    if not lines[()] or any(v != lines[()] for v in lines.values()):
        raise AssertionError("CLI --conditioner jax lines != native")
    log(f"CLI run --conditioner jax (with and without --frontend mask) == "
        f"native ({len(lines[()])} lines)")
    return res, launches, _frames_key(native)


def farm_lanes(templates, n_streams, seed0):
    """(captures, repeats) for the farm: one stream per template in turn,
    FARM_WINDOWS windows plus the tail each (torch_synth.lane)."""
    from torch_synth import lane

    n = FARM_WINDOWS * WINDOW + FARM_TAIL
    out = [lane(templates[i % len(templates)], n, seed=seed0 + i)
           for i in range(n_streams)]
    return [x for x, _ in out], [r for _, r in out]


def pause_lanes(templates, seed=90):
    """PAUSE_STREAMS farm streams with a field-off stretch of 200k-400k
    samples (noise about zero, as long_capture's) across one segment
    boundary of every window after the first, so the speculative lanes
    there cannot verify."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sigs, _ = farm_lanes(templates, PAUSE_STREAMS, seed)
    seg = WINDOW // 16
    for x in sigs:
        for w in range(1, FARM_WINDOWS):
            edge = w * WINDOW + int(rng.integers(1, 16)) * seg
            lo = edge - int(rng.integers(*PAUSE_LEAD))
            n = min(int(rng.integers(*PAUSE_LEN)), len(x) - lo)
            x[lo : lo + n] = np.float32(2e-3) * rng.standard_normal(
                n).astype(np.float32)
    return sigs


def host_stream_frames(sigs):
    """Each stream through the host StreamingNfcDecoder (native
    conditioner) in 65536-sample blocks, eight streams at a time."""
    from concurrent.futures import ThreadPoolExecutor

    from nfclab_torch.runtime.streaming import StreamingNfcDecoder

    def one(x):
        dec = StreamingNfcDecoder(RATE)
        out = []
        for off in range(0, len(x), 65536):
            out.extend(dec.feed(x[off : off + 65536]))
        out.extend(dec.finish())
        return _frames_key(out)

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, sigs))


def run_farm(sigs, **kw):
    """CudaStreamFarm(fetch="mask", k_chunks=32, walk_threads=8) over the
    streams, fed FARM_FEED samples at a time through one reused buffer:
    (farm, per-stream frames, wall seconds, [(window width, scan
    launches, mask launches)] per dispatch)."""
    import numpy as np

    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.runtime.farm import CudaStreamFarm

    farm = CudaStreamFarm(len(sigs), RATE, fetch="mask", k_chunks=32,
                          walk_threads=8, **kw)
    windows = []
    device_pass = farm._device_pass

    def counted(batch, base0):
        # dispatches run one at a time on the farm's IO thread
        s0, m0 = ff.SCAN.launches, ff.MASK.launches
        res = device_pass(batch, base0)
        windows.append((batch.shape[1], ff.SCAN.launches - s0,
                        ff.MASK.launches - m0))
        return res

    farm._device_pass = counted
    frames = [[] for _ in sigs]
    total = len(sigs[0])
    buf = np.empty((len(sigs), FARM_FEED), np.float32)
    t0 = time.perf_counter()
    for off in range(0, total, FARM_FEED):
        w = min(FARM_FEED, total - off)
        for i, x in enumerate(sigs):
            buf[i, :w] = x[off : off + w]
        for i, new in enumerate(farm.feed(buf[:, :w])):
            frames[i].extend(new)
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    dt = time.perf_counter() - t0
    return farm, frames, dt, windows


def _farm_reading(farm, dt, windows, n_samples):
    st = dict(farm.stats)
    return {"streams": farm.n_streams, "segments": farm.segments,
            "wall_s": dt, "samples_per_s": n_samples / dt,
            **{k: st[k] for k in (
                "device_s", "walk_s", "wait_s", "dispatches",
                "seg_dispatches", "repaired_streams", "repair_chunks",
                "seg_backoff_windows")},
            "launches_per_window": [{"samples": w, "scan": a, "mask": b}
                                    for w, a, b in windows]}


def _missed(got, sent):
    """Synthesized frames missing from `got` (decoded bytes), or None
    when got is not an ordered subsequence of sent."""
    j = 0
    for d in got:
        while j < len(sent) and sent[j] != d:
            j += 1
        if j == len(sent):
            return None
        j += 1
    return len(sent) - len(got)


def _hold_frames(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if _frames_key(g) != w or not g:
            raise AssertionError(f"{what}: stream {i} frames != host "
                                 "streaming decoder")


def repair_steps(x, row):
    """One repair as the segmented engine runs it (run_chained_masks on
    one stream, a 16-segment window's segment of 2 chunks, from a carried
    state at base = the fold modulus), its steps' host seconds (a
    trace.Lap's counters) in the third of three runs; and the scan kernel
    alone at that shape (CUDA events)."""
    import torch

    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.runtime import trace

    pt, _, mp = _params(RATE)
    plan = ff.kernel_plan(RATE)
    dev = torch.device("cuda", 0)
    seg = x[None, : 2 * cc.CHAIN_CHUNK]
    state = torch.from_numpy(row).to(dev)
    for _ in range(3):
        steps = {}
        t0 = time.perf_counter()
        cc.run_chained_masks(seg, state, plan.fold_modulus, pt, mp,
                             want_carry=True,
                             lap=trace.Lap(steps, cc.LAP_COUNTERS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = dict(steps, unattributed=wall - sum(steps.values()), wall=wall)
    x_tm = torch.from_numpy(seg[0, : cc.CHAIN_CHUNK, None].copy()).to(dev)
    st = state.t().contiguous()
    res["scan_kernel_ms"] = _event_ms(
        lambda: ff.fused_scan(x_tm, st, plan.fold_modulus, pt, plan), 3)
    deps, _, so = ff.fused_scan(x_tm, st, plan.fold_modulus, pt, plan)
    res["mask_kernel_ms"] = _event_ms(
        lambda: ff.fused_mask(deps, x_tm, st, so, mp, plan), 3)
    return res


def run_farm_phase(templates):
    """Phase 9: the live farm (CudaStreamFarm, the reference's deployment
    mode) on the card.  9a: FARM_STREAMS streams in the default
    configuration (segments=None: 16 segments, 1024 lanes); 9b:
    pause-heavy traffic, without and with the adaptive backoff; 9c: 9a's
    input through the serial chain (segments=1).  Frames are held against
    the host streaming decoder (and against the synthesizer's bytes on
    9a's streams); 9c's conditioning rows 0-4 after the last full window
    against 9a's segmented carry, bit for bit.  Returns the readings, the
    launch counts of each run among them, and 9a's streams with their
    repeats and host frames (phase 10d's input and reference)."""
    import numpy as np
    import torch

    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.dsp import fused_frontend as ff

    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    out = {}
    t0 = time.perf_counter()
    sigs, reps = farm_lanes(templates, FARM_STREAMS, 2000)
    want = host_stream_frames(sigs)
    n = FARM_STREAMS * len(sigs[0])
    log(f"farm: {FARM_STREAMS} streams x {len(sigs[0])} samples built and "
        f"host-decoded in {time.perf_counter() - t0:.1f} s")

    def counted_run(name, sigs, **kw):
        """run_farm with the kernels' counts set to 0 just before and read
        just after; the peak device memory of the run."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in ff.KERNELS:
            k.launches = 0
        farm, frames, dt, win = run_farm(sigs, **kw)
        res = _farm_reading(farm, dt, win, len(sigs) * len(sigs[0]))
        res["launches"] = {k.name: k.launches for k in ff.KERNELS}
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        for kname, c in res["launches"].items():
            if c <= 0:
                raise AssertionError(f"kernel {kname} never ran in farm "
                                     f"{name}")
        out[name] = res
        return farm, frames

    # 9a: the default configuration at the engine's full lane width
    farm_a, got_a = counted_run("9a", sigs)
    # the second window always runs the segmented engine; whether the
    # later ones do is the adaptive backoff's reading of the repairs
    if farm_a.segments != 16 or out["9a"]["seg_dispatches"] < 1:
        raise AssertionError(f"farm 9a did not segment: {out['9a']}")
    _hold_frames(got_a, want, "farm 9a")
    # the synthesizer's bytes, in order and none invented; the host
    # decoders (nfclab's too) miss a few BPSK frames on some of these
    # noisy lanes, and the farm's frames equal theirs, so misses are
    # counted, not failed, up to 1% of the frames sent
    missed, sent = {}, 0
    for i in range(FARM_STREAMS):
        tp = templates[i % len(templates)]
        m = _missed([f.data for f in got_a[i] if f.frame_type in keep],
                    tp.sent * reps[i])
        if m is None:
            raise AssertionError(f"farm 9a stream {i}: frames the "
                                 "synthesizer did not write")
        sent += len(tp.sent) * reps[i]
        if m:
            missed[i] = m
    if sum(missed.values()) > sent // 100:
        raise AssertionError(f"farm 9a missed {missed} of {sent} frames")
    out["9a"]["synth_frames"] = sent
    out["9a"]["synth_missed_by_stream"] = missed
    log(f"farm 9a == host streaming decoder; synthesized bytes in order, "
        f"{sum(missed.values())} of {sent} frames missed (by stream: "
        f"{missed}): {json.dumps(out['9a'])}")

    # 9c: the first FARM_CUT streams of that input through the serial chain
    farm_c, got_c = counted_run("9c", sigs[:FARM_CUT], segments=1)
    if [_frames_key(f) for f in got_c] != [_frames_key(f)
                                           for f in got_a[:FARM_CUT]]:
        raise AssertionError("farm 9c frames != 9a's")
    rows_c = farm_c._state[:, :5].cpu().numpy()
    rows_a = farm_a._carry["end"][:FARM_CUT, :5]
    if rows_c.shape != rows_a.shape or not np.array_equal(
            rows_c.view(np.uint32), rows_a.view(np.uint32)):
        raise AssertionError("farm 9c conditioning rows 0-4 != 9a's "
                             "segmented carry")
    log(f"farm 9c (segments=1) frames == 9a's, conditioning rows 0-4 == "
        f"9a's carry (bit-exact, {FARM_CUT} streams): "
        f"{json.dumps(out['9c'])}")
    out["repair"] = repair_steps(sigs[0], farm_a._carry["end"][:1])
    log(f"one repair of a 2-chunk segment, by step (s): "
        f"{json.dumps(out['repair'])}")
    stream_in = (sigs, reps, want)
    del got_a, got_c, farm_a, farm_c

    # 9b: pause-heavy traffic
    sigs = pause_lanes(templates)
    want = host_stream_frames(sigs)
    _, got = counted_run("9b_fixed", sigs, adaptive_segments=False)
    if out["9b_fixed"]["repaired_streams"] <= 0 or (
            out["9b_fixed"]["repair_chunks"] <= 0):
        raise AssertionError("farm 9b repaired nothing")
    _hold_frames(got, want, "farm 9b (adaptive_segments=False)")
    log(f"farm 9b (pauses, adaptive_segments=False) == host: "
        f"{json.dumps(out['9b_fixed'])}")
    _, got = counted_run("9b_adaptive", sigs, adaptive_segments=True)
    if out["9b_adaptive"]["seg_backoff_windows"] < 1:
        raise AssertionError("farm 9b never backed off")
    _hold_frames(got, want, "farm 9b (adaptive_segments=True)")
    log(f"farm 9b (pauses, adaptive_segments=True) == host: "
        f"{json.dumps(out['9b_adaptive'])}")
    return out, stream_in


FULL_CHUNKS = 2           # phase 10a: chunks of 65536 a capture
ORACLE_LANES = 8          # 10a: lanes held to the C++ oracle
KERNEL_LANES = 2          # 10a: lanes held to the chained fused_frontend
FULL_DECODE_LEN = 4 * 65536   # 10b: samples of a template capture


def run_full_path(caps2):
    """Phase 10a: fused_batch_all over the captures (STREAMS x FULL_CHUNKS
    chunks), with its step times, the launches read around exactly that
    call and its peak memory; then ORACLE_LANES lanes' eight Conditioned
    arrays against the C++ oracle and KERNEL_LANES lanes' channels and
    mask against the card's chained fused_frontend, bit for bit."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.native import condition_exact

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = {}
    for k in ff.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = cc.fused_batch_all(caps2, RATE, device="cuda", stats=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ff.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"fused_scan": FULL_CHUNKS, "fused_mask": FULL_CHUNKS}:
        raise AssertionError(f"full path launches {launches}, not "
                             f"{FULL_CHUNKS} + {FULL_CHUNKS}")
    n = len(caps2) * len(caps2[0])
    out = {"captures": len(caps2), "samples": len(caps2[0]),
           "wall_s": dt, "samples_per_s": n / dt,
           "steps_s": dict(steps, unattributed=dt - sum(steps.values())),
           "edge_tracker_s": steps["edge_tracker_s"],
           "max_memory_allocated": peak, "launches": launches}
    log(f"full path: fused_batch_all {len(caps2)} x {len(caps2[0])}: "
        f"{json.dumps(out)}")

    params = SignalParams(RATE)
    attrs = ("value", "envelope", "filtered", "deviation", "average",
             "mod_depth", "edge_peak", "edge_time")
    for i in range(ORACLE_LANES):
        ref = condition_exact(caps2[i], params)
        cond = res[i][0]
        for a in attrs:
            g, w = getattr(cond, a), getattr(ref, a)
            if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                    g.view(np.uint32), w.view(np.uint32)):
                raise AssertionError(f"fused_batch_all {a} lane {i} != C++ "
                                     "oracle")
    log(f"fused_batch_all conditioning == C++ oracle (bit-exact, 8 arrays) "
        f"on {ORACLE_LANES} lanes")

    pt, mp_all, _ = _params(RATE)
    chunk = cc.CHAIN_CHUNK
    x = torch.from_numpy(np.stack(caps2[:KERNEL_LANES])).to("cuda")
    st, parts = None, []
    for c in range(FULL_CHUNKS):
        got, st = ff.fused_frontend(x[:, c * chunk : (c + 1) * chunk], pt,
                                    mask_params=mp_all, state=st,
                                    base=c * chunk, return_state=True)
        parts.append({k: v.cpu().numpy() for k, v in got.items()})
    for i in range(KERNEL_LANES):
        chans = res[i][1]
        for name in cc.fetch_names(RATE):
            want = np.concatenate([p[name][i] for p in parts])
            if not np.array_equal(chans[name].view(np.uint8),
                                  want.view(np.uint8)):
                raise AssertionError(f"fused_batch_all {name} lane {i} != "
                                     "the chained fused_frontend")
    log(f"fused_batch_all channels and mask == chained fused_frontend "
        f"(bit-exact) on lanes 0-{KERNEL_LANES - 1}")
    return out


def check_full_decode(templates):
    """Phase 10b: one capture of each template (torch_synth.lane,
    FULL_DECODE_LEN samples) through fused_capture_all, and through
    fused_capture_channels with native conditioning; frames equal the
    host frontend's and the synthesizer's bytes."""
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.runtime.decoder import NfcDecoder
    from torch_synth import lane

    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    for i, tp in enumerate(templates):
        x, reps = lane(tp, FULL_DECODE_LEN, seed=3000 + i)
        host = _frames_key(NfcDecoder().decode(x, RATE))
        cond, chans = cc.fused_capture_all(x, RATE)
        full = NfcDecoder().decode(x, RATE, cond=cond, tpu_channels=chans)
        boxes = NfcDecoder().decode(
            x, RATE, tpu_channels=cc.fused_capture_channels(x, RATE))
        for what, frames in (("fused_capture_all", full),
                             ("fused_capture_channels", boxes)):
            if _frames_key(frames) != host:
                raise AssertionError(f"{tp.name}: {what} frames != host")
            if [f.data for f in frames if f.frame_type in keep] != (
                    tp.sent * reps):
                raise AssertionError(f"{tp.name}: {what} frames != "
                                     "synthesized bytes")
        log(f"decode {tp.name} ({len(x)} samples): fused_capture_all and "
            f"fused_capture_channels == host == synth bytes "
            f"({len(full)} frames)")


def check_full_surfaces(templates, out_dir):
    """Phase 10c: decode_batch(frontend="fused") with native and device
    conditioning, the CLI's run --frontend fused and bench_cli --frontend
    fused --conditioner device, on the template WAVs of phase 7, against
    the native frames."""
    from nfclab_torch.runtime.batch import decode_batch

    paths = [str(out_dir / f"{tp.name}.wav") for tp in templates]
    want = decode_batch(paths, conditioner="native", pool="thread")
    for kw in ({"frontend": "fused"},
               {"frontend": "fused", "conditioner": "device"}):
        got = decode_batch(paths, pool="thread", **kw)
        for p in paths:
            if _frames_key(got[p]) != _frames_key(want[p]) or not got[p]:
                raise AssertionError(f"decode_batch({kw}) {p} != native")
        log(f"decode_batch({kw}) == native on {len(paths)} template WAVs")
    proc = subprocess.run(
        [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
         "--json", "--frontend", "fused", paths[0]],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"CLI --frontend fused failed:\n{proc.stderr}")
    lines = proc.stdout.splitlines()
    if not lines or lines != _frames_key(want[paths[0]]):
        raise AssertionError("CLI --frontend fused lines != native")
    log(f"CLI run --frontend fused == native ({len(lines)} lines)")
    proc = subprocess.run(
        [sys.executable, "-m", "nfclab_torch.apps.bench_cli", "--no-kernel",
         "--decode", *paths, "--frontend", "fused", "--conditioner",
         "device", "--pool", "thread"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"bench_cli --frontend fused failed:\n"
                             f"{proc.stderr}")
    rec = json.loads(proc.stdout.splitlines()[-1])
    if rec["frames"] != sum(len(v) for v in want.values()):
        raise AssertionError(f"bench_cli --frontend fused: {rec}")
    log(f"bench_cli --frontend fused --conditioner device: {json.dumps(rec)}")
    return rec


TIMING_KEYS = ("timestamp", "time_start", "time_end", "sample_start",
               "sample_end", "date_time")


def _timing_shift(got, want):
    """(largest shift in samples, largest in symbol periods of the frame's
    rate) of the sample bounds of frames (JSON lines) that agree in every
    other key; None when the counts differ or a frame differs beyond its
    timing.  A frame without a rate (carrier events) counts in samples."""
    if len(got) != len(want):
        return None
    samples = symbols = 0.0
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        if ({k: v for k, v in g.items() if k not in TIMING_KEYS}
                != {k: v for k, v in w.items() if k not in TIMING_KEYS}):
            return None
        period = RATE / g["rate"] if g.get("rate") else 1.0
        for k in ("sample_start", "sample_end"):
            samples = max(samples, abs(g[k] - w[k]))
            symbols = max(symbols, abs(g[k] - w[k]) / period)
    return samples, symbols


def box_drift(x):
    """max |kernel - host| of each box channel of one stream, over its
    first and its last 2**20 samples: the kernels' float32 running sums
    (fused_capture_all on the card) against the host's float64 boxes
    (LazyChannels on the C++ oracle's conditioning)."""
    import numpy as np

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.native import condition_exact
    from nfclab_torch.runtime.decoder import DecoderContext

    _, chans = cc.fused_capture_all(x, RATE)
    params = SignalParams(RATE)
    ch = DecoderContext(condition_exact(x, params), RATE, params).channels
    out = {}
    for name, (_, kind, w, lag) in cc.box_keys(RATE).items():
        host = (ch.box_value(w) if kind == 0 else ch.box_sq(w) if kind == 1
                else ch.box_bpsk(lag, w))
        d = np.abs(chans[name].astype(np.float64) - host)
        out[name] = [float(d[: 1 << 20].max()), float(d[-(1 << 20):].max())]
    return out


def run_full_farm(sigs, want, reps, templates):
    """Phase 10d: CudaStreamFarm(fetch="full") over 9a's streams, fed
    FARM_FEED samples at a time through one reused buffer, with the
    kernels' counts set to 0 just before and read just after (and per
    feed).  Its carried state after the last feed equals, bit for bit, a
    chained fused_frontend over the same streams at unfolded clocks.
    Frames against the host streaming decoder's (phase 9's): the walk
    reads the kernels' float32 running box sums, which drift from the
    host's float64 boxes over millions of samples (ROADMAP Queue 3), so a
    stream may differ in frame timing only: the same frames, equal in
    every key but their sample bounds, which move by less than one symbol
    period of the frame's rate (a whole symbol would be another symbol
    alignment, and other bytes); and the decoded bytes are the
    synthesizer's in order, as in 9a."""
    import numpy as np
    import torch

    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.runtime.farm import CudaStreamFarm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in ff.KERNELS:
        k.launches = 0
    farm = CudaStreamFarm(len(sigs), RATE, fetch="full")
    feeds = []
    feed_full = farm._feed_full

    def counted(blocks):
        s0, m0 = ff.SCAN.launches, ff.MASK.launches
        res = feed_full(blocks)
        feeds.append((blocks.shape[1], ff.SCAN.launches - s0,
                      ff.MASK.launches - m0))
        return res

    farm._feed_full = counted
    frames = [[] for _ in sigs]
    total = len(sigs[0])
    buf = np.empty((len(sigs), FARM_FEED), np.float32)
    t0 = time.perf_counter()
    for off in range(0, total, FARM_FEED):
        w = min(FARM_FEED, total - off)
        for i, x in enumerate(sigs):
            buf[i, :w] = x[off : off + w]
        for i, new in enumerate(farm.feed(buf[:, :w])):
            frames[i].extend(new)
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ff.KERNELS}
    st = dict(farm.stats)
    out = {"streams": len(sigs), "wall_s": dt,
           "samples_per_s": len(sigs) * total / dt,
           **{k: st[k] for k in ("device_s", "walk_s", "dispatches")},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "launches_per_feed": [{"samples": w, "scan": a, "mask": b}
                                 for w, a, b in sorted(set(feeds))]}
    log(f"farm 10d (fetch='full'): {json.dumps(out)}")
    if any(a != 1 or b != 1 for _, a, b in feeds) or (
            launches["fused_scan"] != len(feeds)):
        raise AssertionError(f"full farm launches per feed: {feeds}")

    # the farm's chain of kernels against one at unfolded clocks
    pt, mp_all, _ = _params(RATE)
    st = None
    for off in range(0, total, FARM_FEED):
        x = torch.from_numpy(np.stack(
            [sg[off : off + FARM_FEED] for sg in sigs])).to("cuda")
        _, st = ff.fused_frontend(x, pt, mask_params=mp_all, state=st,
                                  base=off, return_state=True,
                                  select=("detect_mask",))
    if not _same(farm._state, st):
        raise AssertionError("farm 10d state != the chained fused_frontend")
    del x, st

    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    shifted, worst, missed, sent = {}, (0.0, 0.0), {}, 0
    for i, (g, w) in enumerate(zip(frames, want)):
        gk = _frames_key(g)
        if not gk:
            raise AssertionError(f"farm 10d stream {i}: no frames")
        if gk != w:
            q = _timing_shift(gk, w)
            if q is None or q[1] >= 1.0:
                raise AssertionError(f"farm 10d stream {i} frames != host "
                                     f"streaming decoder beyond timing: {q}")
            shifted[i] = sum(a != b for a, b in zip(gk, w))
            worst = tuple(max(a, b) for a, b in zip(worst, q))
        tp = templates[i % len(templates)]
        m = _missed([f.data for f in g if f.frame_type in keep],
                    tp.sent * reps[i])
        if m is None:
            raise AssertionError(f"farm 10d stream {i}: frames the "
                                 "synthesizer did not write")
        sent += len(tp.sent) * reps[i]
        if m:
            missed[i] = m
    if sum(missed.values()) > sent // 100:
        raise AssertionError(f"farm 10d missed {missed} of {sent} frames")
    if shifted:
        out["box_drift"] = box_drift(sigs[min(shifted)])
    out.update(streams_equal_host=len(sigs) - len(shifted),
               frames_shifted_by_stream=shifted,
               max_shift_samples=worst[0], max_shift_symbols=worst[1],
               synth_frames=sent, synth_missed_by_stream=missed)
    log(f"farm 10d state == chained fused_frontend (bit-exact); frames == "
        f"host streaming decoder on {len(sigs) - len(shifted)} of "
        f"{len(sigs)} streams, the others in sample bounds only (frames "
        f"shifted by stream {shifted}, at most {worst[0]:.0f} samples, "
        f"{worst[1]:.3f} symbols); synthesized bytes in order, "
        f"{sum(missed.values())} of {sent} missed: {json.dumps(out)}")
    return out


LIVE_WINDOW = 8 * 65536   # phase 11: the live decoder's window (k_chunks=8)
LIVE_WINDOWS = 32         # 16,777,216 samples, 1.68 s of air
LIVE_PIECE = 1 << 20      # samples of one template's lane in the capture
LIVE_PAUSE_WINDOWS = (3, 19)   # windows whose segment boundary a pause crosses
LIVE_GAP = 4096           # field-off samples that start each piece
LIVE_LEAD = 32768         # carrier samples after them
LIVE_PACED = 1 << 23      # 11b: samples served at the capture's own rate
# int16 values of a SpyServer message (two a sample): unpaced, 2**18
# samples, so the bridge's 64-block queue holds the whole capture; paced,
# 65536 samples (6.6 ms of air)
LIVE_MSG_UNPACED = 1 << 19
LIVE_MSG_PACED = 1 << 17


def live_capture(templates, seed=3000):
    """Phase 11's capture, (x, the synthesizer's frame bytes in order):
    lanes of the templates in turn (torch_synth.lane, LIVE_PIECE samples
    each, seeded gain, offset and noise) back to back, and two field-off
    stretches of PAUSE_LEN samples (noise about zero, as phase 9b's) that
    start PAUSE_LEAD samples before a segment boundary of windows
    LIVE_PAUSE_WINDOWS, so the speculative lanes there cannot verify.
    Each piece starts with LIVE_GAP samples of field-off, as a reader's
    polling loop drops the field between technologies, and LIVE_LEAD of
    carrier (the host decoders garble the NFC-A 424k template's first
    poll after a shorter lead); a piece too short for a whole template
    is carrier only."""
    import numpy as np

    from torch_synth import lane

    rng = np.random.default_rng(seed)
    total = LIVE_WINDOWS * LIVE_WINDOW
    pauses = []
    for w in LIVE_PAUSE_WINDOWS:
        edge = w * LIVE_WINDOW + int(rng.integers(1, 4)) * (LIVE_WINDOW // 4)
        pauses.append((edge - int(rng.integers(*PAUSE_LEAD)),
                       int(rng.integers(*PAUSE_LEN))))
    parts, sent, at, i = [], [], 0, 0
    for lo, n in pauses + [(total, 0)]:
        while at < lo:
            tp = templates[i % len(templates)]
            m = min(LIVE_PIECE, lo - at)
            body = m - LIVE_GAP - LIVE_LEAD
            if body >= len(tp.samples):
                x, reps = lane(tp, body, seed=seed + i)
                lead = np.tile(x[:1024], LIVE_LEAD // 1024)
            else:  # no partial frame
                x, reps = np.full(max(body, 0), tp.samples[-1], np.float32), 0
                lead = np.full(LIVE_LEAD, tp.samples[-1], np.float32)
            gap = np.float32(2e-3) * rng.standard_normal(LIVE_GAP).astype(
                np.float32)
            parts.append(np.concatenate([gap, lead, x])[:m])
            sent += tp.sent * reps
            at += m
            i += 1
        if n:
            parts.append(np.float32(2e-3) * rng.standard_normal(n).astype(
                np.float32))
            at += n
    return np.concatenate(parts)[:total], sent


def live_child(out_path, argv, extra=None) -> int:
    """decode_cli's main(argv) in this process with observers on the bus:
    the wall time at which each raw block and each frame is published,
    the samples waiting in the decoder task's queue when the EOF block is
    published, and the tasks' statuses, with what `extra()` returns after
    main; written to out_path as JSON.  Returns main's exit code."""
    import nfclab_torch.runtime.pipeline as rp
    from nfclab_torch.apps import decode_cli
    from nfclab_torch.runtime.subject import Subject

    tasks, raw, frames, rec = [], [], [], {"statuses": []}

    class Recorded(rp.RadioDecoderTask):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            tasks.append(self)

    rp.RadioDecoderTask = Recorded

    def on_raw(buf):
        t = time.perf_counter()
        if buf.valid:
            raw.append((int(buf.offset), int(buf.elements), t))
        elif "eof_t" not in rec:
            # observers run in subscription order: the EOF block is not
            # in the decoder's queue yet
            q = tasks[0].signal_queue
            with q.mutex:
                rec["pending_at_eof"] = sum(b.elements for b in q.queue)
            rec["eof_t"] = t

    def on_frame(f):
        t = time.perf_counter()
        if f is not None:
            frames.append((int(f.sample_end), t))
        else:
            rec.setdefault("sentinel_t", t)

    Subject.name("radio.signal.raw").subscribe(on_raw, replay=False)
    Subject.name("radio.decoder.frame").subscribe(on_frame, replay=False)
    Subject.name("radio.decoder.status").subscribe(rec["statuses"].append,
                                                   replay=False)
    rc = decode_cli.main(argv)
    rec.update(rc=rc, raw=raw, frames=frames,
               receiver=Subject.name("radio.receiver.status").value,
               **(extra() if extra is not None else {}))
    Path(out_path).write_text(json.dumps(rec))
    return rc


def run_live_cli(iq, frontend, tag, paced=False):
    """`decode_cli live spyserver://...` in a subprocess (through
    live_child) against the port's MockSpyServer serving `iq`, paced at
    RATE or unpaced: (frame lines, live_child's record)."""
    from torch_sdr_mocks import MockSpyServer

    out = ROOT / "chiprun_out" / "chip_smoke" / f"live_{tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    srv = MockSpyServer(iq, chunk=LIVE_MSG_PACED if paced else LIVE_MSG_UNPACED,
                        rate=RATE if paced else None)
    argv = ["live", f"spyserver://127.0.0.1:{srv.port}", "--json",
            "--no-settings", "--sample-rate", str(RATE), "--frontend",
            frontend, "--timeout", "60"]
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.live_child(sys.argv[1], sys.argv[2:]))")
    proc = subprocess.run([sys.executable, "-c", code, str(out), *argv],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    srv.thread.join(timeout=30)
    if proc.returncode != 0:
        raise AssertionError(f"decode_cli live --frontend {frontend} "
                             f"({tag}) failed:\n{proc.stderr[-4000:]}")
    rec = json.loads(out.read_text())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return lines, rec


def live_reading(rec, lines, n):
    """Checks on one live CLI run and its numbers: the decoder task's
    last status "complete" and none "error" or with a fallback, no
    sample lost, every raw sample published; samples/s from the first raw
    block to the EOF sentinel; the publication lag of each frame (its
    publication minus that of the raw block holding its sample_end)."""
    import numpy as np

    sts = rec["statuses"]
    if (not sts or sts[-1].get("status") != "complete"
            or any(s.get("status") == "error" or "frontend_fallback" in s
                   for s in sts)):
        raise AssertionError(f"live decoder statuses: {sts[-3:]}")
    lost = (rec["receiver"] or {}).get("lost")
    if lost != 0:
        raise AssertionError(f"live source lost samples: {rec['receiver']}")
    raw = np.array(rec["raw"], np.float64)
    if raw[:, 1].sum() != n or len(rec["frames"]) != len(lines):
        raise AssertionError("live run: samples or frames missing")
    ends = raw[:, 0] + raw[:, 1]
    fr = np.array(rec["frames"], np.float64)
    at = np.minimum(np.searchsorted(ends, fr[:, 0], side="right"),
                    len(ends) - 1)
    lag = fr[:, 1] - raw[at, 2]
    wall = rec["sentinel_t"] - raw[0, 2]
    return {"samples": n, "wall_s": wall, "samples_per_s": n / wall,
            "realtime_x": n / wall / RATE, "frames": len(lines),
            "samples_lost": lost,
            "pending_at_eof": rec["pending_at_eof"],
            "raw_blocks": len(raw),
            "lag_s": {"median": float(np.median(lag)),
                      "p99": float(np.percentile(lag, 99)),
                      "max": float(lag.max())},
            "decoder_status": sts[-1]}


def run_live_launches(mag):
    """The live mask path in this process: RadioDecoderTask(frontend=
    "mask") fed `mag` in 65536-sample SignalBuffers through Executor, with
    the kernels' counts set to 0 just before it: (frames, its launches,
    launches per window, the farm's stats, peak device memory)."""
    import queue

    import torch

    import nfclab_torch.runtime.pipeline as rp
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.hw import SignalBuffer, SignalType
    from nfclab_torch.runtime.subject import Subject

    farms, windows = [], []

    class Counted(rp._MaskLiveDecoder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            farm = self._farm
            farms.append(farm)
            device_pass = farm._device_pass

            def counted(batch, base0):
                # dispatches run one at a time on the farm's IO thread
                s0, m0 = ff.SCAN.launches, ff.MASK.launches
                res = device_pass(batch, base0)
                windows.append((batch.shape[1], ff.SCAN.launches - s0,
                                ff.MASK.launches - m0))
                return res

            farm._device_pass = counted

    Subject.clear_registry()
    frames, sts, done = [], [], queue.Queue()
    Subject.name("radio.decoder.frame").subscribe(
        lambda f: done.put(None) if f is None else frames.append(f),
        replay=False)
    Subject.name("radio.decoder.status").subscribe(sts.append, replay=False)
    orig = rp._MaskLiveDecoder
    rp._MaskLiveDecoder = Counted
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        task = rp.RadioDecoderTask(frontend="mask")
        ex = rp.Executor(pool_size=1)
        for k in ff.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        ex.submit(task)
        raw = Subject.name("radio.signal.raw")
        for off in range(0, len(mag), 65536):
            raw.next(SignalBuffer(
                mag[off : off + 65536], RATE, off,
                signal_type=SignalType.SIGNAL_TYPE_RADIO_SAMPLES))
        raw.next(SignalBuffer.eof(RATE))
        done.get(timeout=600)
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in ff.KERNELS}
        ex.shutdown()
    finally:
        rp._MaskLiveDecoder = orig
    if any(s.get("status") == "error" or "frontend_fallback" in s
           for s in sts):
        raise AssertionError(f"in-process live task: {sts[-3:]}")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never ran on the live path")
    (farm,) = farms
    st = dict(farm.stats)
    return frames, {
        "wall_s": dt, "samples_per_s": len(mag) / dt,
        "segments": farm.segments, "launches": launches,
        "windows": st["dispatches"],
        "launches_per_window": [{"samples": w, "scan": a, "mask": b}
                                for w, a, b in windows],
        **{k: st[k] for k in ("seg_dispatches", "repaired_streams",
                              "repair_chunks", "seg_backoff_windows",
                              "device_s", "walk_s", "wait_s")},
        "max_memory_allocated": torch.cuda.max_memory_allocated()}


def live_chunk_ms(mag):
    """ms of both fused kernels over one 65536-sample chunk (CUDA events,
    3 launches after a warm-up) at the live path's two launch widths:
    B = 1 (the serial chain's windows, the first and the backoff ones,
    and the repairs) and B = 4 (a segmented window's lanes), on the
    capture's first samples from a zero state at base = the fold
    modulus."""
    import torch

    from nfclab_torch.dsp import fused_frontend as ff

    pt, _, mp = _params(RATE)
    plan = ff.kernel_plan(RATE)
    dev = torch.device("cuda", 0)
    out = {}
    for b in (1, 4):
        x = torch.from_numpy(mag[: b * 65536].reshape(b, 65536).T.copy())
        x = x.to(dev)
        st = torch.zeros(plan.nstate, b, device=dev)
        out[f"B{b}"] = _event_ms(
            lambda: ff.run_chunk(x, st, plan.fold_modulus, pt, mp, plan,
                                 ("detect_mask",)), 3)
    return out


def run_live_phase(templates):
    """Phase 11: live capture on the card through decode_cli live and the
    port's mock SpyServer.  (a) the capture unpaced, --frontend mask and
    then --frontend host: equal lines, both equal to the host
    StreamingNfcDecoder over iq_to_magnitude of the payload, the
    synthesizer's bytes in order with at most 1% missed; (b) its first
    LIVE_PACED samples paced at RATE with --frontend mask: publication
    lags and the queue at EOF; (c) the capture in this process through
    RadioDecoderTask(frontend="mask"), launches counted."""
    import numpy as np

    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.dsp.magnitude import iq_to_magnitude
    from nfclab_torch.runtime.streaming import StreamingNfcDecoder
    from torch_sdr_mocks import iq_int16

    t0 = time.perf_counter()
    x, sent = live_capture(templates)
    iq = iq_int16(x)
    del x
    mag = iq_to_magnitude((iq.astype(np.float32) / 32768.0).reshape(-1, 2))[0]

    def host(m):
        dec = StreamingNfcDecoder(RATE, window=1 << 20)
        out = []
        for off in range(0, len(m), 65536):
            out.extend(dec.feed(m[off : off + 65536]))
        out.extend(dec.finish())
        return out

    want = host(mag)
    want_lines = _frames_key(want)
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    missed = _missed([f.data for f in want if f.frame_type in keep], sent)
    if missed is None or missed > len(sent) // 100:
        raise AssertionError(f"live capture: {missed} of {len(sent)} "
                             "synthesized frames missed or out of order")
    out = {"capture": {"samples": len(mag), "synth_frames": len(sent),
                       "synth_missed": missed,
                       "build_and_host_decode_s": time.perf_counter() - t0}}
    for fe in ("mask", "host"):
        lines, rec = run_live_cli(iq, fe, f"11a_{fe}")
        if lines != want_lines:
            raise AssertionError(f"live --frontend {fe} lines != the host "
                                 "streaming decoder's")
        out[f"11a_{fe}"] = live_reading(rec, lines, len(mag))
    n = LIVE_PACED
    lines, rec = run_live_cli(iq[: 2 * n], "mask", "11b", paced=True)
    if lines != _frames_key(host(mag[:n])):
        raise AssertionError("paced live --frontend mask lines != the host "
                             "streaming decoder's")
    out["11b"] = live_reading(rec, lines, n)
    paced = (iq[: 2 * n], lines)  # phase 13b's input and reference
    got, out["11c"] = run_live_launches(mag)
    out["11c"]["chunk_ms"] = live_chunk_ms(mag)
    if _frames_key(got) != want_lines:
        raise AssertionError("in-process live task frames != host")
    if out["11c"]["segments"] != 4 or out["11c"]["seg_dispatches"] < 1:
        raise AssertionError(f"the live farm did not segment: {out['11c']}")
    return out, paced


LOGIC_RATE = 24_000_000   # phase 12: the logic tests' rate, 4 MHz card clock
LOGIC_STREAMS = 32        # 12c: CudaLogicFarm's streams
LOGIC_MAP_STREAMS = 16    # 12c under a channel map: the first 16 lanes
LOGIC_WINDOW = 1 << 20    # TpuLogicFarm's default k_samples
LOGIC_LANE = 2 * LOGIC_WINDOW   # 12c: 87 ms of capture a stream (4
                                # windows before phase 15)
LOGIC_ONE = 1 << 24       # 12b and 12d's live run: one stream, 0.70 s
LOGIC_BLOCK = 65536       # 12b: LogicSourceTask's block
LOGIC_FEED = 262_144      # 12c: samples a feed
LOGIC_SEED = 5000         # 12c: lanes 5000-5031; 12b and 12d: 5100
LOGIC_WIRING = [1, 2, 0, 3]     # probes carry [clk, rst, io, vcc]
LOGIC_CMAP = {"io": 2, "clk": 0, "rst": 1, "vcc": 3}
LOGIC_BYTES = 17          # a sample of the mask: 4 float32 in, 1 byte out


def _iso_data(frames):
    """The bytes of the ATR, PPS, TPDU and T=1 block frames, in order."""
    from nfclab_torch.core.frame import FrameType

    keep = {int(t) for t in (FrameType.IsoATRFrame, FrameType.IsoRequestFrame,
                             FrameType.IsoResponseFrame,
                             FrameType.IsoExchangeFrame)}
    return [f.data for f in frames if f.frame_type in keep]


def _iso_oneshot(x, sent, what):
    """The one-shot IsoDecoder's frames of x, which must carry the
    synthesizer's bytes."""
    from nfclab_torch.runtime.logic_decoder import IsoDecoder

    frames = IsoDecoder().decode(x, LOGIC_RATE)
    if _iso_data(frames) != sent or not sent:
        raise AssertionError(f"{what}: one-shot frames != synthesized bytes")
    return _frames_key(frames)


def run_logic_mask(lanes):
    """12a: logic_event_mask on the card at the farm's window, [32,
    LOGIC_WINDOW, 4] float32, over the lanes' first two windows with the
    carry threaded, bit for bit against device="cpu" on 4 of the streams
    (and on a block of special values: -0.0, NaN, +-inf, fractions); CUDA
    event ms per call on the second window, its bytes bound, peak memory
    over the input's bytes and the CUDA kernels one call launches
    (torch.profiler)."""
    import collections
    import re

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nfclab_torch.dsp.logic_frontend import logic_event_mask

    w = LOGIC_WINDOW
    chunks = [np.stack([x[k * w : (k + 1) * w] for x, _ in lanes])
              for k in (0, 1)]
    got, carries, carry = [], [], None
    for c in chunks:
        m, carry = logic_event_mask(c, carry)
        got.append(m.cpu())
        carries.append(carry)
    want, cc = [], None
    for c in chunks:
        m, cc = logic_event_mask(c[:4], cc, device="cpu")
        want.append(m)
    for k in (0, 1):
        if not torch.equal(got[k][:4], want[k]):
            raise AssertionError(f"logic mask chunk {k} != device='cpu'")
    if not torch.equal(carry[:4].cpu(), cc):
        raise AssertionError("logic mask carry != device='cpu'")
    rng = np.random.default_rng(LOGIC_SEED)
    levels = np.array([0, 1, -0.0, 0.5, 0.9921875, np.nan, np.inf, -np.inf],
                      np.float32)
    sp = rng.choice(levels, (4, 65536, 8)).astype(np.float32)
    a, ca = logic_event_mask(sp[:, :40_000])
    b, cb = logic_event_mask(sp[:, 40_000:], ca)
    ref, rc = logic_event_mask(sp, device="cpu")
    if not (torch.equal(torch.cat([a, b], 1).cpu(), ref)
            and torch.equal(cb.cpu().isnan(), rc.isnan())
            and torch.equal(cb.cpu().nan_to_num(), rc.nan_to_num())):
        raise AssertionError("logic mask on special values != device='cpu'")
    nonzero = int((got[0] != 0).sum() + (got[1] != 0).sum())
    del got, want, a, b

    x = torch.from_numpy(chunks[1]).cuda()
    c0 = carries[0]
    del chunks, carries
    ms = _event_ms(lambda: logic_event_mask(x, c0), 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    logic_event_mask(x, c0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logic_event_mask(x, c0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    # short names: the innermost functor (or copy) each kernel runs
    short = collections.Counter(
        (re.findall(r"\w+Functor\w*|direct_copy_kernel_cuda|"
                    r"compare_scalar_kernel", k) or [k[:60]])[-1]
        for k in kernels)
    n = x.shape[0] * x.shape[1]
    bound, by = _bound(LOGIC_BYTES * n, 0)
    return {"shape": list(x.shape), "ms": ms, "bound_ms": bound,
            "bound_by": by, "bound_share": bound / ms,
            "samples_per_s": n / (ms * 1e-3),
            "peak_work_bytes": peak, "input_bytes": x.numel() * 4,
            "peak_over_input": (peak + x.numel() * 4) / (x.numel() * 4),
            "kernels_per_call": len(kernels) if names else None,
            "kernels": dict(short),
            "nonzero_mask_samples": nonzero, "max_abs_err": 0.0}


def run_logic_stream(x, sent, want):
    """12b: one stream through StreamingIsoDecoder with the device and the
    host frontend, fed LOGIC_BLOCK samples at a time: frames equal to each
    other's, to the one-shot decoder's and to the synthesizer's bytes;
    the four event index sets equal; samples/s of each."""
    import numpy as np

    from nfclab_torch.runtime.logic_decoder import StreamingIsoDecoder

    out, decs = {}, {}
    for fe in ("device", "host"):
        dec = StreamingIsoDecoder(LOGIC_RATE, frontend=fe)
        frames = []
        t0 = time.perf_counter()
        for off in range(0, len(x), LOGIC_BLOCK):
            frames.extend(dec.feed(x[off : off + LOGIC_BLOCK]))
        frames.extend(dec.finish())
        dt = time.perf_counter() - t0
        frames.sort(key=lambda f: (f.sample_start, f.sample_end))
        if _frames_key(frames) != want or _iso_data(frames) != sent:
            raise AssertionError(f"StreamingIsoDecoder(frontend={fe!r}) "
                                 "frames != one-shot / synthesized")
        decs[fe] = dec
        out[fe] = {"wall_s": dt, "samples_per_s": len(x) / dt,
                   "frames": len(frames)}
    for k in ("io_edges", "io_falls", "line_edges", "clk_falls"):
        if not np.array_equal(decs["device"]._idx[k].view(),
                              decs["host"]._idx[k].view()):
            raise AssertionError(f"12b: {k} device != host")
    out["events"] = {k: int(decs["host"]._idx[k].n) for k in (
        "io_edges", "io_falls", "line_edges", "clk_falls")}
    out["samples"] = len(x)
    return out


def run_logic_farm(lanes, wants, channel_map=None):
    """12c: CudaLogicFarm(len(lanes), LOGIC_RATE) over the lanes (probes
    permuted by LOGIC_WIRING under a channel map), fed LOGIC_FEED samples
    at a time through one reused buffer: each stream's frames equal its
    lane's one-shot frames and the synthesizer's bytes.  Wall time,
    samples/s, the seconds of the IO thread's upload + mask + fetch
    (timed around the farm's _mask from outside), of the caller's walk
    (its streams' feed calls) and peak device memory."""
    import numpy as np
    import torch

    from nfclab_torch.runtime.farm import CudaLogicFarm

    n_s, total = len(lanes), len(lanes[0][0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    farm = CudaLogicFarm(n_s, LOGIC_RATE, channel_map=channel_map)
    disp, walk = [], [0.0]
    mask = farm._mask

    def timed_mask(batch):
        t = time.perf_counter()
        res = mask(batch)
        disp.append((batch.shape[1], time.perf_counter() - t))
        return res

    farm._mask = timed_mask
    for st in farm.streams:
        def timed_feed(*a, _f=st.feed, **k):
            t = time.perf_counter()
            res = _f(*a, **k)
            walk[0] += time.perf_counter() - t
            return res
        st.feed = timed_feed
    cols = LOGIC_WIRING if channel_map else [0, 1, 2, 3]
    frames = [[] for _ in lanes]
    buf = np.empty((n_s, LOGIC_FEED, 4), np.float32)
    t0 = time.perf_counter()
    for off in range(0, total, LOGIC_FEED):
        w = min(LOGIC_FEED, total - off)
        for i, (x, _) in enumerate(lanes):
            buf[i, :w] = x[off : off + w][:, cols]
        for i, new in enumerate(farm.feed(buf[:, :w])):
            frames[i].extend(new)
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_frames = 0
    for i, fr in enumerate(frames):
        fr.sort(key=lambda f: (f.sample_start, f.sample_end))
        if _frames_key(fr) != wants[i] or _iso_data(fr) != lanes[i][1]:
            raise AssertionError(f"logic farm stream {i} frames != one-shot "
                                 "/ synthesized")
        n_frames += len(fr)
    n = n_s * total
    return {"streams": n_s, "samples_a_stream": total,
            "channel_map": channel_map, "wall_s": dt,
            "samples_per_s": n / dt, "dispatches": len(disp),
            "dispatch_widths": sorted({w for w, _ in disp}),
            "dispatch_s": sum(s for _, s in disp), "walk_s": walk[0],
            "frames": n_frames, "max_memory_allocated": peak}


def logic_live_child(out_path, argv) -> int:
    """decode_cli's main(argv) on a logic URI in this process with
    observers on the bus: the wall time at which each raw block and each
    frame is published, the tasks' statuses and the receiver's; written
    to out_path as JSON.  Returns main's exit code."""
    from nfclab_torch.apps import decode_cli
    from nfclab_torch.runtime.subject import Subject

    raw, frames, rec = [], [], {"statuses": []}

    def on_raw(buf):
        t = time.perf_counter()
        if buf.valid:
            raw.append((int(buf.offset), int(buf.elements), t))

    def on_frame(f):
        t = time.perf_counter()
        if f is not None:
            frames.append((int(f.sample_end), t))
        else:
            rec.setdefault("sentinel_t", t)

    Subject.name("logic.signal.raw").subscribe(on_raw, replay=False)
    Subject.name("logic.decoder.frame").subscribe(on_frame, replay=False)
    Subject.name("logic.decoder.status").subscribe(rec["statuses"].append,
                                                   replay=False)
    rc = decode_cli.main(argv)
    rec.update(rc=rc, raw=raw, frames=frames,
               receiver=Subject.name("logic.receiver.status").value)
    Path(out_path).write_text(json.dumps(rec))
    return rc


def run_logic_cli(x, sent, want):
    """12d: (1) decode_cli run --json --channel-map on an 8-bit logic WAV of
    a lane with its probes permuted (LOGIC_WIRING): the one-shot decoder's
    frames of the WAV's samples, and the synthesizer's bytes; (2)
    decode_cli live logictcp://... in a subprocess against the port's
    MockLogicTcpServer serving x: the one-shot decoder's frames, no sample
    lost; samples/s from the first raw block to the EOF sentinel, against
    real time at LOGIC_RATE."""
    import numpy as np

    from nfclab_torch.io.wav import read_wav, write_wav
    from nfclab_torch.runtime.logic_decoder import IsoDecoder
    from torch_logic_synth import logic_lane
    from torch_sdr_mocks import MockLogicTcpServer

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    lane, lane_sent = logic_lane(LOGIC_LANE, LOGIC_SEED + 101)
    wav = out_dir / "logic_permuted.wav"
    write_wav(str(wav), np.ascontiguousarray(lane[:, LOGIC_WIRING]),
              LOGIC_RATE, bits=8)
    samples, _ = read_wav(str(wav))
    wav_want = _frames_key(IsoDecoder(channel_map=LOGIC_CMAP).decode(
        samples, LOGIC_RATE))
    cmap = ",".join(f"{k}={v}" for k, v in LOGIC_CMAP.items())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
         "--json", "--channel-map", cmap, str(wav)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    run_s = time.perf_counter() - t0
    wav.unlink()
    if proc.returncode != 0:
        raise AssertionError(f"decode_cli run (logic) failed:\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    if lines != wav_want:
        raise AssertionError("decode_cli run --channel-map lines != the "
                             "one-shot decoder's")
    got = IsoDecoder().decode(samples[:, np.argsort(LOGIC_WIRING)],
                              LOGIC_RATE)
    if _frames_key(got) != lines or _iso_data(got) != lane_sent:
        raise AssertionError("decode_cli run (logic): frames != synthesized")
    out = {"run": {"samples": len(lane), "lines": len(lines),
                   "subprocess_s": run_s}}

    rec_path = out_dir / "logic_live.json"
    srv = MockLogicTcpServer(x, LOGIC_RATE)
    argv = ["live", f"logictcp://127.0.0.1:{srv.port}", "--json",
            "--no-settings", "--sample-rate", str(LOGIC_RATE),
            "--timeout", "60"]
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.logic_live_child("
            "sys.argv[1], sys.argv[2:]))")
    proc = subprocess.run([sys.executable, "-c", code, str(rec_path), *argv],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    srv.thread.join(timeout=30)
    if proc.returncode != 0:
        raise AssertionError(f"decode_cli live logictcp failed:\n"
                             f"{proc.stderr[-4000:]}")
    rec = json.loads(rec_path.read_text())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if lines != want:
        raise AssertionError("decode_cli live logictcp lines != the one-shot "
                             "decoder's")
    if any(s.get("status") == "error" for s in rec["statuses"]):
        raise AssertionError(f"live logic decoder: {rec['statuses'][-3:]}")
    lost = (rec["receiver"] or {}).get("lost")
    raw = np.array(rec["raw"], np.float64)
    if lost != 0 or raw[:, 1].sum() != len(x):
        raise AssertionError(f"live logic: samples lost ({lost}) or "
                             f"missing ({raw[:, 1].sum()} of {len(x)})")
    wall = rec["sentinel_t"] - raw[0, 2]
    out["live"] = {"samples": len(x), "frames": len(lines),
                   "raw_blocks": len(raw), "wall_s": wall,
                   "samples_per_s": len(x) / wall,
                   "realtime_x": len(x) / wall / LOGIC_RATE,
                   "samples_lost": lost}
    return out


def run_logic_phase():
    """Phase 12: the ISO7816 logic path on the card (12a-12d)."""
    from torch_logic_synth import logic_lane

    t0 = time.perf_counter()
    lanes = [logic_lane(LOGIC_LANE, LOGIC_SEED + i)
             for i in range(LOGIC_STREAMS)]
    one, one_sent = logic_lane(LOGIC_ONE, LOGIC_SEED + 100)
    built = time.perf_counter() - t0
    out = {"card": card_line(), "build_lanes_s": built,
           "12a": run_logic_mask(lanes)}
    log(f"12a logic mask: {json.dumps(out['12a'])}")
    t1 = time.perf_counter()
    one_want = _iso_oneshot(one, one_sent, "12b lane")
    wants = [_iso_oneshot(x, s, f"12c lane {i}")
             for i, (x, s) in enumerate(lanes)]
    out["oneshot_s"] = time.perf_counter() - t1
    out["oneshot_samples_per_s"] = ((len(one) + LOGIC_STREAMS * LOGIC_LANE)
                                    / out["oneshot_s"])
    out["12b"] = run_logic_stream(one, one_sent, one_want)
    log(f"12b one stream: {json.dumps(out['12b'])}")
    out["12c"] = run_logic_farm(lanes, wants)
    log(f"12c logic farm: {json.dumps(out['12c'])}")
    out["12c_channel_map"] = run_logic_farm(
        lanes[:LOGIC_MAP_STREAMS], wants[:LOGIC_MAP_STREAMS], LOGIC_CMAP)
    log(f"12c logic farm, channel map: {json.dumps(out['12c_channel_map'])}")
    del lanes, wants
    out["12d"] = run_logic_cli(one, one_sent, one_want)
    log(f"12d logic CLI: {json.dumps(out['12d'])}")
    return out


SPECTRUM_SHAPES = (          # phase 13a: (rows, IQ pairs a row, rate)
    (1, 1024, RATE),         # FourierTask's block: one 1024-point row
    (4096, 1024, RATE),
    (256, 2048, 2 * RATE),   # decimation 2
)
SPECTRUM_TOL = 1e-5          # of each row's maximum, against device="cpu"
SPECTRUM_TONE = 1.2e6        # 13a: peaks at bin 512 + 123
SPECTRUM_BLOCKS = 200        # 13a: FourierTask-shaped calls timed


def _spectrum_err(got, want):
    """Largest |got - want| over each row's maximum; raises unless within
    SPECTRUM_TOL with argmax equal."""
    import numpy as np

    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    if g.shape != w.shape or got.dtype != np.float32:
        raise AssertionError(f"spectrum shape {got.shape} {got.dtype}")
    err = float((np.abs(g - w).max(axis=1) / w.max(axis=1)).max())
    if not err <= SPECTRUM_TOL or not np.array_equal(g.argmax(axis=1),
                                                     w.argmax(axis=1)):
        raise AssertionError(f"spectrum on the card != cpu: {err}")
    return err


def _wall_ms(fn, reps):
    """Host ms a call of fn (which ends in a device sync), after one
    warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_spectrum():
    """13a: SpectrumProcessor on the card against device="cpu" on seeded
    IQ at SPECTRUM_SHAPES and every window, within SPECTRUM_TOL of each
    row's maximum with argmax equal; a 1.2 MHz tone's peak bin; CUDA event
    ms of the batched calls' device work (spectrum() on the uploaded rows)
    beside their bound; wall us a block at FourierTask's shape (upload,
    FFT, fetch); peak device memory."""
    import numpy as np
    import torch

    from nfclab_torch.dsp.spectrum import SpectrumProcessor, spectrum

    out, worst = {"calls": {}}, 0.0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for b, n, rate in SPECTRUM_SHAPES:
        dec = max(1, int(rate / 10e6))
        iq = np.random.default_rng(b + n).standard_normal(
            (b, n, 2)).astype(np.float32)
        if b == 1:
            iq = iq[0]
        for window in (0, 1, 2):
            card = SpectrumProcessor(window=window)
            got = card.process(iq, rate)
            want = SpectrumProcessor(window=window,
                                     device="cpu").process(iq, rate)
            worst = max(worst, _spectrum_err(got, want))
        if b == 1:
            continue
        # the device work of one batched call, on the rows it uploads
        x = torch.from_numpy(iq[:, : 1024 * dec]).cuda()
        ms = _event_ms(lambda: spectrum(x, card._window, dec), 10)
        ops = 5 * 1024 * np.log2(1024) * b   # radix-2 FFT flops a row
        nbytes = b * 1024 * 8 + 1024 * 4 + b * 1024 * 4
        bound, by = _bound(nbytes, ops)
        out["calls"][f"{b}x{n}@{rate}"] = {
            "ms": ms, "bound_ms": bound, "bound_by": by,
            "process_ms": _wall_ms(lambda: card.process(iq, rate), 5)}
        del x
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    t = np.arange(4096) / RATE
    tone = np.stack([np.cos(2 * np.pi * SPECTRUM_TONE * t),
                     np.sin(2 * np.pi * SPECTRUM_TONE * t)],
                    axis=-1).astype(np.float32)
    card = SpectrumProcessor()
    peak = int(np.argmax(card.process(tone, RATE)))
    expect = 512 + int(round(SPECTRUM_TONE / RATE * 1024))
    if abs(peak - expect) > 1:
        raise AssertionError(f"tone peak at bin {peak}, not {expect}")
    block = np.random.default_rng(1).standard_normal(
        (65536, 2)).astype(np.float32)   # one paced SpyServer message
    out["block_us"] = _wall_ms(lambda: card.process(block, RATE),
                               SPECTRUM_BLOCKS) * 1e3
    out.update(max_rel_err=worst, tone_peak_bin=peak)
    return out


def monitor_child(out_path, argv) -> int:
    """live_child with the monitor read from inside: the kernels' counts
    set to 0 just before main and read just after, the signal.fft buffers
    counted, the page and the last /data snapshot fetched just before the
    server stops (tests/torch_monitor.PolledMonitor), the detail trees
    the port's ProtocolParser gives the published frames in order, and
    the seconds spent in what the monitor adds (the split): the spectrum
    (SpectrumProcessor.process, on FourierTask's thread), resample_radio
    (ResamplingTask's), MonitorState's bus observers (on the publishers'
    threads: frames on the decoder's) and its snapshots (the server's)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_monitor

    from nfclab_torch.apps import monitor
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.dsp import resample, spectrum
    from nfclab_torch.protocol.parser import ProtocolParser
    from nfclab_torch.runtime.subject import Subject

    split = {}

    def timed(owner, name, key):
        fn = getattr(owner, name)
        split[key] = 0.0

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[key] += time.perf_counter() - t

        setattr(owner, name, wrapper)

    timed(spectrum.SpectrumProcessor, "process", "spectrum_s")
    timed(resample, "resample_radio", "resample_s")
    for name in ("_on_frame", "_on_fft", "_on_wave", "snapshot"):
        timed(monitor.MonitorState, name, f"state{name}_s")
    polled = torch_monitor.polled_monitor()
    monitor.MonitorServer = polled
    frames, ffts = [], []
    Subject.name("radio.decoder.frame").subscribe(frames.append,
                                                  replay=False)
    Subject.name("signal.fft").subscribe(
        lambda b: ffts.append(len(b.data)), replay=False)
    for k in ff.KERNELS:
        k.launches = 0

    def extra():
        launches = {k.name: k.launches for k in ff.KERNELS}
        parser, details = ProtocolParser(), []
        for f in frames:
            if f is None:
                parser.reset()
                continue
            node = parser.parse(f)
            details.append(node.to_json() if node is not None else None)
        (mon,) = polled.instances
        return {"launches": launches, "fft_buffers": len(ffts),
                "fft_bins": sorted(set(ffts)), "details": details,
                "page": mon.page, "last": mon.last, "split_s": split}

    return live_child(out_path, argv, extra)


def run_monitor_cli(iq, want_lines):
    """13b: decode_cli live --frontend mask --monitor 0 --json in a
    subprocess (monitor_child) against the mock SpyServer serving `iq`
    paced at RATE.  This process reads the URL from its stderr and polls
    /data while the capture runs; the last snapshot (taken in the child
    just before the server stops) must hold the last printed frames with
    the parser's detail trees, the spectrum, waterfall, wave and the four
    statuses; the printed lines must equal phase 11b's."""
    import re
    import threading
    import urllib.request

    import torch_monitor
    from torch_sdr_mocks import MockSpyServer

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out, log_path = out_dir / "live_13b.json", out_dir / "live_13b.stdout"
    srv = MockSpyServer(iq, chunk=LIVE_MSG_PACED, rate=RATE)
    argv = ["live", f"spyserver://127.0.0.1:{srv.port}", "--json",
            "--no-settings", "--sample-rate", str(RATE), "--frontend",
            "mask", "--timeout", "60", "--monitor", "0"]
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.monitor_child(sys.argv[1], sys.argv[2:]))")
    polls, err = [], []

    def poll(proc):
        for line in proc.stderr:
            err.append(line)
            m = re.match(r"# monitor: (http://127\.0\.0\.1:\d+)/", line)
            if m:
                break
        else:
            return
        rest = threading.Thread(target=lambda: err.extend(proc.stderr),
                                daemon=True)
        rest.start()
        while proc.poll() is None:
            try:
                snap = json.loads(torch_monitor.get(m.group(1) + "/data",
                                                    timeout=5))
            except OSError:
                break  # the server stopped
            polls.append((time.perf_counter(), len(snap["frames"]),
                          bool(snap["spectrum"])))
            time.sleep(0.25)
        rest.join(timeout=30)

    with open(log_path, "w") as stdout:
        proc = subprocess.Popen([sys.executable, "-c", code, str(out), *argv],
                                stdout=stdout, stderr=subprocess.PIPE,
                                text=True, cwd=ROOT)
        poller = threading.Thread(target=poll, args=(proc,), daemon=True)
        poller.start()
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        poller.join(timeout=60)
    srv.thread.join(timeout=30)
    if proc.returncode != 0:
        raise AssertionError("decode_cli live --monitor failed:\n"
                             + "".join(err)[-4000:])
    rec = json.loads(out.read_text())
    lines = [ln for ln in log_path.read_text().splitlines()
             if ln.startswith("{")]
    if lines != want_lines:
        raise AssertionError("live --monitor lines != phase 11b's")
    res = live_reading(rec, lines, len(iq) // 2)
    res["monitor"] = torch_monitor.check_snapshot(rec["last"], lines,
                                                  rec["details"])
    if "nfclab live monitor" not in rec["page"]:
        raise AssertionError("the monitor's page was not served")
    if not polls or not any(n for _, n, _ in polls):
        raise AssertionError(f"no frames polled while the capture ran: "
                             f"{polls[-3:]}")
    for name, c in rec["launches"].items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never ran on the monitored "
                                 "live path")
    res.update(launches=rec["launches"], fft_buffers=rec["fft_buffers"],
               fft_bins=rec["fft_bins"], split_s=rec["split_s"],
               polls=len(polls),
               polls_with_frames=sum(1 for _, n, _ in polls if n),
               polls_with_spectrum=sum(1 for *_, s in polls if s))
    if rec["fft_buffers"] < 1 or rec["fft_bins"] != [1024]:
        raise AssertionError(f"signal.fft buffers: {rec['fft_buffers']} "
                             f"{rec['fft_bins']}")
    return res


def _page_frames(page: str):
    """(tech, type, command, data) of the frames JSON a report embeds."""
    body = page.split('<script type="application/json" id="frames-json">')[1]
    return [(a["tech"], a["type"], a["command"], a["data"])
            for a in json.loads(body.split("</script>")[0])]


def run_reports(templates):
    """13c: decode_cli run --html with --frontend mask on the template
    WAVs writes --frontend host's page byte for byte; their host frames
    written to a TRZ with the port's io.trz give, through `python -m
    nfclab_torch.tools.trace_cli X.trz --html`, a frame table with the
    same events and data."""
    from nfclab_torch.io.trz import write_trace
    from nfclab_torch.io.wav import read_wav, write_wav
    from nfclab_torch.runtime.decoder import NfcDecoder

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    paths, frames = [], []
    for tp in templates:
        paths.append(str(out_dir / f"{tp.name}.wav"))
        write_wav(paths[-1], tp.samples, RATE)
        x, info = read_wav(paths[-1])
        frames += NfcDecoder().decode(x, info.sample_rate)
    pages, procs = {}, {}
    t0 = time.perf_counter()
    for fe in ("host", "mask"):  # both at once
        procs[fe] = subprocess.Popen(
            [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
             "--json", "--frontend", fe, "--html",
             str(out_dir / f"report_{fe}.html"), *paths],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            cwd=ROOT)
    for fe, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"run --html --frontend {fe} failed:\n"
                                 f"{err[-4000:]}")
        pages[fe] = (out_dir / f"report_{fe}.html").read_bytes()
    res = {"run_both_s": time.perf_counter() - t0}
    if pages["mask"] != pages["host"]:
        raise AssertionError("run --html --frontend mask page != host's")
    trz, page = out_dir / "templates.trz", out_dir / "trace.html"
    write_trace(str(trz), frames)
    proc = subprocess.run(
        [sys.executable, "-m", "nfclab_torch.tools.trace_cli", str(trz),
         "--html", str(page)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"trace_cli --html failed:\n{proc.stderr}")
    got = _page_frames(page.read_text(encoding="utf-8"))
    want = _page_frames(pages["host"].decode("utf-8"))
    if got != want or not got:
        raise AssertionError("trace_cli's frame table != run --html's")
    res.update(page_bytes=len(pages["host"]), frames=len(got),
               commands=sorted({c for *_, c, _ in got if c}))
    return res


def run_monitor_phase(templates, paced, live_11b):
    """Phase 13: the spectrum, the live monitor and the reports."""
    t0 = time.perf_counter()
    out = {"card": card_line(), "13a": run_spectrum()}
    log(f"13a spectrum: {json.dumps(out['13a'])}")
    iq, lines = paced
    out["13b"] = run_monitor_cli(iq, lines)
    out["13b"]["without_monitor_11b"] = {
        k: live_11b[k] for k in ("realtime_x", "lag_s", "pending_at_eof")}
    log(f"13b live --monitor: {json.dumps(out['13b'])}")
    out["13c"] = run_reports(templates)
    log(f"13c reports: {json.dumps(out['13c'])}")
    out["phase_s"] = time.perf_counter() - t0
    return out


SHARD_PREFIX = 1 << 21    # 14a: samples held against a CPU run
SHARD_LANES = 3           # 14a: template repeats in each noisy lane
# 14a: (count, sha256 of the JSON lines) of nfclab's decode_sharded frames on
# long_capture's first SHARD_PREFIX samples, held against nfclab by
# tests/test_torch_shard.py::test_noise_free_capture_frames_match_nfclab
SHARD_NFCLAB_FRAMES = (
    30, "4f2bd3f6982148fca454bc7a025c637c26add2958722442b87cf57db98ddf94d")


def _frames_against(got, want):
    """How two frame lists (JSON lines) part: equal lines, lines only in
    each, and lines equal but for their timing keys."""
    def untimed(lines):
        return {json.dumps({k: v for k, v in json.loads(ln).items()
                            if k not in TIMING_KEYS}, sort_keys=True)
                for ln in lines}

    g, w = set(got), set(want)
    return {"frames": len(got), "reference": len(want),
            "equal": len(g & w), "only_here": len(g - w),
            "only_in_reference": len(w - g),
            "untimed_only_here": len(untimed(got) - untimed(want)),
            "untimed_only_in_reference": len(untimed(want) - untimed(got))}


def shard_child(out_path, cap_path, host_path, *wavs) -> int:
    """Phase 14a in its own process: world size 1 on NCCL (shard/launch.
    initialize over a file store), the blocks layout on the card, the
    capture and its host frames from files; then, with the group
    destroyed, 14d: validate_cuda_shard_kernel's entry point on the WAVs.
    The record goes to out_path as JSON."""
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.dsp.cuda_channels import fused_capture_channels
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.native import condition_exact
    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.shard import multichip as sm
    from nfclab_torch.shard.launch import global_mesh, initialize
    from torch_dist_child import digest
    from torch_synth import lane, templates

    initialize(f"file://{Path(out_path).with_suffix('.store')}", 1, 0,
               device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"world size 1 on {dist.get_backend()}")
    mesh = global_mesh(device="cuda")
    x = np.load(cap_path)["samples"]
    host = json.loads(Path(host_path).read_text())
    kernels = (*ff.KERNELS, ck.COND)
    rec = {"card": card_line(), "backend": dist.get_backend(), "world": 1,
           "samples": len(x)}

    def counted(fn, need):
        """fn() with the kernels' counts set to 0 just before and read
        just after; every kernel of `need` must have run."""
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = {k.name: k.launches for k in kernels}
        for name in need:
            if n[name] <= 0:
                raise AssertionError(f"{name} never ran on the shard path")
        return out, {"s": dt, "launches": n}

    # the kernel path against the one-process block layout, bit for bit
    kc, rec["kernel_path"] = counted(
        lambda: sm.sharded_kernel_channels(x, RATE, mesh=mesh),
        ("fused_scan", "fused_mask"))
    ref = fused_capture_channels(x, RATE, device="cuda")
    if set(kc) != set(ref) or not all(
            kc[k].dtype == ref[k].dtype and np.array_equal(
                kc[k].view(np.uint8), ref[k].view(np.uint8)) for k in ref):
        raise AssertionError("sharded_kernel_channels != "
                             "fused_capture_channels on the card")
    del ref
    log(f"14a sharded_kernel_channels == fused_capture_channels (bit for "
        f"bit, {len(kc)} channels): {json.dumps(rec['kernel_path'])}")

    # the first rows' conditioning: row 0 from clock = pulse = -H over its
    # zero halo, row 1 from 0 over row 0's tail; the kernel against the
    # plain version, row 0's body against a fresh stream of the oracle
    L, H = sm.DEFAULT_L, sm.DEFAULT_H
    rows, _, _ = sm._layout_rows(x[: 2 * L], L, 1)
    win, first, _ = sm._left_windows(torch.from_numpy(rows).cuda(), mesh, 2,
                                     L, H)
    z = torch.zeros(2, device="cuda")
    neg = torch.where(first, -H, 0).to(torch.int32)
    pt = _params_tuple(SignalParams(RATE))
    card = ck.condition_scan(win, z, z, z, z, neg, neg, pt)
    plain = ck.condition_scan_plain(win.cpu(), z.cpu(), z.cpu(), z.cpu(),
                                    z.cpu(), neg.cpu(), neg.cpu(), pt)
    for a, b in zip(card, plain):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("condition_scan from clock -H != its plain "
                                 "version")
    oracle = condition_exact(x[:L], SignalParams(RATE))
    for name, i in (("envelope", 0), ("deviation", 2), ("average", 3),
                    ("filtered", 4)):
        a = card[i][0, H:].cpu().numpy()
        if not np.array_equal(a.view(np.uint32),
                              getattr(oracle, name).view(np.uint32)):
            raise AssertionError(f"row 0 {name} != a fresh stream")
    log("14a first rows: condition_scan from clock = pulse = -H equals its "
        "plain version (rows 0-1) and row 0's body a fresh stream of the "
        "C++ oracle, bit for bit")

    # the capture path, on the card against a CPU run of its prefix, bit
    # for bit
    cc, rec["capture_path"] = counted(
        lambda: sm.sharded_capture_channels(x, RATE, mesh=mesh),
        ("condition_scan",))
    xp = x[:SHARD_PREFIX]
    t0 = time.perf_counter()
    cpu = sm.sharded_capture_channels(xp, RATE,
                                      mesh=global_mesh(device="cpu"))
    rec["capture_path"]["cpu_prefix_s"] = time.perf_counter() - t0
    for k, v in cpu.items():
        if not np.array_equal(cc[k][:SHARD_PREFIX].view(np.uint8),
                              v.view(np.uint8)):
            raise AssertionError(f"sharded {k}: card != CPU")
    log(f"14a sharded_capture_channels == its CPU run on {SHARD_PREFIX} "
        f"samples (bit for bit): {json.dumps(rec['capture_path'])}")

    # decode_sharded: on the prefix nfclab's frames, frame for frame; on
    # the whole capture against phase 7's host frames
    head = _frames_key(sm.decode_sharded(xp, RATE, mesh=mesh))
    pinned = (len(head),
              hashlib.sha256("\n".join(head).encode()).hexdigest())
    if pinned != SHARD_NFCLAB_FRAMES:
        raise AssertionError(f"decode_sharded on the prefix: {pinned} != "
                             f"nfclab's {SHARD_NFCLAB_FRAMES}")
    if head != _frames_key(NfcDecoder().decode(xp, RATE, tpu_channels=cpu)):
        raise AssertionError("decode_sharded on the prefix: card != CPU")
    rec["prefix_frames"] = {"frames": len(head), "equal_nfclab": True}
    frames, rec["decode"] = counted(
        lambda: sm.decode_sharded(x, RATE, mesh=mesh), ("condition_scan",))
    got = _frames_key(frames)
    if got != _frames_key(NfcDecoder().decode(x, RATE, tpu_channels=cc)):
        raise AssertionError("decode_sharded != the walk over its channels")
    rec["decode"]["against_host"] = _frames_against(got, host)
    mask_only = _frames_key(NfcDecoder().decode(
        x, RATE, tpu_channels={"detect_mask": cc["detect_mask"]}))
    if mask_only != host:
        raise AssertionError("the host walk over the sharded detect_mask "
                             "alone != phase 7's host frames")
    rec["decode"]["mask_only_equals_host"] = True
    log(f"14a decode_sharded: the prefix's {len(head)} frames == nfclab's; "
        f"whole capture {json.dumps(rec['decode'])}")

    # noisy lanes (seeded gain, offset, noise) of the five templates
    moved = []
    for i, tp in enumerate(templates()):
        y, _ = lane(tp, SHARD_LANES * len(tp.samples), seed=300 + i)
        g = sm.decode_sharded(y, RATE, mesh=mesh)
        w = NfcDecoder().decode(y, RATE)
        shift = _timing_shift(_frames_key(g), _frames_key(w))
        if shift is None or shift[0] > 2:
            raise AssertionError(f"decode_sharded on the {tp.name} lane "
                                 "!= host beyond 2 samples")
        moved.append(sum(a != b for a, b in zip(_frames_key(g),
                                                 _frames_key(w))))
    rec["lanes_moved_frames"] = moved
    log(f"14a decode_sharded on the five noisy template lanes == host but "
        f"for bounds moved by <= 2 samples in {moved} frames")
    rec["digests"] = {"cap": {k: digest(v) for k, v in cc.items()},
                      "ker": {k: digest(v) for k, v in kc.items()},
                      "frames": got}
    dist.destroy_process_group()

    import contextlib
    import io

    from nfclab_torch.tools import validate_cuda_shard_kernel

    buf, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = validate_cuda_shard_kernel.main(list(wavs))
    lines = buf.getvalue().splitlines()
    if (code != 0 or lines[-1:] != ["OK"]
            or sum("bit-exact" in ln for ln in lines) != len(wavs)):
        raise AssertionError(f"14d validate_cuda_shard_kernel: {lines}")
    rec["validate"] = {"wavs": len(wavs), "s": time.perf_counter() - t0,
                       "lines": lines[:-1]}
    Path(out_path).write_text(json.dumps(rec))
    return 0


def run_shard_phase(templates, host_frames, out_dir):
    """Phase 14: sharding on the card, in subprocesses, one at a time.
    (a) world size 1 on NCCL on phase 7's long capture, then (d)
    validate_cuda_shard_kernel's entry point on the template WAVs, in one
    process (shard_child); (b) two gloo ranks sharing the card
    (tests/torch_dist_child.py); (c) scaling_bench at world size 1 with
    --cuda."""
    import tempfile

    import numpy as np

    from torch_dist_child import run_world

    from nfclab_torch.shard.multichip import DEFAULT_H, DEFAULT_L

    t0 = time.perf_counter()
    out = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cap = tmp / "capture.npz"
        np.savez(cap, samples=long_capture(templates), rate=RATE)
        (tmp / "host.json").write_text(json.dumps(host_frames))
        code = ("import sys, chip_smoke; sys.exit(chip_smoke.shard_child("
                "*sys.argv[1:]))")
        paths = [str(out_dir / f"{tp.name}.wav") for tp in templates]
        proc = subprocess.run(
            [sys.executable, "-c", code, str(tmp / "a.json"), str(cap),
             str(tmp / "host.json"), *paths],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        for ln in proc.stdout.splitlines():
            log("  " + ln)
        if proc.returncode != 0:
            raise AssertionError(f"phase 14a failed:\n{proc.stderr[-4000:]}")
        a = json.loads((tmp / "a.json").read_text())
        want = a.pop("digests")
        out["14d"] = a.pop("validate")
        out["14a"] = a
        log(f"14d validate_cuda_shard_kernel on {len(paths)} template WAVs: "
            f"OK ({out['14d']['s']:.1f} s)")

        (tmp / "b").mkdir()
        t1 = time.perf_counter()
        ranks = run_world(2, cap, tmp / "b", device="cuda", backend="gloo",
                          kernel_lh=(DEFAULT_L, DEFAULT_H), timeout=300)
        b_s = time.perf_counter() - t1
    for r, rk in enumerate(ranks):
        if (rk["cap"] != want["cap"] or rk["ker"] != want["ker"]
                or rk["frames"] != want["frames"]):
            raise AssertionError(f"14b rank {r} of 2 (gloo, one card) != "
                                 "world size 1")
    out["14b"] = {"ranks": 2, "backend": "gloo", "wall_s": b_s,
                  "decode_s": [rk["decode_s"] for rk in ranks],
                  "kernel_s": [rk["kernel_s"] for rk in ranks]}
    log(f"14b two gloo ranks on one card == world size 1 (channels of both "
        f"paths bit for bit, frames): {json.dumps(out['14b'])}")

    proc = subprocess.run(
        [sys.executable, "-m", "nfclab_torch.tools.scaling_bench",
         "--devices", "1", "--cuda"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"14c scaling_bench failed:\n{proc.stderr}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    if ([r["metric"] for r in rows]
            != ["sharded_frontend_samples_per_second",
                "fused_kernel_samples_per_second_per_card"]
            or not all(r["value"] > 0 for r in rows)
            or not 0.0 <= rows[0]["collective_share"] < 1.0):
        raise AssertionError(f"14c scaling_bench: {rows}")
    out["14c"] = rows
    log(f"14c scaling_bench: {json.dumps(rows)}")
    out["phase_s"] = time.perf_counter() - t0
    return out


TOOLS_LANES = 4           # phase 15: NFC lanes of validate_cuda_farm
TOOLS_LANE = 1 << 20      # their samples: 4 windows at k_chunks 4
TOOLS_LOGIC_LANE = 1 << 22   # samples of the logic lane (24 MS/s)
TOOLS_LOGIC_TPDUS = (     # nfclab's validate_tpu_logic TPDUs
    (0x00, 0xA4, 0x04, 0x00, 0x02, 0xA4, 0x3F, 0x00, 0x90, 0x00),
    (0x00, 0xB0, 0x00, 0x08, 0x00, 0x6A, 0x82),
)
TOOLS_STREAMING = ("--total", "2000000", "--farm-total", "262144")


def _tool_kernels():
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.dsp.conditioner_kernel import COND

    return (*ff.KERNELS, COND)


def tools_child(out_path, name, *argv) -> int:
    """run_tool(name, argv) in a child process of its own, so that CUDA
    starts there only when the tool starts it; writes its reading to
    out_path."""
    run, _ = run_tool(name, argv)
    Path(out_path).write_text(json.dumps(run))
    return 0


def run_tool(name, argv, need=()):
    """nfclab_torch.tools.<name>.main(argv) in this process, its standard
    output captured (and logged indented), the kernels' counts set to 0
    just before and read just after; main must return 0 and each kernel
    in `need` must have run.  Returns ({"rc", "s", "launches"}, output)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"nfclab_torch.tools.{name}")
    kernels = _tool_kernels()
    for k in kernels:
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([str(a) for a in argv])
    out = {"rc": rc, "s": time.perf_counter() - t0,
           "launches": {k.name: k.launches for k in kernels}}
    for ln in buf.getvalue().splitlines():
        log("  " + ln[:400])
    if rc != 0:
        raise AssertionError(f"15 {name} {' '.join(map(str, argv))} "
                             f"returned {rc}")
    for kname in need:
        if out["launches"][kname] <= 0:
            raise AssertionError(f"15 {name}: kernel {kname} never ran")
    log(f"15 {name}: {json.dumps(out)}")
    return out, buf.getvalue()


def tools_inputs(templates, tmp):
    """Phase 15's seeded inputs under tmp: templates/ (each template as a
    16-bit WAV), lanes/ (TOOLS_LANES torch_synth lanes of TOOLS_LANE
    samples), each NFC WAV with the golden JSON of the host frontend's
    frames of what it holds beside it; logic/ (8-bit 4-channel sessions
    of nfclab's TPDUs and one logic_lane)."""
    from torch_logic_synth import SAMPLE_RATE, logic_lane, make_session
    from torch_synth import lane

    from nfclab_torch.io.golden import write_golden_frames
    from nfclab_torch.io.wav import read_wav, write_wav
    from nfclab_torch.runtime.decoder import NfcDecoder

    def nfc(path, x):
        write_wav(str(path), x, RATE)
        samples, _ = read_wav(str(path))
        write_golden_frames(str(path.with_suffix(".json")),
                            NfcDecoder().decode(samples, RATE))
        return str(path)

    paths = {}
    for sub in ("templates", "lanes", "logic"):
        (tmp / sub).mkdir()
    paths["templates"] = [nfc(tmp / "templates" / f"{tp.name}.wav",
                              tp.samples) for tp in templates]
    paths["lanes"] = [
        nfc(tmp / "lanes" / f"lane{i}.wav",
            lane(templates[i % len(templates)], TOOLS_LANE,
                 seed=6000 + i)[0])
        for i in range(TOOLS_LANES)]
    logic = [make_session(atr=(0x3B, 0x00), tpdu=list(t))
             for t in TOOLS_LOGIC_TPDUS]
    logic.append(logic_lane(TOOLS_LOGIC_LANE, seed=6100)[0])
    paths["logic"] = []
    for i, x in enumerate(logic):
        paths["logic"].append(str(tmp / "logic" / f"logic{i}.wav"))
        write_wav(paths["logic"][-1], x, SAMPLE_RATE, bits=8)
    return paths


def run_tools_phase(templates):
    """Phase 15: every tool of nfclab_torch/tools on the card, on seeded
    inputs (tools_inputs): (a) validate_fused at nfclab's 2048 x 4096;
    (b) validate_cuda_decode on the template WAVs; (c)
    validate_rate_parametric on the NFC-A 106k template; (d)
    validate_cuda_farm on the lanes (full and mask fetch, k_chunks 4 in 2
    segments, the forced repairs, the production 16 x 32); (e)
    validate_cuda_logic on the logic WAVs, in this process and as
    python -m in a subprocess; (f) hw_smoke, bare and recording
    logicloop://test to a WAV; (g) e2e_bench --reps 1 on the template
    WAVs in a child process (tools_child: CUDA untouched until its host
    curve has run); (h)
    streaming_bench with TOOLS_STREAMING, which reaches the single-stream
    bench and every farm configuration of its main.  Each in-process run
    has the kernels' counts set to 0 just before and read just after."""
    import os
    import tempfile

    from nfclab_torch.io.wav import read_wav

    t0 = time.perf_counter()
    fused = ("fused_scan", "fused_mask")
    out = {"card": card_line(), "cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = tools_inputs(templates, tmp)
        out["inputs_s"] = time.perf_counter() - t0
        out["validate_fused"], _ = run_tool(
            "validate_fused", [], need=(*fused, "condition_scan"))
        out["validate_cuda_decode"], _ = run_tool(
            "validate_cuda_decode", paths["templates"], need=fused)
        out["validate_rate_parametric"], _ = run_tool(
            "validate_rate_parametric", paths["templates"][:1], need=fused)
        out["validate_cuda_farm"], text = run_tool(
            "validate_cuda_farm", paths["lanes"], need=fused)
        # full, mask and segmented on each lane, 2 pause and 2 tiled streams
        if text.count(": OK (") != 3 * TOOLS_LANES + 2 + 2:
            raise AssertionError("15d validate_cuda_farm ran fewer checks "
                                 "than its four")
        out["validate_cuda_logic"], _ = run_tool(
            "validate_cuda_logic", paths["logic"])
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nfclab_torch.tools.validate_cuda_logic",
             *paths["logic"]],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        if proc.returncode != 0 or not proc.stdout.endswith("PASS\n"):
            raise AssertionError(f"15e python -m validate_cuda_logic: "
                                 f"{proc.returncode}\n{proc.stderr[-4000:]}")
        out["validate_cuda_logic_m"] = {"rc": proc.returncode,
                                        "s": time.perf_counter() - t1}
        log(f"15e python -m validate_cuda_logic: "
            f"{json.dumps(out['validate_cuda_logic_m'])}")

        hw, text = run_tool("hw_smoke", [])
        listing = json.loads(text.splitlines()[0])
        if not listing["native"] or "logicloop" not in listing["drivers"]:
            raise AssertionError(f"15f hw_smoke listing: {listing}")
        wav = tmp / "hw_smoke.wav"
        hw2, text = run_tool("hw_smoke", ["--capture", "logicloop://test",
                                          "--seconds", "0.3", "--out", wav])
        rec = json.loads(text.splitlines()[1])
        samples, info = read_wav(str(wav))
        if (not rec["opened"] or rec["samples"] <= 0
                or info.channels != 4 or len(samples) != rec["samples"]):
            raise AssertionError(f"15f hw_smoke capture: {rec}")
        out["hw_smoke"] = {"enumerate": hw, "capture": hw2,
                           "capture_samples": rec["samples"],
                           "drivers": sorted(listing["drivers"])}

        t1 = time.perf_counter()
        code = ("import sys, chip_smoke; sys.exit(chip_smoke.tools_child("
                "*sys.argv[1:]))")
        proc = subprocess.run(
            [sys.executable, "-c", code, str(tmp / "e2e_run.json"),
             "e2e_bench", str(tmp / "templates"),
             "--reps", "1", "--out", str(tmp / "e2e.json")],
            capture_output=True, text=True, cwd=ROOT, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"15g e2e_bench failed:\n"
                                 f"{proc.stderr[-4000:]}")
        run = json.loads((tmp / "e2e_run.json").read_text())
        e2e = json.loads((tmp / "e2e.json").read_text())
        if run["launches"]["fused_scan"] <= 0 or not e2e["link"]:
            raise AssertionError(f"15g e2e_bench: {run}, {e2e['link']}")
        curve = e2e["aggregate_scaling"]["curve"]
        out["e2e_bench"] = {
            "rc": run["rc"], "s": run["s"],
            "wall_s": time.perf_counter() - t1,
            "launches": run["launches"],
            "link": e2e["link"],
            "modes": {fe: r["value"] for fe, r in e2e["modes"].items()},
            "frames": {fe: r["frames"] for fe, r in e2e["modes"].items()},
            "curve": {c["config"]: c["value"] for c in curve},
            "cpu_capacity": e2e["aggregate_scaling"]["cpu_capacity"]}
        if len(set(out["e2e_bench"]["frames"].values())) != 1:
            raise AssertionError(f"15g e2e_bench frames differ by "
                                 f"frontend: {out['e2e_bench']['frames']}")
        log(f"15g e2e_bench: {json.dumps(out['e2e_bench'])}")

        run, _ = run_tool(
            "streaming_bench", ["--wav", paths["templates"][0],
                                *TOOLS_STREAMING, "--out",
                                tmp / "streaming.json"], need=fused)
        st = json.loads((tmp / "streaming.json").read_text())
        from nfclab_torch.tools.streaming_bench import FARM_CONFIGS

        want = {"single_stream_windowed_dense",
                "single_stream_windowed_sparse",
                *(key for key, _, _ in FARM_CONFIGS)}
        if set(st) != want or any(r["value"] <= 0 for r in st.values()):
            raise AssertionError(f"15h streaming_bench: {sorted(st)}")
        out["streaming_bench"] = dict(run, rates={
            key: {"value": r["value"],
                  "sustained": r["sustained_samples_per_second"],
                  "frames": r["frames"], "stages": r.get("stages")}
            for key, r in st.items()})
        link = st["farm_cuda"]["link_at_bench"]
        out["streaming_bench"]["link_at_bench"] = link
    out["phase_s"] = time.perf_counter() - t0
    return out


def check_v2(dev, streams, chunk, errs, seed, timed=False):
    """fused_v2's kernels against their plain versions over two chunks of
    mixed lanes with carried state (clocks from 40): the two-kernel chain
    against the plain chain, and the mask kernel alone on the plain scan's
    outputs.  With `timed`, the kernels' times on chunk 1's inputs (CUDA
    events) and the plain versions' times from its comparison run."""
    import torch

    from nfclab_torch.experiments import fused_v2 as v2
    from torch_synth import mixed_lanes

    pt, mp, _ = _params(RATE)
    x = torch.from_numpy(mixed_lanes(streams, 2 * chunk, seed=seed)).to(dev)
    mrows = v2.mask_state_rows().to(dev)
    mk = v2.OUTPUT_NAMES.index("detect_mask")
    st_k = torch.zeros(v2.NSTATE, streams, device=dev)
    st_p = st_k.clone()
    t = {}
    for c in range(2):
        base = 40 + c * chunk
        x_tm = x[:, c * chunk : (c + 1) * chunk].t().contiguous()
        out_k, so_k = v2.run_chunk(x_tm, st_k, base, pt, mp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, so_p = v2._scan_plain(x_tm, st_p, base, pt)
        torch.cuda.synchronize()
        t["scan_plain_ms"] = (time.perf_counter() - t0) * 1e3
        out_m, so_m = out_p.clone(), so_p.clone()
        v2.v2_mask(out_m, st_p, so_m, base, mp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v2._mask_plain(out_p, st_p, so_p, base, mp)
        torch.cuda.synchronize()
        t["mask_plain_ms"] = (time.perf_counter() - t0) * 1e3
        what = f"{streams} x {chunk}, chunk {c}, base {base}"
        _hold(errs, "fused_v2_scan", out_k[:mk], out_p[:mk], what)
        _hold(errs, "fused_v2_scan", so_k[~mrows], so_p[~mrows], what)
        for o, s in ((out_m, so_m), (out_k, so_k)):
            _hold(errs, "fused_v2_mask", o[mk], out_p[mk], what)
            _hold(errs, "fused_v2_mask", s[mrows], so_p[mrows], what)
        if c == 0:
            st_k, st_p = so_k, so_p
            del out_m, so_m
    log(f"fused_v2 kernels == plain (bit-exact) at {streams} streams x 2 x "
        f"{chunk}, carried state")
    if not timed:
        return t
    out_t, so_t = out_k.clone(), so_k.clone()
    t["scan_ms"] = _event_ms(lambda: v2.v2_scan(x_tm, st_k, base, pt), 3)
    t["mask_ms"] = _event_ms(
        lambda: v2.v2_mask(out_t, st_k, so_t, base, mp), 5)
    # each input read once and each output written once: the scan reads
    # the samples and its state rows and writes 14 channels and its rows;
    # the mask writes detect_mask and its rows (its inputs are the scan's
    # outputs)
    n = chunk * streams
    row_b = streams * 4
    n_mrows = int(mrows.sum())
    t["scan_bound"] = _bound(60 * n + 2 * (v2.NSTATE - n_mrows) * row_b,
                             V2_SCAN_OPS * n)
    t["mask_bound"] = _bound(4 * n + 2 * n_mrows * row_b, V2_MASK_OPS * n)
    # the floor of the two-kernel split: the mask kernel also reads env and
    # its five lookback channels once (24 B a sample)
    t["mask_two_kernel_floor"] = _bound(28 * n + 2 * n_mrows * row_b,
                                        V2_MASK_OPS * n)
    return t


def check_experiment_kernels(dev, errs):
    """Phase 2 for the experiments/ counterparts: the probes at one group
    x CHECK_CHUNK samples x 2048 lanes (field-off stretches past the
    silence timeout on every 8th lane, a zero first sample on lane 0), pair
    equal to serial; the copy probe at 1024 x 1024 x 3 outputs, 2 sweeps;
    fused_v2 at STREAMS x 2 chunks of CHECK_CHUNK, then its public
    function against fused_frontend_plain."""
    import numpy as np
    import torch

    from nfclab_torch.experiments import fused_v2 as v2
    from nfclab_torch.experiments import membw_probe as mb
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf
    from torch_synth import mixed_lanes

    x = psf.probe_input(1, CHECK_CHUNK, psf.SUB, dev)
    x[:, 1000:3000, ::8] = 0.0
    x[0, 0, 0] = 0.0
    serial = psf.serial_probe(x)
    pair = pps.pair_probe(x)
    what = f"1 x {CHECK_CHUNK} x {x.shape[2]}"
    for a, b in zip(serial, psf.serial_probe_plain(x)):
        _hold(errs, "serial_probe", a, b, what)
    for a, b in zip(pair, pps.pair_probe_plain(x)):
        _hold(errs, "pair_probe", a, b, what)
    for a, b in zip(pair, serial):
        if not _same(a, b):
            raise AssertionError(f"pair_probe != serial_probe, {what}")
    log(f"serial_probe, pair_probe == plain and pair == serial (bit-exact) "
        f"at {what}")

    xc = torch.from_numpy(np.random.default_rng(1).random(
        (1024, 1024), dtype=np.float32)).to(dev)
    for a, b in zip(mb.copy_probe(xc, 3, 2), mb.copy_probe_plain(xc, 3, 2)):
        _hold(errs, "copy_probe", a, b, "1024 x 1024 x 3, 2 sweeps")
    log("copy_probe == plain (bit-exact) at 1024 x 1024 x 3 outputs")

    check_v2(dev, STREAMS, CHECK_CHUNK, errs, seed=31)
    pt, mp, _ = _params(RATE)
    xv = mixed_lanes(STREAMS, 2 * CHECK_CHUNK, seed=32)
    st = stp = None
    for c in range(2):
        xc = torch.from_numpy(xv[:, c * CHECK_CHUNK : (c + 1) * CHECK_CHUNK])
        got, st = v2.fused_frontend(xc, pt, mask_params=mp, state=st,
                                    base=c * CHECK_CHUNK, return_state=True,
                                    device=dev)
        want, stp = v2.fused_frontend_plain(
            xc.to(dev), pt, mask_params=mp, state=stp, base=c * CHECK_CHUNK,
            return_state=True)
        for n in v2.OUTPUT_NAMES:
            if not _same(got[n], want[n]):
                raise AssertionError(f"fused_v2.fused_frontend {n} != plain")
        if not _same(st, stp):
            raise AssertionError("fused_v2.fused_frontend state != plain")
    torch.cuda.synchronize()
    log(f"fused_v2.fused_frontend == fused_frontend_plain (bit-exact) at "
        f"{STREAMS} x 2 x {CHECK_CHUNK} from a fresh stream")


def _counted(kernels, fn):
    """fn() with the launch counts of `kernels` set to 0 just before and
    read just after; raises if one of them never ran."""
    for k in kernels:
        k.launches = 0
    res = fn()
    counts = {k.name: k.launches for k in kernels}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never ran on its path")
    return res, counts


def probe_vs_condition(dev, tpls):
    """ms of serial_probe_kernel and cond_scan_kernel (from a zero state
    at clock 0) on two inputs of 2048 lanes x 65536 samples: the probe's
    own (uniform noise, where the envelope rarely updates) and lanes of
    the templates (carrier, where it nearly always does)."""
    import numpy as np
    import torch

    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.experiments import probe_serial_floor as psf
    from torch_synth import lane

    lanes = psf.SUB * 128
    noise = psf.probe_input(1, psf.T_PROBE, psf.SUB, dev)[0]
    caps = np.stack([lane(tpls[i % len(tpls)], psf.T_PROBE, seed=2000 + i)[0]
                     for i in range(lanes)], 1)
    z = torch.zeros(lanes, device=dev)
    zi = torch.zeros(lanes, dtype=torch.int32, device=dev)
    pt = psf.params()
    res = {}
    for what, x_tm in (("noise", noise), ("captures",
                                          torch.from_numpy(caps).to(dev))):
        res[f"serial_probe_{what}_ms"] = _event_ms(
            lambda: psf.serial_probe(x_tm[None]), 3)
        res[f"condition_scan_{what}_ms"] = _event_ms(
            lambda: ck.condition_scan_tm(x_tm, z, z, z, z, zi, zi, pt), 3)
    return res


def run_experiments(dev, errs, tpls):
    """Phase 8: the experiments/ counterparts at the originals' full
    widths, each through its entry point with its launch counts read
    around exactly that call; then each kernel timed against its plain
    version at that shape.  Returns (per-kernel times, launch counts)."""
    import numpy as np
    import torch

    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.experiments import bench_v2
    from nfclab_torch.experiments import fused_v2 as v2
    from nfclab_torch.experiments import membw_probe as mb
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf
    from nfclab_torch.experiments.common import best_time

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kt, launches = {}, {}

    # the copy probe: the original's measurement, then one sweep of
    # 8192 x 8192 x NOUT against the plain version and one broadcast
    # torch.mul
    r, n = _counted([mb.COPY], lambda: mb.bandwidth(device=dev))
    launches.update(n)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (mb.ROWS, mb.COLS), dtype=np.float32)).to(dev)
    sc = torch.tensor(mb.scales(mb.NOUT), device=dev).view(mb.NOUT, 1, 1)
    lib_out = torch.empty(mb.NOUT, mb.ROWS, mb.COLS, device=dev)

    def library_sweeps():
        for _ in range(mb.SWEEPS):
            torch.mul(x, sc, out=lib_out)
        return float(lib_out[:, -1, -1].sum())

    lib_best = best_time(library_sweeps, 4)
    r["library_gb_per_s"] = r["traffic_bytes"] / lib_best / 1e9
    peak = H100_BYTES_PER_S / 1e9
    if r["gb_per_s"] > 1.05 * peak:
        raise AssertionError(
            f"copy probe read {r['gb_per_s']:.0f} GB/s, over 105% of "
            f"{peak:.0f}: stores were dropped")
    got = mb.copy_probe(x, mb.NOUT, 1)
    for a, b in zip(got, mb.copy_probe_plain(x, mb.NOUT, 1)):
        _hold(errs, "copy_probe", a, b, "8192 x 8192 x 14")
    del got
    nbytes = x.numel() * 4 * (1 + mb.NOUT)
    kt["copy_probe"] = {
        "ms": _event_ms(lambda: mb.copy_probe(x, mb.NOUT, 1), 5),
        "plain_ms": _event_ms(lambda: mb.copy_probe_plain(x, mb.NOUT, 1), 3),
        "library_ms": _event_ms(lambda: torch.mul(x, sc, out=lib_out), 5),
        "bound": _bound(nbytes, mb.NOUT * x.numel())}
    log(f"copy probe: {json.dumps(r)}")
    del x, lib_out
    torch.cuda.empty_cache()

    # the conditioning probes: each main's measurement, then one call at
    # its shape against the plain version
    serial, n = _counted([psf.SERIAL], lambda: psf.measure(device=dev))
    launches.update(n)
    pair, n = _counted([pps.PAIR], lambda: pps.measure("pair", device=dev))
    launches.update(n)
    log(f"conditioning probes: serial {json.dumps(serial)}, pair "
        f"{json.dumps(pair)}, serial at pair's shape "
        f"{json.dumps(pps.measure('serial', device=dev))}")
    for name, g, probe, plain in (
            ("serial_probe", 1, psf.serial_probe, psf.serial_probe_plain),
            ("pair_probe", 8, pps.pair_probe, pps.pair_probe_plain)):
        xp = psf.probe_input(g, psf.T_PROBE, psf.SUB, dev)
        ms = _event_ms(lambda: probe(xp), 3)
        # the serial probe at the pair's shape, beside it
        serial_ms = (_event_ms(lambda: psf.serial_probe(xp), 3)
                     if name == "pair_probe" else None)
        got = probe(xp)
        if name == "pair_probe":
            for a, b in zip(got, psf.serial_probe(xp)):
                if not _same(a, b):
                    raise AssertionError("pair_probe != serial_probe at "
                                         f"{tuple(xp.shape)}")
            log(f"pair_probe == serial_probe (bit-exact) at "
                f"{xp.shape[2] * g} lanes x {psf.T_PROBE}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(xp)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for a, b in zip(got, want):
            _hold(errs, name, a, b, f"{tuple(xp.shape)}")
        n = xp.numel()
        kt[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "ns_per_step": ms * 1e6 / psf.T_PROBE,
                    "bound": _bound(24 * n, PROBE_OPS * n)}
        if serial_ms is not None:
            kt[name]["serial_ms_at_this_shape"] = serial_ms
        del xp, got, want
        torch.cuda.empty_cache()

    # bench_v2: v2 and prod, launch counts and peak memory around each
    for which, kernels in (("v2", v2.KERNELS), ("prod", ff.KERNELS)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows, n = _counted(kernels, lambda: bench_v2.run(which, device=dev))
        if which == "v2":
            launches.update(n)
        peak = torch.cuda.max_memory_allocated()
        for row in rows:
            row["max_memory_allocated_gib"] = peak / 2**30
            row["launches"] = n
        log(f"bench_v2 {which}: {json.dumps(rows)}")
    log(f"serial_probe and condition_scan at 2048 lanes x {psf.T_PROBE} "
        f"(ms): {json.dumps(probe_vs_condition(dev, tpls))}")

    # fused_v2 against its plain version on two full-width chunks
    torch.cuda.empty_cache()
    t = check_v2(dev, V2_STREAMS, V2_CHUNK, errs, seed=33, timed=True)
    for key in ("scan", "mask"):
        kt[f"fused_v2_{key}"] = {
            "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
            "library_ms": None, "ns_per_step": t[f"{key}_ms"] * 1e6 / V2_CHUNK,
            "bound": t[f"{key}_bound"]}
    kt["fused_v2_mask"]["two_kernel_floor_ms"] = t["mask_two_kernel_floor"][0]
    torch.cuda.empty_cache()
    return kt, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-2)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "nfclab_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build
    from nfclab_torch.kernels import build as kbuild
    from nfclab_torch.native import build as nbuild

    t0 = time.perf_counter()
    kbuild.build(force=True)
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
    for ln in kbuild.ptxas_lines():
        log("  " + ln.strip())
    t0 = time.perf_counter()
    nbuild.build()
    log(f"native build: {time.perf_counter() - t0:.1f} s")

    # 2. kernels vs plain, bit-exact, two rates; C++ oracle
    t_phase = time.perf_counter()
    errs = {name: 0.0 for name in (
        "fused_scan", "fused_mask", "condition_scan", "fused_v2_scan",
        "fused_v2_mask", "serial_probe", "pair_probe", "copy_probe")}

    def timed(fn, *a):
        t = time.perf_counter()
        res = fn(dev, *a, errs)
        log(f"  {fn.__name__}{tuple(a)} took {time.perf_counter() - t:.1f} s")
        return res

    x, outs = timed(check_kernels, RATE, CHECK_CHUNK, 2)
    check_oracle(x, outs, RATE)
    timed(check_kernels, 3_200_000, CHECK_CHUNK, 2)
    timed(check_kernels, 40_000_000, CHECK_CHUNK, 2)
    del x, outs
    for rate in (RATE, 3_200_000):
        timed(check_condition_kernel, rate, CHECK_CHUNK, 2)
        timed(check_boundary, rate)
    for fn in (check_boundary_experiments, check_ff_mask_boundary,
               check_segmented_shapes, check_experiment_kernels):
        timed(fn)
    log(f"phase 2 took {time.perf_counter() - t_phase:.1f} s")
    if args.kernels_only:
        log(json.dumps({"max_abs_err": errs}))
        return 0

    # 3. kernels vs plain at the main path's shape, on its captures; times
    from torch_synth import templates as make_templates

    t_phase = time.perf_counter()
    tpls = make_templates()
    t0 = time.perf_counter()
    caps, reps = build_lanes(tpls)
    log(f"built {len(caps)} captures x {WINDOW} samples in "
        f"{time.perf_counter() - t0:.1f} s")
    tk = check_main_shape(dev, caps, errs)
    tk.update(check_condition_main_shape(dev, caps, errs))
    log(f"times at {STREAMS} x 65536 (ms): {json.dumps(tk)}")
    resources = log_scan_resources(kbuild)
    log(f"phase 3 took {time.perf_counter() - t_phase:.1f} s")

    # 4. the main path at full width
    res, dt, launches, peak, steps = run_main_path(caps)
    n = len(caps) * WINDOW
    log(f"main path: chained_batch_masks {len(caps)} x {WINDOW}: "
        f"{dt * 1e3:.1f} ms per window, {n / dt:.4g} samples/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches}")
    if any(r["n"] != WINDOW for r in res):
        raise AssertionError("main path returned a wrong capture length")
    cap = max(4096, WINDOW // 16)
    counts = [len(r["detect_idx"]) for r in res]
    log("main path steps (host s, no added sync): "
        + json.dumps(dict(steps, unattributed=dt - sum(steps.values()))))
    log(f"compaction cap {cap}: {sum(c > cap for c in counts)} of "
        f"{len(counts)} streams over it, most triggers {max(counts)}")

    # 5. frames
    t_phase = time.perf_counter()
    check_decode(caps, reps, res, tpls)
    del res
    out_dir = check_cli(tpls)
    log(f"phase 5 took {time.perf_counter() - t_phase:.1f} s")

    # 6. the dense frontend at full width
    t_phase = time.perf_counter()
    dense = run_dense_frontend(dev, caps)
    # phase 10a's captures: the first FULL_CHUNKS chunks of these lanes
    caps2 = [c[: FULL_CHUNKS * 65536].copy() for c in caps]
    del caps
    log(f"dense frontend {STREAMS} x 65536 at {RATE} Hz: {json.dumps(dense)}")
    log(f"phase 6 took {time.perf_counter() - t_phase:.1f} s")

    # 7. the device conditioner and its callers
    t_phase = time.perf_counter()
    cpath, cond_launches, host7 = run_conditioner_path(tpls, out_dir)
    log(f"conditioning path: {json.dumps(cpath)}")
    log(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")

    # 8. the experiments/ counterparts at full width
    t0 = time.perf_counter()
    ekt, elaunch = run_experiments(dev, errs, tpls)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # 9. the live farm on the card at full width
    t0 = time.perf_counter()
    farm, (farm_sigs, farm_reps, farm_want) = run_farm_phase(tpls)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # 10. the full-channel device frontend
    t0 = time.perf_counter()
    full = {"10a": run_full_path(caps2)}
    del caps2
    check_full_decode(tpls)
    full["10c_bench_cli"] = check_full_surfaces(tpls, out_dir)
    full["10d"] = run_full_farm(farm_sigs[:FARM_CUT], farm_want[:FARM_CUT],
                                farm_reps[:FARM_CUT], tpls)
    del farm_sigs, farm_want
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # 11. live capture through decode_cli live
    t0 = time.perf_counter()
    live, paced = run_live_phase(tpls)
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # 12. the ISO7816 logic path
    t0 = time.perf_counter()
    logic = run_logic_phase()
    logic["phase_s"] = time.perf_counter() - t0
    log(f"phase 12 took {logic['phase_s']:.1f} s")

    # 13. the spectrum, the live monitor and the reports
    monitor = run_monitor_phase(tpls, paced, live["11b"])
    del paced
    log(f"phase 13 took {monitor['phase_s']:.1f} s")

    # 14. sharding: world size 1 on NCCL, two gloo ranks, the tools
    shard = run_shard_phase(tpls, host7, out_dir)
    del host7
    log(f"phase 14 took {shard['phase_s']:.1f} s")

    # 15. the validation and benchmark tools
    tools = run_tools_phase(tpls)
    log(f"phase 15 took {tools['phase_s']:.1f} s")
    tool_runs = {name: r for name, r in tools.items()
                 if isinstance(r, dict) and "launches" in r}

    per_step = {"fused_scan": {
                    "ns_per_step": tk["scan_ns_per_step"],
                    "kernel": tk["scan_kernel"],
                    "other_kernel": tk["scan_other_kernel"],
                    "other_ms": tk["scan_other_ms"],
                    "repair_ms": farm["repair"]["scan_kernel_ms"],
                    "pair_all_outputs_ms": tk["chunk_all_ms"],
                    "pair_all_outputs_bound_ms": tk["chunk_all_bound"][0],
                    "full_path_launches": full["10a"]["launches"][
                        "fused_scan"],
                    "full_farm_launches": full["10d"]["launches"][
                        "fused_scan"],
                    "live_launches": live["11c"]["launches"]["fused_scan"],
                    "shard_launches": shard["14a"]["kernel_path"][
                        "launches"]["fused_scan"],
                    "tools_launches": {t: r["launches"]["fused_scan"]
                                       for t, r in tool_runs.items()}},
                "fused_mask": {
                    "repair_ms": farm["repair"]["mask_kernel_ms"],
                    "full_path_launches": full["10a"]["launches"][
                        "fused_mask"],
                    "full_farm_launches": full["10d"]["launches"][
                        "fused_mask"],
                    "live_launches": live["11c"]["launches"]["fused_mask"],
                    "shard_launches": shard["14a"]["kernel_path"][
                        "launches"]["fused_mask"],
                    "tools_launches": {t: r["launches"]["fused_mask"]
                                       for t, r in tool_runs.items()},
                    "two_kernel_floor_ms": tk["two_kernel_floor_ms"],
                    "md_ms": tk["mask_md_ms"],
                    "md_plain_ms": tk["mask_md_plain_ms"],
                    "two_kernel_floor_md_ms": tk["two_kernel_floor_md_ms"],
                    **resources["ff_mask_kernel"]},
                "condition_scan": {
                    "ns_per_step": tk["cond_ns_per_step"],
                    "repair_ms": tk["cond_repair_ms"],
                    "repair_ns_per_step": tk["cond_repair_ns_per_step"],
                    "shard_launches": shard["14a"]["capture_path"][
                        "launches"]["condition_scan"],
                    "tools_launches": {t: r["launches"]["condition_scan"]
                                       for t, r in tool_runs.items()}},
                "fused_v2_scan": resources["v2_scan_kernel"],
                "fused_v2_mask": resources["v2_mask_kernel"],
                "serial_probe": resources["serial_probe_kernel"],
                "pair_probe": resources["pair_probe_kernel"]}
    kernels = []
    for name, key, src, tpu, n in (
            ("fused_scan", "scan", SOURCE, TPU_KERNEL, launches["fused_scan"]),
            ("fused_mask", "mask", SOURCE, TPU_KERNEL, launches["fused_mask"]),
            ("condition_scan", "cond", COND_SOURCE, COND_TPU_KERNEL,
             cond_launches)):
        bound, by = tk[f"{key}_bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": tpu, "launches": n,
            "max_abs_err": errs[name], "ms": tk[f"{key}_ms"],
            "plain_ms": tk[f"{key}_plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": None, **per_step.get(name, {}),
        })
    for name, src, tpu in (
            ("fused_v2_scan", V2_SOURCE, V2_TPU_KERNEL),
            ("fused_v2_mask", V2_SOURCE, V2_TPU_KERNEL),
            ("serial_probe", PROBE_SOURCE, SERIAL_TPU_KERNEL),
            ("pair_probe", PROBE_SOURCE, PAIR_TPU_KERNEL),
            ("copy_probe", PROBE_SOURCE, COPY_TPU_KERNEL)):
        k = ekt[name]
        bound, by = k["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": elaunch[name], "max_abs_err": errs[name],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": k["library_ms"],
            **{key: k[key] for key in ("ns_per_step", "two_kernel_floor_ms",
                                       "serial_ms_at_this_shape") if key in k},
            **per_step.get(name, {}),
        })
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "nfclab"))
    if loaded:
        raise AssertionError(f"JAX or nfclab was imported: {loaded[:5]}")
    log(json.dumps({"tools": tools}))
    log(json.dumps({"shard": shard}))
    log(json.dumps({"monitor": monitor}))
    log(json.dumps({"logic": logic}))
    log(json.dumps({"live": live}))
    log(json.dumps({"full_path": {
        "10a": full["10a"]["launches"],
        "10d": {"total": full["10d"]["launches"],
                "per_feed": full["10d"]["launches_per_feed"]}}}))
    log(json.dumps({"farm_launches": {
        run: {"total": r["launches"], "per_window": r["launches_per_window"]}
        for run, r in farm.items() if run != "repair"}}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
