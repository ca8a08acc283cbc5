"""Validate the stream farm on the card: several captures decode
CONCURRENTLY as rows of one chunked device batch (carried kernel state
across chunks), and every stream's frames must equal the host streaming
decoder's.

Counterpart of ``nfclab/tools/validate_tpu_farm.py``, over
``runtime/farm.CudaStreamFarm``.  On the 10 MS/s WAV captures given, fed
CHUNK samples at a time (each padded with zeros to a whole chunk):

1. ``fetch="full"`` and ``fetch="mask"`` (``NFCLAB_FARM_MODES``): every
   stream's frames equal a host ``StreamingNfcDecoder`` fed the same
   blocks, and where a golden ``.json`` lies beside the WAV, its
   Poll/Listen frames equal the golden's;
2. the segmented engine (mask mode, ``k_chunks`` 4 and 2 segments,
   ``NFCLAB_FARM_KCHUNKS`` / ``NFCLAB_FARM_SEGMENTS``, adaptive backoff
   off) on the same captures: the same references, with
   ``seg_dispatches >= 2`` (so the longest capture must span 3 windows
   of k_chunks x 65,536 samples);
3. a field-off pause of 6 and of 5 chunks between two copies of 1's
   first capture, which speculative warm-up cannot bridge: boundary
   verification fails, the repair path runs, and the frames equal the
   host's;
4. the production configuration (``window=1 << 20`` gives 16 segments
   and ``k_chunks`` 32) on the first capture tiled over three windows
   and on its one-chunk-shifted twin, against the host decoder with the
   same window (``NFCLAB_FARM_SKIP_PROD_SEG=1`` skips it).

``NFCLAB_FARM_WINDOW`` sets the streams' window (default unbounded) and
``NFCLAB_FARM_SKIP_SEGMENTED=1`` skips 2-4, as in nfclab.  The farm
refuses ``fetch="full"`` with segments > 1 (a deliberate difference from
nfclab, which ignores it), so segmented checks run in mask mode only.

Run: python -m nfclab_torch.tools.validate_cuda_farm CAPTURE.wav [...]
[--device cpu].  nfclab's tool reads the reference decoder's fixtures
test_NFC-A_106kbps_002, test_NFC-A_424kbps_001, test_NFC-B_106kbps_001
and test_POLL_AB_001 by default, and for 2 test_POLL_ABF_001 (three
windows at k_chunks 4), test_POLL_AB_001, test_NFC-B_106kbps_001 and
test_NFC-A_106kbps_002.  Prints one OK/MISMATCH line per stream and
check; exit 1, with a message, on a mismatch, no capture or a missing
file, or a missing card (``--device cpu`` runs the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .fixtures import golden_path, missing
from .validate_cuda_decode import print_first_diff

RATE = 10_000_000
CHUNK = 65536


def _padded(streams, total: int) -> np.ndarray:
    out = np.zeros((len(streams), total), np.float32)
    for i, s in enumerate(streams):
        out[i, : len(s)] = s[:total]
    return out


def run_farm(farm, padded: np.ndarray) -> list[list]:
    """Feed [n, total] through the farm CHUNK samples at a time; per-stream
    frames after finish()."""
    frames = [[] for _ in range(len(padded))]
    for lo in range(0, padded.shape[1], CHUNK):
        for i, new in enumerate(farm.feed(padded[:, lo : lo + CHUNK])):
            frames[i].extend(new)
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    return frames


def host_frames(stream: np.ndarray, window=None) -> list:
    """A host StreamingNfcDecoder fed the stream CHUNK samples at a time."""
    from ..runtime.streaming import StreamingNfcDecoder

    host = StreamingNfcDecoder(RATE, window=window)
    want = []
    for lo in range(0, len(stream), CHUNK):
        want.extend(host.feed(stream[lo : lo + CHUNK]))
    want.extend(host.finish())
    return want


def check_streams(label: str, frames, padded, window=None,
                  goldens=None) -> int:
    """Print one line per stream; returns the mismatches.  Each stream's
    frames must equal the host decoder's over the same padded samples and,
    where ``goldens[i]`` names a file, that golden's Poll/Listen frames."""
    from ..io.golden import GOLDEN_TYPES, read_golden_frames

    bad = 0
    for i, got in enumerate(frames):
        pairs = [("host", got, host_frames(padded[i], window))]
        if goldens and goldens[i]:
            pairs.append(("golden",
                          [f for f in got if f.frame_type in GOLDEN_TYPES],
                          read_golden_frames(goldens[i])))
        diffs = [p for p in pairs if p[1] != p[2]]
        n_gold = sum(f.frame_type in GOLDEN_TYPES for f in got)
        print(f"CUDA FARM [{label}] stream {i}: "
              f"{'MISMATCH' if diffs else 'OK'} ({n_gold} golden-type "
              f"frames, against {' and '.join(p[0] for p in pairs)})",
              flush=True)
        bad += len(diffs)
        for ref, a, b in diffs:
            print_first_diff(ref, a, b)
    return bad


def _stats_line(what: str, st: dict) -> None:
    print(f"  {what} stats: {st['seg_dispatches']} seg dispatches, "
          f"{st['repaired_streams']} repaired streams, "
          f"{st['repair_chunks']} repair chunks", flush=True)


def validate_modes(streams, goldens, window, device) -> int:
    from ..runtime.farm import CudaStreamFarm

    modes = os.environ.get("NFCLAB_FARM_MODES", "full,mask").split(",")
    total = -(-max(len(s) for s in streams) // CHUNK) * CHUNK
    padded = _padded(streams, total)
    bad = 0
    for fetch in modes:
        farm = CudaStreamFarm(len(streams), RATE, window=window, fetch=fetch,
                              device=device)
        bad += check_streams(fetch, run_farm(farm, padded), padded, window,
                             goldens)
    return bad


def validate_segmented(streams, goldens, base_a, window, device) -> int:
    """The segment-parallel engine (mask mode): a small-window farm so the
    captures span several full windows (serial head window + segmented
    continuations); then a field-off pause long enough that speculative
    warm-up cannot converge, forcing verify + repair; then the production
    configuration on a long tiled capture.  Both use ``base_a``, the
    first capture of the first check."""
    from ..runtime.farm import CudaStreamFarm

    k_chunks = int(os.environ.get("NFCLAB_FARM_KCHUNKS", "4"))
    segments = int(os.environ.get("NFCLAB_FARM_SEGMENTS", "2"))
    total = -(-max(len(s) for s in streams) // CHUNK) * CHUNK
    padded = _padded(streams, total)
    farm = CudaStreamFarm(len(streams), RATE, window=window, fetch="mask",
                          k_chunks=k_chunks, segments=segments,
                          adaptive_segments=False, device=device)
    frames = run_farm(farm, padded)
    if farm.stats["seg_dispatches"] < 2:
        raise AssertionError(
            f"seg_dispatches {farm.stats['seg_dispatches']} < 2: the longest "
            f"capture must span 3 windows of {k_chunks * CHUNK} samples")
    bad = check_streams(f"mask seg={farm.segments} k={k_chunks}", frames,
                        padded, window, goldens)
    _stats_line("segmented", farm.stats)

    # synthetic field-off pause: the speculative envelope cannot recover
    # the pre-pause frozen level from a zero halo, so boundary
    # verification must fail and route those segments through the exact
    # repair path
    synth = [np.concatenate([base_a, np.zeros(g * CHUNK, np.float32), base_a])
             for g in (6, 5)]  # both >> EMA memory, different
    total = -(-max(len(s) for s in synth) // CHUNK) * CHUNK
    padded = _padded(synth, total)
    farm = CudaStreamFarm(len(synth), RATE, window=window, fetch="mask",
                          k_chunks=k_chunks, segments=segments,
                          adaptive_segments=False, device=device)
    bad += check_streams("mask seg pause", run_farm(farm, padded), padded,
                         window)
    _stats_line("pause", farm.stats)

    # production auto configuration (k_chunks=32 -> segments=16): a long
    # tiled capture against the host streaming decoder with the same
    # window (positions shift per repetition, so no golden)
    if os.environ.get("NFCLAB_FARM_SKIP_PROD_SEG") != "1":
        reps = -(-3 * 32 * CHUNK // len(base_a)) + 1
        long_s = np.tile(base_a, reps)
        padded = np.stack([long_s, np.concatenate(
            [np.zeros(CHUNK, np.float32), long_s[:-CHUNK]])])
        farm = CudaStreamFarm(len(padded), RATE, window=1 << 20,
                              fetch="mask", adaptive_segments=False,
                              device=device)
        if farm.segments != 16 or farm.k_chunks != 32:
            raise AssertionError(f"production farm: segments {farm.segments}"
                                 f", k_chunks {farm.k_chunks} != 16, 32")
        frames = run_farm(farm, padded)
        if farm.stats["seg_dispatches"] < 2:
            raise AssertionError(f"production farm: {farm.stats}")
        bad += check_streams("mask seg=16 k=32 tiled", frames, padded,
                             1 << 20)
        _stats_line("prod-seg", farm.stats)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-torch-validate-cuda-farm",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("wavs", nargs="*", metavar="CAPTURE.wav")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device
    from ..io.wav import read_wav

    paths = args.wavs
    skip_seg = os.environ.get("NFCLAB_FARM_SKIP_SEGMENTED") == "1"
    if missing(paths):
        return 1
    window = int(os.environ.get("NFCLAB_FARM_WINDOW", "0")) or None

    def load(ps):
        out = []
        for p in ps:
            samples, info = read_wav(p)
            if info.sample_rate != RATE:
                raise ValueError(f"{p}: {info.sample_rate} S/s, the farm "
                                 f"validation runs at {RATE}")
            out.append(np.asarray(samples, np.float32))
        return out

    try:
        dev = resolve_device(args.device)
        streams = load(paths)
        bad = validate_modes(streams, [golden_path(p) for p in paths],
                             window, dev)
        if not skip_seg:
            bad += validate_segmented(
                streams, [golden_path(p) for p in paths], streams[0],
                window, dev)
    except (DeviceUnavailable, AssertionError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
