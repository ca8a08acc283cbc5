"""Validate the card-fed batch decode: frames of the fused frontend
against the host frontend's.

Counterpart of ``nfclab/tools/validate_tpu_decode.py``.  On the WAV
captures given, ``runtime/batch.decode_batch(frontend="fused")``, with
the box channels and detect triggers from the fused kernels and native
conditioning in the worker (``host-cond``), then the same with
``conditioner="device"``, the conditioning fetched from the kernels too
(``device-cond``), must give the frames of ``decode_batch(
frontend="host", conditioner="native")``; where a golden ``.json`` lies
beside a WAV, its Poll/Listen frames too (RawFrame.cpp:82-97 equality).
The box sums carry the float32 running-sum roundoff of the kernels, so
frame equality, not bitwise channel equality, is the criterion.

Run: python -m nfclab_torch.tools.validate_cuda_decode CAPTURE.wav
[...] [--device cpu].  nfclab's tool reads five of the reference
decoder's fixtures by default: test_NFC-A_106kbps_002 (ASK poll/listen),
test_NFC-A_424kbps_001 (BPSK listen), test_NFC-B_106kbps_001 (the NFC-B
falling-edge path), test_NFC-A_424kbps_002 and test_NFC-B_106kbps_002
(long frames across chunk boundaries).  Prints one OK/MISMATCH line per
capture and label; exit 1, with a message, on a mismatch, no capture or
a missing file, or a missing card (``--device cpu`` runs the kernels'
plain versions).
"""

from __future__ import annotations

import argparse
import os
import sys

from .fixtures import golden_path, missing


def check(results, host, label) -> int:
    """Print one line per capture of ``results``; returns the mismatches.
    Each capture's frames must equal ``host``'s and its golden's."""
    from ..io.golden import GOLDEN_TYPES, read_golden_frames

    bad = 0
    for path, got in results.items():
        name = os.path.splitext(os.path.basename(path))[0]
        pairs = [("host", got, host[path])]
        gold = golden_path(path)
        if gold is not None:
            pairs.append(("golden",
                          [f for f in got if f.frame_type in GOLDEN_TYPES],
                          read_golden_frames(gold)))
        diffs = [p for p in pairs if p[1] != p[2]]
        print(f"CUDA DECODE {label} {name}: "
              f"{'MISMATCH' if diffs else 'OK'} ({len(got)} frames, against "
              f"{' and '.join(p[0] for p in pairs)})", flush=True)
        bad += len(diffs)
        for ref, a, b in diffs:
            print_first_diff(ref, a, b)
    return bad


def print_first_diff(ref: str, got: list, want: list) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            print(f"  first diff from {ref} at frame {i}: got={a!r} "
                  f"want={b!r}")
            break
    if len(got) != len(want):
        print(f"  frame count: got {len(got)}, {ref} {len(want)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-torch-validate-cuda-decode",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("wavs", nargs="*", metavar="CAPTURE.wav")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device
    from ..runtime.batch import decode_batch

    paths = args.wavs
    if missing(paths):
        return 1
    try:
        dev = resolve_device(args.device)
        host = decode_batch(paths, workers=1, frontend="host",
                            conditioner="native", device=dev)
        bad = check(decode_batch(paths, workers=1, frontend="fused",
                                 device=dev), host, "host-cond")
        bad += check(decode_batch(paths, workers=1, frontend="fused",
                                  conditioner="device", device=dev),
                     host, "device-cond")
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
