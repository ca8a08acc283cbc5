"""Validate the sharded kernel frontend on the card.

Counterpart of ``nfclab/tools/validate_tpu_shard_kernel.py``.
``shard/multichip.sharded_kernel_channels`` runs the fused frontend
kernels over a ``blocks`` layout of ranks (halos over the ring) -- the
multi-rank hot path.  On each WAV capture given, this tool asserts:

1. bit-exact channel equality against the one-process overlap-save path
   (dsp.cuda_channels.fused_capture_channels);
2. the frames of the host walk over the sharded-kernel channels equal
   NfcDecoder().decode's (RawFrame.cpp:82-97 equality), and, where a
   golden ``.json`` lies beside the WAV, its Poll/Listen frames.

Run: python -m nfclab_torch.tools.validate_cuda_shard_kernel CAPTURE.wav
[...] [--device cpu].  Under ``torchrun`` every rank joins the layout
(shard/launch.initialize); alone it runs at world size 1.  Exit 1, with a
message, on a missing file, a missing card or any difference.
"""

from __future__ import annotations

import argparse
import os
import sys


def check(path: str, device="cuda") -> str:
    """Run the checks on one WAV; returns the summary line, raises
    AssertionError on a difference."""
    import numpy as np

    from ..dsp.cuda_channels import fused_capture_channels
    from ..io.golden import GOLDEN_TYPES, read_golden_frames
    from ..io.wav import read_wav
    from ..runtime.decoder import NfcDecoder
    from ..shard.multichip import sharded_kernel_channels

    name = os.path.basename(path)
    samples, info = read_wav(path)
    ref = fused_capture_channels(samples, info.sample_rate, device=device)
    got = sharded_kernel_channels(samples, info.sample_rate, device=device)
    if set(got) != set(ref):
        raise AssertionError(f"{name}: channels {sorted(got)} != "
                             f"{sorted(ref)}")
    for k in ref:
        if got[k].dtype != ref[k].dtype or not np.array_equal(
                got[k].view(np.uint8), ref[k].view(np.uint8)):
            raise AssertionError(f"{name}:{k}: sharded != fused_capture_"
                                 "channels")
    frames = NfcDecoder().decode(samples, info.sample_rate,
                                 tpu_channels=got)
    want = NfcDecoder().decode(samples, info.sample_rate)
    if frames != want:
        raise AssertionError(f"{name}: {len(frames)} frames != "
                             f"NfcDecoder().decode's {len(want)}")
    line = (f"{name}: sharded kernel channels bit-exact, {len(frames)} "
            "frames equal NfcDecoder().decode's")
    golden = os.path.splitext(path)[0] + ".json"
    if os.path.exists(golden):
        have = [f for f in frames if f.frame_type in GOLDEN_TYPES]
        gold = read_golden_frames(golden)
        if have != gold:
            raise AssertionError(f"{name}: {len(have)} frames != golden "
                                 f"{len(gold)}")
        line += f", {len(gold)} golden frames OK"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nfclab-torch-validate-shard-kernel",
        description=__doc__.split("\n")[0])
    ap.add_argument("wavs", nargs="+", metavar="CAPTURE.wav")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable
    from ..shard.launch import initialize

    for path in args.wavs:
        if not os.path.isfile(path):
            print(f"error: no such file: {path}", file=sys.stderr)
            return 1
    try:
        initialize(device=args.device)
        for path in args.wavs:
            print(check(path, args.device), flush=True)
    except (DeviceUnavailable, AssertionError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
