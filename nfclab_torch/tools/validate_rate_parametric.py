"""Validate the rate-parametric fused kernels: the device frontends at
capture rates other than 10 MS/s must give exactly the host decode's
frames.

Counterpart of ``nfclab/tools/validate_rate_parametric.py``.  Covers the
reference's own rate flexibility (NfcDecoder.cpp:382-388 re-derives the
bitrate tables on any sample-rate change) on one source capture,
resampled to

- 3.2 MS/s 8-bit (the RTL-SDR degraded mode, README.md:193-201),
- 8 MS/s.

At each rate, the frames of ``NfcDecoder().decode`` fed the mask
frontend's sparse chained triggers (``dsp/cuda_channels.
chained_batch_masks``) and the fused channel frontend's box channels and
triggers (``fused_batch_channels``) must EQUAL the host decode's.

Run: python -m nfclab_torch.tools.validate_rate_parametric SOURCE.wav
[--device cpu].  nfclab's tool reads the reference decoder's fixture
test_NFC-A_106kbps_001.  Prints one OK/MISMATCH line per (rate,
frontend); exit 1, with a message, on a mismatch, no capture or a
missing file, or a missing card (``--device cpu`` runs the kernels'
plain versions).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .fixtures import missing

RATES = ((3_200_000, True), (8_000_000, False))


def _resampled(samples: np.ndarray, src_rate: int, rate: int,
               bits8: bool) -> np.ndarray:
    t_old = np.arange(len(samples)) / src_rate
    n_new = int(len(samples) * rate / src_rate)
    x = np.interp(np.arange(n_new) / rate, t_old, samples)
    if bits8:
        x = np.round(x * 255) / np.float32(255)
    return x.astype(np.float32)


def rate_frames(x: np.ndarray, rate: int, device="cuda") -> dict:
    """The frames of x at ``rate``: {"host", "mask", "fused"}."""
    from ..dsp.cuda_channels import chained_batch_masks, fused_batch_channels
    from ..runtime.decoder import NfcDecoder

    mask = chained_batch_masks([x], rate, device=device)[0]
    chans = fused_batch_channels([x], rate, device=device)[0]
    return {
        "host": NfcDecoder().decode(x.copy(), rate),
        "mask": NfcDecoder().decode(x.copy(), rate, tpu_channels=mask),
        "fused": NfcDecoder().decode(x.copy(), rate, tpu_channels=chans),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nfclab-torch-validate-rate-parametric",
        description=__doc__.split("\n")[0])
    ap.add_argument("wav", nargs="?", metavar="SOURCE.wav")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device
    from ..io.wav import read_wav

    path = args.wav
    if missing([path] if path else []):
        return 1
    samples, info = read_wav(path)
    bad = 0
    try:
        dev = resolve_device(args.device)
        for rate, bits8 in RATES:
            x = _resampled(samples, info.sample_rate, rate, bits8)
            frames = rate_frames(x, rate, dev)
            host = frames["host"]
            if not host:
                print(f"error: the host decode of {path} at {rate} S/s "
                      "gives no frame", file=sys.stderr)
                return 1
            for label in ("mask", "fused"):
                got = frames[label]
                ok = got == host
                print(f"RATE {rate / 1e6:.1f} MS/s [{label}]: "
                      f"{'OK' if ok else 'MISMATCH'} "
                      f"({len(got)} vs {len(host)} frames)", flush=True)
                if not ok:
                    bad += 1
                    for i, (a, b) in enumerate(zip(host, got)):
                        if a != b:
                            print(f"  first diff at frame {i}: {a} vs {b}")
                            break
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
