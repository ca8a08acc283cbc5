"""Hardware smoke harness — the reference's test-dio role.

The reference's test-dio (test-dio/src/main/cpp/main.cpp) enumerates the
logic-analyzer devices on the USB bus, opens the first one, configures
stream capture, and records one second of probe samples to a WAV file.
This tool does the same across every native capture driver (radio and
logic, network and USB): enumerate everything, optionally open one device
and record N seconds to WAV via hw.record.RecordDevice.

Without hardware it degrades to listing the (empty) USB enumerations plus
the loopback devices — and the USB drivers are fully exercisable against
the mock libusb stack (NFCLAB_LIBUSB; see tests/test_usb_logic.py).

    python -m nfclab.tools.hw_smoke                       # enumerate
    python -m nfclab.tools.hw_smoke --capture logicloop://test --seconds 1
"""

from __future__ import annotations

import argparse
import sys
import time


def enumerate_all() -> dict:
    from ..native.binding import (
        native_available,
        sdr_drivers,
        sdr_enumerate,
        usb_device_list,
    )

    if not native_available():
        return {"native": False, "drivers": {}, "usb_bus": []}
    idents = sdr_enumerate()
    drivers = {
        name: [s for s in idents if s.startswith(name + "://")]
        for name in sdr_drivers()
    }
    return {"native": True, "drivers": drivers, "usb_bus": usb_device_list()}


def capture(ident: str, seconds: float, out_path: str | None,
            sample_rate: int | None) -> dict:
    """Open `ident`, stream for `seconds`, optionally write a WAV — the
    test-dio capture loop (device.start(handler) -> storage.write)."""
    import numpy as np

    from ..hw.device import PARAM_CHANNEL_COUNT, PARAM_SAMPLE_RATE
    from ..hw.sdr import LOGIC_SCHEMES, NativeSdrDevice
    from ..io.wav import write_wav

    dev = NativeSdrDevice(ident)
    if not dev.open():
        return {"ident": ident, "opened": False}
    if sample_rate:
        dev.set(PARAM_SAMPLE_RATE, sample_rate)
    rate = int(dev.get(PARAM_SAMPLE_RATE, 10_000_000))
    is_logic = ident.split("://")[0] in LOGIC_SCHEMES
    channels = int(dev.get(PARAM_CHANNEL_COUNT, 4)) if is_logic else 1
    dev.start()
    chunks, total = [], 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        block = dev.read(timeout=0.25)
        if block is None:
            continue
        if len(block) == 0:  # driver EOF
            break
        chunks.append(np.asarray(block))
        total += len(block)
    dev.stop()
    dev.close()
    samples = total // channels
    if out_path and chunks:
        data = np.concatenate(chunks)
        usable = len(data) - len(data) % channels
        data = data[:usable].reshape(-1, channels) if channels > 1 else data
        write_wav(out_path, data, rate, bits=8 if is_logic else 16)
    return {
        "ident": ident,
        "opened": True,
        "sample_rate": rate,
        "channels": channels,
        "samples": samples,
        "seconds": seconds,
        "rate_msps": samples / seconds / 1e6,
        "wav": out_path if chunks else None,
    }


def main(argv=None) -> int:
    import json

    ap = argparse.ArgumentParser(prog="nfclab-hw-smoke", description=__doc__)
    ap.add_argument("--capture", metavar="IDENT",
                    help="open this device and stream (e.g. dslogic://)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", help="record captured samples to this WAV")
    ap.add_argument("--sample-rate", type=int, default=None)
    args = ap.parse_args(argv)

    print(json.dumps(enumerate_all()))
    if args.capture:
        print(json.dumps(
            capture(args.capture, args.seconds, args.out, args.sample_rate)
        ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
