"""Subprocess body for tests/test_torch_logic_cli.py's USB logic-analyzer
tests: the port's counterpart of tests/usb_logic_child.py.

Runs in a fresh interpreter whose NFCLAB_LIBUSB points at the mock libusb
(tests/mock_libusb.cpp), so the port's native bridge binds the mock device
stack.  Checks that the driver enumerates the mock device, then runs the
port's ``decode_cli live <ident> --json``: USB driver ->
LiveLogicSourceTask -> LogicDecoderTask, each frame printed as one JSON
line for the parent to compare against the one-shot decode.

argv: <ident> <sample_rate>     e.g.  sipeed:// 24000000
"""

import ctypes
import sys


def main() -> int:
    ident, rate = sys.argv[1], int(sys.argv[2])

    from nfclab_torch.apps import decode_cli
    from nfclab_torch.native.binding import _load

    # the USB drivers must enumerate the mock devices
    lib = _load()
    buf = ctypes.create_string_buffer(4096)
    lib.nfclab_sdr_enumerate(buf, len(buf))
    listed = buf.value.decode()
    scheme = ident.split(":")[0]
    assert f"{scheme}://" in listed, f"{scheme} not enumerated: {listed!r}"

    return decode_cli.main(["live", ident, "--json", "--no-settings",
                            "--sample-rate", str(rate), "--timeout", "30"])


if __name__ == "__main__":
    sys.exit(main())
