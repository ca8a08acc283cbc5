"""Trace analysis CLI (py_nfclab __main__ parity).

Reads a TRZ trace, a golden/frame JSON file, or JSON-lines from stdin
(the ``nfclab-decode run --json`` stream), detects commands, and prints a
structured listing or JSON export.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..core.frame import Frame, FrameTech, FrameType
from .analyze import annotate_frames, detect_command

_CARRIER_TYPES = {int(FrameType.NfcCarrierOn), int(FrameType.NfcCarrierOff)}


def _load_frames(path: str | None) -> list[Frame]:
    if path is None:
        frames = []
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            data = b""
            if "data" in obj:
                data = bytes(int(t, 16) for t in obj["data"].split(":"))
            frames.append(
                Frame(
                    tech_type=obj.get("tech_type", 0),
                    frame_type=obj.get("frame_type", 0),
                    data=data,
                    sample_start=obj.get("sample_start", 0),
                    sample_end=obj.get("sample_end", 0),
                    sample_rate=obj.get("sample_rate", 0),
                    time_start=float(obj.get("time_start", 0.0)),
                    time_end=float(obj.get("time_end", 0.0)),
                )
            )
        return frames
    if path.endswith(".trz"):
        from ..io.trz import read_trace

        frames, _signals = read_trace(path)
        return frames
    from ..io.golden import read_golden_frames

    return read_golden_frames(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-trace")
    ap.add_argument("path", nargs="?", help="trz/json file (default: stdin)")
    ap.add_argument("--no-carrier", action="store_true")
    ap.add_argument("--json", action="store_true", help="JSON export")
    ap.add_argument("--tree", action="store_true", help="include detail trees")
    ap.add_argument(
        "--html",
        metavar="PATH",
        help="write a standalone HTML report (frame table + protocol "
        "trees + wave strips from TRZ render streams)",
    )
    args = ap.parse_args(argv)

    signals = []
    if args.path and args.path.endswith(".trz"):
        from ..io.trz import read_trace

        frames, signals = read_trace(args.path)
    else:
        frames = _load_frames(args.path)
    if args.no_carrier:
        frames = [f for f in frames if f.frame_type not in _CARRIER_TYPES]

    if args.html:
        from .html_report import render_html

        page = render_html(
            frames, signals, title=args.path or "nfclab trace"
        )
        with open(args.html, "w", encoding="utf-8") as fh:
            fh.write(page)
        print(f"wrote {args.html}")
        return 0

    if args.json:
        out = annotate_frames(frames)
        if not args.tree:
            for o in out:
                o.pop("tree", None)
        json.dump(out, sys.stdout, indent=2)
        print()
        return 0

    for f in frames:
        cmd = detect_command(f) or ""
        try:
            tech = FrameTech(f.tech_type).name
        except ValueError:
            tech = hex(f.tech_type)
        print(
            f"{f.time_start:12.6f}s {tech:12s} {cmd:22s} {f.hex_data}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
