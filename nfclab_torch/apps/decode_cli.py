"""Headless decode CLI of the port.

- ``nfclab-torch-decode test <wav...|dir>``: the golden regression harness:
  decode each wav, compare against the sibling .json, print PASS/FAIL,
  create the golden on first run (TEST UPDATED).
- ``nfclab-torch-decode run <wav...>``: print each decoded frame as a text
  line or compact JSON line (--json).

``--frontend host`` decodes on the host alone; ``--frontend mask`` takes
the detect triggers from the fused frontend kernels (dsp.cuda_channels) on
``--device`` (cuda by default; cpu runs the kernels' plain versions);
``--frontend fused`` takes the conditioning, every correlator channel and
the detect mask from them (``fused_capture_all``), and only the
carrier-edge tracker and the walk run on the host.  ``--conditioner jax``
conditions on ``--device`` with the device conditioner
(dsp.conditioner.condition_jax) instead of the C++ one; it combines with
the host and mask frontends (the fused one conditions on the device
anyway).  Multi-channel (ISO7816 logic) captures are not decoded by the
port yet.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from ..core.frame import Frame, FrameFlags, FrameTech, FrameType
from ..io.golden import GOLDEN_TYPES, read_golden_frames, write_golden_frames
from ..runtime.decoder import NfcDecoder

_TECH_NAMES = {
    int(FrameTech.NfcATech): "NfcA",
    int(FrameTech.NfcBTech): "NfcB",
    int(FrameTech.NfcFTech): "NfcF",
    int(FrameTech.NfcVTech): "NfcV",
    int(FrameTech.NfcAnyTech): "NFC",
    int(FrameTech.Iso7816Tech): "ISO7816",
    int(FrameTech.IsoAnyTech): "ISO",
}
_TYPE_NAMES = {
    int(FrameType.NfcCarrierOn): "CARRIER_ON",
    int(FrameType.NfcCarrierOff): "CARRIER_OFF",
    int(FrameType.NfcPollFrame): "POLL",
    int(FrameType.NfcListenFrame): "LISTEN",
    int(FrameType.IsoATRFrame): "ATR",
    int(FrameType.IsoRequestFrame): "REQUEST",
    int(FrameType.IsoResponseFrame): "RESPONSE",
    int(FrameType.IsoExchangeFrame): "EXCHANGE",
}


def frame_json(frame: Frame) -> str:
    """Compact JSON line (app-rx printFrameJSON parity, main.cpp:350-440)."""
    obj: dict = {
        "timestamp": int(frame.sample_start),
        "tech": _TECH_NAMES.get(int(frame.tech_type), "UNKNOWN"),
        "type": _TYPE_NAMES.get(int(frame.frame_type), "UNKNOWN"),
        "tech_type": int(frame.tech_type),
        "frame_type": int(frame.frame_type),
        "time_start": 0 if frame.time_start == 0.0 else frame.time_start,
        "time_end": 0 if frame.time_end == 0.0 else frame.time_end,
        "sample_start": int(frame.sample_start),
        "sample_end": int(frame.sample_end),
        "sample_rate": int(frame.sample_rate),
        "date_time": (
            int(frame.date_time)
            if frame.date_time == math.floor(frame.date_time)
            else frame.date_time
        ),
    }
    if frame.frame_rate > 0:
        obj["rate"] = int(frame.frame_rate)
    if frame.data:
        obj["data"] = ":".join(f"{b:02x}" for b in frame.data)
        obj["length"] = len(frame.data)
    flags = []
    if frame.has_flags(FrameFlags.CrcError):
        flags.append("crc-error")
    if frame.has_flags(FrameFlags.ParityError):
        flags.append("parity-error")
    if frame.has_flags(FrameFlags.SyncError):
        flags.append("sync-error")
    if frame.has_flags(FrameFlags.Truncated):
        flags.append("truncated")
    if frame.has_flags(FrameFlags.Encrypted):
        flags.append("encrypted")
    if frame.frame_type in (int(FrameType.NfcPollFrame), int(FrameType.IsoRequestFrame)):
        flags.append("request")
    elif frame.frame_type in (
        int(FrameType.NfcListenFrame),
        int(FrameType.IsoResponseFrame),
    ):
        flags.append("response")
    if flags:
        obj["flags"] = flags
    return json.dumps(obj, separators=(",", ":"))


def frame_text(frame: Frame) -> str:
    """Text line (app-rx printFrame parity)."""
    tech = _TECH_NAMES.get(int(frame.tech_type), "?")
    ftype = _TYPE_NAMES.get(int(frame.frame_type), "?")
    data = ":".join(f"{b:02X}" for b in frame.data)
    return f"{frame.time_start:010.3f} {tech:8s} {ftype:8s} {data}"


def _thresholds_from_args(args):
    """Per-tech threshold config from --protocol-config (the reference's
    JSON decoder-config workflow, RadioDecoderTask.cpp:207-366: per-tech
    correlationThreshold + minimumModulationDeep/maximumModulationDeep
    merged onto the defaults).  The file holds either the ``protocol``
    subtree directly or a config object containing one."""
    from ..core.thresholds import DecoderThresholds

    path = getattr(args, "protocol_config", None)
    if not path:
        return DecoderThresholds()
    with open(path, encoding="utf-8") as fh:
        cfg = json.load(fh)
    proto = cfg.get("protocol", cfg)
    return DecoderThresholds.from_protocol_config(proto)


class UnsupportedCapture(Exception):
    """A capture the port cannot decode yet."""


def _decode(path: str, args) -> list[Frame]:
    from ..io.wav import read_wav

    samples, info = read_wav(path)
    if info.channels > 1:
        raise UnsupportedCapture(
            f"{path}: {info.channels}-channel capture (ISO7816 logic "
            "probes); nfclab_torch decodes radio captures only so far"
        )
    dec = NfcDecoder(
        enable_nfca=not args.disable_nfca,
        enable_nfcb=not args.disable_nfcb,
        enable_nfcf=not args.disable_nfcf,
        enable_nfcv=not args.disable_nfcv,
        power_level_threshold=args.power_threshold,
        conditioner=args.conditioner,
        thresholds=_thresholds_from_args(args),
    )
    if args.frontend == "fused":
        # conditioning + correlator channels + detect triggers from the
        # fused kernels; only the edge tracker + walk run on the host
        from ..dsp.cuda_channels import fused_capture_all

        cond, chans = fused_capture_all(
            samples, info.sample_rate, args.power_threshold,
            thresholds=dec.thresholds, device=args.device,
        )
        return dec.decode(samples, info.sample_rate, cond=cond,
                          tpu_channels=chans)
    cond = chans = None
    if args.conditioner == "jax":
        # the device conditioner on --device; the decoder takes its arrays
        from ..core.params import SignalParams
        from ..dsp.conditioner import condition_jax

        params = SignalParams(info.sample_rate,
                              power_level_threshold=args.power_threshold)
        cond = condition_jax(samples, params, device=args.device)
    if args.frontend == "mask":
        # detect triggers only from the kernels (compacted on the device);
        # the box channels build natively on the host
        from ..dsp.cuda_channels import fused_capture_masks

        chans = fused_capture_masks(
            samples, info.sample_rate, args.power_threshold,
            thresholds=dec.thresholds, device=args.device,
        )
    return dec.decode(samples, info.sample_rate, cond=cond,
                      tpu_channels=chans)


def _check_paths(paths) -> str | None:
    """First missing input path, or None."""
    for p in paths:
        if not Path(p).exists():
            return str(p)
    return None


def cmd_test(args) -> int:
    missing = _check_paths(args.paths)
    if missing:
        print(f"error: no such file or directory: {missing}",
              file=sys.stderr)
        return 1
    paths: list[Path] = []
    for p in args.paths:
        p = Path(p)
        if p.is_dir():
            paths.extend(sorted(p.glob("*.wav")))
        else:
            paths.append(p)
    failures = 0
    for wav in paths:
        target = wav.with_suffix(".json")
        frames = [
            f for f in _decode(str(wav), args)
            if f.frame_type in GOLDEN_TYPES
        ]
        if target.exists():
            want = read_golden_frames(str(target))
            ok = frames == want
            print(f"TEST FILE {wav.stem}: {'PASS' if ok else 'FAIL'}")
            failures += not ok
        else:
            write_golden_frames(str(target), frames)
            print(f"TEST FILE {wav.stem}: TEST UPDATED!")
    return 1 if failures else 0


def cmd_run(args) -> int:
    missing = _check_paths(args.paths)
    if missing:
        print(f"error: no such file or directory: {missing}",
              file=sys.stderr)
        return 1
    for wav in args.paths:
        for frame in _decode(wav, args):
            print(frame_json(frame) if args.json else frame_text(frame))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-torch-decode")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("test", cmd_test), ("run", cmd_run)):
        p = sub.add_parser(name)
        p.add_argument("paths", nargs="+")
        p.add_argument("--json", "-j", action="store_true")
        p.add_argument("--disable-nfca", action="store_true")
        p.add_argument("--disable-nfcb", action="store_true")
        p.add_argument("--disable-nfcf", action="store_true")
        p.add_argument("--disable-nfcv", action="store_true")
        p.add_argument("--power-threshold", type=float, default=0.01)
        p.add_argument(
            "--protocol-config", metavar="JSON",
            help="per-tech threshold config file (the reference's "
            "'protocol' JSON subtree: nfca/nfcb/nfcf/nfcv sections with "
            "correlationThreshold + minimum/maximumModulationDeep)",
        )
        p.add_argument(
            "--conditioner", choices=("native", "jax"), default="native",
            help="native = the C++ conditioner on the host; jax = the "
            "device conditioner (nfclab's name) on --device",
        )
        p.add_argument(
            "--frontend", choices=("host", "fused", "mask"),
            default="host",
            help="fused = conditioning, correlator channels and detect "
            "triggers computed by the fused frontend kernels "
            "(dsp.cuda_channels); mask = detect triggers only, compacted "
            "on the device",
        )
        p.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where --frontend fused|mask and --conditioner jax run: "
            "cuda (the kernels) or cpu (their plain PyTorch versions)",
        )
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    from ..dsp.cuda_channels import DeviceUnavailable

    try:
        return args.fn(args)
    except (UnsupportedCapture, DeviceUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
