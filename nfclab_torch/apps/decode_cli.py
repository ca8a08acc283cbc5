"""Headless decode CLI of the port.

- ``nfclab-torch-decode test <wav...|dir>``: the golden regression harness:
  decode each wav, compare against the sibling .json, print PASS/FAIL,
  create the golden on first run (TEST UPDATED).
- ``nfclab-torch-decode run <wav...>``: print each decoded frame as a text
  line or compact JSON line (--json); ``--html OUT`` also writes nfclab's
  report (frame table, protocol trees, spectrum waterfall, wave strips).
- ``nfclab-torch-decode live <uri>``: live SDR capture (loopback, rtl_tcp,
  SpyServer or a USB radio through the native bridge) or live
  logic-analyzer capture (logicloop, logictcp, DSLogic, Sipeed) decoded as
  it streams, each frame printed as it completes; ``--monitor PORT``
  serves nfclab's live monitor, its spectrum on ``--device``.

``--frontend host`` decodes on the host alone; ``--frontend mask`` takes
the detect triggers from the fused frontend kernels (dsp.cuda_channels) on
``--device`` (cuda by default; cpu runs the kernels' plain versions);
``--frontend fused`` takes the conditioning, every correlator channel and
the detect mask from them (``fused_capture_all``), and only the
carrier-edge tracker and the walk run on the host.  ``live --frontend
mask`` runs the live decoder on a one-stream CudaStreamFarm on
``--device``; it exits 1 when its decoder task (or, with --monitor,
FourierTask or ResamplingTask) fails, and never falls back to the host
frontend.  ``--conditioner jax``
conditions on ``--device`` with the device conditioner
(dsp.conditioner.condition_jax) instead of the C++ one; it combines with
the host and mask frontends (the fused one conditions on the device
anyway).  Multi-channel captures are logic-analyzer probes: they decode
with the ISO7816 decoder (runtime.logic_decoder.IsoDecoder), the probes
named by ``--channel-map``, as nfclab's CLI does; the radio options do not
apply to them.
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


def _parse_channel_map(spec: str | None):
    """--channel-map 'io=2,clk=0,rst=1,vcc=3' or '2,0,1,3' ([io,clk,rst,
    vcc] physical probe indices)."""
    if not spec:
        return None
    if "=" in spec:
        out = {}
        for part in spec.split(","):
            k, _, v = part.partition("=")
            out[k.strip().lower()] = int(v)
        return out
    return [int(x) for x in spec.split(",")]


def _decode(path: str, args):
    """(frames, samples, info) of one WAV, read once."""
    from ..io.wav import read_wav

    samples, info = read_wav(path)
    if info.channels > 1:
        # multi-channel capture = logic-analyzer probes -> ISO7816 decoder
        # (nfclab routes these to IsoDecoder the same way)
        from ..runtime.logic_decoder import IsoDecoder

        dec = IsoDecoder(channel_map=_parse_channel_map(args.channel_map))
        return dec.decode(samples, info.sample_rate), samples, info
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
        frames = dec.decode(samples, info.sample_rate, cond=cond,
                            tpu_channels=chans)
        return frames, samples, info
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
    frames = dec.decode(samples, info.sample_rate, cond=cond,
                        tpu_channels=chans)
    return frames, samples, info


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
            f for f in _decode(str(wav), args)[0]
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
    sections = []
    all_frames: list[Frame] = []
    for wav in args.paths:
        frames, samples, info = _decode(wav, args)
        all_frames.extend(frames)
        for frame in frames:
            print(frame_json(frame) if args.json else frame_text(frame))
        if args.html:
            # spectrum waterfall + wave strip per capture (GUI views)
            from ..tools.html_report import capture_sections

            sections.append(
                capture_sections(
                    Path(wav).stem, samples, info.sample_rate, frames
                )
            )
    if args.html:
        from ..tools.html_report import render_html

        page = render_html(
            all_frames, title=" + ".join(Path(p).stem for p in args.paths),
            extra_sections="".join(sections),
        )
        with open(args.html, "w", encoding="utf-8") as fh:
            fh.write(page)
        print(f"wrote {args.html}")
    return 0


def reconcile_decoder(command_subject, desired: dict,
                      timeout: float = 5.0) -> dict:
    """app-rx's desired-vs-actual reconciliation (main.cpp:225-345):
    Query the decoder task's current config, diff against `desired`
    (detect_changes), send Configure with ONLY the changed subset, and
    return the converged snapshot.  `desired` uses the task's status
    shape: {"powerLevelThreshold": ..., "protocol": {nfca: {...}, ...}}."""
    import threading as _threading

    from ..runtime.config import detect_changes
    from ..runtime.subject import Event

    def call(code, params=None):
        done = _threading.Event()
        out: dict = {}

        def ok(snap):
            out["snap"] = snap
            done.set()

        def bad(err):
            out["err"] = err
            done.set()

        command_subject.next(
            Event(code, params, on_resolve=ok, on_reject=bad)
        )
        if not done.wait(timeout):
            raise TimeoutError(f"decoder command {code!r} unanswered")
        if "err" in out:
            raise RuntimeError(out["err"])
        return out["snap"]

    snap = call("query")
    diff = detect_changes(snap, desired)
    if diff:
        # the Configure surface applies minimum/maximumModulationDeep only
        # as a PAIR (reference configDecoder semantics); a one-sided diff
        # would be silently dropped and the reconcile would never converge,
        # so complete the pair from the current snapshot
        for tech, sect in (diff.get("protocol") or {}).items():
            if not isinstance(sect, dict):
                continue
            keys = ("minimumModulationDeep", "maximumModulationDeep")
            present = [k for k in keys if k in sect]
            if len(present) == 1:
                other = keys[1 - keys.index(present[0])]
                sect[other] = snap["protocol"][tech][other]
        snap = call("configure", diff)
    return snap


def cmd_live(args) -> int:
    """Live capture + decode (app-rx's receiver role, main.cpp:189-345):
    a native-bridge SDR device streams into the incremental decoder; frames
    print as they complete.  A logic-analyzer URI (hw.sdr.LOGIC_SCHEMES)
    streams into the incremental ISO7816 decoder instead.  ``--monitor``
    adds nfclab's monitor: FourierTask (the spectrum on --device),
    ResamplingTask and the MonitorServer on the bus.  Exits 1 when the
    decoder task, FourierTask or ResamplingTask ends in error (a failed
    dispatch of the mask frontend, say): frames stop there.
    ``--trace-out PATH`` records the live path's spans (runtime/trace)
    and writes them to PATH as Chrome-trace JSON at exit."""
    import queue as _queue

    from ..hw.device import (
        PARAM_GAIN_MODE,
        PARAM_GAIN_VALUE,
        PARAM_SAMPLE_RATE,
        PARAM_TUNE_FREQUENCY,
    )
    from ..hw.sdr import LOGIC_SCHEMES
    from ..runtime.pipeline import (
        Executor,
        LiveRadioSourceTask,
        RadioDecoderTask,
    )
    from ..runtime.subject import Subject

    frames: "_queue.Queue" = _queue.Queue()

    def watch(task: str):
        """Observer of a task's status: its error wakes the printing loop
        below."""
        def on_status(status):
            if status.get("status") == "error":
                frames.put({"task": task, "error": status.get("error")})
        return on_status

    if args.uri.split("://")[0] in LOGIC_SCHEMES:
        # live logic capture (logicloop / logictcp / dslogic / sipeed) ->
        # streaming ISO7816 decoder (LogicDeviceTask+LogicDecoderTask role)
        from ..runtime.pipeline import LiveLogicSourceTask, LogicDecoderTask

        prefix = "logic.decoder"
        source = LiveLogicSourceTask(
            args.uri, {PARAM_SAMPLE_RATE: args.sample_rate},
            duration_blocks=args.blocks,
        )
        decoder = LogicDecoderTask(
            channel_map=_parse_channel_map(args.channel_map)
        )
    else:
        config = {PARAM_SAMPLE_RATE: args.sample_rate}
        if args.frequency:
            config[PARAM_TUNE_FREQUENCY] = args.frequency
        if args.gain is not None:
            config[PARAM_GAIN_MODE] = 1
            config[PARAM_GAIN_VALUE] = args.gain
        prefix = "radio.decoder"
        # DeviceUnavailable (main prints it) before any capture starts
        decoder = RadioDecoderTask(
            frontend=args.frontend,
            device=args.device,
            enable_nfca=not args.disable_nfca,
            enable_nfcb=not args.disable_nfcb,
            enable_nfcf=not args.disable_nfcf,
            enable_nfcv=not args.disable_nfcv,
            power_level_threshold=args.power_threshold,
            thresholds=_thresholds_from_args(args),
        )
        source = LiveRadioSourceTask(
            args.uri, config, duration_blocks=args.blocks,
            reconnect=args.reconnect,
        )
    monitor_tasks = []
    if args.monitor is not None:
        # live monitoring view: spectrum + adaptive-wave tasks + one-page
        # web app off the bus; the spectrum runs on --device
        # (DeviceUnavailable, which main prints, before any capture starts)
        from ..runtime.pipeline import FourierTask, ResamplingTask

        monitor_tasks = [FourierTask(device=args.device), ResamplingTask()]
        for task in ("fourier", "adaptive"):
            Subject.name(f"{task}.status").subscribe(watch(task),
                                                     replay=False)
    Subject.name(f"{prefix}.frame").subscribe(frames.put, replay=False)
    Subject.name(f"{prefix}.status").subscribe(watch("decoder"),
                                               replay=False)
    # SIGTERM (systemd stop, `timeout`) should shut the capture chain down
    # like ^C: Python's default action kills the process mid-stream with
    # native reader threads still in recv(), which aborts at teardown
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # non-main thread (embedded use): keep default

    if args.trace_out:
        from ..runtime import trace

        trace.enable()
    monitor = None
    ex = Executor(pool_size=4)
    if monitor_tasks:
        from .monitor import MonitorServer

        for task in monitor_tasks:
            ex.submit(task)
        monitor = MonitorServer(port=args.monitor).start()
        print(
            f"# monitor: http://127.0.0.1:{monitor.port}/", file=sys.stderr
        )
    ex.submit(decoder)

    # persistent settings tier (the reference's nfc-lab.ini): stored
    # decoder settings apply first, then an explicit --config file wins;
    # the reconciled state is written back at exit
    store = None
    if not args.no_settings:
        from ..runtime.config import SettingsStore, merge_patch

        store = SettingsStore(args.settings)
    desired = store.load().get("decoder", {}) if store else {}
    file_desired = {}
    if args.config:
        # app-rx reconciliation: desired config file -> Query/diff/Configure.
        # Must complete BEFORE the source starts streaming: Configure takes
        # effect at the next decode session, and a live capture is one
        # session from its first buffer on.
        with open(args.config, encoding="utf-8") as fh:
            file_desired = json.load(fh).get("decoder", {})
        desired = merge_patch(desired, file_desired) if store else file_desired
    if desired and not isinstance(decoder, RadioDecoderTask):
        if file_desired:
            # only warn about an EXPLICIT --config; silently skip stored
            # radio settings on a logic session
            print("# --config decoder section applies to radio capture",
                  file=sys.stderr)
    elif desired:
        snap = reconcile_decoder(
            Subject.name("radio.decoder.command"), desired
        )
        print(f"# decoder configured: {json.dumps(snap)}", file=sys.stderr)

    ex.submit(source)

    count = 0
    failed = None
    try:
        while True:
            frame = frames.get(timeout=args.timeout)
            if isinstance(frame, dict):  # a task's error status
                failed = frame
                break
            if frame is None:  # per-session EOF sentinel
                if args.reconnect:
                    continue  # next session follows after the rescan
                break
            print(frame_json(frame) if args.json else frame_text(frame))
            count += 1
    except (_queue.Empty, KeyboardInterrupt):
        pass
    finally:
        if store is not None and isinstance(decoder, RadioDecoderTask):
            # persist the decoder's final state (incl. any live Configure
            # changes) — QSettings-at-exit parity
            try:
                snap = decoder._command_snapshot()
                snap.pop("status", None)
                store.update({"decoder": snap})
            except Exception as e:
                print(f"# settings not saved: {e!r}", file=sys.stderr)
        ex.shutdown()
        if monitor is not None:
            monitor.stop()
        if args.trace_out:
            trace.disable()
            n = trace.export(args.trace_out)
            print(f"# trace: {n} spans in {args.trace_out}", file=sys.stderr)
    print(f"# {count} frames", file=sys.stderr)
    if failed is not None:
        print(f"error: {failed['task']} task failed: {failed['error']}",
              file=sys.stderr)
        return 1
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
        p.add_argument(
            "--channel-map", metavar="MAP",
            help="ISO7816 probe wiring: 'io=2,clk=0,rst=1,vcc=3' or "
            "'2,0,1,3' ([io,clk,rst,vcc] physical probe indices)",
        )
        if name == "run":
            p.add_argument(
                "--html", metavar="OUT",
                help="write an HTML report (frame table + protocol trees + "
                "spectrum waterfall + wave strips)",
            )
        p.set_defaults(fn=fn)
    p = sub.add_parser("live", help="live SDR capture + decode")
    p.add_argument(
        "uri",
        help="auto (hotplug-scan USB radios, attach when one appears) | "
             "auto://scheme1,scheme2 | "
             "loopback://test | rtltcp://host:port | spyserver://host:port "
             "| airspy:// hydrasdr:// rtlsdr:// mirisdr:// (USB radio) "
             "| logicloop://test | logictcp://host:port | dslogic:// | "
             "sipeed:// (ISO7816)",
    )
    p.add_argument("--json", "-j", action="store_true")
    p.add_argument("--sample-rate", type=float, default=10_000_000)
    p.add_argument("--frequency", type=float, default=27_120_000)
    p.add_argument("--gain", type=float, default=None)
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N capture blocks (default: run until ^C)")
    p.add_argument("--reconnect", action="store_true",
                   help="keep rescanning/reopening the device after "
                        "disconnect (the reference GUI's 1 Hz hotplug loop)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="idle seconds before exiting")
    p.add_argument("--disable-nfca", action="store_true")
    p.add_argument("--disable-nfcb", action="store_true")
    p.add_argument("--disable-nfcf", action="store_true")
    p.add_argument("--disable-nfcv", action="store_true")
    p.add_argument("--power-threshold", type=float, default=0.01)
    p.add_argument(
        "--protocol-config", metavar="JSON",
        help="per-tech threshold config file (see 'run --protocol-config')",
    )
    p.add_argument(
        "--channel-map", metavar="MAP",
        help="ISO7816 probe wiring (see 'run --channel-map')",
    )
    p.add_argument(
        "--frontend", choices=("host", "mask"), default="host",
        help="live dense frontend: host (native conditioning + trigger "
        "scan) or mask (detect triggers from the fused frontend kernels "
        "on --device: pipelined 8-chunk dispatches, device-compacted "
        "fetch; no host fallback)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where --frontend mask and --monitor's spectrum run: cuda "
        "(the kernels, cuFFT) or cpu (their plain PyTorch versions, "
        "PyTorch's CPU FFT)",
    )
    p.add_argument(
        "--settings", metavar="PATH", default=None,
        help="persistent settings file (default "
        "~/.config/nfclab/settings.json or $NFCLAB_SETTINGS); stored "
        "decoder settings load at start and the final state — including "
        "live Configure changes — is saved at exit",
    )
    p.add_argument(
        "--no-settings", action="store_true",
        help="do not load or save the persistent settings file",
    )
    p.add_argument(
        "--monitor", type=int, metavar="PORT", default=None,
        help="serve the live monitor view (frame table + spectrum + task "
        "status) on this port (0 = ephemeral; URL printed to stderr); the "
        "spectrum runs on --device",
    )
    p.add_argument(
        "--config", metavar="JSON",
        help="desired decoder config file (app-rx reconciliation: Query "
        "the running task, diff, Configure only the changes; 'decoder' "
        "section with powerLevelThreshold + protocol subtree)",
    )
    p.add_argument(
        "--trace-out", metavar="PATH", default=None,
        help="record the live path's spans (the decoder task's queue, "
        "feed and publish; the farm's staging, IO thread, device steps "
        "and walk) and write them to PATH as Chrome-trace JSON at exit",
    )
    p.set_defaults(fn=cmd_live)
    args = ap.parse_args(argv)
    from ..dsp.cuda_channels import DeviceUnavailable

    try:
        return args.fn(args)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
