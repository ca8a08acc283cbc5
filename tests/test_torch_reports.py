"""The port's reports and live monitor against nfclab's on the CPU: the
copied protocol parsers, tools (analyze, html_report, trace_cli) and
apps/monitor.py, wired into `decode_cli run --html` and `decode_cli live
--monitor`.

- ``ProtocolParser`` / ``parse_frames_to_json`` / ``annotate_frames`` of
  both packages give equal JSON on the frames of the torch_synth
  templates, of torch_logic_synth sessions and of the command sets of
  tests/test_parser_synth.py.
- ``decode_cli run --html``: the port's page with --frontend host,
  --frontend mask --device cpu and --conditioner jax --device cpu equals
  nfclab's page byte for byte on a synthetic radio WAV, and on an 8-bit
  logic WAV with --channel-map (wave strips for each probe).
- ``trace_cli`` of both packages on one TRZ: equal text, --json, --json
  --tree and --html output.
- ``decode_cli live spyserver://... --frontend mask --device cpu --monitor
  0`` against the mock SpyServer, CHAIN_CHUNK cut to 4096: `/` serves the
  page, the last `/data` snapshot holds the last printed frames with their
  detail trees (a WUPA node), the spectrum, the waterfall, the wave and
  the four statuses; the printed lines equal the run without --monitor.
  A FourierTask or ResamplingTask that fails ends the CLI with exit 1.
- ``MonitorServer``'s `/command` and `/open` on the port's bus (nfclab's
  tests/test_monitor.py command-plane and open-trace tests on synthetic
  captures).
nfclab's CLI runs in this process, its native binding loaded from a copy
of the port's library (tests/torch_native.py).
"""

import dataclasses
import json
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_monitor
import torch_synth
from torch_logic_synth import SAMPLE_RATE as LOGIC_RATE
from torch_logic_synth import logic_lane, make_session

RATE = torch_synth.RATE
CHUNK = 4096
LOGIC_WIRING = [1, 2, 3, 0]  # physical probes carry [clk, rst, vcc, io]
LOGIC_CMAP = "io=3,clk=0,rst=1,vcc=2"


@pytest.fixture(autouse=True, scope="module")
def _jax_cpu():
    from conftest import ensure_cpu_devices

    ensure_cpu_devices()


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """Both packages' native libraries (nfclab's from a copy of the
    port's)."""
    from torch_native import use_ref_native

    from nfclab_torch.native.binding import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    use_ref_native(tmp_path_factory.mktemp("native_reports"))


def _wupa_capture(seed=700, n=None):
    """A WUPA (short frame 52) and its ATQA, then the NFC-A 106k template
    once, cut to n samples: ([n] float32 magnitude, the port's host frames
    of it)."""
    from nfca_synth import ListenWriter

    from nfclab_torch.runtime.decoder import NfcDecoder

    w = ListenWriter()
    w.frame(b"\x52", short=True)
    w.listen_frame(b"\x04\x00")
    w.gap()
    tp = torch_synth.templates()[0]
    lane = torch_synth.lane(tp, len(tp.samples) + 4096, seed=seed)[0]
    x = np.concatenate([w.build(4096), lane])[:n].astype(np.float32)
    return x, NfcDecoder().decode(x, RATE)


def _as_ref(frames):
    from nfclab.core.frame import Frame

    return [Frame(**dataclasses.asdict(f)) for f in frames]


def _as_port(frames):
    from nfclab_torch.core.frame import Frame

    return [Frame(**dataclasses.asdict(f)) for f in frames]


def _frames(source):
    """(the port's frames, nfclab's equal frames) of a source."""
    if source == "templates":
        from nfclab_torch.runtime.decoder import NfcDecoder

        port = []
        for i, tp in enumerate(torch_synth.templates()):
            x = torch_synth.lane(tp, 2 * len(tp.samples), seed=800 + i)[0]
            port += NfcDecoder().decode(x, RATE)
        return port, _as_ref(port)
    if source == "logic":
        from nfclab_torch.runtime.logic_decoder import IsoDecoder

        port = IsoDecoder().decode(logic_lane(1 << 21, seed=810)[0],
                                   LOGIC_RATE)
        port += IsoDecoder().decode(make_session(atr=(0x3B, 0x02, 0x41,
                                                      0x42)), LOGIC_RATE)
        return port, _as_ref(port)
    import test_parser_synth

    ref = [f for _, fs in test_parser_synth.EXCHANGES for f in fs]
    return _as_port(ref), ref


@pytest.mark.parametrize("source", ["templates", "logic", "commands"])
def test_parsers_and_analyze_equal_nfclab(native, source):
    """Equal JSON from both packages: parse_frames_to_json, each
    ProtocolParser.parse in turn, annotate_frames and detect_command."""
    from nfclab.protocol.parser import ProtocolParser as RefParser
    from nfclab.protocol.parser import parse_frames_to_json as ref_json
    from nfclab.tools.analyze import annotate_frames as ref_annotate
    from nfclab.tools.analyze import detect_command as ref_detect

    from nfclab_torch.protocol.parser import (
        ProtocolParser, parse_frames_to_json,
    )
    from nfclab_torch.tools.analyze import annotate_frames, detect_command

    port, ref = _frames(source)
    assert len(port) >= 10
    got = parse_frames_to_json(port)
    assert got == ref_json(ref) and len(got) >= len(port) // 2
    pp, rp = ProtocolParser(), RefParser()
    for f, r in zip(port, ref):
        a, b = pp.parse(f), rp.parse(r)
        assert (a is None) == (b is None)
        assert a is None or a.to_json() == b.to_json()
        assert detect_command(f) == ref_detect(r)
    assert annotate_frames(port) == ref_annotate(ref)


def _main(module, argv, capsys):
    """A package's decode_cli or trace_cli main() in this process:
    (returncode, stdout lines, stderr)."""
    import importlib

    pkg = module.split(".")[0]
    importlib.import_module(f"{pkg}.runtime.subject").Subject.clear_registry()
    capsys.readouterr()
    old = signal.getsignal(signal.SIGTERM)
    try:
        rc = importlib.import_module(module).main([str(a) for a in argv])
    finally:
        signal.signal(signal.SIGTERM, old)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


@pytest.fixture(scope="module")
def radio_wav(native, tmp_path_factory):
    from nfclab_torch.io.wav import write_wav

    path = tmp_path_factory.mktemp("html") / "wupa_nfca.wav"
    write_wav(str(path), _wupa_capture(n=20_292)[0], RATE)
    return path


@pytest.fixture(scope="module")
def logic_wav(native, tmp_path_factory):
    """An 8-bit 4-channel WAV of a session, probes permuted (decoded
    with --channel-map)."""
    from nfclab_torch.io.wav import write_wav

    x = make_session(atr=(0x3B, 0x00), tpdu=(0x00, 0xA4, 0x04, 0x00, 0x02,
                                             0xA4, 0x3F, 0x00, 0x90, 0x00))
    path = tmp_path_factory.mktemp("html_logic") / "logic.wav"
    write_wav(str(path), np.ascontiguousarray(x[:, LOGIC_WIRING]),
              LOGIC_RATE, bits=8)
    return path


@pytest.mark.parametrize("route", ["host", "mask", "conditioner_jax",
                                   "logic_channel_map"])
def test_run_html_equals_nfclab(route, radio_wav, logic_wav, tmp_path,
                                capsys, monkeypatch):
    """The port's run --json --html page and lines equal nfclab's (its
    host route) byte for byte.  The mask route chains chunks of 4096 (the
    capture is padded to whole chunks)."""
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)
    extra = {"host": [], "mask": ["--frontend", "mask", "--device", "cpu"],
             "conditioner_jax": ["--conditioner", "jax", "--device", "cpu"],
             "logic_channel_map": ["--channel-map", LOGIC_CMAP]}[route]
    wav = logic_wav if route == "logic_channel_map" else radio_wav
    ref_extra = extra if route == "logic_channel_map" else []
    pages = {}
    for pkg, args in (("nfclab", ref_extra), ("nfclab_torch", extra)):
        out = tmp_path / pkg / "report.html"
        out.parent.mkdir()
        rc, lines, err = _main(f"{pkg}.apps.decode_cli",
                               ["run", "--json", *args, "--html", out, wav],
                               capsys)
        assert rc == 0, err
        assert lines[-1] == f"wrote {out}"
        pages[pkg] = (lines[:-1], out.read_bytes())
    assert pages["nfclab_torch"] == pages["nfclab"]
    lines, page = pages["nfclab_torch"]
    assert len(lines) >= 4 and b"<h2>Frames</h2>" in page
    if route == "logic_channel_map":
        assert b"logic \xe2\x80\x94 logic probe" in page
        assert b"spectrum \xe2\x80\x94" not in page
        assert b"ATR" in page
    else:
        assert b"spectrum \xe2\x80\x94 wupa_nfca" in page
        assert b"WUPA" in page


@pytest.fixture(scope="module")
def trz(native, tmp_path_factory):
    """A TRZ of the port's io.trz: the WUPA capture's frames and its
    radio render stream."""
    from nfclab_torch.dsp.resample import resample_radio
    from nfclab_torch.io.trz import SignalStream, write_trace

    x, frames = _wupa_capture()
    vals, offs = resample_radio(x)
    path = tmp_path_factory.mktemp("trz") / "session.trz"
    write_trace(str(path), frames, [SignalStream(
        0, RATE, "radio", offsets=offs.astype(np.int64), values=vals)])
    return path


@pytest.mark.parametrize("mode", ["text", "no_carrier", "json", "tree",
                                  "html"])
def test_trace_cli_equals_nfclab(mode, trz, tmp_path, capsys):
    """Both packages' trace_cli on one TRZ print the same output (and
    write the same page)."""
    args = {"text": [], "no_carrier": ["--no-carrier"], "json": ["--json"],
            "tree": ["--json", "--tree"],
            "html": ["--html", tmp_path / "trace.html"]}[mode]
    out = {}
    for pkg in ("nfclab", "nfclab_torch"):
        rc, lines, err = _main(f"{pkg}.tools.trace_cli", [trz, *args],
                               capsys)
        assert rc == 0, err
        out[pkg] = (lines, (tmp_path / "trace.html").read_bytes()
                    if mode == "html" else None)
    assert out["nfclab_torch"] == out["nfclab"]
    lines, page = out["nfclab_torch"]
    if mode == "html":
        assert b"WUPA" in page and b"<svg" in page
    elif mode == "tree":
        assert any('"tree"' in ln for ln in lines)
    else:
        assert lines


@pytest.fixture
def small_chunk(monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)


LIVE = ("live", "--json", "--no-settings", "--sample-rate", str(RATE),
        "--timeout", "60", "--frontend", "mask", "--device", "cpu")


def test_cli_live_monitor(native, small_chunk, monkeypatch, capsys):
    """live --frontend mask --device cpu --monitor 0 over the mock
    SpyServer: the page, the last snapshot (the last printed frames with
    the parser's detail trees, a WUPA node, the spectrum, waterfall, wave
    and the four statuses) and snapshots polled while it ran; the lines
    equal those of the same run without --monitor."""
    from torch_sdr_mocks import MockSpyServer, iq_int16

    from nfclab_torch.apps import monitor
    from nfclab_torch.protocol.parser import ProtocolParser
    from nfclab_torch.runtime.subject import Subject

    iq = iq_int16(_wupa_capture(n=40_000)[0])  # a window and a tail
    srv = MockSpyServer(iq)
    rc, plain, err = _main("nfclab_torch.apps.decode_cli",
                           [*LIVE, f"spyserver://127.0.0.1:{srv.port}"],
                           capsys)
    assert rc == 0, err
    polled = torch_monitor.polled_monitor(interval=0.1)
    monkeypatch.setattr(monitor, "MonitorServer", polled)
    frames = []
    orig_clear = Subject.clear_registry

    def clear_and_record():
        orig_clear()
        Subject.name("radio.decoder.frame").subscribe(frames.append,
                                                      replay=False)

    monkeypatch.setattr(Subject, "clear_registry", clear_and_record)
    srv = MockSpyServer(iq)
    rc, lines, err = _main("nfclab_torch.apps.decode_cli",
                           [*LIVE, f"spyserver://127.0.0.1:{srv.port}",
                            "--monitor", "0"], capsys)
    assert rc == 0, err
    assert lines == plain and len(lines) >= 5
    (mon,) = polled.instances
    assert f"# monitor: http://127.0.0.1:{mon.port}/" in err
    assert "nfclab live monitor" in mon.page and "/data" in mon.page
    assert mon.snaps, "no snapshot polled while the capture ran"
    parser = ProtocolParser()
    details = []
    for f in frames:
        if f is None:
            parser.reset()
            continue
        node = parser.parse(f)
        details.append(node.to_json() if node is not None else None)
    got = torch_monitor.check_snapshot(mon.last, lines, details)
    assert got["spectrum_bins"] == 512 and got["statuses"]["fourier"] in (
        "streaming", "complete")
    poll = next(r for r in mon.last["frames"] if r["event"] == "Poll")
    assert poll["data"] == "52" and "WUPA" in poll["detail"]["name"]


@pytest.mark.parametrize("task", ["fourier", "adaptive"])
def test_cli_live_monitor_task_failure_exits_1(task, native, monkeypatch,
                                               capsys):
    """A FourierTask whose spectrum raises, or a ResamplingTask whose
    resampler raises: the CLI exits 1 with the task's error (no host
    fallback)."""
    from torch_sdr_mocks import MockSpyServer, iq_int16

    from nfclab_torch.dsp import resample, spectrum

    def fail(*a, **k):
        raise RuntimeError(f"{task} step failed")

    if task == "fourier":
        monkeypatch.setattr(spectrum, "spectrum", fail)
    else:
        monkeypatch.setattr(resample, "resample_radio", fail)
    srv = MockSpyServer(iq_int16(_wupa_capture(n=20_292)[0]))
    rc, lines, err = _main("nfclab_torch.apps.decode_cli",
                           ["live", "--json", "--no-settings", "--timeout",
                            "60", f"spyserver://127.0.0.1:{srv.port}",
                            "--device", "cpu", "--monitor", "0"], capsys)
    assert rc == 1
    assert f"error: {task} task failed" in err and "step failed" in err


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def test_monitor_command_plane(native, tmp_path):
    """POST /command drives the port's task command plane (nfclab's
    tests/test_monitor.py::test_monitor_command_plane on the WUPA
    capture): a threshold Configure changes what the decoder decodes,
    Stop/Start gates the session, a storage Configure writes a TRZ with
    the decoded frames, and bad subjects or codes are refused."""
    from nfclab_torch.apps.monitor import MonitorServer
    from nfclab_torch.hw.signal import SignalBuffer, SignalType
    from nfclab_torch.io.trz import read_trace
    from nfclab_torch.runtime.pipeline import (
        Executor, RadioDecoderTask, ResamplingTask, TraceStorageTask,
    )
    from nfclab_torch.runtime.subject import Subject

    Subject.clear_registry()
    samples = _wupa_capture()[0]
    monitor = MonitorServer(port=0).start()
    frames_q = []
    Subject.name("radio.decoder.frame").subscribe(frames_q.append,
                                                  replay=False)
    raw = Subject.name("radio.signal.raw")
    ex = Executor(pool_size=3)
    ex.submit(RadioDecoderTask())
    ex.submit(ResamplingTask())
    ex.submit(TraceStorageTask(str(tmp_path / "unused.trz")))
    base = f"http://127.0.0.1:{monitor.port}"

    def session():
        frames_q.clear()
        for off in range(0, len(samples), 65536):
            raw.next(SignalBuffer(
                samples[off : off + 65536], RATE, off,
                signal_type=SignalType.SIGNAL_TYPE_RADIO_SAMPLES))
        raw.next(SignalBuffer.eof(RATE))
        assert torch_monitor.wait_for(lambda: None in frames_q)
        return [f for f in frames_q if f is not None
                and f.frame_type in (0x102, 0x103)]

    def command(subject, code, params=None):
        body = {"subject": subject, "code": code}
        if params is not None:
            body["params"] = params
        return _post(base + "/command", body)

    try:
        polls = session()
        assert polls and polls[0].data == b"\x52"
        assert command("radio.decoder", "configure", {"protocol": {
            "nfca": {"correlationThreshold": 99.0}}})["ok"]
        d = command("radio.decoder", "query")
        assert d["ok"]
        assert d["result"]["protocol"]["nfca"]["correlationThreshold"] == 99.0
        assert not [f for f in session() if f.tech_type == 0x0101]
        assert command("radio.decoder", "stop")["ok"]
        frames_q.clear()
        for off in range(0, len(samples), 65536):
            raw.next(SignalBuffer(samples[off : off + 65536], RATE, off))
        raw.next(SignalBuffer.eof(RATE))
        time.sleep(0.5)
        assert not [f for f in frames_q if f is not None]
        assert command("radio.decoder", "start")["ok"]
        assert command("radio.decoder", "configure", {"protocol": {
            "nfca": {"correlationThreshold": 0.5}}})["ok"]
        assert [f for f in session() if f.frame_type == 0x102]
        out = tmp_path / "via_monitor.trz"
        assert command("storage", "configure", {"fileName": str(out)})["ok"]
        saved, _ = read_trace(str(out))
        assert [f for f in saved if f.frame_type == 0x102]
        assert not command("radio.decoder.frame", "stop")["ok"]
        assert not command("radio.decoder", "reboot")["ok"]
    finally:
        ex.shutdown()
        monitor.stop()


def test_monitor_open_trace(trz, tmp_path):
    """POST /open replays a TRZ through TraceReplayTask into the port's
    monitor: its frames land in the frame table (with their detail
    trees), its render stream in the wave; a missing file is refused."""
    from nfclab_torch.apps.monitor import MonitorServer
    from nfclab_torch.io.trz import read_trace
    from nfclab_torch.runtime.subject import Subject

    Subject.clear_registry()
    want, _ = read_trace(str(trz))
    monitor = MonitorServer(port=0).start()
    base = f"http://127.0.0.1:{monitor.port}"
    try:
        r = _post(base + "/open", {"path": str(tmp_path / "missing.trz")})
        assert not r["ok"] and "no such trace" in r["error"]
        assert _post(base + "/open", {"path": str(trz)})["ok"]
        snap = {}

        def replayed():
            snap.update(json.loads(torch_monitor.get(base + "/data")))
            return len(snap["frames"]) >= len(want) and snap["wave"]

        assert torch_monitor.wait_for(replayed, timeout=20, interval=0.1)
        rows = snap["frames"]
        assert [r["data"] for r in rows] == [f.data.hex(":") for f in want]
        poll = next(r for r in rows if r["event"] == "Poll")
        assert poll["data"] == "52" and "WUPA" in poll["detail"]["name"]
    finally:
        monitor.stop()
