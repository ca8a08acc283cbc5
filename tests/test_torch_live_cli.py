"""The port's `decode_cli live` against nfclab's on the CPU, through the
mock SDR servers of tests/torch_sdr_mocks.py (the helpers and the cut
CHAIN_CHUNK of tests/test_torch_live.py).

- SpyServer (int16) and rtl_tcp (8-bit): the lines of --frontend mask
  --device cpu equal those of --frontend host and of nfclab's CLI, and the
  host streaming decoder's frames of the payload's magnitude.
- Refusals, exit 1 with a message and no capture, without a card and
  without --device cpu (DeviceUnavailable): --frontend mask, and --monitor
  (its spectrum).  (The logic analyzers' schemes decode:
  tests/test_torch_logic_cli.py; the monitor itself:
  tests/test_torch_reports.py.)
- A dispatch that fails mid-session: exit 1 with the error, and no line
  after the frames decoded before it (no host fallback).
- The mocks' pacing option.
The cuda-marked test runs the CLI's mask frontend on the card.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_synth
from test_torch_live import BLOCK, RATE, TEMPLATES, _capture, _host_frames, _json
from torch_sdr_mocks import MockRtlTcpServer, MockSpyServer, iq_int16, iq_uint8

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 4096


@pytest.fixture(autouse=True, scope="module")
def _native():
    from nfclab_torch.native.binding import native_available

    if not native_available():
        pytest.skip("native library unavailable")


@pytest.fixture(scope="module")
def ref_env(tmp_path_factory):
    """Environment for nfclab's CLI in a subprocess (torch_native.py)."""
    from torch_native import ref_native_lib

    return {"NFCLAB_NATIVE_LIB": ref_native_lib(
        tmp_path_factory.mktemp("native_cli"))}


@pytest.fixture
def small_chunk(monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nfclab_torch's kernels run only "
                    "there)")


def _live(*args, env=None):
    """decode_cli live in a subprocess: (returncode, stdout lines, stderr)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    proc = subprocess.run(
        [sys.executable, "-m", *map(str, args)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600,
    )
    return proc.returncode, proc.stdout.splitlines(), proc.stderr


def _live_in_process(argv, capsys):
    """The port's decode_cli main() in this process (so the engines can be
    cut or stubbed): (returncode, stdout lines, stderr)."""
    from nfclab_torch.apps import decode_cli
    from nfclab_torch.runtime.subject import Subject

    Subject.clear_registry()
    capsys.readouterr()
    old = signal.getsignal(signal.SIGTERM)
    try:
        rc = decode_cli.main(argv)
    finally:
        signal.signal(signal.SIGTERM, old)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


LIVE = ("live", "--json", "--no-settings", "--sample-rate", str(RATE),
        "--timeout", "60")


def test_cli_spyserver_mask_equals_host_and_nfclab(small_chunk, ref_env,
                                                   capsys):
    """decode_cli live spyserver://... over a ~200k-sample int16 payload:
    the port's --frontend mask --device cpu prints the lines of its
    --frontend host and of nfclab's --frontend host, and those are the
    host streaming decoder's frames of the payload's magnitude."""
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.dsp.magnitude import iq_to_magnitude

    names = ("nfca_106k", "nfcb", "nfca_424k_bpsk")
    x = _capture(names, seed=500)
    iq = iq_int16(x)
    lines = {}
    srv = MockSpyServer(iq)
    rc, lines["mask"], err = _live_in_process(
        [*LIVE, f"spyserver://127.0.0.1:{srv.port}", "--frontend", "mask",
         "--device", "cpu"], capsys)
    assert rc == 0, err
    srv = MockSpyServer(iq)
    rc, lines["host"], err = _live(
        "nfclab_torch.apps.decode_cli", *LIVE,
        f"spyserver://127.0.0.1:{srv.port}", "--frontend", "host")
    assert rc == 0, err
    srv = MockSpyServer(iq)
    rc, lines["nfclab"], err = _live(
        "nfclab.apps.decode_cli", *LIVE,
        f"spyserver://127.0.0.1:{srv.port}", "--frontend", "host",
        env=ref_env)
    assert rc == 0, err
    mag = iq_to_magnitude((iq.astype(np.float32) / 32768.0).reshape(-1, 2))[0]
    want = _host_frames(mag)
    assert lines["mask"] == lines["host"] == lines["nfclab"] == _json(want)
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    assert [f.data for f in want if f.frame_type in keep] == [
        b for n in names for t in TEMPLATES if t.name == n for b in t.sent]


def test_cli_rtltcp_8bit_mask_equals_host(small_chunk, capsys):
    """An 8-bit rtl_tcp stream of a WUPA (short frame 52) and the NFC-A
    106k template: --frontend mask --device cpu prints the lines of
    --frontend host, whatever block sizes the socket delivered, and the
    first POLL is the WUPA."""
    import json

    from nfca_synth import ListenWriter

    w = ListenWriter()
    w.frame(b"\x52", short=True)
    w.listen_frame(b"\x04\x00")
    w.gap()
    x = np.concatenate([w.build(4096), _capture(("nfca_106k",), seed=520)])
    iq = iq_uint8(x)
    lines = {}
    for fe in ("mask", "host"):
        srv = MockRtlTcpServer(payload=iq, min_commands=2)
        rc, lines[fe], err = _live_in_process(
            [*LIVE, f"rtltcp://127.0.0.1:{srv.port}", "--frontend", fe,
             "--device", "cpu"], capsys)
        assert rc == 0, err
    assert lines["mask"] == lines["host"]
    polls = [json.loads(ln) for ln in lines["mask"]]
    polls = [f for f in polls if f["type"] == "POLL"]
    assert polls[0]["data"] == "52" and polls[0]["tech"] == "NfcA"
    assert len(polls) == 1 + 2


@pytest.mark.parametrize("case", ["no_card", "monitor_no_card"])
def test_cli_live_refusals(case, monkeypatch, capsys):
    """Exit 1 with DeviceUnavailable's message and no capture, without a
    card and without --device cpu: --frontend mask (the decoder's
    kernels), and --frontend host --monitor 0 (the monitor's spectrum,
    FourierTask)."""
    from nfclab_torch.runtime import pipeline

    started = []
    monkeypatch.setattr(pipeline.LiveRadioSourceTask, "run",
                        lambda self: started.append(self))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [*LIVE, "loopback://test"]
    if case == "no_card":
        argv += ["--frontend", "mask"]
    else:
        argv += ["--frontend", "host", "--monitor", "0"]
    rc, lines, err = _live_in_process(argv, capsys)
    assert rc == 1 and lines == [] and started == []
    assert err.startswith("error: ") and "CUDA is not available" in err


def test_cli_dispatch_failure_exits_1(small_chunk, monkeypatch, capsys):
    """A failed dispatch mid-session ends the CLI with exit 1 and the
    error; the lines printed before it are the host frontend's first
    lines (no frame of the failed window or after it)."""
    from nfclab_torch.dsp import cuda_channels as cc

    x = _capture(("nfca_106k", "nfcb", "nfcf"), seed=540)
    iq = iq_int16(x)
    srv = MockSpyServer(iq)
    rc, host, err = _live_in_process(
        [*LIVE, f"spyserver://127.0.0.1:{srv.port}"], capsys)
    assert rc == 0, err
    orig, calls = cc.run_chained_masks, []

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("kernel launch failed")
        return orig(*a, **k)

    monkeypatch.setattr(cc, "run_chained_masks", fail_second)
    monkeypatch.setattr(cc, "run_segmented_masks", fail_second)
    srv = MockSpyServer(iq)
    rc, lines, err = _live_in_process(
        [*LIVE, f"spyserver://127.0.0.1:{srv.port}", "--frontend", "mask",
         "--device", "cpu"], capsys)
    assert rc == 1
    assert "error: decoder task failed" in err and "kernel launch failed" in err
    assert lines == host[: len(lines)] and len(lines) < len(host)


@pytest.mark.parametrize("rate", [None, 2_000_000])
def test_mock_spyserver_paces_its_sends(rate):
    """The mocks' one option: at `rate` samples/s the last message leaves
    no sooner than its air time after streaming starts; paced or not, the
    payload arrives whole (SpyServer int16 -> x / 32768)."""
    from nfclab_torch.hw.device import PARAM_SAMPLE_RATE
    from nfclab_torch.hw.sdr import NativeSdrDevice

    n, chunk = 200_000, 1 << 14  # int16 values a message: 8192 samples
    payload = iq_int16(np.linspace(-0.5, 0.5, n, dtype=np.float32))
    srv = MockSpyServer(payload, chunk=chunk, rate=rate)
    dev = NativeSdrDevice(f"spyserver://127.0.0.1:{srv.port}")
    assert dev.open() and dev.set(PARAM_SAMPLE_RATE, RATE)
    t0 = time.perf_counter()
    assert dev.start()
    got = []
    deadline = time.time() + 20
    while sum(len(b) for b in got) < 2 * n and time.time() < deadline:
        block = dev.read(timeout=2.0)
        if block is not None and len(block):
            got.append(block)
    dt = time.perf_counter() - t0
    dev.stop()
    dev.close()
    srv.thread.join(timeout=15)
    np.testing.assert_array_equal(np.concatenate(got),
                                  payload.astype(np.float32) / 32768.0)
    if rate is not None:
        last = (n - 1) // (chunk // 2) * (chunk // 2)  # its first sample
        assert dt >= last / rate


@pytest.mark.cuda
def test_cli_spyserver_mask_on_the_card(cuda):
    """decode_cli live --frontend mask on the card prints the lines of
    --frontend host."""
    x = np.concatenate([torch_synth.lane(tp, 4 * BLOCK, seed=620 + i)[0]
                        for i, tp in enumerate(TEMPLATES)])
    iq = iq_int16(x)
    lines = {}
    for fe in ("mask", "host"):
        srv = MockSpyServer(iq, chunk=1 << 17)
        rc, lines[fe], err = _live(
            "nfclab_torch.apps.decode_cli", *LIVE,
            f"spyserver://127.0.0.1:{srv.port}", "--frontend", fe)
        assert rc == 0, err
    assert lines["mask"] and lines["mask"] == lines["host"]


def test_native_library_exports_the_sdr_bridge():
    """Every nfclab_sdr_* entry point that the port's hw/sdr.py and
    native/binding.py bind is exported by the port's native library."""
    import re

    from nfclab_torch.native.binding import _load

    names = set()
    for rel in ("hw/sdr.py", "native/binding.py"):
        text = (ROOT / "nfclab_torch" / rel).read_text()
        names.update(re.findall(r"lib\.(nfclab_sdr_\w+)", text))
    assert len(names) >= 9, names
    lib = _load()
    assert [n for n in sorted(names) if not hasattr(lib, n)] == []
