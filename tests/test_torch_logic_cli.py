"""The port's decode CLI on ISO7816 logic captures, against nfclab's CLI
and the one-shot IsoDecoder on the CPU (no card is involved: the logic
CLI paths decode on the host, as nfclab's do).

- ``run --json`` on a multi-channel (8-bit logic) WAV, with and without
  ``--channel-map`` on a probe-permuted capture: nfclab's lines, and the
  one-shot decoder's frames of the WAV's samples.
- ``test`` on the same WAVs: the golden it writes passes in both CLIs.
- ``live logicloop://test``, ``live logictcp://`` through the port's
  MockLogicTcpServer (tests/torch_sdr_mocks.py), with and without
  ``--channel-map``, and the ``dslogic://`` / ``sipeed://`` USB drivers
  through tests/mock_libusb.cpp in tests/torch_usb_logic_child.py: the
  one-shot decoder's frames, and nfclab's lines.
- A ``--config`` decoder section on a logic session is skipped with a
  note, as nfclab's CLI does.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_logic_synth import SAMPLE_RATE, make_session
from torch_sdr_mocks import MockLogicTcpServer

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
WIRING = [1, 2, 3, 0]  # physical probes carry [clk, rst, vcc, io]
CMAP = "io=3,clk=0,rst=1,vcc=2"
TPDU = (0x00, 0xA4, 0x04, 0x00, 0x02, 0xA4, 0x3F, 0x00, 0x90, 0x00)


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


@pytest.fixture(scope="module")
def capture():
    return make_session(atr=(0x3B, 0x00), tpdu=TPDU)


@pytest.fixture(scope="module")
def ref_env(tmp_path_factory):
    """Environment for nfclab's CLI in a subprocess (torch_native.py)."""
    from torch_native import ref_native_lib

    return {"NFCLAB_NATIVE_LIB": ref_native_lib(
        tmp_path_factory.mktemp("native_logic"))}


def _cli(module, *args, env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", module, *map(str, args)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )


def _main(argv, capsys):
    """The port's decode_cli main() in this process: (returncode, stdout
    lines, stderr)."""
    from nfclab_torch.apps import decode_cli
    from nfclab_torch.runtime.subject import Subject

    Subject.clear_registry()
    capsys.readouterr()
    old = signal.getsignal(signal.SIGTERM)
    try:
        rc = decode_cli.main([str(a) for a in argv])
    finally:
        signal.signal(signal.SIGTERM, old)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


def _want(x):
    from nfclab_torch.apps.decode_cli import frame_json
    from nfclab_torch.runtime.logic_decoder import IsoDecoder

    return [frame_json(f) for f in IsoDecoder().decode(x, SAMPLE_RATE)]


def _wired(x, mapped: bool):
    return np.ascontiguousarray(x[:, WIRING]) if mapped else x


def _map_args(mapped: bool):
    return ["--channel-map", CMAP] if mapped else []


@pytest.fixture(scope="module", params=["plain", "channel_map"])
def logic_wav(request, capture, tmp_path_factory):
    """An 8-bit 4-channel WAV (levels read back as 127/128), probes
    permuted for the channel_map case: (path, mapped, the samples the WAV
    holds in decoder layout)."""
    from nfclab_torch.io.wav import read_wav, write_wav

    mapped = request.param == "channel_map"
    path = tmp_path_factory.mktemp("logic") / f"logic_{request.param}.wav"
    write_wav(str(path), _wired(capture, mapped), SAMPLE_RATE, bits=8)
    samples, info = read_wav(str(path))
    assert info.channels == 4
    if mapped:
        samples = samples[:, np.argsort(WIRING)]
    return path, mapped, samples


def test_run_logic_wav_prints_nfclab_lines(logic_wav, ref_env, capsys):
    path, mapped, samples = logic_wav
    rc, lines, err = _main(["run", "--json", path, *_map_args(mapped)],
                           capsys)
    assert rc == 0, err
    want = _want(samples)
    assert lines == want
    assert any('"type":"ATR"' in ln for ln in lines)
    assert any('"type":"EXCHANGE"' in ln for ln in lines)
    ref = _cli("nfclab.apps.decode_cli", "run", "--json", path,
               *_map_args(mapped), env=ref_env)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.splitlines() == lines
    rc, text, err = _main(["run", path, *_map_args(mapped)], capsys)
    assert rc == 0 and len(text) == len(lines) and "ISO7816" in text[-1]


def test_test_logic_wav_golden_passes_in_both(logic_wav, ref_env, capsys,
                                              tmp_path):
    import shutil

    path, mapped, _ = logic_wav
    local = tmp_path / path.name
    shutil.copy(path, local)
    for want in ("TEST UPDATED!", "PASS"):
        rc, lines, err = _main(["test", local, *_map_args(mapped)], capsys)
        assert rc == 0, err
        assert lines == [f"TEST FILE {local.stem}: {want}"]
    ref = _cli("nfclab.apps.decode_cli", "test", local, *_map_args(mapped),
               env=ref_env)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.strip() == f"TEST FILE {local.stem}: PASS"


LIVE = ("live", "--json", "--no-settings", "--sample-rate", str(SAMPLE_RATE),
        "--timeout", "30")


@pytest.fixture
def native():
    if not _native_ok():
        pytest.skip("native library unavailable")


def test_live_logicloop(native, ref_env, capsys):
    """The synthetic logic loopback (an idle card interface) streams through
    the logic decoder task: exit 0, and nfclab's lines (none: no line
    ever changes)."""
    argv = [*LIVE, "logicloop://test", "--blocks", "3"]
    rc, lines, err = _main(argv, capsys)
    assert rc == 0, err
    assert "# 0 frames" in err
    ref = _cli("nfclab.apps.decode_cli", *argv, env=ref_env)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.splitlines() == lines == []


@pytest.mark.parametrize("mapped", [False, True],
                         ids=["plain", "channel_map"])
def test_live_logictcp_prints_iso_decoder_frames(native, ref_env, capture,
                                                  capsys, mapped):
    """A synthesized session served as packed probe bytes over logictcp:
    the lines are the one-shot decoder's frames of the capture, and
    nfclab's CLI prints the same ones."""
    x = _wired(capture, mapped)
    want = _want(capture)
    srv = MockLogicTcpServer(x, SAMPLE_RATE)
    rc, lines, err = _main([*LIVE, f"logictcp://127.0.0.1:{srv.port}",
                            *_map_args(mapped)], capsys)
    srv.thread.join(timeout=30)
    assert rc == 0, err
    assert lines == want and len(want) > 2
    if mapped:
        return
    srv = MockLogicTcpServer(x, SAMPLE_RATE)
    ref = _cli("nfclab.apps.decode_cli", *LIVE,
               f"logictcp://127.0.0.1:{srv.port}", env=ref_env)
    srv.thread.join(timeout=30)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.splitlines() == lines


def test_live_logic_skips_config_decoder_section(native, capture, capsys,
                                                 tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"decoder": {"powerLevelThreshold": 0.02}}))
    srv = MockLogicTcpServer(capture, SAMPLE_RATE)
    rc, lines, err = _main([*LIVE, f"logictcp://127.0.0.1:{srv.port}",
                            "--config", cfg], capsys)
    srv.thread.join(timeout=30)
    assert rc == 0, err
    assert "# --config decoder section applies to radio capture" in err
    assert lines == _want(capture)


# ------------------------------------------------ USB drivers, mock libusb

def pack_sipeed(capture: np.ndarray) -> bytes:
    """One byte per sample, bit i = probe i (sri_samples semantics)."""
    bits = (capture > 0.5).astype(np.uint8)
    packed = np.zeros(len(bits), np.uint8)
    for c in range(bits.shape[1]):
        packed |= bits[:, c] << c
    return packed.tobytes()


def pack_dslogic(capture: np.ndarray) -> bytes:
    """DSLogic stream-mode layout (DSLogicDevice.cpp transpose()): chunks
    of channels*8 bytes; 8 consecutive bytes per channel; byte i of a
    channel holds samples 8i..8i+7 of the 64-sample block, LSB first."""
    bits = (capture > 0.5).astype(np.uint8)
    n, ch = bits.shape
    pad = (-n) % 64
    if pad:
        bits = np.vstack([bits, np.repeat(bits[-1:], pad, axis=0)])
    blocks = bits.reshape(-1, 8, 8, ch)  # [block, i, r, c]
    shifts = np.arange(8, dtype=np.uint8)[None, None, :, None]
    by = (blocks << shifts).sum(axis=2).astype(np.uint8)  # [block, i, c]
    return by.transpose(0, 2, 1).reshape(-1).tobytes()  # [block, c, i]


@pytest.fixture(scope="module")
def mock_libusb(tmp_path_factory):
    if not _native_ok():
        pytest.skip("native library unavailable")
    out = tmp_path_factory.mktemp("mockusb") / "libmock_usb.so"
    subprocess.run(
        ["g++", "-O1", "-shared", "-fPIC", "-std=c++17", "-o", str(out),
         str(ROOT / "mock_libusb.cpp")],
        check=True, capture_output=True,
    )
    return out


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
@pytest.mark.parametrize("ident", ["sipeed://", "dslogic://"])
def test_usb_logic_drivers_decode_iso7816(mock_libusb, capture, tmp_path,
                                          ident, sync):
    """The mock device streams the packed session through the port's USB
    driver (both transfer engines) into decode_cli live: the one-shot
    decoder's frames."""
    scheme = ident.split(":")[0]
    pack = pack_sipeed if scheme == "sipeed" else pack_dslogic
    payload = tmp_path / "payload.bin"
    payload.write_bytes(pack(capture))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["NFCLAB_LIBUSB"] = str(mock_libusb)
    env[f"NFCLAB_MOCK_PAYLOAD_{scheme.upper()}"] = str(payload)
    if sync:  # the synchronous bulk reader (the async engine otherwise)
        env["NFCLAB_USB_SYNC"] = "1"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "torch_usb_logic_child.py"), ident,
         str(SAMPLE_RATE)],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert proc.stdout.splitlines() == _want(capture)
