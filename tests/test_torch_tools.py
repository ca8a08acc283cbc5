"""The port's validation tools (nfclab_torch/tools/validate_*.py) and its
hw_smoke copy on the CPU, against nfclab where nfclab's code runs here.

- Each validator's ``main([...] + ["--device", "cpu"])`` returns 0:
  validate_fused on nfclab's 2048 x 4096 input; on seeded WAVs written
  under tmp_path, validate_rate_parametric, whose 3.2 and 8 MS/s resamples decode
  through the mask and fused frontends (plain versions) to nfclab's
  NfcDecoder().decode frames; validate_cuda_logic on nfclab's three
  ISO7816 sessions (tests/torch_logic_synth.make_session).
- On a missing file, and without a card and without ``--device cpu``,
  every tool returns 1 with an ``error:`` line.
- hw_smoke: nfclab's three tests of tests/test_hw_smoke.py (enumerate,
  logicloop to WAV, the mock-libusb Sipeed capture) against
  ``nfclab_torch.tools.hw_smoke``.
- The cuda-marked tests run validate_fused at nfclab's size and
  validate_cuda_logic on the card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_logic_synth
import torch_synth
from test_torch_logic_cli import mock_libusb, pack_sipeed  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
# nfclab's validate_tpu_logic sessions: its capture and its two farm
# sessions
LOGIC_TPDUS = (
    [0x00, 0xA4, 0x04, 0x00, 0x02, 0xA4, 0x3F, 0x00, 0x90, 0x00],
    [0x00, 0xA4, 0x04, 0x00, 0x00, 0x90, 0x00],
    [0x00, 0xB0, 0x00, 0x08, 0x00, 0x6A, 0x82],
)


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """nfclab's host decoder loads a copy of the port's native library
    (see torch_native.py)."""
    from torch_native import use_ref_native

    use_ref_native(tmp_path_factory.mktemp("native"))


@pytest.fixture
def small_chunk(monkeypatch):
    """The chained engine's chunk cut to 1024 samples (the plain versions
    cost a fraction of a millisecond a sample)."""
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(cc, "CHAIN_CHUNK", 1024)


def nfc_wav(path: Path, x: np.ndarray) -> str:
    """Write x as a 16-bit 10 MS/s WAV with the golden JSON of the host
    decode of what the WAV holds beside it."""
    from nfclab_torch.io.golden import write_golden_frames
    from nfclab_torch.io.wav import read_wav, write_wav
    from nfclab_torch.runtime.decoder import NfcDecoder

    write_wav(str(path), x, RATE)
    samples, _ = read_wav(str(path))
    write_golden_frames(str(path.with_suffix(".json")),
                        NfcDecoder().decode(samples, RATE))
    return str(path)


@pytest.fixture(scope="module")
def short_wav(tmp_path_factory):
    return nfc_wav(tmp_path_factory.mktemp("nfc") / "nfca_424k.wav",
                   short_capture())


def short_capture() -> np.ndarray:
    """The first 16,384 samples of the NFC-A 424k BPSK template: a poll
    and its listen frame."""
    return TEMPLATES[1].samples[:16384]


@pytest.fixture(scope="module")
def logic_wavs(tmp_path_factory):
    from nfclab_torch.io.wav import write_wav

    d = tmp_path_factory.mktemp("logic")
    paths = []
    for i, tpdu in enumerate(LOGIC_TPDUS):
        x = torch_logic_synth.make_session(atr=(0x3B, 0x00), tpdu=tpdu)
        paths.append(str(d / f"session{i}.wav"))
        write_wav(paths[-1], x, torch_logic_synth.SAMPLE_RATE, bits=8)
    return paths


def test_validate_fused_on_the_cpu(capsys):
    from nfclab_torch.tools import validate_fused

    assert validate_fused.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "PASS"
    for name in validate_fused.COND_OUTPUTS:
        assert f"{name}: bit-exact" in out
    for name in validate_fused.OUT_CHECK:
        assert f"chunked {name}: bit-exact" in out
    assert sum("bits differ" in ln for ln in out) == 8


def test_validate_fused_input_is_nfclabs():
    """The tool's input is nfclab's, two attenuated stretches included."""
    from nfclab_torch.tools.validate_fused import nfclab_input

    x = nfclab_input()
    rng = np.random.default_rng(42)
    want = (rng.random((2048, 4096), dtype=np.float32) * 0.4
            + 0.01).astype(np.float32)
    want[:, 1000:1100] *= 0.05
    want[:, 2000:2100] *= 0.3
    assert x.dtype == np.float32 and np.array_equal(x, want)


def test_validate_rate_parametric_gives_nfclab_frames(
        short_wav, small_chunk, ref_native, monkeypatch, capsys):
    """The resamples decode through the port's mask and fused frontends
    (plain versions) to nfclab's NfcDecoder().decode frames."""
    from nfclab.apps.decode_cli import frame_json as ref_json
    from nfclab.io.golden import GOLDEN_TYPES
    from nfclab.runtime.decoder import NfcDecoder as RefDecoder
    from nfclab.tools.validate_rate_parametric import (
        _resampled as ref_resampled)

    from nfclab_torch.apps.decode_cli import frame_json
    from nfclab_torch.io.wav import read_wav
    from nfclab_torch.tools import validate_rate_parametric as vr

    seen = {}

    def recorded(x, rate, device="cuda"):
        seen[rate] = (x, vr_rate_frames(x, rate, device))
        return seen[rate][1]

    vr_rate_frames = vr.rate_frames
    monkeypatch.setattr(vr, "rate_frames", recorded)
    assert vr.main([short_wav, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(": OK (" in ln for ln in out)
    samples, info = read_wav(short_wav)
    assert sorted(seen) == [3_200_000, 8_000_000]
    for rate, bits8 in vr.RATES:
        x, frames = seen[rate]
        assert np.array_equal(
            x, ref_resampled(samples, info.sample_rate, rate, bits8))
        ref = RefDecoder().decode(x.copy(), rate)
        assert any(f.frame_type in GOLDEN_TYPES for f in ref)
        want = [ref_json(f) for f in ref]
        for label in ("host", "mask", "fused"):
            assert [frame_json(f) for f in frames[label]] == want, label


def test_validate_cuda_logic_on_the_cpu(logic_wavs, capsys):
    from nfclab_torch.tools import validate_cuda_logic

    assert validate_cuda_logic.main([*logic_wavs, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "PASS"
    assert sum("exact (" in ln for ln in out) == 4 * len(logic_wavs)
    assert sum("frames: identical" in ln for ln in out) == len(logic_wavs)
    assert sum(ln.startswith("CUDA LOGIC FARM") and ": OK (" in ln
               for ln in out) == len(logic_wavs)


def test_validate_cuda_logic_index_oracle_is_nfclabs(logic_wavs):
    """The dense host scans are nfclab's (validate_tpu_logic.py:52-64)."""
    from nfclab.demod.iso7816 import CH_CLK, CH_IO, CH_RST, CH_VCC

    from nfclab_torch.io.wav import read_wav
    from nfclab_torch.tools.validate_cuda_logic import dense_indices

    x, _ = read_wav(logic_wavs[0])
    edge = np.zeros_like(x)
    edge[1:] = x[1:] - x[:-1]
    want = {
        "io_edges": np.flatnonzero(edge[:, CH_IO] != 0),
        "io_falls": np.flatnonzero(edge[:, CH_IO] < 0),
        "line_edges": np.union1d(np.flatnonzero(edge[:, CH_RST] != 0),
                                 np.flatnonzero(edge[:, CH_VCC] != 0)),
        "clk_falls": np.flatnonzero(edge[:, CH_CLK] < 0),
    }
    got = dense_indices(x)
    assert list(got) == list(want)
    for k in want:
        assert len(want[k]) and np.array_equal(got[k], want[k]), k


def _tool(name):
    import importlib

    return importlib.import_module(f"nfclab_torch.tools.{name}")


MISSING = [
    ("validate_cuda_decode", ["{missing}"]),
    ("validate_rate_parametric", ["{missing}"]),
    ("validate_cuda_farm", ["{missing}"]),
    ("validate_cuda_logic", ["{missing}"]),
    ("e2e_bench", ["{dir}"]),
    ("streaming_bench", ["--wav", "{missing}"]),
]


@pytest.mark.parametrize("name,argv", MISSING, ids=[m[0] for m in MISSING])
def test_tool_refuses_a_missing_file(name, argv, tmp_path, capsys):
    """A missing WAV (an empty directory for e2e_bench) exits 1 with an
    error line, before anything runs."""
    argv = [a.format(missing=tmp_path / "none.wav", dir=tmp_path)
            for a in argv]
    assert _tool(name).main([*argv, "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: ") and (
        "no such file" in err or "no WAV in" in err)


@pytest.mark.parametrize("name", ["validate_fused"] + [m[0] for m in MISSING])
def test_tool_without_a_card_exits_1(name, short_wav, logic_wavs,
                                     monkeypatch, capsys):
    """No card and no --device cpu: DeviceUnavailable, an error line and
    exit 1, never a skip that exits 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"validate_fused": [],
            "validate_cuda_logic": logic_wavs[:1],
            "e2e_bench": [str(Path(short_wav).parent)],
            "streaming_bench": ["--wav", short_wav]}.get(name, [short_wav])
    assert _tool(name).main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "CUDA is not available" in err


def test_validate_cuda_logic_needs_a_wav(capsys):
    from nfclab_torch.tools import validate_cuda_logic

    assert validate_cuda_logic.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().err.startswith("error: ")


def test_default_fixtures_are_nfclabs():
    """The tools take their WAVs as arguments and read no default
    directory; their usage text names nfclab's default fixtures."""
    from nfclab.tools import (validate_rate_parametric, validate_tpu_decode,
                              validate_tpu_farm)

    from nfclab_torch.tools import fixtures, streaming_bench
    from nfclab_torch.tools import validate_cuda_decode as vd
    from nfclab_torch.tools import validate_cuda_farm as vf
    from nfclab_torch.tools import validate_rate_parametric as vr

    for port, names in ((vd, validate_tpu_decode.DEFAULT_FIXTURES),
                        (vf, validate_tpu_farm.DEFAULT_FIXTURES),
                        (vr, [validate_rate_parametric.SOURCE[:-4]]),
                        (streaming_bench,
                         [validate_rate_parametric.SOURCE[:-4]])):
        for name in names:
            assert name in port.__doc__, (port.__name__, name)
    assert not hasattr(fixtures, "WAV_DIR")


NO_INPUT = [
    ("validate_cuda_decode", "give the WAV captures"),
    ("validate_rate_parametric", "give the WAV captures"),
    ("validate_cuda_farm", "give the WAV captures"),
    ("validate_cuda_logic", "give the WAV captures"),
    ("e2e_bench", "give the directory"),
    ("streaming_bench", "give the WAV captures"),
]


@pytest.mark.parametrize("name,why", NO_INPUT, ids=[m[0] for m in NO_INPUT])
def test_tool_without_paths_exits_1(name, why, capsys):
    """Given no WAV (no directory for e2e_bench), each tool exits 1 with
    an error line before anything runs."""
    assert _tool(name).main(["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: ") and why in err


# ---------------------------------------------------------------- hw_smoke
# nfclab's tests/test_hw_smoke.py against the port's copy


def _hw_smoke(args, env=None, timeout=120):
    proc = subprocess.run(
        [sys.executable, "-m", "nfclab_torch.tools.hw_smoke", *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
        env=env,
    )
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def test_hw_smoke_enumerate_lists_all_drivers():
    (listing,) = _hw_smoke([])
    assert listing["native"]
    for name in ("loopback", "logicloop", "dslogic", "sipeed", "airspy"):
        assert name in listing["drivers"]


def test_hw_smoke_loopback_capture_to_wav(tmp_path):
    out = tmp_path / "cap.wav"
    listing, result = _hw_smoke(
        ["--capture", "logicloop://test", "--seconds", "0.3",
         "--out", str(out)]
    )
    assert result["opened"] and result["samples"] > 0
    from nfclab_torch.io.wav import read_wav

    samples, info = read_wav(str(out))
    assert info.channels == 4 and info.sample_rate == result["sample_rate"]
    # 8-bit logic rails: 0.0 and the saturated positive full scale 127/128
    assert set(np.unique(samples)) <= {0.0, np.float32(127 / 128)}


def test_hw_smoke_sipeed_usb_capture_matches_payload(mock_libusb,  # noqa: F811
                                                     tmp_path):
    capture = torch_logic_synth.make_session(atr=(0x3B, 0x00))
    payload_file = tmp_path / "payload.bin"
    payload_file.write_bytes(pack_sipeed(capture))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["NFCLAB_LIBUSB"] = str(mock_libusb)
    env["NFCLAB_MOCK_PAYLOAD_SIPEED"] = str(payload_file)
    out = tmp_path / "cap.wav"
    rate = torch_logic_synth.SAMPLE_RATE
    listing, result = _hw_smoke(
        ["--capture", "sipeed://", "--seconds", "3", "--out", str(out),
         "--sample-rate", str(rate)],
        env=env,
    )
    assert listing["drivers"]["sipeed"] == ["sipeed://1:4"]
    assert result["opened"] and result["samples"] > 0
    from nfclab_torch.io.wav import read_wav

    samples, info = read_wav(str(out))
    assert info.sample_rate == rate and info.channels == 4
    n = min(len(samples), len(capture))
    assert n > 0
    np.testing.assert_array_equal(samples[:n] > 0.5, capture[:n] > 0.5)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused kernels and the logic "
                    "mask run on the card)")


@pytest.mark.cuda
def test_validate_fused_on_the_card(cuda, capsys):
    from nfclab_torch.tools import validate_fused

    assert validate_fused.main([]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "PASS"


@pytest.mark.cuda
def test_validate_cuda_logic_on_the_card(cuda, logic_wavs, capsys):
    from nfclab_torch.tools import validate_cuda_logic

    assert validate_cuda_logic.main(logic_wavs) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "PASS"
    assert sum("bit for bit device='cpu'" in ln for ln in out) == 3
