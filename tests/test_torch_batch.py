"""The device conditioner's callers in the port, on the CPU:

- ``NfcDecoder(conditioner="jax")`` on the five synthetic templates gives
  the frames of ``conditioner="native"``, of nfclab's decoder and the bytes
  the synthesizer wrote (the CPU is bound with MonkeyPatch: a
  ``functools.partial`` of ``condition_jax`` with ``device="cpu"`` and
  blocks of 16384, so a template spans several blocks);
- ``decode_batch`` (``pool="thread"``, ``device="cpu"``) over WAVs of the
  templates, with ``conditioner="jax"``, with ``frontend="mask"`` and with
  ``frontend="fused"`` (both conditioners), gives the native frames per
  path;
- the CLI's ``run --json --conditioner jax --device cpu`` prints what
  nfclab's ``run --json`` prints, and ``bench_cli --device cpu`` prints
  its JSON lines (also ``--frontend fused --conditioner device``);
- no card and no ``device="cpu"``: an error, never a CPU run.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_synth

ROOT = Path(__file__).resolve().parent.parent
RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
NAMES = [tp.name for tp in TEMPLATES]


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


@pytest.fixture
def cpu_conditioner(monkeypatch):
    import nfclab_torch.dsp.conditioner as cmod

    monkeypatch.setattr(cmod, "condition_jax", functools.partial(
        cmod.condition_jax, device="cpu", block=16384, halo=4096))


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """nfclab's decoder runs on a copy of the port's native library (see
    torch_native.py)."""
    from torch_native import use_ref_native

    use_ref_native(tmp_path_factory.mktemp("native"))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.io.wav import write_wav

    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for tp in TEMPLATES:
        paths.append(str(d / f"{tp.name}.wav"))
        write_wav(paths[-1], tp.samples, RATE)
    return paths


def _lines(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


@pytest.mark.parametrize("name", NAMES)
def test_decoder_jax_conditioner_frames(name, cpu_conditioner, ref_native):
    import nfclab.apps.decode_cli as ref_cli
    import nfclab.runtime.decoder as ref
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.decoder import NfcDecoder

    tp = TEMPLATES[NAMES.index(name)]
    got = NfcDecoder(conditioner="jax").decode(tp.samples, RATE)
    native = NfcDecoder().decode(tp.samples, RATE)
    want = ref.NfcDecoder().decode(tp.samples, RATE)
    assert _lines(got) == _lines(native)
    assert _lines(got) == [ref_cli.frame_json(f) for f in want]
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    assert [f.data for f in got if f.frame_type in keep] == tp.sent


def test_decode_batch_jax_and_mask_equal_native(wavs, cpu_conditioner,
                                                monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.runtime.batch import decode_batch

    monkeypatch.setattr(cc, "CHAIN_CHUNK", 4096)
    want = decode_batch(wavs, conditioner="native", pool="thread")
    for kw in ({"conditioner": "jax"}, {"frontend": "mask"}):
        got = decode_batch(wavs, pool="thread", device="cpu", **kw)
        assert list(got) == wavs
        for p in wavs:
            assert got[p], (kw, p)
            assert _lines(got[p]) == _lines(want[p]), (kw, p)


def test_decode_batch_refusals(wavs, monkeypatch):
    """frontend="fused" gives the native frames with both conditioners:
    channels from the block layout and triggers from the chained engine
    with native conditioning, and everything from the chained
    full-channel runner with conditioner="device".  Without a card every
    device path raises."""
    import nfclab_torch.runtime.batch as batch
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable

    want = batch.decode_batch(wavs, conditioner="native", pool="thread")
    for kw in ({"frontend": "fused"}, {"frontend": "fused",
                                       "conditioner": "device"}):
        got = batch.decode_batch(wavs, pool="thread", device="cpu", **kw)
        assert list(got) == wavs
        for p in wavs:
            assert got[p], (kw, p)
            assert _lines(got[p]) == _lines(want[p]), (kw, p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        batch.decode_batch(wavs)                   # conditioner="jax"
    with pytest.raises(DeviceUnavailable):
        batch.decode_batch(wavs, frontend="mask")
    for cond in ("native", "device"):
        with pytest.raises(DeviceUnavailable):
            batch.decode_batch(wavs, frontend="fused", conditioner=cond)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not batch._fork_ok()


def _cli(module, *args, env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", module, *map(str, args)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600,
    )


def test_cli_run_conditioner_jax_prints_nfclab_lines(wavs, tmp_path):
    from torch_native import ref_native_lib

    port = _cli("nfclab_torch.apps.decode_cli", "run", "--json",
                "--conditioner", "jax", "--device", "cpu", wavs[0])
    ref = _cli("nfclab.apps.decode_cli", "run", "--json", wavs[0],
               env={"NFCLAB_NATIVE_LIB": ref_native_lib(tmp_path)})
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    lines = port.stdout.splitlines()
    assert len(lines) >= 4
    assert lines == ref.stdout.splitlines()


def test_cli_conditioner_jax_without_card_is_an_error(wavs, monkeypatch,
                                                      capsys):
    from nfclab_torch.apps.decode_cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["run", "--conditioner", "jax", wavs[0]]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_bench_cli_frontend_line(capsys, monkeypatch):
    from nfclab_torch.apps.bench_cli import main

    assert main(["--device", "cpu", "--batch", "4", "--span", "4096",
                 "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "frontend_samples_per_second"
    assert rec["value"] > 0 and rec["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--batch", "4", "--span", "4096", "--reps", "1"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_decode_batch_fused_refuses_mixed_rates(wavs, tmp_path):
    """nfclab's error for captures of different sample rates."""
    from nfclab_torch.io.wav import write_wav
    from nfclab_torch.runtime.batch import decode_batch

    other = str(tmp_path / "other_rate.wav")
    write_wav(other, TEMPLATES[0].samples, 5_000_000)
    for cond in ("native", "device"):
        with pytest.raises(ValueError, match="uniform sample rate"):
            decode_batch([wavs[0], other], frontend="fused",
                         conditioner=cond, device="cpu")


def test_bench_cli_fused_device_conditioner_line(wavs, capsys):
    """bench_cli --frontend fused --conditioner device prints its decode
    JSON line (the full-channel frontend on the CPU's plain kernels)."""
    from nfclab_torch.apps.bench_cli import main

    assert main(["--device", "cpu", "--no-kernel", "--decode", wavs[3],
                 "--frontend", "fused", "--conditioner", "device",
                 "--pool", "thread"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "end_to_end_decode_samples_per_second"
    assert rec["frontend"] == "fused" and rec["device"] == "cpu"
    assert rec["captures"] == 1 and rec["frames"] > 0 and rec["value"] > 0
