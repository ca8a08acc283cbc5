"""The port's decode CLI: `run --frontend mask --device cpu` prints the
lines nfclab's CLI prints, `run --frontend fused --device cpu` the lines
of `--frontend host`, `test` passes against a golden nfclab wrote, and
--device cuda without a card is an error, not a silent CPU run.
Multi-channel (logic) captures: tests/test_torch_logic_cli.py."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_synth

ROOT = Path(__file__).resolve().parent.parent


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.io.wav import write_wav

    path = tmp_path_factory.mktemp("cli") / "nfca_106k.wav"
    write_wav(str(path), torch_synth.templates()[0].samples, torch_synth.RATE)
    return path


@pytest.fixture(scope="module")
def ref_env(tmp_path_factory):
    """Environment for nfclab's CLI: its native library is a copy of the
    port's (see torch_native.py)."""
    from torch_native import ref_native_lib

    return {"NFCLAB_NATIVE_LIB": ref_native_lib(
        tmp_path_factory.mktemp("native"))}


def _cli(module, *args, env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", module, *map(str, args)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600,
    )


def test_run_mask_prints_nfclab_lines(wav, ref_env):
    port = _cli("nfclab_torch.apps.decode_cli", "run", "--json", "--device",
                "cpu", "--frontend", "mask", wav)
    ref = _cli("nfclab.apps.decode_cli", "run", "--json", wav, env=ref_env)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    lines = port.stdout.splitlines()
    assert len(lines) >= 4
    assert lines == ref.stdout.splitlines()


def test_run_fused_prints_host_lines(wav, capsys, monkeypatch):
    """--frontend fused (conditioning, channels and mask from the fused
    kernels' plain versions) prints the --frontend host lines; without a
    card it is an error."""
    from nfclab_torch.apps.decode_cli import main

    assert main(["run", "--json", "--frontend", "host", str(wav)]) == 0
    host = capsys.readouterr().out.splitlines()
    assert main(["run", "--json", "--frontend", "fused", "--device", "cpu",
                 str(wav)]) == 0
    fused = capsys.readouterr().out.splitlines()
    assert len(host) >= 4
    assert fused == host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["run", "--frontend", "fused", str(wav)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_test_mask_passes_nfclab_golden(wav, tmp_path, ref_env):
    """nfclab writes the golden (TEST UPDATED); the port's mask frontend
    decodes the same capture to it (PASS)."""
    local = tmp_path / wav.name
    local.write_bytes(wav.read_bytes())
    first = _cli("nfclab.apps.decode_cli", "test", local, env=ref_env)
    assert "TEST UPDATED" in first.stdout, first.stderr
    port = _cli("nfclab_torch.apps.decode_cli", "test", "--device", "cpu",
                "--frontend", "mask", local)
    assert port.returncode == 0, port.stderr
    assert port.stdout.strip() == f"TEST FILE {local.stem}: PASS"


def test_run_host_text_lines(wav, capsys):
    from nfclab_torch.apps.decode_cli import main

    assert main(["run", str(wav)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any("NfcA" in ln and "POLL" in ln for ln in out)


def test_missing_file_exits_1(capsys):
    from nfclab_torch.apps.decode_cli import main

    assert main(["run", "/nonexistent/capture.wav"]) == 1
    assert "no such file" in capsys.readouterr().err


def test_cuda_without_card_is_an_error(wav, monkeypatch, capsys):
    from nfclab_torch.apps.decode_cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["run", "--frontend", "mask", str(wav)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
