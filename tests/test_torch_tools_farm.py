"""The port's decode and farm validators and its benchmarks
(nfclab_torch/tools/validate_cuda_decode.py, validate_cuda_farm.py,
e2e_bench.py, streaming_bench.py) on the CPU, with the kernels' plain
versions and the chained engine's chunk cut to 1024 samples.

- validate_cuda_decode and validate_cuda_farm (full and mask fetch, the
  segmented engine at k_chunks 4 and its forced repairs; the production
  configuration is skipped here, ``NFCLAB_FARM_SKIP_PROD_SEG=1``) return
  0 on seeded WAVs with golden JSON beside them, and 1 on a golden that
  disagrees.
- e2e_bench.main on a two-WAV directory with os.cpu_count patched to 2:
  the scaling curve's configurations and equal frame counts from the
  host and mask frontends.
- streaming_bench: bench_single_stream's frames equal nfclab's
  bench_single_stream over the same looped capture (nfclab's hard-coded
  _looped_capture replaced by the port's, which takes the path), and
  bench_farm(device="cpu") in both fetch modes gives the host streaming
  decoder's frame count over the same looped input; main writes --out
  only when it is given.
"""

import json

import numpy as np
import pytest

import torch_synth
from test_torch_tools import nfc_wav, ref_native, short_capture  # noqa: F401

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
CHUNK = 1024


@pytest.fixture
def small_chunk(monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.tools import validate_cuda_farm

    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)
    monkeypatch.setattr(validate_cuda_farm, "CHUNK", CHUNK)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """The short NFC-A 424k capture and a noisy NFC-F lane, 16,384
    samples each, golden JSON beside both."""
    d = tmp_path_factory.mktemp("farm")
    lane, _ = torch_synth.lane(TEMPLATES[3], 16384, seed=33)
    return [nfc_wav(d / "nfca_424k.wav", short_capture()),
            nfc_wav(d / "nfcf_lane.wav", lane)]


def _verdicts(out: str) -> list[str]:
    return [ln.split(": ")[1].split()[0] for ln in out.splitlines()
            if ln.startswith(("CUDA DECODE", "CUDA FARM"))]


def test_validate_cuda_decode_on_the_cpu(wavs, small_chunk, capsys):
    from nfclab_torch.tools import validate_cuda_decode

    assert validate_cuda_decode.main([wavs[0], "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _verdicts(out) == ["OK", "OK"]
    assert out.count("against host and golden") == 2


def test_validate_cuda_farm_on_the_cpu(wavs, small_chunk, monkeypatch,
                                       capsys):
    from nfclab_torch.tools import validate_cuda_farm

    monkeypatch.setenv("NFCLAB_FARM_SKIP_PROD_SEG", "1")
    assert validate_cuda_farm.main([*wavs, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # 2 streams x (full, mask, segmented, pause)
    assert _verdicts(out) == ["OK"] * 8
    for label in ("[full]", "[mask]", "[mask seg=2 k=4]", "[mask seg pause]"):
        assert out.count(f"CUDA FARM {label}") == 2, label
    assert out.count("against host and golden") == 6
    seg = [ln for ln in out.splitlines() if "stats:" in ln]
    assert len(seg) == 2 and all(int(ln.split()[2]) >= 2 for ln in seg)
    assert int(seg[1].split()[5]) > 0  # the pause forced repairs


def test_validate_cuda_farm_fails_on_a_wrong_golden(wavs, small_chunk,
                                                    monkeypatch, tmp_path,
                                                    capsys):
    import shutil

    from nfclab_torch.tools import validate_cuda_farm

    wav = tmp_path / "x.wav"
    shutil.copy(wavs[1], wav)
    gold = json.loads(open(wavs[1][:-4] + ".json").read())
    gold["frames"] = gold["frames"][1:]
    (tmp_path / "x.json").write_text(json.dumps(gold))
    monkeypatch.setenv("NFCLAB_FARM_MODES", "mask")
    monkeypatch.setenv("NFCLAB_FARM_SKIP_SEGMENTED", "1")
    assert validate_cuda_farm.main([str(wav), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert _verdicts(out) == ["MISMATCH"] and "got 1, golden 0" in out


def test_e2e_bench_on_a_two_wav_directory(wavs, small_chunk, monkeypatch,
                                          capsys):
    import os
    from pathlib import Path

    from nfclab_torch.tools import e2e_bench

    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    d = str(Path(wavs[0]).parent)
    assert e2e_bench.main([d, "--device", "cpu", "--reps", "1",
                           "--frontends", "host", "mask"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fixtures"] == 2 and out["link"] is None
    curve = out["aggregate_scaling"]["curve"]
    assert [c["config"] for c in curve] == ["serial", "thread_x2",
                                            "process_x2"]
    assert all(c["value"] > 0 for c in curve)
    modes = out["modes"]
    assert modes["host"]["frames"] == modes["mask"]["frames"] > 0
    assert modes["mask"]["device"] == "cpu"
    assert out["bytes_per_sample"]["fused_fetch"] == 37.0


def _ref_looped(monkeypatch, wav):
    """nfclab's streaming_bench with its hard-coded capture replaced by
    the port's _looped_capture over ``wav``."""
    import nfclab.tools.streaming_bench as ref

    from nfclab_torch.tools import streaming_bench as sb

    monkeypatch.setattr(
        ref, "_looped_capture",
        lambda total, idle_ratio=0, idle="const":
            sb._looped_capture(wav, total, idle_ratio, idle))
    return ref


@pytest.mark.parametrize("idle_ratio", [0, 9])
def test_single_stream_frames_equal_nfclabs(wavs, ref_native,  # noqa: F811
                                            monkeypatch, idle_ratio):
    from nfclab_torch.tools import streaming_bench as sb

    ref = _ref_looped(monkeypatch, wavs[1])
    got = sb.bench_single_stream(wavs[1], total=400_000, chunk=4096,
                                 idle_ratio=idle_ratio)
    want = ref.bench_single_stream(total=400_000, chunk=4096,
                                   idle_ratio=idle_ratio)
    assert got["frames"] == want["frames"] > 0
    assert got["samples"] == want["samples"] == 400_000
    assert set(got) == set(want)


def test_looped_capture_matches_nfclabs_tiling(wavs, monkeypatch):
    """The port's _looped_capture tiles as nfclab's does (nfclab's read
    through a patched read_wav: its own opens a fixed path)."""
    import nfclab.io.wav
    import nfclab.tools.streaming_bench as ref

    from nfclab_torch.io.wav import read_wav
    from nfclab_torch.tools import streaming_bench as sb

    monkeypatch.setattr(nfclab.io.wav, "read_wav",
                        lambda _path: read_wav(wavs[1]))
    for idle_ratio, idle in ((0, "const"), (3, "const"), (3, "recorded")):
        a, ra = sb._looped_capture(wavs[1], 100_000, idle_ratio, idle)
        b, rb = ref._looped_capture(100_000, idle_ratio, idle)
        assert ra == rb == RATE and np.array_equal(a, b)


@pytest.mark.parametrize("fetch", ["full", "mask"])
def test_bench_farm_frames_equal_host_streaming(wavs, small_chunk, fetch):
    from nfclab_torch.runtime.streaming import StreamingNfcDecoder
    from nfclab_torch.tools import streaming_bench as sb

    total, n = 12 * CHUNK, 2
    got = sb.bench_farm(wavs[1], n_streams=n, total=total, chunk=CHUNK,
                        fetch=fetch, warm=False, device="cpu", k_chunks=4)
    sig, rate = sb._looped_capture(wavs[1], total)
    host = StreamingNfcDecoder(rate, window=1 << 21)
    frames = sum(len(host.feed(sig[off : off + CHUNK]))
                 for off in range(0, total, CHUNK))
    frames += len(host.finish())
    assert got["frames"] == n * frames > 0
    assert got["samples_per_stream"] == total and got["fetch"] == fetch
    assert got["stages"]["dispatches"] > 0


def test_streaming_bench_main_writes_out_only_when_asked(
        wavs, tmp_path, monkeypatch, capsys):
    from nfclab_torch.tools import streaming_bench as sb

    monkeypatch.chdir(tmp_path)
    argv = ["--wav", wavs[1], "--total", "100000", "--skip-farm"]
    assert sb.main(argv) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["metric"] == "streaming_samples_per_second"
    assert line["idle_ratio"] == 9 and list(tmp_path.iterdir()) == []
    assert sb.main([*argv, "--out", "s.json"]) == 0
    saved = json.loads((tmp_path / "s.json").read_text())
    assert set(saved) == {"single_stream_windowed_dense",
                          "single_stream_windowed_sparse"}
