"""The batch-corpus cell end to end on the CPU, at a tiny size: its
configuration with the entry driver ``batch_corpus`` and decode_batch's
defaults (the device conditioner's plain version here, in blocks of 8,192
with halos of 4,096; the walks on threads), over a ring of 8
recordings of one template a round with 10,000 samples of field off.
The warm-up walks the ring once (two calls of four), the window the
next two calls.  A sound run is correct with every due frame and edge
found; under the control (a recording in 16 never handed over, the 16th
in the window) it is not."""

import functools
import json
import shutil
from pathlib import Path

import pytest

from nfcbench import faults, harness

PKG = Path(harness.__file__).resolve().parent
MIX = {"templates": ["nfcf"], "transaction_rounds": [1, 1, 1, 1],
       "polling_periods": [1, 1, 1, 1], "field_off_samples": 10_000}


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    from nfclab_torch.native.binding import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    import nfclab_torch.dsp.conditioner as cmod
    from nfclab_torch.runtime import batch

    monkeypatch.setattr(cmod, "condition_jax", functools.partial(
        cmod.condition_jax, block=8192, halo=4096))
    # the walks on threads, as on the card (CUDA is live there, so the
    # default does not fork); a fork of this process would copy the
    # threads of JAX and torch
    monkeypatch.setattr(batch, "_fork_ok", lambda: False)
    pkg = tmp_path / "nfcbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "tests", "_cache", "__pycache__"))
    mix = dict(json.loads((pkg / "traffic" / "corpus.json").read_text()),
               **MIX)
    (pkg / "traffic" / "tiny-corpus.json").write_text(json.dumps(mix))
    spec = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-batch", "config": "nfc10m-batch",
                              "traffic": "tiny-corpus", "chips": 1,
                              "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, pkg


def test_batch_corpus_sound_run(tiny_cell):
    root, pkg = tiny_cell
    res = harness.run_cell("tiny-batch", 2**31 + 21, 0.5, False,
                           device="cpu", root=root, pkg=pkg)
    assert res["correct"], res["checks"]
    # the window's four recordings: 2 frames a round, and the field-off
    # edge of the first polling session (the second's lies within
    # carrier_lag of the window's end)
    assert res["attempted"] == 4 * 2 + 1 and res["failed"] == 0
    assert res["checks"]["carrier_lag_max"]["value"] <= 5
    assert set(res["metrics"]) == {"decode_rate", "setup_s"}
    assert res["metrics"]["decode_rate"]["value"] > 0


def test_batch_corpus_control_fails(tiny_cell, monkeypatch):
    root, pkg = tiny_cell
    bad = harness.run_cell("tiny-batch", 2**31 + 21, 0.5, False,
                           device="cpu", root=root, pkg=pkg,
                           setup_hook=faults.hook(["drop_block"],
                                                  monkeypatch.setattr))
    assert not bad["correct"], bad["checks"]
    assert bad["checks"]["missing"]["value"] >= 2
