"""The batch-corpus-mask cell on the CPU, at a tiny size: the cell and its
configuration as ``BENCHMARK.json`` has them, with the entry driver
``batch_corpus_mask`` and ``decode_batch(frontend="mask")`` (the fused
frontend kernels' plain versions here, in chunks of 4,096 and windows of
four chunks; the walks on threads), over a ring of 8 recordings of one
template a round with 10,000 samples of field off.  The warm-up walks
the ring once (two calls of four), the window the next two calls.  A
sound run is correct with every due frame and edge found; under the
control (a recording in 16 never handed over, the 16th in the window) it
is not.  The driver labels the mask branch's spans for the trace reader,
and the cell's readers read their counters on hand-built windows, and
nothing where the program keeps no such counter (as an earlier program
would)."""

import json
import shutil
from pathlib import Path

import pytest

from nfcbench import faults, harness
from nfcbench.roofline import frontend_least_s

PKG = Path(harness.__file__).resolve().parent
RATE = 10_000_000
CELL = "batch-corpus-mask"
MIX = {"templates": ["nfcf"], "transaction_rounds": [1, 1, 1, 1],
       "polling_periods": [1, 1, 1, 1], "field_off_samples": 10_000}
METRICS = ("batchmask.masks_share", "batchmask.masks_wait_share",
           "batchmask.condition_share", "batchmask.fetch_share",
           "kernels.batch_mask_roofline")


def test_cell_as_benchmark_json_has_it():
    spec = harness.load_spec(PKG.parent)
    cell = harness.find(spec["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "nfc10m-batch-mask", "corpus", 1)
    conf = harness.find(spec["configs"], cell["config"], "config")
    cfg = json.loads((PKG.parent / conf["file"]).read_text())
    assert cfg["entry"] == "batch_corpus_mask"
    assert cfg["decode_batch"] == {"frontend": "mask"}
    assert cfg["captures_per_call"] == 4
    assert cfg["reduced"] == conf["reduced"] == ["recording_samples"]
    got = {m["name"]: m for m in spec["per_layer"]
           if CELL in m.get("workloads", [])}
    assert set(got) == set(METRICS)
    for m in got.values():
        assert m["workloads"] == [CELL] and m["moves"] == "decode_rate"
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    from nfclab_torch.native.binding import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.runtime import batch

    monkeypatch.setattr(cc, "CHAIN_CHUNK", 4096)
    monkeypatch.setattr(cc, "BATCH_K_CHUNKS", 4)
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
    spec["workloads"].append({"name": "tiny-batch-mask",
                              "config": "nfc10m-batch-mask",
                              "traffic": "tiny-corpus", "chips": 1,
                              "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, pkg


def test_batch_corpus_mask_sound_run(tiny_cell):
    root, pkg = tiny_cell
    res = harness.run_cell("tiny-batch-mask", 2**31 + 21, 0.5, False,
                           device="cpu", root=root, pkg=pkg)
    assert res["correct"], res["checks"]
    # the window's four recordings: 2 frames a round, and the field-off
    # edge of the first polling session (the second's lies within
    # carrier_lag of the window's end)
    assert res["attempted"] == 4 * 2 + 1 and res["failed"] == 0
    assert res["checks"]["carrier_lag_max"]["value"] <= 5
    assert set(res["metrics"]) == {"decode_rate", "setup_s"}
    assert res["metrics"]["decode_rate"]["value"] > 0


def test_batch_corpus_mask_control_fails(tiny_cell, monkeypatch):
    root, pkg = tiny_cell
    bad = harness.run_cell("tiny-batch-mask", 2**31 + 21, 0.5, False,
                           device="cpu", root=root, pkg=pkg,
                           setup_hook=faults.hook(["drop_block"],
                                                  monkeypatch.setattr))
    assert not bad["correct"], bad["checks"]
    assert bad["checks"]["missing"]["value"] >= 2


def test_driver_labels_the_mask_branch(tiny_cell):
    """One call with spans on: the device pass and the parent's wait on it
    are ``device_pass``, the parent's conditioning ``condition``, the walks
    ``walk``, and the call's counters reach the drain event."""
    from nfclab_torch.runtime import trace

    root, pkg = tiny_cell
    spec = harness.load_spec(root)
    cell = harness.find(spec["workloads"], "tiny-batch-mask", "workload")
    conf = harness.find(spec["configs"], cell["config"], "config")
    cfg = json.loads((root / conf["file"]).read_text())
    mix = harness.load_mix(cell["traffic"], pkg / "traffic")
    gen = harness.load_generator(mix, pkg)
    traffic = gen.Traffic(mix, 2**31 + 21, 1, int(cfg["block"]), RATE)
    driver = harness.load_module(
        pkg / "drivers" / f"{cfg['entry']}.py").Driver(cfg, traffic, "cpu")
    driver.spans_on = True
    trace.clear()
    try:
        with trace.enable():
            driver._call()
    finally:
        trace.clear()
        driver.finish()
    labels = [name for _, _, name in driver.spans]
    assert labels.count("condition") == 4
    assert labels.count("device_pass") == 2
    assert "walk" in labels
    st = driver.events[-1][2]
    assert st["captures"] == 4 and st["masks_windows"] > 0
    assert st["masks_s"] > 0 and st["native_condition_s"] > 0


# ------------------------------------------------------------------ readers

STATS0 = {"captures": 8, "samples": 18e6, "read_s": 1.0, "pool_s": 0.5,
          "walk_wait_s": 3.0, "masks_s": 10.0, "native_condition_s": 2.0,
          "masks_wait_s": 8.0, "masks_stage_s": 0.5, "masks_upload_s": 0.3,
          "masks_launch_s": 0.2, "masks_compact_s": 6.0,
          "masks_fetch_s": 3.0, "masks_windows": 20}
STATS1 = dict(STATS0, masks_s=40.0, native_condition_s=7.0,
              masks_wait_s=30.0, masks_fetch_s=13.0, masks_windows=60)
# the counters of a program without the mask branch's
OLD = {"captures": 8, "samples": 18e6, "read_s": 1.0, "pool_s": 0.5,
       "walk_wait_s": 3.0, "thread_walks": 8}
NARROW = "void ff_scan_kernel_narrow<6, 4, 2, 3>"
MASK = "void ff_mask_kernel<32>"


def _window(**kw):
    base = dict(setup_s=30.0, t_open=100.0, t_close=150.0,
                drained_open=18_000_000, drained_close=54_000_000,
                stats_open=STATS0, stats_close=STATS1, n_streams=1,
                window_samples=18_000_000, lags=[], trace=None,
                cfg={"sample_rate": RATE}, workload=CELL)
    base.update(kw)
    return harness.Window(**base)


def _read(name, w):
    return harness.load_module(PKG / "metrics" / f"{name}.py").read(w)


@pytest.mark.parametrize("name,want", [
    ("batchmask.masks_share", 60.0),          # 30 s of 50
    ("batchmask.masks_wait_share", 44.0),     # 22 s
    ("batchmask.condition_share", 10.0),      # 5 s
    ("batchmask.fetch_share", 20.0),          # 10 s
])
def test_counter_readers(name, want):
    assert _read(name, _window()) == pytest.approx(want)


def test_batch_mask_roofline_names_its_kernels_exactly():
    """The scan (either kernel) and the mask by their exact names; a
    kernel whose name only holds one of theirs, the conditioner and the
    copies are not counted."""
    tr = {"busy_s": 2.0, "window_s": 50.0,
          "ops": {NARROW: 0.6, MASK: 0.2, "void ff_scan_kernel<6, 4, 2, 3>":
                  0.2, "void ff_scan_kernel_v2<1>": 5.0,
                  "cond_scan_kernel(CondScanArgs)": 3.0,
                  "Memcpy DtoH (Device -> Pageable)": 0.4}}
    least = frontend_least_s(36_000_000, 40, RATE)
    assert _read("kernels.batch_mask_roofline", _window(trace=tr)) == \
        pytest.approx(100.0 * least / 1.0)


@pytest.mark.parametrize("name", METRICS)
def test_readers_nothing_to_read(name):
    """A program without the mask branch's counters (the parent of the
    change that added them), with or without a trace: nothing, no error.
    The roofline reads nothing without a trace or without its kernels."""
    tr = {"busy_s": 1.0, "window_s": 50.0, "ops": {NARROW: 1.0}}
    old = _window(stats_open=OLD, stats_close=dict(OLD, read_s=2.0),
                  trace=tr)
    assert _read(name, old) is None
    if name == "kernels.batch_mask_roofline":
        assert _read(name, _window()) is None
        idle = {"busy_s": 1.0, "window_s": 50.0,
                "ops": {"Memcpy HtoD": 1.0}}
        assert _read(name, _window(trace=idle)) is None
