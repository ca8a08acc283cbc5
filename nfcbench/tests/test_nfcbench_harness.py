"""Whole runs on the CPU with the stand-in engines (standin.py): a cell,
configuration, mix, generator, limits file and metric added as new files
are found by name; each fault of nfcbench/faults.py, and the control,
turn ``correct`` false, in the tiny cell and in each live cell."""

import json
import shutil
from pathlib import Path

import pytest

from nfcbench import faults, harness

PKG = Path(harness.__file__).resolve().parent
TINY = {
    "name": "tiny-farm2", "source": "test", "entry": "stream_farm",
    "sample_rate": 10_000_000, "streams": 2, "block": 65536,
    "farm": {"fetch": "mask", "k_chunks": 4, "walk_threads": 2},
    "warm_windows": 1, "reduced": [],
}


@pytest.fixture
def added(tmp_path):
    """A copy of the package with a configuration, a mix and a metric
    added as files, and a BENCHMARK.json that names them."""
    pkg = tmp_path / "nfcbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "tests", "_cache", "__pycache__"))
    mix = json.loads((pkg / "traffic" / "pauses.json").read_text())
    mix.update(templates=["nfcf", "nfca_106k"], field_off_samples=300_000,
               generator="sparse_gen")
    (pkg / "traffic" / "sparse.json").write_text(json.dumps(mix))
    # a generator of its own, whose judge adds a number of its own
    (pkg / "traffic" / "sparse_gen.py").write_text(
        "from .synth import RATE, Traffic  # noqa: F401\n"
        "from .synth import judge as _judge\n\n\n"
        "def judge(*args):\n"
        "    return dict(_judge(*args), streams_judged=2)\n")
    (pkg / "limits" / "tiny-sparse.json").write_text(json.dumps(
        {"missing": 0, "unmatched": 0, "carrier_lag_max": 32768,
         "streams_judged": 2}))
    (pkg / "metrics" / "frames.rate.py").write_text(
        "def read(w):\n    return len(w.lags) / w.seconds\n")
    (pkg / "configs" / "tiny-farm2.json").write_text(json.dumps(TINY))
    spec = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-farm2", "source": "test",
                            "file": "nfcbench/configs/tiny-farm2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-sparse", "config": "tiny-farm2",
                              "traffic": "sparse", "chips": 1, "why": "t"})
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny-sparse")
    spec["per_layer"].append({"name": "frames.rate", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "decode_rate",
                              "workloads": ["tiny-sparse"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, pkg


def test_added_files_are_found(added, engines):
    root, pkg = added
    res = harness.run_cell("tiny-sparse", 2**31 + 77, 1.0, False,
                           device="cpu", root=root, pkg=pkg)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"decode_rate", "setup_s"}
    assert res["checks"]["streams_judged"] == {"value": 2, "limit": 2}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    traced = harness.run_cell("tiny-sparse", 5, 1.0, True, device="cpu",
                              root=root, pkg=pkg)
    assert traced["correct"]
    assert traced["metrics"]["frames.rate"]["value"] > 0
    assert {"farm.walk_share", "farm.wait_share", "device.idle_share",
            "pipeline.frame_lag_p95"} <= set(traced["metrics"])


def test_a_rate_the_generator_does_not_write_is_refused(added):
    root, pkg = added
    path = pkg / "configs" / "tiny-farm2.json"
    path.write_text(json.dumps(dict(TINY, sample_rate=3_200_000)))
    with pytest.raises(ValueError, match="3200000"):
        harness.run_cell("tiny-sparse", 1, 1.0, False, device="cpu",
                         root=root, pkg=pkg)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault, added, engines, monkeypatch):
    root, pkg = added
    res = harness.run_cell("tiny-sparse", 31, 2.0, False, device="cpu",
                           root=root, pkg=pkg,
                           setup_hook=faults.hook([fault],
                                                  monkeypatch.setattr))
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


def test_live_task_sound_run(engines):
    """The live entry (RadioDecoderTask under an Executor) on a real cell."""
    res = harness.run_cell("live1-pauses", 2**31 + 3, 1.5, False,
                           device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["carrier_lag_max"]["value"] <= \
        res["checks"]["carrier_lag_max"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", ["live1-dense", "live1-pauses"])
def test_live_task_fault(workload, fault, engines, monkeypatch):
    """Each fault, planted under the live entry of each cell, fails it."""
    bad = harness.run_cell(workload, 2**31 + 3, 1.5, False, device="cpu",
                           setup_hook=faults.hook([fault],
                                                  monkeypatch.setattr))
    assert not bad["correct"], bad["checks"]
    assert bad["failed"] > 0
