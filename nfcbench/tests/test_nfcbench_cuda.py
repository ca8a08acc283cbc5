"""On the card: a short run of each cell of BENCHMARK.json is correct, and
under the control (a block dropped in 16) it is not."""

import json
from pathlib import Path

import pytest

from nfcbench import faults, harness

CELLS = [w["name"] for w in json.loads(
    (Path(harness.ROOT) / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_and_control(workload, cuda_device, monkeypatch):
    res = harness.run_cell(workload, 2**31 + 21, 3.0, False,
                           device=cuda_device)
    assert res["correct"], res["checks"]
    assert res["metrics"]["decode_rate"]["value"] > 0
    bad = harness.run_cell(workload, 2**31 + 21, 3.0, False,
                           device=cuda_device, setup_hook=faults.hook(
                               ["drop_block"], monkeypatch.setattr))
    assert not bad["correct"]
