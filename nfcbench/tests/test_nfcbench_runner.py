"""The runner's refusals, and the shape BENCHMARK.json must keep."""

import json
import re
from pathlib import Path

import pytest

from nfcbench import run

ROOT = Path(run.__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "live1-dense", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_too_few_cards(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "live1-pauses", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload():
    with pytest.raises(KeyError):
        run.chips_needed("no-such-cell")


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["nfcbench"]
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and set(c) == {
            "name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "nfcbench" / "drivers" / f"{cfg['entry']}.py").is_file()
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = json.loads((ROOT / "nfcbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "nfcbench" / "traffic"
                / f"{mix['generator']}.py").is_file()
    assert {w["config"] for w in spec["workloads"]} == set(names)
    files = {(ROOT / c["file"]).resolve() for c in spec["configs"]}
    assert set((ROOT / "nfcbench" / "configs").glob("*.json")) == files
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert "\n" not in m["layer"]
