"""The reader of kernels.scan_narrow_share on hand-built windows: nothing
where no scan ran or the farm keeps no launch counters (an earlier
program), 0 and 100 at the extremes, a mixed window; and its entry in
BENCHMARK.json."""

from pathlib import Path

import pytest

from nfcbench import harness

PKG = Path(harness.__file__).resolve().parent
NAME = "kernels.scan_narrow_share"
STATS = {"device_s": 1.0, "walk_s": 2.0, "wait_s": 0.5, "dispatches": 10,
         "drained_samples": 1000}


def window(open_counts, close_counts):
    def stats(counts):
        if counts is None:
            return dict(STATS)
        scans, narrow = counts
        return dict(STATS, scan_launches=scans, scan_narrow_launches=narrow)

    return harness.Window(
        setup_s=12.5, t_open=100.0, t_close=110.0, drained_open=0,
        drained_close=1, stats_open=stats(open_counts),
        stats_close=stats(close_counts), n_streams=1, window_samples=524288,
        lags=[], trace=None, cfg={"sample_rate": 10_000_000}, workload="x")


def read(w):
    return harness.load_module(PKG / "metrics" / f"{NAME}.py").read(w)


@pytest.mark.parametrize("opened,closed,want", [
    ((40, 40), (40, 40), None),      # no scan in the window
    (None, None, None),              # a farm without the counters
    ((40, 0), (140, 0), 0.0),        # every scan on ff_scan_kernel
    ((40, 40), (140, 140), 100.0),   # every scan on the narrow kernel
    ((40, 30), (140, 105), 75.0),    # 75 of the window's 100 narrow
])
def test_scan_narrow_share(opened, closed, want):
    got = read(window(opened, closed))
    assert got == (None if want is None else pytest.approx(want))


def test_listed_for_the_live_cells():
    spec = harness.load_spec(PKG.parent)
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "dsp/fused_frontend",
                 "moves": "decode_rate",
                 "workloads": ["live1-dense", "live1-pauses"]}
