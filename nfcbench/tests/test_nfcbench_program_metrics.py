"""The readers of the program's own counters and spans, on hand-built
windows: their arithmetic, and nothing (no error) where the program
keeps no such counter or span, as a program without them would."""

import sys
from pathlib import Path

import numpy as np
import pytest

from nfcbench import harness

PKG = Path(harness.__file__).resolve().parent
OLD = {"device_s": 1.0, "walk_s": 2.0, "wait_s": 0.5, "dispatches": 10,
       "seg_dispatches": 6, "repaired_streams": 3, "repair_chunks": 4,
       "seg_backoff_windows": 2, "drained_samples": 1000}
NEW = {"io_idle_s": 1.0, "upload_s": 0.1, "launch_s": 0.2, "compact_s": 3.0,
       "fetch_s": 0.3, "verify_s": 0.01, "repair_s": 0.5,
       "walk_busy_s": 4.0, "walk_cpu_s": 3.0}
COUNTERS = ("farm.io_starved_share", "farm.upload_share", "farm.fetch_share",
            "segmented.repair_time_share", "farm.walk_stall_share")


def window(stats_open=None, stats_close=None, **kw):
    st0 = dict(OLD, **NEW) if stats_open is None else stats_open
    st1 = dict(st0, io_idle_s=3.5, upload_s=0.6, fetch_s=1.3, repair_s=2.5,
               walk_busy_s=9.0, walk_cpu_s=7.0) if stats_close is None \
        else stats_close
    base = dict(setup_s=12.5, t_open=100.0, t_close=110.0,
                drained_open=0, drained_close=1, stats_open=st0,
                stats_close=st1, n_streams=1, window_samples=524288, lags=[],
                trace=None, cfg={"sample_rate": 10_000_000}, workload="x")
    base.update(kw)
    return harness.Window(**base)


def read(name, w):
    return harness.load_module(PKG / "metrics" / f"{name}.py").read(w)


@pytest.mark.parametrize("name,want", [
    ("farm.io_starved_share", 25.0),       # 2.5 s of 10
    ("farm.upload_share", 5.0),
    ("farm.fetch_share", 10.0),
    ("segmented.repair_time_share", 20.0),
    # 5 s of walk in wall time, 4 s of them on a CPU: 20% off it
    ("farm.walk_stall_share", 20.0),
])
def test_counter_shares(name, want):
    assert read(name, window()) == pytest.approx(want)


@pytest.mark.parametrize("name", COUNTERS)
def test_nothing_without_the_counters(name):
    """A farm without the counters (an earlier program) reads nothing."""
    assert read(name, window(stats_open=dict(OLD),
                             stats_close=dict(OLD, walk_s=6.0))) is None


def test_walk_stall_nothing_without_a_walk():
    st = dict(OLD, **NEW)
    assert read("farm.walk_stall_share",
                window(stats_open=st, stats_close=dict(st))) is None


@pytest.fixture
def ring():
    from nfclab_torch.runtime import trace

    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


def test_queue_wait_p95(ring):
    """Blocks taken inside the window count, whenever they were put;
    spans of other names and blocks taken outside do not."""
    with ring.enable():
        for k in range(20):    # taken at 100.5..110 s, waited 1..20 ms
            t = 100.0 + 0.5 * (k + 1)
            ring.record("task.queued", t - 0.001 * (k + 1), t, offset=k)
        ring.record("task.queued", 99.0, 99.5, offset=99)      # before
        ring.record("task.queued", 105.0, 111.0, offset=100)   # after
        ring.record("task.feed", 101.0, 109.0, offset=0)
    # numpy's linear 95th percentile of 1..20 ms: 19.05 ms
    assert read("pipeline.queue_wait_p95", window()) == pytest.approx(19.05)
    # a block put before the window and taken in it counts: 10,500 ms
    with ring.enable():
        ring.record("task.queued", 90.0, 100.5, offset=101)
    want = float(np.percentile([*range(1, 21), 10500.0], 95))
    assert read("pipeline.queue_wait_p95", window()) == pytest.approx(want)


def test_queue_wait_nothing_without_spans(ring, monkeypatch):
    import nfclab_torch.runtime

    assert read("pipeline.queue_wait_p95", window()) is None
    # a program without the trace module: the import fails, the reader
    # reads nothing
    with ring.enable():
        ring.record("task.queued", 104.0, 105.0, offset=0)
    monkeypatch.setitem(sys.modules, "nfclab_torch.runtime.trace", None)
    monkeypatch.delattr(nfclab_torch.runtime, "trace")
    assert read("pipeline.queue_wait_p95", window()) is None


def test_every_new_metric_listed_for_the_live_cells():
    spec = harness.load_spec(PKG.parent)
    names = {m["name"]: m for m in spec["per_layer"]}
    for name in (*COUNTERS, "pipeline.queue_wait_p95"):
        m = names[name]
        assert m["moves"] == "decode_rate"
        assert m["workloads"] == ["live1-dense", "live1-pauses"]
        assert (PKG / "metrics" / f"{name}.py").is_file()
