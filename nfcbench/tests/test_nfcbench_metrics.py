"""Each metric's arithmetic on fabricated counters, lags and traces."""

import json
from pathlib import Path

import pytest

from nfcbench import harness, roofline, trace

PKG = Path(harness.__file__).resolve().parent
STATS0 = {"device_s": 1.0, "walk_s": 2.0, "wait_s": 0.5, "dispatches": 10,
          "seg_dispatches": 6, "repaired_streams": 3, "repair_chunks": 4,
          "seg_backoff_windows": 2, "drained_samples": 1000}


def window(**kw):
    st1 = dict(STATS0, walk_s=6.0, wait_s=1.5, dispatches=20,
               seg_dispatches=14, repaired_streams=7)
    base = dict(setup_s=12.5, t_open=100.0, t_close=110.0,
                drained_open=4_000_000, drained_close=54_000_000,
                stats_open=STATS0, stats_close=st1, n_streams=2,
                window_samples=2_500_000, lags=[0.1 * i for i in range(1, 21)],
                trace=None, cfg={"sample_rate": 10_000_000}, workload="x")
    base.update(kw)
    return harness.Window(**base)


def read(name, w):
    return harness.load_module(PKG / "metrics" / f"{name}.py").read(w)


def test_end_to_end():
    w = window()
    assert read("decode_rate", w) == pytest.approx(5e6)
    assert read("setup_s", w) == 12.5


def test_frame_lag():
    # numpy's linear percentile of 0.1..2.0: 1.905 s
    assert read("pipeline.frame_lag_p95", window()) == pytest.approx(1905.0)
    assert read("pipeline.frame_lag_p95", window(lags=[])) is None


def test_farm_counters():
    w = window()
    assert read("farm.walk_share", w) == pytest.approx(40.0)
    assert read("farm.wait_share", w) == pytest.approx(10.0)
    # 10 windows, 8 of them segmented
    assert read("segmented.serial_share", w) == pytest.approx(20.0)
    # 4 repaired of 2 streams x 8 segmented windows
    assert read("segmented.repair_share", w) == pytest.approx(25.0)


def test_nothing_to_read():
    flat = dict(STATS0)
    w = window(stats_close=flat)
    assert read("segmented.serial_share", w) is None
    assert read("segmented.repair_share", w) is None
    assert read("device.idle_share", w) is None
    assert read("kernels.frontend_roofline", w) is None
    no_kernels = {"busy_s": 1.0, "window_s": 10.0, "ops": {"memcpy": 1.0}}
    assert read("kernels.frontend_roofline", window(trace=no_kernels)) is None


def test_trace_metrics():
    tr = {"busy_s": 2.5, "window_s": 10.0,
          "ops": {"ff_scan_kernel(float const*)": 0.3, "ff_mask_kernel": 0.1,
                  "Memcpy HtoD": 2.0}}
    w = window(trace=tr)
    assert read("device.idle_share", w) == pytest.approx(75.0)
    samples = 50_000_000
    least = max(
        (5 * samples + 8 * 2109 * 20) / roofline.PEAK_BYTES_S,
        105 * samples / roofline.PEAK_FLOPS_F32)
    assert read("kernels.frontend_roofline", w) == pytest.approx(
        100 * least / 0.4)
    # the state carried follows the configuration's rate
    slow = read("kernels.frontend_roofline",
                window(trace=tr, cfg={"sample_rate": 3_200_000}))
    assert slow == pytest.approx(100 * max(
        (5 * samples + 8 * 1095 * 20) / roofline.PEAK_BYTES_S,
        105 * samples / roofline.PEAK_FLOPS_F32) / 0.4)


def test_summarize_union_and_gaps():
    iv = [(1.0, 2.0, "a"), (1.5, 3.0, "b"), (5.0, 6.0, "a")]
    spans = [(0.0, 1.0, "walk"), (3.0, 5.0, "device_pass")]
    s = trace.summarize(iv, 0.0, 10.0, spans)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["ops"] == {"a": 2.0, "b": 1.5}
    assert s["idle_gaps"][0] == ["feed (no farm span)", 4.0]
    assert ["device_pass (host side)", 2.0] in s["idle_gaps"]
    assert ["walk", 1.0] in s["idle_gaps"]


def test_device_intervals_anchor_and_clip():
    raw = {"anchor": 50.0, "events": [
        {"name": trace.ANCHOR, "ph": "X", "ts": 1_000_000, "dur": 5},
        {"name": "k1", "cat": "kernel", "ts": 1_500_000, "dur": 200_000},
        {"name": "cpy", "cat": "gpu_memcpy", "ts": 3_000_000, "dur": 1_000_000},
        {"name": "op", "cat": "cpu_op", "ts": 1_600_000, "dur": 10},
    ]}
    iv = trace.device_intervals(raw, 50.4, 52.5)
    assert [n for _, _, n in iv] == ["k1", "cpy"]
    assert iv[0][0] == pytest.approx(50.5) and iv[0][1] == pytest.approx(50.7)
    assert iv[1][1] == pytest.approx(52.5)
    with pytest.raises(ValueError):
        trace.device_intervals({"anchor": 0.0, "events": []}, 0, 1)


def test_roofline_bound():
    # bytes-bound below ~ 70 samples of state per sample, flops above
    assert roofline.frontend_least_s(1, 0, 10_000_000) == pytest.approx(
        105 / roofline.PEAK_FLOPS_F32)
    n = 10**6
    assert roofline.frontend_least_s(n, 1000, 10_000_000) == pytest.approx(
        (5 * n + 8 * 2109 * 1000) / roofline.PEAK_BYTES_S)


def test_frozen_state_size_matches_the_plan_arithmetic():
    # carry 8, rings 128 + 128 + 256, product rings 8 + 16 + 32,
    # histories (47, 117, 153, 473, 94) + 128 each, sums 9
    assert roofline.state_floats(10_000_000) == (
        8 + 128 + 128 + 256 + 8 + 16 + 32
        + sum(h + 128 for h in (47, 117, 153, 473, 94)) + 9)


@pytest.mark.parametrize("rate", [500_000, 1_000_000, 3_200_000, 5_000_000,
                                  8_000_000, 10_000_000, 24_000_000,
                                  40_000_000])
def test_state_size_follows_the_program_at_each_rate(rate):
    """The frozen count against the program's own plan (the test may read
    the program; the yardstick may not)."""
    from nfclab_torch.dsp.fused_frontend import kernel_plan

    assert roofline.state_floats(rate) == kernel_plan(rate).nstate


def test_every_metric_has_a_reader():
    spec = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_window_opens_and_closes_on_drain_events():
    ev = [(t, int(t * 10), {}) for t in (1.0, 2.0, 3.5, 4.0, 6.5, 7.0)]
    assert harness._window_events(ev[:2], 2.5, 3.0) is None
    opened, closed = harness._window_events(ev, 1.5, 2.0)
    assert opened[0] == 2.0 and closed[0] == 4.0
    opened, closed = harness._window_events(ev, 2.0, 2.5)
    assert opened[0] == 3.5 and closed[0] == 6.5
    assert harness._window_events(ev, 6.9, 1.0) is None
