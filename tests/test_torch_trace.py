"""The live mask path's measurement on the CPU: the spans of
nfclab_torch/runtime/trace.py and the counters CudaStreamFarm.stats adds
in mask mode (the steps of a trace.Lap), with device="cpu".

The farm runs its real engines (the kernels' plain versions) over two
template lanes, the chained chunk cut to 1024 so a window is 4096
samples: a serial first window, a segmented window whose repairs send
the next windows to the backoff, a two-chunk flush and a host tail;
once with spans off and once with them on.  The profiler, the task and
the CLI run the farm over stand-in engines that step through the lap
the farm passes them, so a run records few profiler events."""

import json
import queue
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_synth

from nfclab_torch.dsp import cuda_channels as cc
from nfclab_torch.runtime import trace
from nfclab_torch.runtime.farm import STEP_COUNTERS, CudaStreamFarm

RATE = torch_synth.RATE
CHUNK = 1024
N = 7 * 4 * CHUNK + 2 * CHUNK + 300
FEED = 3000
STEPS = ("upload_s", "launch_s", "compact_s", "fetch_s", "verify_s",
         "repair_s")
STEP_SPANS = ("upload", "launch", "compact", "fetch", "verify", "repair",
              "carry")
WAITS = ("task.queued", "farm.io_idle", "farm.wait")


@pytest.fixture(autouse=True)
def quiet_ring():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _drive(sigs, **kw):
    farm = CudaStreamFarm(len(sigs), RATE, fetch="mask", k_chunks=4,
                          segments=2, walk_threads=2, device="cpu", **kw)
    frames = [[] for _ in sigs]
    t0 = time.perf_counter()
    for off in range(0, sigs[0].shape[0], FEED):
        blk = np.stack([s[off : off + FEED] for s in sigs])
        for i, new in enumerate(farm.feed(blk)):
            frames[i].extend(new)
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    return farm, frames, time.perf_counter() - t0


@pytest.fixture(scope="module")
def runs():
    """{"off" | "on": (farm, frames, wall seconds, spans)} of one feed
    sequence through the real engines, spans off and then on."""
    tps = {tp.name: tp for tp in torch_synth.templates()}
    sigs = [torch_synth.lane(tps[name], N, seed=50 + i)[0]
            for i, name in enumerate(("nfca_106k", "nfcb"))]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "CHAIN_CHUNK", CHUNK)
        trace.disable()
        trace.clear()
        out["off"] = (*_drive(sigs), trace.spans())
        with trace.enable():
            out["on"] = (*_drive(sigs), trace.spans())
        trace.clear()
    return out


def test_spans_off_record_nothing(runs):
    """With spans off and no profiler the ring stays empty: a span site
    hands out the one shared no-op and a wait records nothing."""
    assert runs["off"][3] == []
    assert not trace.active()
    with trace.span("farm.stage", offset=0) as s:
        assert s is trace.span("farm.walk") and s.id is None
    trace.record("farm.wait", 0.0, 1.0, seq=0)
    assert trace.spans() == []


def test_frames_equal_with_spans_on_and_off(runs):
    assert runs["on"][1] == runs["off"][1]
    assert all(runs["off"][1])


@pytest.mark.parametrize("mode", ["off", "on"])
def test_step_counters_add_up(runs, mode):
    """The step counters tile the device passes: their sum is device_s
    within 2%; a stream's walk spends no more CPU than wall seconds; the
    IO thread idles between passes only."""
    farm, _, wall, _ = runs[mode]
    st = farm.stats
    assert set(STEP_COUNTERS) <= set(st)
    assert sum(st[k] for k in STEPS) == pytest.approx(st["device_s"],
                                                      rel=0.02)
    assert all(st[k] > 0 for k in STEPS)
    assert st["repaired_streams"] > 0 and st["seg_backoff_windows"] > 0
    assert 0 < st["walk_cpu_s"] <= st["walk_busy_s"]
    assert st["io_idle_s"] > 0
    assert st["io_idle_s"] + st["device_s"] <= wall


def test_window_spans_share_seq_and_nest(runs):
    farm, _, _, spans = runs["on"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)

    def named(name):
        return sorted((s for s in spans if s.name == name),
                      key=lambda s: s.args["seq"])

    passes, walks = named("farm.device_pass"), named("farm.walk")
    n = farm.stats["dispatches"]
    assert [p.args["seq"] for p in passes] == list(range(n))
    assert [w.args["seq"] for w in walks] == list(range(n))
    assert [p.args["kind"] for p in passes] == (
        ["serial", "segmented"] + ["backoff"] * (n - 3) + ["flush"])
    # a window's walk covers the samples its device pass covered
    assert [(p.args["lo"], p.args["hi"]) for p in passes] == [
        (w.args["lo"], w.args["hi"]) for w in walks]
    assert passes[-1].args["hi"] == farm._clock

    def pass_of(s):
        while s.name != "farm.device_pass":
            s = by_id[s.parent]
        return s

    steps = [s for s in spans if s.name in STEP_SPANS]
    assert {s.name for s in steps} == set(STEP_SPANS)
    for s in steps:
        assert s.args["seq"] == pass_of(s).args["seq"]
        assert s.thread == passes[0].thread
    repairs = [s for s in steps if s.name == "repair"]
    assert len(repairs) == farm.stats["repaired_streams"]
    for r in repairs:
        inner = {s.name for s in steps if s.parent == r.id}
        assert inner == {"upload", "launch", "compact", "fetch", "carry"}
        assert r.args["chunks"] > 0 and r.args["stream"] in (0, 1)
    for w in walks:
        streams = [s for s in spans if s.parent == w.id]
        assert sorted(s.args["stream"] for s in streams) == [0, 1]
        assert all(s.name == "farm.walk.stream"
                   and s.args["seq"] == w.args["seq"] for s in streams)
    # the IO thread idles between one pass and the next
    idle = named("farm.io_idle")
    assert [s.args["seq"] for s in idle] == list(range(1, n))
    for s in idle:
        k = s.args["seq"]
        assert passes[k - 1].end <= s.start <= s.end <= passes[k].start
    assert [s.args["seq"] for s in named("farm.wait")] == list(range(n))
    stages = [s for s in spans if s.name == "farm.stage"]
    assert [s.args["offset"] for s in stages] == list(range(0, N, FEED))


def test_lap_steps_tile_and_nest(monkeypatch):
    """trace.Lap on a stepped clock: a step counts from the previous
    step's end (the lap's making for the first), a step inside another
    counts alone and the outer leaves it out, the counts tile the lap,
    and each step is a span of its name with the lap's seq; a nested lap
    records spans and counts nothing."""
    clock = [0.0]
    monkeypatch.setattr(trace.time, "perf_counter", lambda: clock[0])
    stats = {"b_s": 10.0}
    lap = trace.Lap(stats, {"a": "a_s", "b": "b_s", "inner": "in_s"}, seq=3)
    clock[0] = 1.0   # before the first step: counts in it
    with trace.enable():
        with lap.step("a"):
            clock[0] = 3.0
        with lap.step("b", k=1):
            clock[0] = 4.0
            with lap.step("inner"):
                clock[0] = 6.0
            with lap.nested().step("a"):
                clock[0] = 6.5
            clock[0] = 7.0
    assert stats == {"a_s": 3.0, "b_s": 12.0, "in_s": 2.0}
    got = {s.name: s for s in trace.spans()}
    assert got["b"].args == {"seq": 3, "k": 1}
    assert got["inner"].parent == got["b"].id
    assert (got["inner"].start, got["inner"].end) == (4.0, 6.0)
    assert got["a"].args == {"seq": 3} and got["a"].parent == got["b"].id


def test_export_writes_chrome_json(tmp_path):
    with trace.enable():
        with trace.span("farm.device_pass", kind="serial", seq=0):
            with trace.span("upload", seq=0):
                pass
        trace.record("farm.io_idle", 1.0, 2.0, seq=1)
    path = tmp_path / "spans.json"
    assert trace.export(path) == 3
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in events) == [
        "farm.device_pass", "farm.io_idle", "upload"]
    outer = next(e for e in events if e["name"] == "farm.device_pass")
    inner = next(e for e in events if e["name"] == "upload")
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert outer["args"]["kind"] == "serial"
    assert outer["ts"] <= inner["ts"] and inner["dur"] <= outer["dur"]
    idle = next(e for e in events if e["name"] == "farm.io_idle")
    assert idle["ts"] == pytest.approx(1e6) and idle["dur"] == pytest.approx(
        1e6)
    names = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert names and all(e["name"] == "thread_name" for e in names)


def _stand_in_engines(mp, step_s=0.002):
    """Both engines replaced by ones that step through the farm's lap
    (each step a short sleep) and report no trigger."""

    def steps(lap, names):
        for step in names:
            with lap.step(step):
                time.sleep(step_s)

    def none(n):
        return [(np.zeros(0, np.int64), np.zeros(0, np.uint8))
                for _ in range(n)]

    def carry(n):
        return {"pen": np.zeros((n, 1), np.float32),
                "end": np.zeros((n, 1), np.float32)}

    def chained(blocks, state, base0, pt, mp_, cap_div=16, chunk=None,
                sample_rate=RATE, lap=None, want_carry=False):
        steps(lap, ("upload", "launch", "compact", "fetch"))
        n = blocks.shape[0]
        return (none(n), state, carry(n)) if want_carry else (none(n), state)

    def segmented(blocks, carry_in, pt, mp_, segments, lap=None, **kw):
        steps(lap, ("upload", "launch", "compact", "fetch", "verify"))
        n = blocks.shape[0]
        return none(n), dict(carry(n), tail=blocks[:, -cc.CHAIN_CHUNK:]), {
            "repaired_streams": 0, "repair_chunks": 0}

    mp.setattr(cc, "run_chained_masks", chained)
    mp.setattr(cc, "run_segmented_masks", segmented)
    mp.setattr(cc, "chain_state0", lambda *a, **k: None)


def test_profiler_ranges_match_spans(monkeypatch):
    """Under a CPU torch.profiler session (recording every thread) the
    ring records with spans off, and each span but the waits is a
    record_function range of its name within 1 ms of its perf_counter
    times, mapped through an anchor; the waits are not ranges.  The farm
    runs at the interpreter's default switch interval beside a thread
    that holds the interpreter lock whenever it can, as the walk and the
    feeder do: a range opened by a call that gives the lock away would
    wait a switch interval (5 ms) to get it back."""
    _stand_in_engines(monkeypatch)
    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)
    x = np.zeros((1, 6 * 4 * CHUNK), np.float32)
    cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=cfg)
    stop = threading.Event()

    def contend():
        while not stop.is_set():
            pass

    rival = threading.Thread(target=contend, daemon=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(0.005)
    try:
        prof.start()
        for _ in range(3):  # the first ranges of a session open slowly
            with torch.profiler.record_function("warm-up"):
                pass
        with torch.profiler.record_function("anchor"):
            anchor = time.perf_counter()
        rival.start()
        farm = CudaStreamFarm(1, RATE, fetch="mask", k_chunks=4, segments=1,
                              device="cpu")
        for off in range(0, x.shape[1], FEED):
            farm.feed(x[:, off : off + FEED])
        farm.finish()
        stop.set()
        rival.join()
        prof.stop()
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert not trace.active()
    spans = trace.spans()
    names = {s.name for s in spans}
    assert {"farm.stage", "farm.device_pass", "upload", "launch", "compact",
            "fetch", "farm.walk", "farm.walk.stream", "farm.io_idle",
            "farm.wait"} <= names
    events = prof.events()
    ranges: dict = {}
    t_anchor = None
    for e in events:
        if e.name == "anchor":
            t_anchor = e.time_range.start
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    assert t_anchor is not None

    def mapped(us):
        return anchor + (us - t_anchor) * 1e-6

    for s in spans:
        if s.name in WAITS:
            assert s.name not in ranges
            continue
        err = min(max(abs(mapped(a) - s.start), abs(mapped(b) - s.end))
                  for a, b in ranges[s.name])
        assert err < 1e-3, (s, err)


def test_task_spans_carry_block_offsets(monkeypatch):
    """RadioDecoderTask(frontend="mask"): a span of each block's time in
    the queue, its feed and its publication, each with the block's sample
    offset; the farm's staging of a block nests in that block's feed."""
    from nfclab_torch.hw import SignalBuffer
    from nfclab_torch.runtime.pipeline import Executor, RadioDecoderTask
    from nfclab_torch.runtime.subject import Subject

    _stand_in_engines(monkeypatch, step_s=0.0)
    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)
    Subject.clear_registry()
    done: queue.Queue = queue.Queue()
    Subject.name("radio.decoder.frame").subscribe(
        lambda f: f is None and done.put(f), replay=False)
    task = RadioDecoderTask(frontend="mask", device="cpu")
    ex = Executor(pool_size=1)
    block, n = 4096, 6
    with trace.enable():
        ex.submit(task)
        raw = Subject.name("radio.signal.raw")
        try:
            for k in range(n):
                raw.next(SignalBuffer(np.zeros(block, np.float32), RATE,
                                      k * block))
            raw.next(SignalBuffer.eof(RATE))
            done.get(timeout=60)
        finally:
            ex.shutdown()
    spans = trace.spans()
    offsets = [k * block for k in range(n)]

    def offs(name):
        return [s.args["offset"] for s in spans if s.name == name]

    assert offs("task.queued") == offsets + [0]   # the EOF buffer last
    assert offs("task.feed") == offsets
    assert offs("task.publish") == offsets
    by_id = {s.id: s for s in spans}
    stages = [s for s in spans if s.name == "farm.stage"]
    assert [s.args["offset"] for s in stages] == offsets
    for s in stages:
        feed = by_id[s.parent]
        assert feed.name == "task.feed"
        assert feed.args["offset"] == s.args["offset"]
    assert not task._put_times


def test_clear_drops_the_put_times():
    from nfclab_torch.hw import SignalBuffer
    from nfclab_torch.runtime.pipeline import RadioDecoderTask
    from nfclab_torch.runtime.subject import Subject

    Subject.clear_registry()
    task = RadioDecoderTask(frontend="host")
    raw = Subject.name("radio.signal.raw")
    for k in range(3):
        raw.next(SignalBuffer(np.zeros(8, np.float32), RATE, 8 * k))
    assert task.signal_queue.qsize() == 3 and len(task._put_times) == 3
    task._on_clear()
    assert task.signal_queue.qsize() == 0 and not task._put_times


def test_live_cli_trace_out(monkeypatch, tmp_path, capsys):
    """decode_cli live --trace-out writes the session's spans as Chrome
    JSON at exit (loopback source, stand-in engines)."""
    from nfclab_torch.apps import decode_cli

    _stand_in_engines(monkeypatch, step_s=0.0)
    path = tmp_path / "live.json"
    rc = decode_cli.main([
        "live", "loopback://test", "--blocks", "10", "--json",
        "--no-settings", "--frontend", "mask", "--device", "cpu",
        "--timeout", "20", "--trace-out", str(path)])
    assert rc == 0
    assert f"spans in {path}" in capsys.readouterr().err
    assert not trace.active()
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"}
    assert {"task.queued", "task.feed", "task.publish", "farm.stage",
            "farm.device_pass", "farm.walk"} <= names
