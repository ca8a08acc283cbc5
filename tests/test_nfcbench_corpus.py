"""The batch-corpus cell's pieces (``nfcbench/``) and the counters of the
path it measures, on the CPU (and one test on the card):

- the corpus generator (``nfcbench/traffic/corpus.py``): a ring of whole
  recordings, transaction and polling alternating, the same lengths and
  frames for every seed, no frame across a recording's end; its judge;
- ``decode_batch(conditioner="jax", device="cpu")`` gives the frames of
  ``conditioner="native"`` on recordings of the corpus, both the frames
  the generator wrote; its ``stats`` and spans;
- ``condition_jax(device="cpu")`` equals ``condition_exact`` bit for bit
  on a corpus recording, and its ``stats`` add over calls;
- each new metric reader on hand-built windows, and nothing (no error)
  where the program keeps no such counter or the kernel did not run;
- the entry driver with a ``decode_batch`` that takes no ``stats``, as
  an earlier program's;
- on the card (``cuda``): ``condition_jax`` equals ``condition_exact`` in
  all eight arrays on every recording of the ring; ``decode_batch`` with
  its defaults, CUDA live before the walks, walks every capture on threads
  and gives the native conditioner's frames.

``test_nfcbench_batch_cell.py`` runs the whole cell at a tiny size.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

from nfcbench import cond_roofline, harness, roofline
from nfcbench.check import CARRIER_OFF, CARRIER_ON, LISTEN, POLL, Emitted
from nfcbench.traffic import corpus

ROOT = Path(harness.__file__).resolve().parent.parent
PKG = ROOT / "nfcbench"
RATE = 10_000_000
ROUND = 246_493                   # the five templates back to back
PERIOD = 50_000 + ROUND + 1_000_000   # one polling period
SEED = 2**31 + 21
ARRAYS = ("value", "envelope", "filtered", "deviation", "average",
          "mod_depth", "edge_peak", "edge_time")
LIMITS = {"missing": 0, "unmatched": 0, "carrier_lag_max": 32768}
# a small corpus for the CPU: two templates a round, a short field-off
TINY = {"templates": ["nfcf", "nfca_106k"], "transaction_rounds": [1, 2],
        "polling_periods": [2, 1], "field_off_samples": 30_000}


def _mix(**kw) -> dict:
    return dict(harness.load_mix("corpus"), **kw)


@pytest.fixture(scope="module")
def full():
    return corpus.Traffic(_mix(), SEED, 1, 65536)


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _recording_of(t, pos: int) -> int:
    return int(np.searchsorted(t.starts, pos, side="right")) - 1


# --------------------------------------------------------------- generator

def test_ring_kinds_and_lengths(full):
    assert full.ring == 8
    assert full.kinds == ["transaction", "polling"] * 4
    lengths = [len(x) for x in full.recordings]
    assert lengths[0::2] == [r * ROUND for r in (4, 12, 6, 10)]
    assert lengths[1::2] == [p * PERIOD for p in (1, 3, 2, 2)]
    assert all(n % 65536 for n in lengths)
    assert 985_000 < min(lengths) and max(lengths) < 3_890_000
    # each call of four asks the same work
    assert sum(lengths[:4]) == sum(lengths[4:]) == 9_129_860
    assert full.period == sum(lengths) == full.starts[-1] + lengths[-1]
    assert all(x.dtype == np.float32 for x in full.recordings)
    assert full.block(9).shape == (1, lengths[1])


def test_no_frame_crosses_an_end(full):
    """Each recording holds whole rounds (14 frames each), its frames and
    edges inside it; a polling session owes its field-off edges and the
    field-on edges between its periods, none at its ends."""
    frames = full.frames[0]
    for f in frames:
        j = _recording_of(full, f.start)
        assert full.starts[j] < f.start < f.end
        assert f.end <= full.starts[j] + len(full.recordings[j])
    for j, kind in enumerate(full.kinds):
        lo = full.starts[j]
        hi = lo + len(full.recordings[j])
        n = len(full.recordings[j])
        mine = [f for f in frames if lo <= f.start < hi]
        edges = [e for e in full.edges if lo <= e[1] < hi]
        if kind == "transaction":
            assert len(mine) == 14 * (n // ROUND) and edges == []
        else:
            periods = n // PERIOD
            assert len(mine) == 14 * periods
            assert [k for k, _ in edges] == (
                [CARRIER_OFF, CARRIER_ON] * periods)[:2 * periods - 1]
            assert all(lo < p < hi for _, p in edges)
            # the field is off at each field-off edge
            for k, p in edges:
                x = full.recordings[j][p - lo - 100 : p - lo + 100]
                assert (abs(x[:100]).mean() > 0.1) == (k == CARRIER_OFF)


def test_same_seed_same_ring():
    a = corpus.Traffic(_mix(**TINY), 7, 1, 65536)
    b = corpus.Traffic(_mix(**TINY), 7, 1, 65536)
    assert all(np.array_equal(x, y) for x, y in zip(a.recordings,
                                                    b.recordings))
    assert a.frames == b.frames and a.edges == b.edges


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 2**40 + 3])
def test_other_seed_same_work(full, seed):
    """Another seed: the same lengths and frames, the frames in another
    order, with other samples."""
    other = corpus.Traffic(_mix(), seed, 1, 65536)
    assert list(map(len, other.recordings)) == list(map(len,
                                                        full.recordings))
    assert other.starts == full.starts and other.edges == full.edges
    assert [f.data for f in other.frames[0]] != [
        f.data for f in full.frames[0]]
    assert other.period == full.period
    assert sorted(f.data for f in other.frames[0]) == sorted(
        f.data for f in full.frames[0])
    assert not np.array_equal(other.recordings[0][:1000],
                              full.recordings[0][:1000])


def test_refusals():
    with pytest.raises(ValueError, match="3200000"):
        corpus.Traffic(_mix(), 1, 1, 65536, rate=3_200_000)
    with pytest.raises(ValueError, match="streams"):
        corpus.Traffic(_mix(**TINY), 1, 2, 65536)
    with pytest.raises(ValueError, match="as many"):
        corpus.Traffic(_mix(**dict(TINY, polling_periods=[1])), 1, 1, 65536)


def test_line_repeats_the_ring():
    t = corpus.Traffic(_mix(**TINY), 3, 1, 65536)
    p = t.period
    one = t.frames_between(0, 0, p)
    assert one == t.frames[0]
    assert t.frames_between(0, 2 * p, 3 * p) == [
        f._replace(start=f.start + 2 * p, end=f.end + 2 * p) for f in one]
    assert t.edges_between(p, 2 * p) == [(k, e + p) for k, e in t.edges]
    assert t.starts_between(0, 2 * p) == t.starts + [s + p for s in t.starts]
    # a frame across the window's edge is not in it
    f = one[3]
    assert f not in t.frames_between(0, f.start + 1, p)


# ------------------------------------------------------------------ judge

def _emit(f, in_window=True, flags=0, data=None, shift=0):
    return Emitted(0, f.tech, f.kind, flags, f.data if data is None else data,
                   f.start + shift, f.end + shift, in_window)


@pytest.fixture(scope="module")
def tiny():
    return corpus.Traffic(_mix(**TINY), SEED, 1, 65536)


def _all_emitted(t, laps=1):
    out = []
    for lap in range(laps):
        at = lap * t.period
        out += [_emit(f, shift=at) for f in t.frames[0]]
        out += [Emitted(0, 0, k, 0, b"", p + at, p + at, True)
                for k, p in t.edges]
        for s in t.starts:    # what a decoder emits at a capture's start
            out += [Emitted(0, 0, CARRIER_OFF, 0, b"", s + at + d, s + at + d,
                            True) for d in (0, 1)]
            out.append(Emitted(0, 0, CARRIER_ON, 0, b"", s + at + 5,
                               s + at + 5, True))
    return out


def test_judge_everything_written_is_correct(tiny):
    got = corpus.judge_emitted(_all_emitted(tiny, 2), tiny, 0,
                               2 * tiny.period, LIMITS)
    edges = len(tiny.edges_between(0, 2 * tiny.period - 32768))
    assert got == {"due": 2 * len(tiny.frames[0]) + edges, "missing": 0,
                   "unmatched": 0, "carrier_lag_max": 5.0}
    assert edges >= 2      # a polling session of two periods owes both kinds


@pytest.mark.parametrize("fault", ["lost", "altered", "flagged", "moved",
                                   "late_edge"])
def test_judge_fails_each_fault(tiny, fault):
    em = _all_emitted(tiny)
    data = [i for i, e in enumerate(em) if e.kind in (POLL, LISTEN)]
    i = data[len(data) // 2]
    e = em[i]
    if fault == "lost":
        del em[i]
    elif fault == "altered":
        em[i] = e._replace(data=e.data[:-1] + bytes([e.data[-1] ^ 1]))
    elif fault == "flagged":
        em[i] = e._replace(flags=0x20)
    elif fault == "moved":      # off its own samples
        em[i] = e._replace(start=e.start + 10_000, end=e.end + 10_000)
    else:
        k = next(j for j, x in enumerate(em) if x.kind == CARRIER_OFF
                 and x.start in {p for _, p in tiny.edges})
        em[k] = em[k]._replace(start=em[k].start + 40_000)
    got = corpus.judge_emitted(em, tiny, 0, tiny.period, LIMITS)
    assert got["missing"] + got["unmatched"] > 0, got


def test_judge_start_edges_are_not_due(tiny):
    """A run that emits nothing at the recordings' starts misses nothing
    there."""
    em = [e for e in _all_emitted(tiny)
          if e.start - tiny.starts[_recording_of(tiny, e.start)] > 5
          or e.kind in (POLL, LISTEN)]
    got = corpus.judge_emitted(em, tiny, 0, tiny.period, LIMITS)
    assert got["missing"] == 0 and got["unmatched"] == 0


# ----------------------------------------------- the program on the corpus

@pytest.fixture
def cpu_conditioner(monkeypatch):
    import nfclab_torch.dsp.conditioner as cmod

    monkeypatch.setattr(cmod, "condition_jax", functools.partial(
        cmod.condition_jax, device="cpu", block=16384, halo=4096))


@pytest.fixture
def ring_spans():
    from nfclab_torch.runtime import trace

    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


def _rows(frames):
    return [(f.frame_type, f.tech_type, f.sample_start, f.sample_end,
             bytes(f.data), f.frame_flags) for f in frames]


def test_decode_batch_jax_equals_native_and_the_table(tmp_path, tiny,
                                                      cpu_conditioner,
                                                      ring_spans):
    """Two recordings of the tiny corpus (a transaction of one round, a
    polling session of two periods) as float WAVs: the device conditioner
    gives the native conditioner's frames, every data frame the generator
    wrote at its samples; stats total both calls, and every step is a
    span."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfcbench.drivers.batch_corpus import write_float_wav
    from nfclab_torch.runtime.batch import decode_batch

    paths = []
    for j in (0, 1):
        paths.append(str(tmp_path / f"rec{j}.wav"))
        write_float_wav(paths[-1], tiny.recordings[j], RATE)
    stats: dict = {}
    with ring_spans.enable():
        got = decode_batch(paths, pool="thread", device="cpu", stats=stats)
    want = decode_batch(paths, conditioner="native", pool="thread",
                        stats=stats)
    names = {s.name for s in ring_spans.spans()}
    for j, p in enumerate(paths):
        assert _rows(got[p]) == _rows(want[p])
        lo = tiny.starts[j]
        table = sorted((f.data, f.start - lo, f.end - lo)
                       for f in tiny.frames_between(
                           0, lo, lo + len(tiny.recordings[j])))
        data = [f for f in got[p] if f.frame_type in (POLL, LISTEN)]
        assert len(data) == len(table)
        for f in data:
            assert not f.frame_flags & 0x78
            assert any(d == bytes(f.data) and a < f.sample_end
                       and f.sample_start < b for d, a, b in table)
    n = sum(len(tiny.recordings[j]) for j in (0, 1))
    assert stats["captures"] == 4 and stats["samples"] == 2 * n
    assert stats["blocks"] >= 2 and stats["repairs"] >= 1
    for k in ("read_s", "condition_s", "walk_wait_s", "pass1_s",
              "edge_tracker_s"):
        assert stats[k] > 0, k
    assert stats["condition_s"] >= stats["pass1_s"] + stats["repair_s"]
    assert {"batch.read", "batch.condition", "batch.pool", "batch.walk",
            "cond.upload", "cond.pass1", "cond.verify", "cond.repair",
            "cond.fetch", "cond.edge_tracker"} <= names


@pytest.mark.cuda
def test_decode_batch_defaults_walk_on_threads_on_card(tmp_path, tiny):
    """On the card, as the cell runs it: ``decode_batch`` with its defaults
    over the tiny corpus's recordings.  CUDA is live before the walks
    start, so every capture is walked on a thread, and the frames are the
    native conditioner's, with data frames on every recording."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nfclab_torch's kernels run only "
                    "there)")
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfcbench.drivers.batch_corpus import write_float_wav
    from nfclab_torch.runtime.batch import decode_batch

    paths = []
    for j, x in enumerate(tiny.recordings):
        paths.append(str(tmp_path / f"rec{j}.wav"))
        write_float_wav(paths[-1], x, RATE)
    stats: dict = {}
    got = decode_batch(paths, device="cuda", stats=stats)
    want = decode_batch(paths, conditioner="native", pool="thread")
    assert list(got) == paths
    for p in paths:
        assert any(f.frame_type in (POLL, LISTEN) for f in got[p]), p
        assert _rows(got[p]) == _rows(want[p]), p
    assert stats["thread_walks"] == stats["captures"] == len(paths)


def test_condition_jax_bit_exact_on_a_recording_and_stats_add(tiny):
    """The polling session of two periods (field off twice, so blocks
    are repaired): all eight arrays equal the sequential oracle's, and a
    second call adds to the same stats."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.native import condition_exact

    x = tiny.recordings[1]
    stats: dict = {}
    got = condition_jax(x, SignalParams(RATE), block=16384, halo=4096,
                        device="cpu", stats=stats)
    want = condition_exact(x, SignalParams(RATE))
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(_bits(a), _bits(b)), name
    once = dict(stats)
    assert once["samples"] == len(x) and once["blocks"] == -(-len(x) // 16384)
    assert once["repairs"] >= 1
    condition_jax(x[:50_000], SignalParams(RATE), block=16384, halo=4096,
                  device="cpu", stats=stats)
    assert stats["samples"] == len(x) + 50_000
    assert stats["blocks"] == once["blocks"] + 4
    for k in ("upload_s", "pass1_s", "repair_s", "edge_tracker_s"):
        assert stats[k] >= once[k], k


def test_driver_on_a_program_without_stats(monkeypatch, tmp_path, tiny):
    """An earlier decode_batch, without ``stats``: the driver passes none,
    its drain events carry no counters, and the new readers read nothing."""
    from nfcbench.drivers import batch_corpus
    from nfclab_torch.runtime import batch

    calls = []

    def old(paths, workers=None, conditioner="jax", frontend="host",
            pool="process", keep_pool=False, device="cuda", **kw):
        calls.append((list(paths), kw, device))
        return {p: [] for p in paths}

    monkeypatch.setattr(batch, "decode_batch", old)
    cfg = json.loads((PKG / "configs" / "nfc10m-batch.json").read_text())
    d = batch_corpus.Driver(dict(cfg, captures_per_call=2), tiny, "cpu")
    try:
        d.run_until(lambda d: len(d.events) >= 3)
    finally:
        d.finish()
    assert [c[1] for c in calls] == [{}] * 3
    assert calls[1][0] == [d.paths[2], d.paths[3]] and calls[1][2] == "cpu"
    assert [e[1] for e in d.events] == [
        sum(len(tiny.recordings[j % 4]) for j in range(k)) for k in (2, 4, 6)]
    assert all(e[2] == {} for e in d.events)
    assert d.window_samples == tiny.period
    w = harness.Window(setup_s=1.0, t_open=d.events[0][0],
                       t_close=d.events[2][0], drained_open=d.events[0][1],
                       drained_close=d.events[2][1], stats_open={},
                       stats_close={}, n_streams=1, window_samples=1, lags=[],
                       trace=None, cfg=cfg, workload="batch-corpus")
    for name in NEW_METRICS:
        assert _read(name, w) is None, name


def test_float_wav_reads_back(tmp_path):
    from nfcbench.drivers.batch_corpus import write_float_wav
    from nfclab_torch.io.wav import read_wav

    x = np.array([0.0, 1.25, -0.5, 3e-4], np.float32)
    write_float_wav(str(tmp_path / "a.wav"), x, RATE)
    y, info = read_wav(str(tmp_path / "a.wav"))
    assert np.array_equal(x, y)
    assert (info.sample_rate, info.channels, info.bits,
            info.sample_format) == (RATE, 1, 32, 3)


# ------------------------------------------------------------------ readers

NEW_METRICS = ("batch.condition_share", "batch.walk_share",
               "cond.edge_tracker_share", "cond.repair_share",
               "kernels.cond_roofline")
STATS0 = {"captures": 8, "samples": 18e6, "read_s": 1.0, "condition_s": 20.0,
          "pool_s": 0.5, "walk_wait_s": 3.0, "blocks": 300, "repairs": 60,
          "upload_s": 0.2, "pass1_s": 0.4, "verify_s": 0.01, "repair_s": 0.3,
          "fetch_s": 0.3, "edge_tracker_s": 18.0}
STATS1 = dict(STATS0, condition_s=60.0, pool_s=1.5, walk_wait_s=8.0,
              blocks=700, repairs=160, edge_tracker_s=54.0)


def _window(**kw):
    base = dict(setup_s=30.0, t_open=100.0, t_close=150.0,
                drained_open=18_000_000, drained_close=54_000_000,
                stats_open=STATS0, stats_close=STATS1, n_streams=1,
                window_samples=18_000_000, lags=[], trace=None,
                cfg={"sample_rate": RATE}, workload="batch-corpus")
    base.update(kw)
    return harness.Window(**base)


def _read(name, w):
    return harness.load_module(PKG / "metrics" / f"{name}.py").read(w)


@pytest.mark.parametrize("name,want", [
    ("batch.condition_share", 80.0),      # 40 s of 50
    ("batch.walk_share", 12.0),           # 1 + 5 s
    ("cond.edge_tracker_share", 72.0),    # 36 s
    ("cond.repair_share", 25.0),          # 100 of 400 blocks
])
def test_counter_readers(name, want):
    assert _read(name, _window()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_nothing_to_read(name):
    """No counters (an earlier program), no block conditioned in the
    window, no trace or no conditioning kernel in it: nothing, no error."""
    old = {"drained_samples": 5}
    assert _read(name, _window(stats_open=old, stats_close=old)) is None
    idle = _window(stats_close=STATS0, trace={
        "busy_s": 1.0, "window_s": 50.0, "ops": {"Memcpy HtoD": 1.0}})
    if name in ("cond.repair_share", "kernels.cond_roofline"):
        assert _read(name, idle) is None


def test_cond_roofline():
    tr = {"busy_s": 2.0, "window_s": 50.0,
          "ops": {"void cond_scan_kernel": 1.5, "Memcpy HtoD": 0.4,
                  "void ff_scan_kernel_narrow": 0.1}}
    least = 28 * 36_000_000 / 3.35e12
    assert _read("kernels.cond_roofline", _window(trace=tr)) == \
        pytest.approx(100 * least / 1.5)


def test_cond_work_count():
    """28 B a sample (CondScanArgs: the value in, six outputs of 4 B out)
    bind it: 1024 x 65,536 samples in 0.561 ms, the bound of PERF.md's
    kernel table."""
    assert cond_roofline.BYTES_PER_SAMPLE == 28
    assert cond_roofline.PEAK_BYTES_S == roofline.PEAK_BYTES_S
    assert cond_roofline.cond_least_s(1024 * 65536) * 1e3 == pytest.approx(
        0.561, abs=5e-4)
    assert (cond_roofline.FLOPS_PER_SAMPLE / roofline.PEAK_FLOPS_F32
            < cond_roofline.BYTES_PER_SAMPLE / roofline.PEAK_BYTES_S)


def test_benchmark_lists_the_cell_and_its_metrics():
    spec = harness.load_spec(ROOT)
    cell = harness.find(spec["workloads"], "batch-corpus", "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "nfc10m-batch", "corpus", 1)
    assert harness.cell_metrics(spec, "batch-corpus", False) == \
        spec["end_to_end"]
    traced = [m["name"] for m in harness.cell_metrics(spec, "batch-corpus",
                                                      True)]
    assert traced == list(NEW_METRICS)
    conf = harness.find(spec["configs"], "nfc10m-batch", "config")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["decode_batch"] == {} and cfg["entry"] == "batch_corpus"
    assert set(cfg["cuts"]) == set(cfg["reduced"]) == set(conf["reduced"])


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_condition_jax_bit_exact_on_the_ring_on_card():
    """On the card: condition_jax (cond_scan_kernel, halo, repairs) on
    every recording of the cell's ring equals the sequential oracle in
    all eight arrays, bit for bit, its edges from the native tracker."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nfclab_torch's kernels run only "
                    "there)")
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.native import condition_exact

    t = corpus.Traffic(_mix(), SEED, 1, 65536)
    for j, x in enumerate(t.recordings):
        stats: dict = {}
        got = condition_jax(x, SignalParams(RATE), stats=stats)
        want = condition_exact(x, SignalParams(RATE))
        for name in ARRAYS:
            assert np.array_equal(_bits(getattr(got, name)),
                                  _bits(getattr(want, name))), (j, name)
        assert stats["samples"] == len(x)
        assert stats["edge_native"] == 1
