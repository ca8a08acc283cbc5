"""The comparison on fabricated frames."""

import pytest

from nfcbench import check, harness
from nfcbench.traffic import synth

LIMITS = {"missing": 0, "unmatched": 0, "carrier_lag_max": 100}


@pytest.fixture(scope="module")
def traffic():
    return synth.Traffic(harness.load_mix("pauses"), 4, 2, 65536)


def _perfect(traffic, lo, hi, lag=10):
    out = []
    for i in range(traffic.n_streams):
        for f in traffic.frames_between(i, 0, hi + traffic.period):
            inside = lo <= f.start < hi
            out.append(check.Emitted(i, f.tech, f.kind, 0, f.data,
                                     f.start + 5, f.end - 5, inside))
        for kind, p in traffic.edges_between(0, hi + traffic.period):
            out.append(check.Emitted(i, 0x0100, kind, 0, b"", p + lag,
                                     p + lag, lo <= p < hi))
    return out


def test_perfect_run(traffic):
    lo, hi = 2_000_000, 6_000_000
    n = check.judge(_perfect(traffic, lo, hi), traffic, lo, hi, LIMITS)
    assert n["missing"] == n["unmatched"] == 0
    assert n["carrier_lag_max"] == 10.0
    assert n["due"] > 0
    assert all(v["ok"] for v in harness.verdict(n, LIMITS).values())


def test_each_fault_counts(traffic):
    lo, hi = 2_000_000, 6_000_000
    good = _perfect(traffic, lo, hi)
    data = [k for k, e in enumerate(good) if e.in_window and e.data]
    # a byte altered: unmatched, and its written frame missing
    bad = list(good)
    e = bad[data[3]]
    bad[data[3]] = e._replace(data=e.data[:-1] + bytes([e.data[-1] ^ 1]))
    n = check.judge(bad, traffic, lo, hi, LIMITS)
    assert n["unmatched"] == 1 and n["missing"] == 1
    # an error flag
    bad = list(good)
    bad[data[0]] = bad[data[0]]._replace(flags=0x20)
    assert check.judge(bad, traffic, lo, hi, LIMITS)["unmatched"] == 1
    # a frame shifted past its symbols
    bad = list(good)
    e = bad[data[1]]
    bad[data[1]] = e._replace(start=e.start + 65536, end=e.end + 65536)
    assert check.judge(bad, traffic, lo, hi, LIMITS)["unmatched"] == 1
    # a frame never emitted
    bad = [e for k, e in enumerate(good) if k != data[2]]
    assert check.judge(bad, traffic, lo, hi, LIMITS)["missing"] == 1
    # a late carrier event
    late = _perfect(traffic, lo, hi, lag=500)
    n = check.judge(late, traffic, lo, hi, LIMITS)
    assert n["carrier_lag_max"] == 500.0 and n["unmatched"] > 0
    assert not harness.verdict(n, LIMITS)["carrier_lag_max"]["ok"]


def test_judge_frames_reads_program_frames(traffic):
    """The generator's judge takes the program's frame objects."""
    class Frame:
        def __init__(self, e):
            self.tech_type, self.frame_type, self.frame_flags = (
                e.tech, e.kind, e.flags)
            self.data, self.sample_start, self.sample_end = (
                e.data, e.start, e.end)

    lo, hi = 2_000_000, 6_000_000
    good = _perfect(traffic, lo, hi)
    frames = [(e.stream, Frame(e), e.in_window) for e in good]
    assert synth.judge(frames, traffic, lo, hi, LIMITS) == check.judge(
        good, traffic, lo, hi, LIMITS)


def test_verdict_compares_what_the_limits_name():
    v = harness.verdict({"missing": 0, "unmatched": 2, "due": 9},
                        {"missing": 0, "unmatched": 1})
    assert set(v) == {"missing", "unmatched"}
    assert v["missing"]["ok"] and not v["unmatched"]["ok"]


def test_carrier_event_without_edge_is_unmatched():
    t = synth.Traffic(harness.load_mix("dense"), 4, 1, 65536)
    ev = [check.Emitted(0, 0x0100, synth.CARRIER_OFF, 0, b"", 1000, 1000,
                        True)]
    n = check.judge(ev, t, 0, 2000, LIMITS)
    assert n["unmatched"] == 1 and n["carrier_lag_max"] == t.period
