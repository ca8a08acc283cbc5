"""The traffic generator: seeded, the same work for every seed, and the
frames it says it wrote."""

import numpy as np
import pytest

from nfcbench import harness
from nfcbench.traffic import synth

ROUND = 246_493       # the five templates back to back
FRAMES = 14           # 4 + 4 + 2 + 2 + 2 per round


@pytest.mark.parametrize("mix", ["dense", "pauses"])
def test_same_seed_same_traffic(mix):
    m = harness.load_mix(mix)
    a = synth.Traffic(m, 2**31 + 5, 3, 65536)
    b = synth.Traffic(m, 2**31 + 5, 3, 65536)
    assert np.array_equal(a.buf, b.buf)
    assert a.frames == b.frames and a.edges == b.edges


@pytest.mark.parametrize("mix", ["dense", "pauses"])
def test_other_seed_other_traffic_same_work(mix):
    m = harness.load_mix(mix)
    a = synth.Traffic(m, 11, 4, 65536)
    b = synth.Traffic(m, 12, 4, 65536)
    assert not np.array_equal(a.buf, b.buf)
    assert a.order != b.order or a.frames != b.frames
    assert a.period == b.period
    for fa, fb in zip(a.frames, b.frames):
        assert len(fa) == len(fb) == FRAMES
        assert sorted(f.data for f in fa) == sorted(f.data for f in fb)


def test_periods():
    d = synth.Traffic(harness.load_mix("dense"), 1, 1, 65536)
    p = synth.Traffic(harness.load_mix("pauses"), 1, 1, 65536)
    assert d.period == ROUND and d.edges == []
    assert p.period == 50_000 + ROUND + 1_000_000
    assert p.edges == [(synth.CARRIER_OFF, 50_000 + ROUND),
                       (synth.CARRIER_ON, p.period)]
    # the field is off (noise around 0) between the edges
    off = p.buf[0, 50_000 + ROUND : p.period]
    assert abs(float(off.mean())) < 1e-4 and float(off.std()) < 5e-4


def test_blocks_loop_the_period():
    t = synth.Traffic(harness.load_mix("dense"), 3, 2, 65536)
    k = 7
    lo = k * 65536
    want = np.stack([np.take(t.buf[i, : t.period],
                             np.arange(lo, lo + 65536) % t.period)
                     for i in range(2)])
    assert np.array_equal(t.block(k), want)


def test_frames_between_lie_inside():
    t = synth.Traffic(harness.load_mix("pauses"), 9, 1, 65536)
    got = t.frames_between(0, 1_000_000, 4_000_000)
    assert got and all(1_000_000 <= f.start and f.end <= 4_000_000
                       for f in got)
    assert all(f.start < f.end for f in got)
    edges = t.edges_between(0, 3 * t.period)
    assert [k for k, _ in edges] == [synth.CARRIER_OFF, synth.CARRIER_ON] * 2 \
        + [synth.CARRIER_OFF]


def test_crc_frames_are_valid():
    tpl = synth.templates()
    for name, tp in tpl.items():
        for f in tp.frames:
            body, crc = f.data[:-2], f.data[-2:]
            fn = {"nfca": synth.crc_a, "nfcb": synth.crc_b,
                  "nfcf": synth.crc_f, "nfcv": synth.crc_b}[
                {v: k for k, v in synth.TECH.items()}[f.tech]]
            assert fn(body) == crc, name


def test_refuses_another_rate():
    m = harness.load_mix("dense")
    with pytest.raises(ValueError, match="10000000"):
        synth.Traffic(m, 1, 1, 65536, 3_200_000)
    assert synth.Traffic(m, 1, 1, 65536, 10_000_000).period == ROUND


@pytest.mark.parametrize("mix", ["dense", "pauses"])
def test_mix_names_its_generator(mix):
    m = harness.load_mix(mix)
    gen = harness.load_generator(m)
    assert gen.RATE == synth.RATE and callable(gen.judge)
    t = gen.Traffic(m, 3, 1, 65536, 10_000_000)
    assert np.array_equal(t.buf, synth.Traffic(m, 3, 1, 65536).buf)
