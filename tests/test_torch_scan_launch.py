"""What the scan kernels' launchers decide on the host, on the CPU: the
ring-read group size of ff_scan_kernel chosen by plan, its shared memory,
the instantiated box counts, and the stream limits of both scans; which of
ff_scan_kernel and ff_scan_kernel_narrow a scan takes, the narrow kernel's
shared memory, and the counts of their launches; and, in numpy, that a
group of U steps which issues every ring read before any ring write gives
the sequential sums for the plan's rings."""

import numpy as np
import pytest
import torch

from nfclab_torch.dsp import fused_frontend as ff
from nfclab_torch.kernels import conditioner as kc
from nfclab_torch.kernels import fused as kf


@pytest.mark.parametrize("rate,group", [(10_000_000, 6), (3_200_000, 2),
                                        (1_000_000, 1), (20_000_000, 6),
                                        (500_000, 1)])
def test_scan_group_by_plan(rate, group):
    assert kf.scan_group(ff.kernel_plan(rate)) == group


def _rings(plan):
    """(width, ring size) of every ring read of the scan."""
    return ([(w, plan.rv_ring) for w in plan.bv_widths]
            + [(w, plan.rq_ring) for w in plan.q_widths]
            + [(lag, plan.rf_ring) for lag, _ in plan.pb]
            + [(box, r) for (_, box), r in zip(plan.pb, plan.rp_rings)])


def test_every_plan_fits_the_scan():
    """From 0.5 to 40 MS/s: the group is an instantiated size no longer
    than the least read distance and the counts are instantiated; up to
    27 MS/s the rings and stages fit in a block's shared memory (above it
    the rings alone do not, as with the one-warp scan before)."""
    for rate in range(500_000, 40_000_001, 100_000):
        plan = ff.kernel_plan(rate)
        g = kf.scan_group(plan)
        least = min(w for w, _ in _rings(plan))
        assert g in kf.SCAN_GROUPS and g <= max(least, 1), rate
        assert kf.SCAN_TILE_ROWS % g == 0
        counts = (len(plan.bv_widths), len(plan.q_widths), len(plan.pb))
        assert counts in kf.SCAN_COUNTS, rate
        fits = kf.scan_smem(ff._layout(plan).ring_rows) <= kf.SMEM_LIMIT
        assert fits == (rate <= 27_000_000), rate


def _box_sums(x, w, ring_size, base, group):
    """Running sums (s + x[t]) - ring[(t - w) mod R] over a ring of R slots
    that receives x[t] at slot t mod R, taken `group` steps at a time with
    the group's reads before its writes (the ragged rest one step at a
    time, as in the kernel's tiles)."""
    ring = np.arange(ring_size, dtype=np.float64) * 0.5
    mask = ring_size - 1
    s, out = 0.0, []
    n = len(x)
    j = 0
    while j < n:
        u = group if j + group <= n else 1
        t = base + j
        old = [ring[(t + k - w) & mask] for k in range(u)]
        for k in range(u):
            s = (s + x[j + k]) - old[k]
            out.append(s)
            ring[(t + k) & mask] = x[j + k]
        j += u
    return np.array(out), ring


@pytest.mark.parametrize("rate", [10_000_000, 3_200_000, 1_000_000,
                                  20_000_000])
def test_reads_before_writes_is_sequential(rate):
    plan = ff.kernel_plan(rate)
    g = kf.scan_group(plan)
    x = np.random.default_rng(rate % 1000).standard_normal(307)
    for w, r in _rings(plan):
        for base in (0, plan.fold_modulus - 5):
            want = _box_sums(x, w, r, base, 1)
            got = _box_sums(x, w, r, base, g)
            assert np.array_equal(got[0], want[0]), (w, r, base)
            assert np.array_equal(got[1], want[1]), (w, r, base)


def test_a_group_too_long_breaks_the_sums():
    """The bound is tight: a group one step longer than the least width
    reads a slot its own group has rewritten."""
    x = np.random.default_rng(3).standard_normal(100)
    want = _box_sums(x, 6, 8, 0, 1)[0]
    assert np.array_equal(_box_sums(x, 6, 8, 0, 6)[0], want)
    assert not np.array_equal(_box_sums(x, 6, 8, 0, 7)[0], want)


def test_fused_scan_launcher_refuses_what_it_was_not_built_for():
    plan = ff.kernel_plan(10_000_000)
    lay = ff._layout(plan)
    x = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="box counts"):
        kf.launch_scan(x, None, None, None, {}, 0, None,
                       plan._replace(q_widths=(47,)), lay)
    wide = x.expand(1, kf.SCAN_MAX_STREAMS + 1)
    with pytest.raises(ValueError, match="streams a call"):
        kf.launch_scan(wide, None, None, None, {}, 0, None, plan, lay)


# ff_scan_kernel_narrow: which kernel the launcher takes, and its shared
# memory

@pytest.mark.parametrize("rate,sms,narrow_up_to", [
    (10_000_000, 132, 1056), (10_000_000, 1, 8), (10_000_000, 4, 32),
    (3_200_000, 132, 1056), (1_000_000, 132, 1056), (20_000_000, 132, 1056),
    (500_000, 114, 912),
    (40_000_000, 132, 0),     # the rings do not fit a block
])
def test_scan_narrow_rule(rate, sms, narrow_up_to):
    """The narrow kernel while its blocks of 8 streams fill no more than
    the card's SMs, where the plan's rings fit; ff_scan_kernel past that."""
    plan = ff.kernel_plan(rate)
    for B in (1, 2, 3, 4, 5, 8, 9, 16, 64, 256, 1024, 1056, 1057, 2048,
              narrow_up_to, narrow_up_to + 1):
        if B >= 1:
            assert kf.scan_narrow(B, plan, sms) == (B <= narrow_up_to), B


def test_scan_narrow_needs_box_lanes():
    """A role with more boxes than a stream's four box lanes goes to
    ff_scan_kernel, whatever B."""
    plan = ff.kernel_plan(10_000_000)
    five = plan._replace(bv_widths=plan.bv_widths + (120,))
    assert kf.scan_narrow(1, plan, 132)
    assert not kf.scan_narrow(1, five, 132)


def test_every_plan_fits_the_narrow_scan():
    """From 0.5 to 27 MS/s the narrow kernel's stages and rings (rv, rq,
    rf and the largest product ring, a column per box lane) fit a block,
    in no more than ff_scan_kernel's shared memory; its stages hold whole
    groups."""
    assert kf.SCAN_NARROW_THREADS == 6 * 32
    assert kf.SCAN_NARROW_STREAMS * kf.SCAN_NARROW_BOXES == 32
    for rate in range(500_000, 27_000_001, 100_000):
        plan = ff.kernel_plan(rate)
        smem = kf.scan_narrow_smem(plan)
        assert smem <= kf.SMEM_LIMIT, rate
        assert smem <= kf.scan_smem(ff._layout(plan).ring_rows), rate
        assert kf.scan_narrow(1, plan, 132), rate
    plan = ff.kernel_plan(10_000_000)
    assert kf.scan_narrow_smem(plan) == (
        16 * 4 + 4 * 4 * 120 * 8 + 128 * (128 + 256 + 128 + 32))


class _FakeLib:
    """The two scan entry points, recording their calls."""

    def __init__(self):
        self.calls = []

    def nfclab_ff_scan(self, args, device, threads, smem, stream):
        self.calls.append(("wide", args._obj.B, threads, smem))
        return 0

    def nfclab_ff_scan_narrow(self, args, device, threads, smem, stream):
        self.calls.append(("narrow", args._obj.B, threads, smem))
        return 0


@pytest.mark.parametrize("B,sms,kind", [(1, 132, "narrow"),
                                        (4, 132, "narrow"),
                                        (1056, 132, "narrow"),
                                        (1057, 132, "wide"),
                                        (9, 1, "wide")])
def test_launch_scan_takes_the_rule(monkeypatch, B, sms, kind):
    """launch_scan queues the kernel the rule names, with its block and
    shared memory, and says which."""
    plan = ff.kernel_plan(10_000_000)
    lay = ff._layout(plan)
    lib = _FakeLib()
    monkeypatch.setattr(kf, "library", lambda: lib)
    monkeypatch.setattr(kf, "sm_count", lambda index: sms)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    x = torch.zeros(3, B)
    pt = (0.5,) * 7 + (94,)
    narrow = kf.launch_scan(x, x, x, x, {}, 0, pt, plan, lay)
    assert narrow == (kind == "narrow")
    want = ((kind, B, kf.SCAN_NARROW_THREADS, kf.scan_narrow_smem(plan))
            if narrow else
            (kind, B, kf.SCAN_THREADS, kf.scan_smem(lay.ring_rows)))
    assert lib.calls == [want]


@pytest.mark.parametrize("narrow", [False, True])
def test_scan_counters(monkeypatch, narrow):
    """SCAN counts every launch of the scan, SCAN_NARROW those on the
    narrow kernel (the launcher stubbed)."""
    plan = ff.kernel_plan(10_000_000)
    monkeypatch.setattr(kf, "launch_scan", lambda *a: narrow)
    s0, n0 = ff.SCAN.launches, ff.SCAN_NARROW.launches
    x = torch.zeros(5, 2)
    ff._scan_cuda(x, torch.zeros(plan.nstate, 2), 0, None, plan)
    assert ff.SCAN.launches == s0 + 1
    assert ff.SCAN_NARROW.launches == n0 + int(narrow)


def test_farm_counts_the_scan_launches(monkeypatch):
    """CudaStreamFarm.stats scan_launches and scan_narrow_launches: the
    scan's launches gained in each device pass (the engines stubbed, each
    pass launching three scans, two of them narrow)."""
    from nfclab_torch.runtime.farm import STEP_COUNTERS, CudaStreamFarm

    farm = CudaStreamFarm(1, 10_000_000, fetch="mask", device="cpu")
    assert {"scan_launches", "scan_narrow_launches"} <= set(STEP_COUNTERS)
    assert farm.stats["scan_launches"] == farm.stats[
        "scan_narrow_launches"] == 0

    def engines(batch, base0, use_seg, lap):
        ff.SCAN.launches += 3
        ff.SCAN_NARROW.launches += 2
        return ["walked"]

    monkeypatch.setattr(farm, "_run_engines", engines)
    batch = np.zeros((1, 4096), np.float32)
    assert farm._device_pass(batch, 0) == ["walked"]
    ff.SCAN.launches += 5       # outside a pass: not counted
    assert farm._device_pass(batch, 0) == ["walked"]
    assert farm.stats["scan_launches"] == 6
    assert farm.stats["scan_narrow_launches"] == 4


def _env_near_narrow(v, env) -> bool:
    """Mirror of ffn_env_near (csrc/fused_frontend.cu): the envelope test
    by env's class, with no divide."""
    with np.errstate(all="ignore"):
        ad = np.abs(np.float32(v - env))
    near_pos = float(ad) <= (26843545.0 / 536870912.0) * float(env)
    if 0 < env < np.inf:
        return near_pos
    if -np.inf < env < 0:
        return bool(ad == ad)
    minus_zero = np.float32(env).view(np.uint32) == 0x80000000
    return bool(minus_zero and ad > 0)


def _env_near_quotient(v, env) -> bool:
    """cond_env_diff(v, env) < 0.05f: the correctly rounded quotient."""
    with np.errstate(all="ignore"):
        q = np.abs(np.float32(v - env)) / env
    return bool(q < np.float32(0.05))


def test_narrow_env_test_is_the_quotient():
    """ffn_env_near decides |v - env| / env < 0.05f as the divide does for
    every class of env (+-0, subnormal, negative, +-inf, NaN) and v, and
    on both sides of the threshold."""
    f = np.float32
    tiny = np.finfo(np.float32).tiny
    specials = [0.0, -0.0, 1e-45, 1e-40, tiny, 1e-30, 0.5, 0.95, 1.0, 1.05,
                3.0, 1e30, np.finfo(np.float32).max, np.inf, np.nan]
    vals = [f(s) for x in specials for s in (x, -x)]
    rng = np.random.default_rng(18)
    env = (rng.uniform(-1, 1, 4000) * 10.0 ** rng.integers(-44, 38, 4000)
           ).astype(np.float32)
    rel = rng.uniform(-0.06, 0.06, 4000)
    rel[::4] = np.float32(0.05) * rng.choice([-1, 1], 1000)
    pairs = [(v, e) for v in vals for e in vals]
    pairs += [(f(e * (1 + r)), e) for e, r in zip(env, rel)]
    for e in env[:400]:      # v at e * 1.05 and its float neighbours
        b = np.float32(e * np.float32(1.05))
        pairs += [(b, e), (np.nextafter(b, f(np.inf)), e),
                  (np.nextafter(b, f(-np.inf)), e)]
    agree = [_env_near_narrow(v, e) == _env_near_quotient(v, e)
             for v, e in pairs]
    assert all(agree), [p for p, a in zip(pairs, agree) if not a][:5]
    # every class of env decides both ways somewhere
    for e in (f(-0.0), f(-2.0), f(3.0)):
        got = {_env_near_narrow(v, e) for v in vals}
        assert got == {True, False}, e


def test_condition_scan_launcher_refuses_too_many_streams():
    wide = torch.zeros(1, 1).expand(1, kc.MAX_STREAMS + 1)
    with pytest.raises(ValueError, match="streams a call"):
        kc.launch_scan(wide, (), (), None)


def test_carrier_lanes_are_seeded_carrier_magnitudes():
    """torch_synth.carrier_lanes, the card tests' scan lanes: [steps,
    streams] float32 magnitudes, finite, with field-off gaps, the same for
    the same seed."""
    from torch_synth import carrier_lanes

    x = carrier_lanes(4, 3000, seed=1)
    assert x.shape == (3000, 4) and x.dtype == np.float32
    assert (np.abs(x) < 1e-2).any() and np.isfinite(x).all()
    assert (x >= 0).all()
    assert np.array_equal(x, carrier_lanes(4, 3000, seed=1))


# v2_scan_kernel (csrc/fused_v2.cu): rings slotted by the absolute clock,
# t % R, in the state; in shared memory each sits rotated to the chunk in
# a power-of-two ring of P >= R slots (chunk row j at slot j & (P - 1)),
# and a group of U = 6 steps issues its ring reads before its writes.
V2_GROUP = 6
V2_INT32_TOP = 2**31 - 2 * 474   # base + T may reach it (the wrapper's guard)
# (read distance, state ring R, shared ring P) of every ring read
V2_READS = ([(w, 96, 128) for w in (12, 24, 47, 94)]     # rv
            + [(w, 192, 256) for w in (47, 189)]         # rq
            + [(lag, 96, 128) for lag in (24, 47, 94)]   # rf
            + [(6, 8, 8), (12, 16, 16), (24, 32, 32)])   # rp


def _v2_rotate_in(state_ring, base, p):
    """The kernel's v2_ring_in: slot s holds clock base - 1 - d, d =
    (base - 1 - s) mod R, which goes to row j = -1 - d."""
    r = len(state_ring)
    ring = np.full(p, np.nan)
    for s in range(r):
        d = (base - 1 - s) % r
        ring[(-1 - d) & (p - 1)] = state_ring[s]
    return ring


def _v2_rotate_out(ring, r, base, t):
    """The kernel's v2_ring_out: slot s takes row T - 1 - d, d =
    (base + T - 1 - s) mod R."""
    p = len(ring)
    return np.array([ring[(t - 1 - (base + t - 1 - s) % r) & (p - 1)]
                     for s in range(r)])


def _v2_box_sums(x, w, r, p, base, group):
    """Running sums (s + x[j]) - x[j - w] over a rotated ring, `group`
    steps at a time with the group's reads before its writes (the ragged
    rest one by one); returns the sums and the state ring after."""
    state = np.arange(r, dtype=np.float64) * 0.5 + 1.0
    ring = _v2_rotate_in(state, base, p)
    s, out, n, j = 0.0, [], len(x), 0
    while j < n:
        u = group if j + group <= n else 1
        old = [ring[(j + k - w) & (p - 1)] for k in range(u)]
        for k in range(u):
            s = (s + x[j + k]) - old[k]
            out.append(s)
            ring[(j + k) & (p - 1)] = x[j + k]
        j += u
    return np.array(out), _v2_rotate_out(ring, r, base, n)


def _clock_box_sums(x, w, r, base):
    """The sequential reference: a ring of R slots, clock t at t % R."""
    ring = np.arange(r, dtype=np.float64) * 0.5 + 1.0
    s, out = 0.0, []
    for j, v in enumerate(x):
        t = base + j
        s = (s + v) - ring[(t - w) % r]
        out.append(s)
        ring[t % r] = v
    return np.array(out), ring


@pytest.mark.parametrize("t", [5, 97, 301])
@pytest.mark.parametrize("base", [0, 40, 93, 95, 189, 190, 1000,
                                  V2_INT32_TOP - 301])
def test_v2_group_reads_before_writes_is_sequential(base, t):
    """Every v2 ring read, a group of 6 with reads ahead, from any base
    (a ring's wrap inside the chunk, the int32 guard): the sums and the
    state ring rows of the sequential order."""
    x = np.random.default_rng(base % 997 + t).standard_normal(t)
    for w, r, p in V2_READS:
        want = _clock_box_sums(x, w, r, base)
        got = _v2_box_sums(x, w, r, p, base, V2_GROUP)
        assert np.array_equal(got[0], want[0]), (w, r, base, t)
        assert np.array_equal(got[1], want[1]), (w, r, base, t)


def test_v2_group_of_seven_breaks_the_sums():
    """The bound is tight: a group of 7 reads a product-ring slot (box 6)
    its own group has rewritten."""
    x = np.random.default_rng(5).standard_normal(200)
    want = _clock_box_sums(x, 6, 8, 40)[0]
    assert np.array_equal(_v2_box_sums(x, 6, 8, 8, 40, 6)[0], want)
    assert not np.array_equal(_v2_box_sums(x, 6, 8, 8, 40, 7)[0], want)


@pytest.mark.parametrize("r,p", [(96, 128), (192, 256), (8, 8), (16, 16),
                                 (32, 32)])
def test_v2_rotated_slots_follow_the_clock(r, p):
    """Over a whole chunk from any base, the shared slot of row j and the
    state slot t % R hold the same clock: rotating a ring in and straight
    back out gives its rows, and after T steps slot s holds the last clock
    of the chunk that is s modulo R (or its input)."""
    rng = np.random.default_rng(r)
    for base in [0, 1, r - 1, r, 12345, V2_INT32_TOP - 500,
                 *rng.integers(0, V2_INT32_TOP - 500, 20)]:
        base = int(base)
        state = rng.standard_normal(r)
        assert np.array_equal(
            _v2_rotate_out(_v2_rotate_in(state, base, p), r, base, 0), state)
        for t in (1, r - 1, 2 * r + 3, 500):
            ring = _v2_rotate_in(state, base, p)
            clocks = np.full(p, -1, np.int64)
            for j in range(-r, 0):
                clocks[j & (p - 1)] = base + j
            for j in range(t):
                clocks[j & (p - 1)] = base + j
                ring[j & (p - 1)] = base + j
            out = _v2_rotate_out(ring, r, base, t)
            last = base + t - 1
            for s in range(r):
                c = last - (last - s) % r
                assert c % r == s
                want = c if c >= base else state[s]
                assert out[s] == want, (base, t, s)


def test_v2_scan_launcher_host_choices():
    """v2_scan_kernel: six warps, 171,104 B of shared memory per block
    (barriers, 4 stages of sample and env tiles, 568 ring rows), under the
    limit; more stages than fit, or too many streams, are refused before
    anything is launched."""
    from nfclab_torch.kernels import fused_v2 as kv

    assert kv.SCAN_THREADS == 6 * 32
    assert kv.SCAN_TILE_ROWS % V2_GROUP == 0 and kv.SCAN_TILE_ROWS % 16 == 0
    assert kv.SCAN_RING_ROWS == sum(p for _, _, p in
                                    [(0, 96, 128), (0, 96, 128), (0, 192, 256),
                                     (0, 8, 8), (0, 16, 16), (0, 32, 32)])
    assert kv.scan_smem() == 96 + 128 * (2 * 4 * 96 + 568) == 171_104
    assert kv.scan_smem() <= kf.SMEM_LIMIT < kv.scan_smem(stages=7)
    x = torch.zeros(1, 1)
    stages = kv.SCAN_STAGES
    try:
        kv.SCAN_STAGES = 7
        with pytest.raises(ValueError, match="shared memory"):
            kv.launch_scan(x, None, None, None, 0, None, 1285)
    finally:
        kv.SCAN_STAGES = stages
    with pytest.raises(ValueError, match="streams a call"):
        kv.launch_scan(x.expand(1, kv.SCAN_MAX_STREAMS + 1), None, None,
                       None, 0, None, 1285)


@pytest.mark.parametrize("shape", [(1, 1, (1 << 27) + 1),
                                   (1, 2**31 - 16, 1)])
def test_serial_probe_launcher_refuses_what_it_was_not_built_for(shape):
    """serial_probe_kernel: five warps per 32 lanes (the pair kernel the
    same five); 32-bit offsets reach 16 rows of at most 2^27 lanes, and the
    int32 clock its last group."""
    from nfclab_torch.kernels import probes as kp

    assert kp.SERIAL_THREADS == 5 * 32 and kp.PAIR_THREADS == 5 * 32
    value = torch.zeros(1, 1, 1).expand(*shape)
    with pytest.raises(ValueError, match="serial_probe_kernel takes"):
        kp.launch_probe(value, (), None, pair=False)


@pytest.mark.parametrize("shape", [(1, 2, (1 << 27) + 1),
                                   (1, 2**31 - 16, 1)])
def test_pair_probe_launcher_refuses_what_it_was_not_built_for(shape):
    """pair_probe_kernel takes serial_probe_kernel's block and its limits."""
    from nfclab_torch.kernels import probes as kp

    value = torch.zeros(1, 1, 1).expand(*shape)
    with pytest.raises(ValueError, match="pair_probe_kernel takes"):
        kp.launch_probe(value, (), None, pair=True)
