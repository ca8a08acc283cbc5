"""What the scan kernels' launchers decide on the host, on the CPU: the
ring-read group size of ff_scan_kernel chosen by plan, its shared memory,
the instantiated box counts, and the stream limits of both scans; and, in
numpy, that a group of U steps which issues every ring read before any ring
write gives the sequential sums for the plan's rings."""

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


def test_condition_scan_launcher_refuses_too_many_streams():
    wide = torch.zeros(1, 1).expand(1, kc.MAX_STREAMS + 1)
    with pytest.raises(ValueError, match="streams a call"):
        kc.launch_scan(wide, (), (), None)


def test_lever_variants_patch_the_current_sources():
    """The variant patches of experiments/scan_levers apply to csrc/ as it
    is, and its entry point needs a card."""
    from nfclab_torch.experiments import scan_levers as sl
    from nfclab_torch.kernels.build import SRC_DIR

    for patches in (*sl.VARIANTS.values(), *sl.PROBES.values()):
        for fname, edits in patches.items():
            text = (SRC_DIR / fname).read_text()
            for old, _ in edits:
                assert old in text, (fname, old)
    x = sl.carrier_lanes(4, 3000, seed=1)
    assert x.shape == (3000, 4) and x.dtype == np.float32
    assert (np.abs(x) < 1e-2).any() and np.isfinite(x).all()
    assert (x >= 0).all()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            sl.main([])


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
