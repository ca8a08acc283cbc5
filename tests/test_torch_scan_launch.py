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

    for patches in (sl.QUOTIENT, sl.ONE_PATH, *sl.PROBES.values()):
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
