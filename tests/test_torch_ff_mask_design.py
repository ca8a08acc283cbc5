"""The fused frontend's mask kernel design, on the CPU.

``ff_mask_kernel`` (``csrc/fused_frontend.cu``) stages each lag window of a
channel into a shared ring once per span, from geometry the launcher
computes from the plan at run time (``ff_mask_plan``, mirrored by
``kernels/fused.mask_geometry``); a consumer thread reads the rows j, j + S,
... of a lookback from one ring slot, with mirrored rows after each ring
taking the wrap; every SD test is first decided by a float32 band
(``condition_step.cuh::sd_band``) and, where the band leaves it undecided,
exactly by the divide-free ``sd_above``; every warp of the grid copies its
share of the history rows.  Each part is mirrored here in numpy and held to
what it replaces: the geometry to every plan from 0.5 to 40 MS/s, the
producer's copies and the consumers' reads to ``_mask_plain``'s lookbacks,
the band and ``sd_above`` to the float32 quotient on the plans' divisors
(1 to 378) and thresholds, the whole row to ``_mask_plain`` on inputs
whose tests sit on their boundary, and the history rows to
``_mask_plain``'s state."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nfclab_torch.dsp import fused_frontend as ff
from nfclab_torch.experiments.fused_v2 import FLT_MAX, sd_above
from nfclab_torch.kernels import fused as kf

F32 = np.float32
RATES = range(500_000, 40_000_001, 100_000)
THREE = (10_000_000, 3_200_000, 40_000_000)
SELECTIONS = [(True, False), (True, True), (False, True), (False, False)]


def _plans():
    return [(rate, ff.kernel_plan(rate)) for rate in RATES]


def _best_cost(lags):
    """The fewest ring rows any split of sorted lags into runs takes
    (dynamic programming, independent of the mirror's enumeration)."""
    best = [0] + [None] * len(lags)
    for end in range(1, len(lags) + 1):
        best[end] = min(best[start] + kf.mask_ring_rows(lags[end - 1]
                                                        - lags[start])
                        for start in range(end))
    return best[-1]


# --------------------------------------------------------------------------
# geometry


@pytest.mark.parametrize("want_mask,want_md", SELECTIONS)
def test_every_plan_fits_and_every_lag_has_its_window(want_mask, want_md):
    """From 0.5 to 40 MS/s: the rings fit a block at the streams per block
    the geometry picks (32 wherever they fit at 32); every lookback lies in
    one window of its channel, whose ring is a power of two that holds the
    window's spread and the sub-tiles in flight; the windows of a channel
    are disjoint and in lag order, the rings follow one another with
    MASK_PAD mirrored rows each, and no split of a channel's lags takes
    fewer ring rows."""
    for rate, plan in _plans():
        g = kf.mask_geometry(plan, want_mask, want_md)
        assert g[:5] == [kf.MASK_WARPS, kf.MASK_PRODUCERS, kf.MASK_TILE_ROWS,
                         kf.MASK_STAGES, kf.MASK_SPAN_ROWS]
        streams, smem, n = g[5], g[6], g[7]
        wins = [tuple(g[8 + 5 * i : 13 + 5 * i]) for i in range(n)]
        assert len(g) == 8 + 5 * n and n <= kf.MASK_MAX_WINDOWS
        rows = sum(w[3] + kf.MASK_PAD for w in wins)
        assert streams in kf.MASK_STREAMS, rate
        assert smem == kf.mask_smem(rows, streams) <= kf.SMEM_LIMIT, rate
        if streams == 16:
            assert kf.mask_smem(rows, 32) > kf.SMEM_LIMIT, rate
        lags = kf.mask_lags(plan, want_mask, want_md)
        base = 0
        for ch, lmin, lmax, ring, first in wins:
            assert first == base
            base += ring + kf.MASK_PAD
            assert ring & (ring - 1) == 0
            assert ring >= lmax - lmin + kf.MASK_STAGES * kf.MASK_TILE_ROWS
            assert lmin in lags[ch] and lmax in lags[ch]
        for ch, ls in lags.items():
            mine = [w for w in wins if w[0] == ch]
            assert all(a[2] < b[1] for a, b in zip(mine, mine[1:])), rate
            for lag in ls:
                assert sum(w[1] <= lag <= w[2] for w in mine) == 1, (rate, lag)
            assert sum(w[3] for w in mine) == _best_cost(ls), (rate, ch)


def test_geometry_at_the_main_rates():
    """10 MS/s: one window a channel (bv12's A and F lags share a ring of
    512 rows), 32 streams a block, the rings with mod_depth's samples just
    inside a block; 40 MS/s: the far and near A/F lags of bv47 and bv94,
    the two V lags and the two NFC-B delays each a window of their own,
    16 streams a block."""
    g = kf.mask_geometry(ff.kernel_plan(10_000_000))
    assert g[5:8] == [32, 215_328, 6]
    assert [tuple(g[8 + 5 * i : 12 + 5 * i]) for i in range(6)] == [
        (0, 0, 153, 512), (1, 0, 117, 256), (2, 0, 47, 256),
        (3, 378, 473, 256), (4, 0, 94, 256), (5, 0, 0, 128)]
    assert kf.mask_geometry(ff.kernel_plan(10_000_000), True, True)[5:8] \
        == [32, 232_096, 7]
    g = kf.mask_geometry(ff.kernel_plan(40_000_000))
    assert g[5] == 16 and g[7] == 11
    wins = [tuple(g[8 + 5 * i : 11 + 5 * i]) for i in range(11)]
    assert (0, 0, 47) in wins and (0, 567, 614) in wins
    assert (3, 1510, 1510) in wins and (3, 1887, 1887) in wins
    assert (4, 0, 0) in wins and (4, 378, 378) in wins


def test_the_binding_refuses_what_the_kernel_does_not_take():
    """A plan with other test counts than (3, 2, 2) is refused by the
    mirror (the library returns -1 for it and its launcher refuses it, on
    the card); state_out over state_in is refused before any launch."""
    plan = ff.kernel_plan(10_000_000)
    with pytest.raises(ValueError):
        kf.mask_geometry(plan._replace(a_rates=plan.a_rates[:2]))
    with pytest.raises(ValueError):
        kf.mask_geometry(plan._replace(f_rates=plan.f_rates[:1]))
    deps = torch.zeros(6, 8, 4)
    st_in = torch.zeros(plan.nstate, 4)
    with pytest.raises(ValueError, match="apart"):
        kf.launch_mask(deps, deps[0], st_in, st_in, None, None, (0.0,) * 5,
                       plan, ff._layout(plan))
    with pytest.raises(ValueError, match="apart"):
        kf.launch_mask(deps, deps[0], st_in, st_in[1:], None, None,
                       (0.0,) * 5, plan, ff._layout(plan))


# --------------------------------------------------------------------------
# producer and consumers: every ring read is _mask_plain's lookback


def _plain_address(plan, ch, j, c):
    """Where _mask_plain's lagged(ch, c) reads chunk row j: the channel's
    chunk row, or before the chunk its history section's row."""
    i = j - c
    if i >= 0:
        return ("chunk", ch, i)
    n = plan.h_sizes[ch] + ff.TILE if ch <= len(plan.bv_widths) else None
    return ("state", ff._layout(plan).hist_offs[ch] + n + i)


def _staged_reads(plan, win, lags, t, streams):
    """Simulate one window's producer and consumers over a chunk of t rows:
    per span, the rows each sub-tile copies (row r to slot r & (P - 1),
    and a slot below MASK_PAD also to its mirror after the ring), and for
    every consumer group of rows j0, j0 + S, ... (S = 32 / streams) the
    address each read slot holds once its sub-tile's copies have landed
    and again once the producer has run STAGES - 1 sub-tiles further ahead
    (the latest it may).  Returns {(j, c): address}."""
    ch, lmin, lmax, ring, _ = win
    tile, stages, span = (kf.MASK_TILE_ROWS, kf.MASK_STAGES,
                          kf.MASK_SPAN_ROWS)
    step = 32 // streams
    group = 4 // step
    got = {}
    for j0 in range(0, t, span):
        j1 = min(t, j0 + span)
        tiles = list(range(j0, j1, tile))
        slots = [None] * (ring + kf.MASK_PAD)
        copies = []
        for i, J in enumerate(tiles):
            n = min(tile, j1 - J)
            lo = J - lmax if i == 0 else J - lmin
            cp = []
            for r in range(lo, J + n - lmin):
                addr = _plain_address(plan, ch, r, 0)
                cp.append((r & (ring - 1), addr))
                if (r & (ring - 1)) < kf.MASK_PAD:
                    cp.append(((r & (ring - 1)) + ring, addr))
            copies.append(cp)
        copied = [a for c in copies for s, a in c if s < ring]
        assert len(copied) == len(range(j0 - lmax, j1 - lmin))
        applied = 0

        def apply(upto):
            nonlocal applied
            while applied <= min(upto, len(copies) - 1):
                for s, a in copies[applied]:
                    slots[s] = a
                applied += 1

        for i, J in enumerate(tiles):
            n = min(tile, j1 - J)
            reads = []
            for g0 in range(J, J + n, 4):
                for half in range(step):
                    first = g0 + half
                    for c in lags:
                        slot = (first - c) & (ring - 1)
                        for k in range(group):
                            j = first + k * step
                            if j < J + n:
                                reads.append((j, c, slot + k * step))
            apply(i)
            early = {(j, c): slots[s] for j, c, s in reads}
            apply(i + stages - 1)
            for j, c, s in reads:
                assert slots[s] == early[(j, c)], (win, j, c)
            got.update(early)
    return got


@pytest.mark.parametrize("rate", THREE)
@pytest.mark.parametrize("t", [5, 300, 2049, 4100])
def test_staged_windows_read_the_plain_lookbacks(rate, t):
    """Every lookback the consumers read, for every window of the plan, at
    32 and 16 streams a block, with T below and above the largest lag
    (473 at 10 MS/s, 1887 at 40), is the row or history row that
    _mask_plain reads; a slot is never rewritten before the sub-tiles that
    read it are done."""
    plan = ff.kernel_plan(rate)
    g = kf.mask_geometry(plan, True, True)
    wins = [tuple(g[8 + 5 * i : 13 + 5 * i]) for i in range(g[7])]
    lags = kf.mask_lags(plan, True, True)
    for streams in kf.MASK_STREAMS:
        for win in wins:
            mine = [c for c in lags[win[0]] if win[1] <= c <= win[2]]
            got = _staged_reads(plan, win, mine, t, streams)
            assert len(got) == t * len(mine)
            for (j, c), addr in got.items():
                assert addr == _plain_address(plan, win[0], j, c), (
                    rate, win, j, c)


# --------------------------------------------------------------------------
# the SD tests on this family's divisors and thresholds


def _divisors():
    ps = set()
    for _, plan in _plans():
        ps.update(p2 for _, _, p2, _ in plan.a_rates + plan.f_rates)
        ps.add(plan.v_rate[2])
    return sorted(ps)


P2S = _divisors()
THRESHOLDS = (0.75, 0.5, 1.0, 0.25)


def quotient_test(n, y, p2):
    n, y = np.asarray(n, F32), np.asarray(y, F32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        return n / F32(p2) > y


def sd_band(n, y, p2):
    """Mirror of condition_step.cuh::sd_band: (above, undecided)."""
    n, y = np.asarray(n, F32), np.asarray(y, F32)
    r = F32(1) / F32(p2)
    rlo, rhi = r * F32(1 - 2.0**-20), r * F32(1 + 2.0**-20)
    with np.errstate(invalid="ignore", over="ignore"):
        above = n * rlo > y
        below = n * rhi < y
    return above, ~(above | below)


def test_divisors_of_every_plan():
    assert P2S[0] == 1 and P2S[-1] == 378 and len(P2S) > 100
    # the exactness of sd_above takes p2 of at most 28 significant bits
    assert all(int(p).bit_length() <= 9 for p in P2S)


def _boundary_pairs(p2, rng, size=4000):
    """y = thr * env for env log-uniform in the band's range, and n at
    -2..2 ulps of p2 m(y), at p2 y (1 +- 2^-20) +- 2 ulps and at p2 y (1
    +- 2^-19), both signs."""
    env = np.ldexp(rng.uniform(1, 2, size),
                   rng.integers(-60, 60, size)).astype(F32)
    y = (F32(rng.choice(THRESHOLDS)) * env).astype(F32)
    yd = y.astype(np.float64)
    mid = p2 * (yd + np.nextafter(y, F32(np.inf)).astype(np.float64)) * 0.5
    out = []
    for target in (mid, p2 * yd * (1 + 2.0**-20), p2 * yd * (1 - 2.0**-20),
                   p2 * yd * (1 + 2.0**-19), p2 * yd * (1 - 2.0**-19)):
        n = target.astype(F32)
        for k in (-2, -1, 0, 1, 2):
            m = n.copy()
            for _ in range(abs(k)):
                m = np.nextafter(m, F32(np.inf) if k > 0 else F32(-np.inf))
            out += [(m, y), (-m, y)]
    return out


@pytest.mark.parametrize("p2", P2S[::7] + [378])
def test_band_decides_only_what_the_quotient_decides(p2):
    """Where the band decides, it agrees with the float32 quotient; it
    leaves undecided only n / p2 within a relative 2^-19 of y; sd_above
    agrees with the quotient everywhere."""
    rng = np.random.default_rng(p2)
    for n, y in _boundary_pairs(p2, rng):
        above, undecided = sd_band(n, y, p2)
        want = quotient_test(n, y, p2)
        assert np.array_equal(above[~undecided], want[~undecided]), p2
        ratio = np.abs(n.astype(np.float64) / p2) / y.astype(np.float64)
        assert (np.abs(ratio[undecided] - 1) < 2.0**-19).all(), p2
        assert np.array_equal(sd_above(n, y, p2), want), p2


@pytest.mark.parametrize("p2", [1, 4, 47, 189, 378])
def test_band_at_special_numerators(p2):
    y = np.array([2.0**-100, 1e-3, 1.0, 2.0**100], F32)
    for n, above, undecided in ((np.inf, True, False),
                                (-np.inf, False, False),
                                (np.nan, False, True), (0.0, False, False),
                                (-0.0, False, False), (1e-45, False, False),
                                (FLT_MAX, True, False)):
        a, u = sd_band(np.full(y.size, n, F32), y, p2)
        assert (a == above).all() and (u == undecided).all(), (n, p2)


@settings(max_examples=1500, deadline=None)
@given(n=st.floats(width=32, allow_nan=True, allow_infinity=True),
       e=st.integers(-60, 59), frac=st.floats(1.0, 2.0, exclude_max=True),
       thr=st.sampled_from(THRESHOLDS), p2=st.sampled_from(P2S))
def test_band_on_arbitrary_pairs(n, e, frac, thr, p2):
    env = F32(np.ldexp(frac, e))
    y = np.array([F32(thr) * env], F32)
    n = np.array([n], F32)
    above, undecided = sd_band(n, y, p2)
    if not undecided[0]:
        assert above[0] == quotient_test(n, y, p2)[0]
    assert sd_above(n, y, p2)[0] == quotient_test(n, y, p2)[0]


# --------------------------------------------------------------------------
# the kernel's row and its history rows against _mask_plain


MOD_THR = (2.0**-40, 2.0**40)
ENV_BAND = (2.0**-60, 2.0**60)


def mask_mirror(plan, deps, state, mp):
    """ff_mask_kernel's detect_mask in numpy: each SD test by the band,
    and a row whose env lies outside [2^-60, 2^60] (every threshold in
    [2^-40, 2^40]) or whose band leaves a test undecided by sd_above, every
    bit gated by the power test.  Returns (mask, rows the band decided)."""
    power_thr, a_thr, b_min_deep, f_thr, v_thr = (F32(x) for x in mp)
    nbv = len(plan.bv_widths)
    _, t, _ = deps.shape
    lay = ff._layout(plan)

    def at(ch, c):
        n = plan.h_sizes[ch] + ff.TILE
        ext = np.concatenate([state[lay.hist_offs[ch] : lay.hist_offs[ch] + n],
                              deps[ch]])
        return ext[n - c : n - c + t]

    env = deps[nbv + 1]
    assert all(MOD_THR[0] <= x <= MOD_THR[1] for x in (a_thr, f_thr, v_thr))
    with np.errstate(all="ignore"):
        slow = ~((env >= ENV_BAND[0]) & (env <= ENV_BAND[1]))
        m_band = np.zeros(env.shape, np.int32)
        m_exact = np.zeros(env.shape, np.int32)
        tests = ([(w, d, d + 1, d + gap, p2, a_thr, 1 << r)
                  for r, (d, gap, p2, w) in enumerate(plan.a_rates)]
                 + [(w, 0, 1, gap, p2, f_thr, 32 << r)
                    for r, (_, gap, p2, w) in enumerate(plan.f_rates)])
        for w, l0, l1, lg, p2, thr, bit in tests:
            b0, b1, bg = at(w, l0), at(w, l1), at(w, lg)
            n = np.abs(((b0 - bg).astype(F32) - (bg - b1).astype(F32))
                       .astype(F32))
            y = (thr * env).astype(F32)
            above, undecided = sd_band(n, y, p2)
            slow |= undecided
            m_band += above * bit
            m_exact += sd_above(n, y, p2) * bit
        edge = -(b_min_deep * env).astype(F32)
        for r, d in enumerate(plan.b_delays):
            hit = (at(nbv, d) < edge) * (8 << r)
            m_band += hit
            m_exact += hit
        d, gap, p2, w = plan.v_rate
        n = (at(w, d + gap) - at(w, d)).astype(F32)
        y = (v_thr * env).astype(F32)
        above, undecided = sd_band(n, y, p2)
        slow |= undecided
        m_band += above * 128
        m_exact += sd_above(n, y, p2) * 128
        power_ok = env >= power_thr
    m = np.where(slow, m_exact, m_band)
    return np.where(power_ok, m, 0).astype(np.uint8), power_ok & ~slow


@pytest.mark.parametrize("rate", THREE)
@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("mp", [(-1.0, 0.75, 0.10, 0.50, 0.50),
                                (0.0, 1.0, 0.10, 0.25, 1.0),
                                (0.01, 0.75, 0.10, 0.50, 0.50)],
                         ids=["power_neg", "power_zero", "default"])
def test_kernel_row_equals_the_plain_mask(rate, case, mp):
    """The band with sd_above behind it gives _mask_plain's mask on
    channels whose tests sit on their boundary, lookbacks before the chunk
    included; the band decides most rows itself, and the focused tests do
    flip."""
    from torch_synth import _mask_tests, ff_mask_boundary_deps

    plan = ff.kernel_plan(rate)
    deps, value, state = ff_mask_boundary_deps(plan, 520, 24, 5 + case,
                                               case, mp)
    so = torch.zeros(state.shape)
    want = ff._mask_plain(torch.from_numpy(deps), torch.from_numpy(value),
                          torch.from_numpy(state), so, mp, plan, True, True)
    got, fast = mask_mirror(plan, deps, state, mp)
    assert np.array_equal(got, want["detect_mask"].numpy())
    env = deps[len(plan.bv_widths) + 1]
    in_band = (env >= ENV_BAND[0]) & (env <= ENV_BAND[1])
    assert 0.3 < fast.sum() / max(in_band.sum(), 1) < 1.0
    # the focused tests (the case-th of each channel's) do flip
    weight = {}
    for r, (d, gap, p2, w) in enumerate(plan.a_rates):
        weight[(w, d, gap, p2, "a")] = 1 << r
    for r, (_, gap, p2, w) in enumerate(plan.f_rates):
        weight[(w, 0, gap, p2, "f")] = 32 << r
    weight[(plan.v_rate[3], *plan.v_rate[:3], "v")] = 128
    by_channel = {}
    for test in _mask_tests(plan):
        by_channel.setdefault(test[0], []).append(test)
    bits = want["detect_mask"].numpy().astype(np.int32)
    for tests in by_channel.values():
        w = weight[tests[case % len(tests)]]
        assert 0 < ((bits & w) != 0).mean() < 1, (rate, w)


def history_mirror(plan, deps, state, t):
    """ff_mask_history in numpy: history row q is section k, row i, the
    channel's row T - hist_len[k] + i, from the chunk or, before it, from
    the input section shifted by T."""
    lay = ff._layout(plan)
    out = state.copy()
    hlen = [h + ff.TILE for h in plan.h_sizes]
    for q in range(sum(hlen)):
        i, ch = q, 0
        while i >= hlen[ch]:
            i -= hlen[ch]
            ch += 1
        off, n = lay.hist_offs[ch], hlen[ch]
        p = t + i - n
        out[off + i] = deps[ch, p] if p >= 0 else state[off + n + p]
    return out


@pytest.mark.parametrize("rate", THREE)
@pytest.mark.parametrize("t", [1, 100, 700, 2100])
def test_history_rows_equal_the_plain_state(rate, t):
    plan = ff.kernel_plan(rate)
    rng = np.random.default_rng(t)
    deps = rng.standard_normal((len(plan.bv_widths) + 2, t, 3)).astype(F32)
    state = rng.standard_normal((plan.nstate, 3)).astype(F32)
    so = torch.from_numpy(state.copy())
    ff._mask_plain(torch.from_numpy(deps), torch.from_numpy(deps[0]),
                   torch.from_numpy(state), so, (0.01,) * 5, plan, False,
                   False)
    lay = ff._layout(plan)
    rows = slice(lay.hist_off, lay.hist_off + lay.hist_rows)
    assert np.array_equal(history_mirror(plan, deps, state, t)[rows],
                          so.numpy()[rows])
