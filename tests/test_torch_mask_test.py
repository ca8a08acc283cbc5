"""The fused_v2 mask kernel's design, on the CPU.

``v2_mask_kernel`` (``csrc/fused_v2.cu``) decides each threshold test
``RN(n / p2) > y`` without a divide (``csrc/condition_step.cuh::sd_above``)
and reads its lookbacks from shared rings that a producer warp fills once
per span.  Both are mirrored here in numpy and held to what they replace:
the test to the float32 quotient on float32 inputs, around its boundary in
every binade of y from the subnormals to FLT_MAX, at exact ties, at the
special values and on arbitrary pairs; the staged windows to the mask's
addressing by chunk row and absolute clock (``_mask_plain``'s lookback and
ring-out rows), from any clock base up to the int32 guard."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nfclab_torch.experiments import fused_v2 as v2
from nfclab_torch.experiments.fused_v2 import FLT_MAX, sd_above
from nfclab_torch.kernels import fused as kf
from nfclab_torch.kernels import fused_v2 as kv

F32 = np.float32
P2S = (12, 24, 47, 94)   # the mask's divisors: A/F rates and V


def quotient_test(n, y, p2):
    n, y = np.asarray(n, F32), np.asarray(y, F32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        return n / F32(p2) > y


def nudged(x, k):
    """x moved by k float32 ulps (k may be negative)."""
    x = np.asarray(x, F32)
    toward = F32(np.inf) if k >= 0 else F32(-np.inf)
    for _ in range(abs(k)):
        x = np.nextafter(x, toward)
    return x


def assert_same(n, y, p2):
    got = sd_above(n, y, p2)
    want = quotient_test(n, y, p2)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (
        f"p2={p2}: {bad.size} mismatches, first n={n.flat[bad[0]]!r} "
        f"y={y.flat[bad[0]]!r}")


def midpoint(y):
    """The midpoint of y and its float32 successor, in float64 (exact)."""
    y = np.asarray(y, F32)
    return (y.astype(np.float64)
            + np.nextafter(y, F32(np.inf)).astype(np.float64)) * 0.5


def test_midpoint_products_are_exact_in_double():
    """p2 has at most 7 significant bits and the midpoint at most 25, so
    their product is exact in float64 from the least subnormal to
    FLT_MAX."""
    for p2 in P2S:
        assert p2 < 128
    y = np.array([2.0**-149, 3 * 2.0**-149, 2.0**-126, 1.0, 1.5,
                  np.nextafter(F32(2.0), F32(0)), FLT_MAX / 2], F32)
    mid = midpoint(y)
    for p2 in P2S:
        lim = p2 * mid
        # exact: dividing back gives the midpoint, and the midpoint has at
        # most 25 significant bits
        assert np.array_equal(lim / p2, mid)
        mant, _ = np.frexp(mid)
        assert np.array_equal(np.ldexp(mant, 25), np.round(np.ldexp(mant, 25)))


# y binades from the subnormals (2^-149) to 2^127 (~1.7e38; FLT_MAX and
# its predecessors in the top case)
BINADES = [(-149, -127), (-127, -100), (-100, -60), (-60, -30), (-30, -10),
           (-10, 0), (0, 10), (10, 30), (30, 60), (60, 90), (90, 115),
           (115, 128)]


@pytest.mark.parametrize("p2", P2S)
@pytest.mark.parametrize("lo,hi", BINADES)
def test_boundary_in_each_binade(lo, hi, p2):
    """n at -3..3 ulps around the nearest float32 of p2 * m(y), both signs,
    for seeded y in [2^lo, 2^hi)."""
    rng = np.random.default_rng((lo + 150) * 7 + p2)
    exps = rng.integers(lo, hi, 2000)
    y = np.ldexp(rng.uniform(1.0, 2.0, exps.size), exps).astype(F32)
    y = y[(y > 0) & np.isfinite(y)]
    if hi == 128:
        top = np.full(2, FLT_MAX, F32)
        y = np.concatenate([y, nudged(top[:1], -1), nudged(top[1:], -2)])
    with np.errstate(over="ignore"):
        target = (p2 * midpoint(y)).astype(F32)
    for k in range(-3, 4):
        n = nudged(target, k)
        assert_same(n, y, p2)
        assert_same(-n, y, p2)


@pytest.mark.parametrize("p2", P2S)
def test_exact_ties_round_to_even(p2):
    """n / p2 can fall exactly on the midpoint only for subnormal y with a
    short significand and an even p2 (the midpoint is an odd multiple of
    2^-150); there the tie goes to the even neighbour, above y exactly when
    y's last bit is 1."""
    k = np.arange(1, 4096)
    y = (k * 2.0**-149).astype(F32)
    lim = p2 * midpoint(y)
    n = lim.astype(F32)
    tie = n.astype(np.float64) == lim
    if p2 % 2:
        assert not tie.any()
        return
    assert tie.sum() > 100
    assert_same(n[tie], y[tie], p2)
    assert np.array_equal(sd_above(n[tie], y[tie], p2), (k[tie] & 1) == 1)
    # and none for normal y: an odd p2 factor times a 25-bit odd midpoint
    y = np.ldexp(np.random.default_rng(p2).uniform(1, 2, 5000),
                 np.random.default_rng(p2 + 1).integers(-126, 127, 5000)
                 ).astype(F32)
    lim = p2 * midpoint(y)
    with np.errstate(over="ignore"):
        assert not (lim.astype(F32).astype(np.float64) == lim).any()


SPECIAL_Y = {
    "zero": 0.0, "minus_zero": -0.0, "negative": -1.5, "minus_tiny": -1e-45,
    "minus_inf": -np.inf, "inf": np.inf, "nan": np.nan, "flt_max": FLT_MAX,
    "tiny": 1e-45,
}
N_VALUES = np.array([0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 1.5, -1.5, 3e38,
                     -3e38, FLT_MAX, -FLT_MAX, np.inf, -np.inf, np.nan], F32)


@pytest.mark.parametrize("p2", P2S)
@pytest.mark.parametrize("name", sorted(SPECIAL_Y))
def test_special_y(name, p2):
    y = np.full(N_VALUES.size, SPECIAL_Y[name], F32)
    assert_same(N_VALUES, y, p2)


@pytest.mark.parametrize("p2", P2S)
def test_special_n(p2):
    y = np.array([1e-45, 1e-38, 1.0, 3e38, FLT_MAX, *SPECIAL_Y.values()], F32)
    for n in (np.inf, -np.inf, np.nan, 0.0, -0.0):
        assert_same(np.full(y.size, n, F32), y, p2)


float32s = st.floats(width=32, allow_nan=True, allow_infinity=True,
                     allow_subnormal=True)


@settings(max_examples=1500, deadline=None)
@given(n=float32s, y=float32s, p2=st.sampled_from(P2S))
def test_arbitrary_pairs(n, y, p2):
    assert_same(np.array([n], F32), np.array([y], F32), p2)


@settings(max_examples=1500, deadline=None)
@given(y=st.floats(width=32, min_value=float(F32(1e-45)),
                   max_value=FLT_MAX),
       k=st.integers(-40, 40), sign=st.sampled_from([1.0, -1.0]),
       p2=st.sampled_from(P2S))
def test_pairs_near_the_boundary(y, k, sign, p2):
    y = np.array([y], F32)
    with np.errstate(over="ignore"):
        n = nudged((p2 * midpoint(y)).astype(F32), k) * F32(sign)
    assert_same(n, y, p2)


# --------------------------------------------------------------------------
# The staged lag windows of v2_mask_kernel.  A block owns a span of chunk
# rows and walks it in sub-tiles; for a channel with lags lmin..lmax the
# producer copies rows [J - lmin, J + n - lmin) for the sub-tile [J, J + n)
# (the span's first sub-tile also the spread behind them) to slot r & (P -
# 1) of the channel's ring, at most STAGES sub-tiles ahead of the consumers,
# from the chunk's output row r or, before the chunk, from the state ring
# slot (base + r) mod R.  An address is ("out", row) or ("state", slot).

INT32_TOP = 2**31 - 2 * v2.RBV_RING   # base + T may reach it


def channel_lags() -> dict:
    """Every lookback of _mask_plain, by channel, from the rate tables."""
    lags = {"envelope": {0}, "filtered": set(v2.B_DELAYS)}
    for d, gap, _, widx in v2.A_RATES:
        lags.setdefault(f"bv{v2.BV_WIDTHS[widx]}", set()).update(
            (d, d + 1, d + gap))
    for d, gap, _, ridx in v2.F_RATES:
        w = v2.BV_WIDTHS[v2.A_RATES[ridx][3]]
        lags[f"bv{w}"].update((d, d + 1, d + gap))
    dv, gapv, _, widxv = v2.V_RATE
    lags[f"bv{v2.BV_WIDTHS[widxv]}"] = {dv, dv + gapv}
    return lags


def c_mod(t: int, r: int) -> int:
    """The kernel's v2_state_slot: int32 t % r (C's, truncating), then + r
    where negative."""
    assert -(2**31) <= t < 2**31
    s = int(np.fmod(t, r))
    return s + r if s < 0 else s


def lag_address(name, j, c, base):
    """Where _mask_plain reads channel `name` c rows behind chunk row j."""
    i = j - c
    if i >= 0:
        return ("out", i)
    return ("state", (base + i) % v2._RINGS[name][1])


def test_mask_geometry_covers_every_lookback():
    """The kernel's channel table (kernels/fused_v2.MASK_CHANNELS): each
    channel's lag range is _mask_plain's, its state ring the one that holds
    it before the chunk, its shared ring a power of two that holds the
    spread and STAGES sub-tiles; the rings fit a block's shared memory."""
    lags = channel_lags()
    assert [ch[0] for ch in kv.MASK_CHANNELS] == [
        "envelope", "bv47", "bv24", "bv12", "filtered", "bv94"]
    for name, lmin, lmax, ring, r in kv.MASK_CHANNELS:
        assert (lmin, lmax) == (min(lags[name]), max(lags[name])), name
        assert r == (v2._RINGS[name][1] if name in v2._RINGS else 0), name
        assert ring & (ring - 1) == 0, name
        assert ring >= lmax - lmin + kv.MASK_STAGES * kv.MASK_TILE_ROWS, name
        assert name == "envelope" or r > lmax, name
    assert kv.MASK_SPAN_ROWS % kv.MASK_TILE_ROWS == 0
    assert kv.MASK_THREADS == (kv.MASK_WARPS + kv.MASK_PRODUCERS) * 32
    assert kv.mask_smem() == 32 + 128 * (128 + 4 * 256 + 512) <= kf.SMEM_LIMIT
    assert len(kv.mask_geometry()) == 5 + 4 * len(kv.MASK_CHANNELS)


def staged_reads(name, lmin, lmax, ring, t, base):
    """Simulate one channel's producer and consumers over a chunk of t rows:
    per span, the rows copied (each must be copied once), and for every
    consumer read the address its slot holds both once its sub-tile's
    copies have landed and once the producer has run STAGES - 1 sub-tiles
    further ahead (the latest it may).  Returns {(j, c): address}."""
    lag_set = sorted(channel_lags()[name])
    r_state = dict((n, r) for n, _, _, _, r in kv.MASK_CHANNELS)[name]
    tile, stages, span = (kv.MASK_TILE_ROWS, kv.MASK_STAGES,
                          kv.MASK_SPAN_ROWS)
    got = {}
    for j0 in range(0, t, span):
        j1 = min(t, j0 + span)
        tiles = list(range(j0, j1, tile))
        slots = [None] * ring
        copies = []   # per sub-tile: [(slot, address)]
        for i, J in enumerate(tiles):
            n = min(tile, j1 - J)
            lo = J - lmax if i == 0 else J - lmin
            rows = range(lo, J + n - lmin)
            copies.append([(r & (ring - 1),
                            ("out", r) if r >= 0
                            else ("state", c_mod(base + r, r_state)))
                           for r in rows])
        loaded = [a for c in copies for _, a in c]
        want_rows = list(range(j0 - lmax, j1 - lmin))
        assert len(loaded) == len(want_rows), (name, j0)
        applied = 0

        def apply(upto):
            nonlocal applied
            while applied <= min(upto, len(copies) - 1):
                for s, a in copies[applied]:
                    slots[s] = a
                applied += 1

        for i, J in enumerate(tiles):
            n = min(tile, j1 - J)
            reads = [(j, c) for j in range(J, J + n) for c in lag_set]
            apply(i)
            early = {(j, c): slots[(j - c) & (ring - 1)] for j, c in reads}
            apply(i + stages - 1)
            for j, c in reads:
                assert slots[(j - c) & (ring - 1)] == early[(j, c)], (
                    name, j, c, "overwritten before its sub-tile was done")
            got.update(early)
    return got


@pytest.mark.parametrize("t", [5, 97, 300, 2049, 4100])
@pytest.mark.parametrize("base", [0, 40, 473, 1000, INT32_TOP - 4100])
def test_staged_windows_follow_the_clock(t, base):
    """Every lookback the consumers read, for every channel, from any
    base up to the int32 guard, is the row or state slot _mask_plain reads;
    each row is copied once per span."""
    for name, lmin, lmax, ring, _ in kv.MASK_CHANNELS:
        got = staged_reads(name, lmin, lmax, ring, t, base)
        assert len(got) == t * len(channel_lags()[name])
        for (j, c), addr in got.items():
            assert addr == lag_address(name, j, c, base), (name, j, c, base)


@pytest.mark.parametrize("t", [1, 5, 300, 600])
@pytest.mark.parametrize("base", [0, 7, 1000, INT32_TOP - 600])
def test_state_rows_follow_the_clock(t, base):
    """The state rows the mask writes: ring slot s takes the value at lag
    (t_last - s) mod R behind the chunk's last row (one int32 modulo a
    slot), which is _mask_plain's ext row ring + T - 1 - (t_last - s) % R:
    the chunk's row, or before the chunk the slot s of the input."""
    t_last = base + t - 1
    for name, (_, r) in v2._RINGS.items():
        if name == "filtered":
            continue
        for s in range(r):
            d = c_mod(t_last - s, r)
            addr = lag_address(name, t - 1, d, base)
            ext = r + t - 1 - (t_last - s) % r
            want = ("out", ext - r) if ext >= r else ("state", s)
            assert addr == want, (name, s, t, base)


# v2_mask_kernel's row (csrc/fused_v2.cu::v2_mask_row) in numpy: every
# lookback by its chunk row or state slot, b1 from carry rows 5-9 at the
# chunk's first row, the tests through sd_above, every bit gated by the
# power test.  Held to _mask_plain on inputs whose tests sit on their
# boundary (torch_synth.mask_boundary_out).
KERNEL_TESTS = (  # (channel, d, gap, p2, threshold, carry row, weight)
    ("bv47", 0, 47, 47, "a", 5, 1), ("bv24", 94, 23, 24, "a", 8, 2),
    ("bv12", 141, 12, 12, "a", 9, 4), ("bv24", 0, 23, 24, "f", 6, 32),
    ("bv12", 0, 12, 12, "f", 7, 64))


def mask_mirror(out, state, base, mp):
    power_thr, a_thr, b_min_deep, f_thr, v_thr = (F32(x) for x in mp)
    _, t, _ = out.shape
    row = v2._ROW

    def at(name, c):
        """channel `name` c rows behind every chunk row: [t, b]."""
        off, r = v2._RINGS[name]
        j = np.arange(t) - c
        got = out[row[name]][np.maximum(j, 0)].copy()
        before = j < 0
        slots = [(base + i) % r for i in j[before]]
        got[before] = state[off + np.array(slots, int)]
        return got

    env = out[row["envelope"]]
    with np.errstate(all="ignore"):
        power_ok = env >= power_thr
        y = {"a": (a_thr * env).astype(F32), "f": (f_thr * env).astype(F32)}
        m = np.zeros(env.shape, np.int32)
        for name, d, gap, p2, which, carry, w in KERNEL_TESTS:
            b0, bg, b1 = at(name, d), at(name, d + gap), at(name, d + 1)
            b1[0] = state[carry]
            n = ((b0 - bg).astype(F32) - (bg - b1).astype(F32)).astype(F32)
            m += sd_above(np.abs(n), y[which], p2) * w
        edge = -(b_min_deep * env).astype(F32)
        m += (at("filtered", 0) < edge) * 8 + (at("filtered", 94) < edge) * 16
        nv = (at("bv94", 473) - at("bv94", 378)).astype(F32)
        m += sd_above(nv, (v_thr * env).astype(F32), 94) * 128
    return np.where(power_ok, m, 0).astype(F32)


@pytest.mark.parametrize("case", ["a", "f"])
@pytest.mark.parametrize("mp", [(-1.0, 0.75, 0.10, 0.50, 0.50),
                                (0.0, 1.0, 0.10, 0.25, 1.0),
                                (0.01, 0.75, 0.10, 0.50, 0.50)],
                         ids=["power_neg", "power_zero", "default"])
@pytest.mark.parametrize("base", [0, 5000])
def test_kernel_row_equals_the_plain_mask(case, mp, base):
    import torch

    from torch_synth import mask_boundary_out

    out, state = mask_boundary_out(560, 40, 7 + base, case, mp)
    want = torch.from_numpy(out.copy())
    v2._mask_plain(want, torch.from_numpy(state),
                   torch.zeros(state.shape), base, mp)
    got = mask_mirror(out, state, base, mp)
    assert np.array_equal(got, want[-1].numpy())
    # the focused tests do flip around their boundary
    bits = want[-1].numpy().astype(np.int32)
    for w in (1, 2, 4, 32, 64, 128):
        assert 0 < ((bits & w) != 0).mean() < 1, w
