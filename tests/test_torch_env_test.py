"""The divide-free envelope test of the scan kernels, on the CPU.

``cond_scan_kernel`` and ``ff_scan_kernel`` decide whether the envelope
follows the sample with ``|v - env| <= m * env`` in exact double arithmetic
(``csrc/condition_step.cuh::cond_env_near``) instead of the correctly
rounded quotient ``|v - env| / env < 0.05f``.  Its numpy mirror
``conditioner_kernel.env_near`` is held here to the float32 quotient on
float32 inputs: around the boundary in every binade of env from the
subnormals to 3e38, at the special values, and on arbitrary pairs."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nfclab_torch.dsp.conditioner_kernel import ENV_NEAR_MIDPOINT, env_near

F32 = np.float32


def quotient_test(v, env):
    v = np.asarray(v, F32)
    env = np.asarray(env, F32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        return np.abs(v - env) / env < F32(0.05)


def nudged(x, k):
    """x moved by k float32 ulps (k may be negative)."""
    x = np.asarray(x, F32)
    toward = np.where(k >= 0, F32(np.inf), F32(-np.inf)).astype(F32)
    for _ in range(abs(k)):
        x = np.nextafter(x, toward)
    return x


def assert_same(v, env):
    got = env_near(v, env)
    want = quotient_test(v, env)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (
        f"{bad.size} mismatches, first v={v.flat[bad[0]]!r} "
        f"env={env.flat[bad[0]]!r}")


def test_midpoint_constant():
    # 0.05f = 13421773 * 2^-28; m lies halfway to its even predecessor
    assert float(F32(0.05)) == 13421773 / 2.0 ** 28
    assert ENV_NEAR_MIDPOINT == (13421773 - 0.5) / 2.0 ** 28
    below = np.nextafter(F32(0.05), F32(0))
    assert int(below.view(np.uint32)) % 2 == 0


# env binades from the subnormals (2^-149) to 2^127 (~1.7e38, and 3e38 in
# the top case), each split so every case stays small
BINADES = [(-149, -127), (-127, -100), (-100, -60), (-60, -30), (-30, -10),
           (-10, 0), (0, 10), (10, 30), (30, 60), (60, 90), (90, 115),
           (115, 128)]


@pytest.mark.parametrize("side", [1, -1], ids=["above", "below"])
@pytest.mark.parametrize("lo,hi", BINADES)
def test_boundary_in_each_binade(lo, hi, side):
    """v = env * (1 +- 0.05) moved by -3..3 ulps, and |d| itself at -3..3
    ulps around m * env, for seeded env mantissas in [2^lo, 2^hi)."""
    rng = np.random.default_rng((lo + 150) * 2 + (side > 0))
    exps = rng.integers(lo, hi, 3000)
    env = np.ldexp(rng.uniform(1.0, 2.0, exps.size), exps).astype(F32)
    env = env[(env > 0) & np.isfinite(env)]
    if hi == 128:
        env = np.concatenate([env, np.array([3e38, 3.4e38], F32)])
    target = ENV_NEAR_MIDPOINT * env.astype(np.float64)
    for k in range(-3, 4):
        with np.errstate(over="ignore"):
            v = nudged((env.astype(np.float64) + side * target).astype(F32), k)
            assert_same(v, env)
            d = nudged(target.astype(F32), k)
            assert_same((env.astype(np.float64) + side * d).astype(F32), env)


SPECIAL_ENV = {
    "zero": F32(0.0), "minus_zero": F32(-0.0), "negative": F32(-1.5),
    "minus_tiny": F32(-1e-45), "minus_inf": F32(-np.inf),
    "inf": F32(np.inf), "nan": F32(np.nan),
}
V_VALUES = np.array([0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 1.5, -1.5, 3e38,
                     -3e38, np.inf, -np.inf, np.nan], F32)


@pytest.mark.parametrize("name", sorted(SPECIAL_ENV))
def test_special_env(name):
    env = np.full(V_VALUES.size, SPECIAL_ENV[name], F32)
    assert_same(V_VALUES, env)


@pytest.mark.parametrize("v", [np.inf, -np.inf, np.nan],
                         ids=["inf", "minus_inf", "nan"])
def test_special_v(v):
    env = np.concatenate([np.array([1e-45, 1e-38, 1.0, 3e38], F32),
                          np.array(list(SPECIAL_ENV.values()), F32)])
    assert_same(np.full(env.size, v, F32), env)


float32s = st.floats(width=32, allow_nan=True, allow_infinity=True,
                     allow_subnormal=True)


@settings(max_examples=2000, deadline=None)
@given(v=float32s, env=float32s)
def test_arbitrary_pairs(v, env):
    assert_same(np.array([v], F32), np.array([env], F32))


@settings(max_examples=1000, deadline=None)
@given(env=st.floats(width=32, min_value=float(F32(1e-45)),
                     max_value=float(F32(3.4e38))),
       k=st.integers(-40, 40), side=st.sampled_from([1.0, -1.0]))
def test_pairs_near_the_boundary(env, k, side):
    e = F32(env)
    with np.errstate(over="ignore"):
        v = nudged(F32(float(e) * (1.0 + side * 0.05)), k)
    assert_same(np.array([v], F32), np.array([e], F32))


# cond_scan_kernel's per-group choice (csrc/conditioner.cu,
# CondEnvChain::group): a group of GROUP steps takes cond_env_near_pos alone
# when env provably stays positive and finite through it.  Mirrored here
# and held to that claim under every sequence of decisions.
GROUP = 16
INT32_MAX = 2**31 - 1


def group_positive(env, v, clock, etu, w0, w1):
    """The kernel's choice per lane: env [n], v [n, GROUP], clock [n]
    (int32); weights and etu scalars."""
    small = (v <= F32(2.0**100)).all(axis=1)
    positive = small & (v >= F32(2.0**-100)).all(axis=1)
    nonneg = small & (v >= 0).all(axis=1)
    w0, w1 = F32(w0), F32(w1)
    weights_a = 0 <= w0 <= 1 and 2.0**-40 <= w1 <= 1
    weights_b = 0.25 <= w0 <= 1 and 0 <= w1 <= 1
    small_env = env <= F32(2.0**100)
    a = weights_a & positive & (env > 0) & small_env
    b = (weights_b & nonneg & (env >= F32(2.0**-60)) & small_env
         & (clock >= etu) & (clock <= INT32_MAX - (GROUP - 1)))
    return a | b


WEIGHTS = {
    # (enve_w0, enve_w1) of dsp.frontend._params_tuple at 0.5, 3.2, 10 and
    # 40 MS/s, then the edges of both cases
    "0.5MS/s": (0.0, 1.0), "3.2MS/s": (0.84375, 0.15625),
    "10MS/s": (0.95, 0.050000012), "40MS/s": (0.9875, 0.012499988),
    "a_low_w1": (0.0, 2.0**-40), "a_high": (1.0, 1.0),
    "b_low_w0": (0.25, 0.0), "b_high": (1.0, 1.0),
    "b_quarter_one": (0.25, 1.0), "neither": (0.2, 2.0**-41),
}


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_group_choice_keeps_env_positive(name):
    w0, w1 = (F32(w) for w in WEIGHTS[name])
    etu = 94
    rng = np.random.default_rng(sorted(WEIGHTS).index(name))
    n = 20000
    env = np.ldexp(rng.uniform(1, 2, n), rng.integers(-149, 110, n)).astype(F32)
    env[:8] = [2.0**100, 2.0**-60, 2.0**-100, 1e-45, 0.0, -1.0, np.inf,
               np.nan]
    v = np.ldexp(rng.uniform(1, 2, (n, GROUP)),
                 rng.integers(-110, 105, (n, GROUP))).astype(F32)
    v[rng.random((n, GROUP)) < 0.1] = 0.0
    v[rng.random((n, GROUP)) < 0.01] = -1e-3
    v[:4] = [[2.0**100], [2.0**-100], [0.0], [2.0**100]]
    clock = rng.choice(np.array([0, etu - 3, etu, 10**6, INT32_MAX - 15,
                                 INT32_MAX - 14], np.int64), n)
    chosen = group_positive(env, v, clock, etu, w0, w1)
    if name == "neither":
        assert not chosen.any()
        return
    assert chosen.sum() > n // 50
    # the first lanes update at every step: the largest growth (env and v
    # at 2^100) and the deepest decay (env at 2^-60, v at 0)
    always = (np.arange(n) < 4)[chosen]
    e, x, c = env[chosen], v[chosen], clock[chosen]
    with np.errstate(over="ignore", under="ignore"):
        for k in range(GROUP):
            # any decision the test could make: update, hold, or a seed
            # while the clock is below one ETU
            pick = np.where(always, 0, rng.integers(0, 3, e.size))
            ema = e * w0 + x[:, k] * w1
            seeding = (c + k) < etu
            e = np.where(pick == 0, ema,
                         np.where((pick == 1) & seeding, x[:, k], e)
                         ).astype(F32)
            assert ((e > 0) & np.isfinite(e)).all(), (name, k)
            assert_same(x[:, k], e)


# The same vote in v2_scan_kernel and serial_probe_kernel, whose envelope
# chain (CondEnvChain with CondFloatCounter) keeps an integer-valued
# float32 silence count and an int32 clock: the absolute clock base + j in
# v2 (its wrapper keeps base + T + 948 <= 2**31) and a clock that counts
# from 0 in every probe call.  The vote's cases read neither the count
# nor anything but the clock at the group's first step, so here the chain
# runs its real decisions -- the float count forcing updates past its
# timeout, seeds below one ETU -- through every group the vote lets pass.
CLOCKS = {
    "call_local": np.array([0, 1, 93, 94, 95, 1000, 65520], np.int64),
    "absolute": np.array([0, 94, 40, 10**6, 2**31 - 948 - 16,
                          INT32_MAX - 15, INT32_MAX - 14], np.int64),
}


def float_counter_group(env, pcount, v, clock, etu, silence, w0, w1):
    """16 steps of the float-counter chain per lane (numpy, float32):
    returns env after each step, [n, GROUP]."""
    out = np.empty(v.shape, F32)
    for k in range(GROUP):
        x = v[:, k]
        pcount = (pcount + F32(1.0)).astype(F32)
        with np.errstate(over="ignore", under="ignore", invalid="ignore"):
            ema = (env * w0 + x * w1).astype(F32)
        update = env_near(x, env) | (pcount > silence)
        seeding = (clock + k) < etu
        env = np.where(update, ema, np.where(seeding, x, env)).astype(F32)
        pcount = np.where(update, F32(0.0), pcount).astype(F32)
        out[:, k] = env
    return out


@pytest.mark.parametrize("clock", sorted(CLOCKS))
@pytest.mark.parametrize("name", ["3.2MS/s", "10MS/s", "40MS/s",
                                  "b_low_w0", "a_low_w1"])
def test_group_choice_keeps_env_positive_float_counter(name, clock):
    w0, w1 = (F32(w) for w in WEIGHTS[name])
    etu = 94
    silence = F32(etu * 10.0)
    rng = np.random.default_rng(sorted(WEIGHTS).index(name) * 7
                                + len(clock))
    n = 20000
    env = np.ldexp(rng.uniform(1, 2, n), rng.integers(-149, 110, n)).astype(F32)
    env[:4] = [2.0**100, 2.0**-60, 2.0**-100, 1e-45]
    # samples near env (updates), far from it (holds and seeds), zeros
    scale = np.where(rng.random(n) < 0.5, env,
                     np.ldexp(1.0, rng.integers(-110, 100, n))).astype(F32)
    v = (scale[:, None] * rng.uniform(0.9, 1.1, (n, GROUP))).astype(F32)
    v[rng.random((n, GROUP)) < 0.1] = 0.0
    v[:4] = [[2.0**100], [0.0], [2.0**-100], [2.0**100]]
    # counts at 0, just below and past the timeout, and where float32 stops
    # counting
    pcount = rng.choice(np.array([0, 1, 900, 939, 940, 941, 5000, 2**24],
                                 F32), n)
    clocks = rng.choice(CLOCKS[clock], n)
    chosen = group_positive(env, v, clocks, etu, w0, w1)
    assert chosen.sum() > n // 50
    e = env[chosen]
    steps = float_counter_group(e, pcount[chosen], v[chosen], clocks[chosen],
                                etu, silence, w0, w1)
    assert ((steps > 0) & np.isfinite(steps)).all(), name
    before = np.concatenate([e[:, None], steps[:, :-1]], 1)
    for k in range(GROUP):
        assert_same(v[chosen][:, k], before[:, k])


# The mod_depth warps of v2_scan_kernel and serial_probe_kernel take
# condition_step.cuh::cond_mod_depth_split: +0 without a divide where the
# numerator env - clamp(v, 0, env) is +0 and env > 0, the divide otherwise.
# Mirrored here and held to the plain formula (experiments.common
# .mod_depth, the plain versions' own) bit for bit.
def mod_depth_split(v, env):
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        c = np.where(np.isnan(v) | np.isnan(env), F32(np.nan),
                     np.fmin(v, env)).astype(F32)
        c = np.where(np.isnan(c), c, np.fmax(c, F32(0))).astype(F32)
        num = (env - c).astype(F32)
        zero = (num == 0) & (env > 0)
        q = (np.where(zero, env, num) / env).astype(F32)
    return np.where(zero, F32(0), q).astype(F32)


MD_FAMILIES = {
    "specials": lambda rng: np.meshgrid(V_VALUES, V_VALUES),
    "carrier": lambda rng: (
        rng.uniform(0, 0.4, 50000).astype(F32),
        rng.uniform(0, 0.4, 50000).astype(F32)),
    "equal": lambda rng: (np.ldexp(rng.uniform(1, 2, 50000),
                                   rng.integers(-149, 128, 50000))
                          .astype(F32),) * 2,
    "binades": lambda rng: tuple(
        np.ldexp(rng.uniform(-2, 2, 50000), rng.integers(-149, 128, 50000))
        .astype(F32) for _ in range(2)),
}


@pytest.mark.parametrize("family", sorted(MD_FAMILIES))
def test_mod_depth_split_equals_the_quotient(family):
    import torch

    from nfclab_torch.experiments.common import mod_depth

    v, env = (np.ascontiguousarray(a, F32).ravel()
              for a in MD_FAMILIES[family](np.random.default_rng(9)))
    got = mod_depth_split(v, env)
    want = mod_depth(torch.from_numpy(v), torch.from_numpy(env)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (v[~same][:4], env[~same][:4])
    if family in ("carrier", "equal"):
        assert (got == 0).any()   # the split takes its case


# pair_probe_kernel's envelope warp (condition_step.cuh::CondPairChain)
# takes the same vote, then steps two samples at a time: the second
# sample's test runs against each envelope the first can leave -- the
# update c_u, the seed v1 and the hold env -- before the first resolves,
# each with cond_env_near_pos alone in a group the vote lets pass.  Here
# every candidate that can be selected (env and c_u always, v1 while the
# clock is below one ETU) must be positive and finite, and the
# divide-free test against it must equal the quotient, under random
# decisions and under the chain's own; the pairs must give the serial
# chain's envelopes.
def pair_group(env, pcount, v, clock, etu, silence, w0, w1, rng=None):
    """GROUP steps of the pair chain per lane (numpy, float32), the
    outcome of each step drawn from rng when given (update, hold or seed
    where the clock allows it) instead of the tests; returns (env after
    each step [n, GROUP], the candidates checked)."""
    out = np.empty(v.shape, F32)
    checked = 0
    for k in range(0, GROUP, 2):
        v1, v2 = v[:, k], v[:, k + 1]
        with np.errstate(over="ignore", under="ignore", invalid="ignore"):
            c_u = (env * w0 + v1 * w1).astype(F32)
        seed1 = (clock + k) < etu
        for cand, live in ((env, np.ones(env.size, bool)),
                           (c_u, np.ones(env.size, bool)), (v1, seed1)):
            c = cand[live]
            assert ((c > 0) & np.isfinite(c)).all(), k
            assert_same(v2[live], c)
            checked += int(live.sum())
        n1, n_u = env_near(v1, env), env_near(v2, c_u)
        n_s, n_h = env_near(v2, v1), env_near(v2, env)
        p1 = (pcount + F32(1.0)).astype(F32)
        if rng is None:
            u1 = n1 | (p1 > silence)
            s1 = seed1
        else:
            pick = rng.integers(0, 3, env.size)
            u1, s1 = pick == 0, (pick == 2) & seed1
        env1 = np.where(u1, c_u, np.where(s1, v1, env)).astype(F32)
        n2 = np.where(u1, n_u, np.where(s1, n_s, n_h))
        pc1 = np.where(u1, F32(0.0), p1).astype(F32)
        p2 = (pc1 + F32(1.0)).astype(F32)
        with np.errstate(over="ignore", under="ignore", invalid="ignore"):
            c2u = (env1 * w0 + v2 * w1).astype(F32)
        seed2 = (clock + k + 1) < etu
        if rng is None:
            u2, s2 = n2 | (p2 > silence), seed2
        else:
            pick = rng.integers(0, 3, env.size)
            u2, s2 = pick == 0, (pick == 2) & seed2
        env = np.where(u2, c2u, np.where(s2, v2, env1)).astype(F32)
        pcount = np.where(u2, F32(0.0), p2).astype(F32)
        out[:, k], out[:, k + 1] = env1, env
    return out, checked


@pytest.mark.parametrize("decisions", ["chain", "random"])
@pytest.mark.parametrize("clock", sorted(CLOCKS))
@pytest.mark.parametrize("name", ["3.2MS/s", "10MS/s", "40MS/s",
                                  "b_low_w0", "a_low_w1"])
def test_pair_vote_covers_every_candidate(name, clock, decisions):
    w0, w1 = (F32(w) for w in WEIGHTS[name])
    etu = 94
    silence = F32(etu * 10.0)
    rng = np.random.default_rng(sorted(WEIGHTS).index(name) * 11
                                + len(clock) + len(decisions))
    n = 20000
    env = np.ldexp(rng.uniform(1, 2, n), rng.integers(-149, 110, n)).astype(F32)
    env[:4] = [2.0**100, 2.0**-60, 2.0**-100, 1e-45]
    scale = np.where(rng.random(n) < 0.5, env,
                     np.ldexp(1.0, rng.integers(-110, 100, n))).astype(F32)
    v = (scale[:, None] * rng.uniform(0.9, 1.1, (n, GROUP))).astype(F32)
    # zeros, and at the group's first samples (a pair's v1 while seeding)
    v[rng.random((n, GROUP)) < 0.1] = 0.0
    v[rng.random(n) < 0.05, 0] = 0.0
    v[:4] = [[2.0**100], [0.0], [2.0**-100], [2.0**100]]
    pcount = rng.choice(np.array([0, 1, 900, 939, 940, 941, 5000, 2**24],
                                 F32), n)
    clocks = rng.choice(CLOCKS[clock], n)
    chosen = group_positive(env, v, clocks, etu, w0, w1)
    assert chosen.sum() > n // 50
    args = (env[chosen], pcount[chosen], v[chosen], clocks[chosen], etu,
            silence, w0, w1)
    got, checked = pair_group(*args, rng=rng if decisions == "random"
                              else None)
    # env and c_u at every pair, and v1 at the pairs that can seed: case
    # (a) with call-local clocks below one ETU
    assert checked >= GROUP * chosen.sum()
    if clock == "call_local" and w1 >= 2.0**-40:
        assert checked > GROUP * chosen.sum()
    assert ((got > 0) & np.isfinite(got)).all(), name
    if decisions == "chain":
        serial = float_counter_group(*args)
        assert np.array_equal(got.view(np.uint32), serial.view(np.uint32))
