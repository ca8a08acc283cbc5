// The float arithmetic of one step of the NFC conditioning chain
// (NfcTech.cpp:39-68) and of mod_depth (NfcTech.cpp:71-74), and the chains
// that run it serially over a stream, shared by every kernel that
// conditions: ff_scan_kernel and ff_mask_kernel (fused_frontend.cu),
// cond_scan_kernel (conditioner.cu), v2_scan_kernel (fused_v2.cu) and the
// conditioning probes (probes.cu).
//
// The envelope test comes in two forms with the same result: the
// quotient cond_env_diff(v, env) < 0.05f, and cond_env_near /
// cond_env_near_pos, no divide where env is positive and finite, which
// every kernel takes.  CondEnvChain::group lets a warp decide once per
// group of COND_UNROLL steps that env stays positive and finite, so that
// the group runs cond_env_near_pos alone, with no branch; CondPairChain
// runs the same chain two samples a step, pairwise-speculative.  The mask
// kernels' SD threshold test RN(n / p2) > y has the same kind of
// divide-free form (sd_above).
//
// The contract is bit-exactness with the C++ oracle, which is built with
// -ffp-contract=off: every operation is an explicit round-to-nearest
// intrinsic, so no FMA contraction or approximate division can creep in
// whatever the build flags.  The silence counter and the clock differ
// between kernels, so the envelope chain takes them as a parameter:
// CondPulseCounter (the conditioning kernel: an int32 pulse count and a
// per-stream int32 clock) or CondFloatCounter (the fused v2 scan and the
// probes: an integer-valued float count, and an int32 clock that is the
// absolute clock in v2 and counts from 0 in every probe call).

#pragma once

#include <math.h>
#include <stdint.h>

#define COND_UNROLL 16   // steps of a group: samples loaded ahead, one vote

// |v - env| / env: the envelope follows v while this is below 0.05
__device__ __forceinline__ float cond_env_diff(float v, float env)
{
    return __fdiv_rn(fabsf(__fsub_rn(v, env)), env);
}

// cond_env_diff(v, env) < 0.05f with no divide, exact for 0 < env < inf.
//
// 0.05f = 13421773 * 2^-28 and its predecessor is even, so a real quotient
// x rounds below 0.05f exactly when x <= m, m = 26843545 * 2^-29 the
// midpoint (a tie goes to the even predecessor).  For 0 < env < inf that
// is |d| <= m * env with d = v - env rounded as float; m has 25
// significant bits and env 24, so the double product is exact (subnormal
// env included) and so is the comparison.  |d| = inf and NaN compare
// false on both sides.
__device__ __forceinline__ bool cond_env_near_pos(float v, float env)
{
    const float ad = fabsf(__fsub_rn(v, env));
    const double m = 26843545.0 / 536870912.0;  // 2^29, exact
    return (double)ad <= __dmul_rn(m, (double)env);
}

// Exactly cond_env_diff(v, env) < 0.05f for every env.  env <= 0,
// env = +inf and NaN env follow the quotient's own IEEE rules (0/0, x/-0,
// inf/inf...), so those lanes take the divide: a rarely taken branch that
// is part of the semantics.
__device__ __forceinline__ bool cond_env_near(float v, float env)
{
    bool near = cond_env_near_pos(v, env);
    if (__builtin_expect(!(env > 0.0f && env < INFINITY), 0))
        near = cond_env_diff(v, env) < 0.05f;
    return near;
}

// acc * w0 + x * w1: the envelope update and the deviation and average
// EMAs
__device__ __forceinline__ float cond_ema(float acc, float w0, float x,
                                          float w1)
{
    return __fadd_rn(__fmul_rn(acc, w0), __fmul_rn(x, w1));
}

// IIR DC removal: w0 = v + w1 * a, filt = w0 - w1; returns w0
__device__ __forceinline__ float cond_iir(float v, float w1, float a,
                                          float *filt)
{
    const float w0 = __fadd_rn(v, __fmul_rn(w1, a));
    *filt = __fsub_rn(w0, w1);
    return w0;
}

// env - max(0, min(v, env)), with NaN-propagating min and max
// (jnp.minimum / jnp.maximum and torch.minimum / clamp semantics)
__device__ __forceinline__ float cond_mod_depth_num(float v, float env)
{
    float c = (isnan(v) || isnan(env)) ? __int_as_float(0x7fc00000)
                                       : fminf(v, env);
    c = isnan(c) ? c : fmaxf(c, 0.0f);
    return __fsub_rn(env, c);
}

// mod_depth = (env - max(0, min(v, env))) / env
__device__ __forceinline__ float cond_mod_depth(float v, float env)
{
    return __fdiv_rn(cond_mod_depth_num(v, env), env);
}

// cond_mod_depth, bit for bit, with its most common special case taken
// apart: where the sample is at or above a positive envelope the
// numerator is +0 and so is the quotient, which this returns without
// dividing, because a zero numerator sends the correctly rounded divide
// down its slow path, a branch that splits the warp on about half of the
// steps of a magnitude capture.  Every other input divides as before.
__device__ __forceinline__ float cond_mod_depth_split(float v, float env)
{
    const float num = cond_mod_depth_num(v, env);
    const bool zero = (num == 0.0f) & (env > 0.0f);
    const float q = __fdiv_rn(zero ? env : num, env);
    return zero ? 0.0f : q;
}

// ---------------------------------------------------------------------------
// The mask kernels' SD threshold test, RN(n / p2) > y, with no divide.
//
// For 0 < y < FLT_MAX, RN(x) > y exactly when x > m or, at x = m, the tie
// rounds up, m = (y + succ(y)) / 2 the midpoint of y and its float
// successor; a tie goes to the even one of the two, so it rounds up when
// y's last bit is 1 (subnormal y included: the same grid, the same rule).
// With x = n / p2 and p2 > 0 that is n > p2 m, or n = p2 m and y odd.  m
// has at most 25 significant bits and p2 (a box width: 12, 24, 47, 94 in
// v2, 1 to 378 in the plans of 0.5 to 40 MS/s) at most 9, so m, p2 m and
// the comparison are exact in double, from the subnormals to FLT_MAX.
// n = +-inf and NaN compare as the quotient would; a negative n or -0 is
// not above a positive y either way.  y <= 0 (-0 included), y =
// FLT_MAX, +inf and NaN keep the correctly rounded divide: a rarely taken
// branch that is part of the semantics.  The A and F tests pass |n| (|RN(n
// / p2)| = RN(|n| / p2)), the V test its signed n.

// the midpoint m of y and its successor, for 0 < y < FLT_MAX
__device__ __forceinline__ double sd_midpoint(float y)
{
    const float up = __uint_as_float(__float_as_uint(y) + 1u);
    return __dmul_rn(__dadd_rn((double)y, (double)up), 0.5);
}

// RN(n / p2) > y for 0 < y < FLT_MAX, mid = sd_midpoint(y)
__device__ __forceinline__ bool sd_above_pos(float n, float y, double mid,
                                             double p2)
{
    const double lim = __dmul_rn(p2, mid);
    const double x = (double)n;
    return (x > lim) | ((x == lim) & ((__float_as_uint(y) & 1u) != 0u));
}

// y for which sd_above_pos does not hold: the divide decides
__device__ __forceinline__ bool sd_special(float y)
{
    return !(y > 0.0f && y < 0x1.fffffep127f);
}

// Exactly __fdiv_rn(n, p2) > y, given mid = sd_midpoint(y) and divide =
// sd_special(y) (or any superset of it)
__device__ __forceinline__ bool sd_above(float n, float y, double mid,
                                         double p2, bool divide)
{
    bool above = sd_above_pos(n, y, mid, p2);
    if (__builtin_expect(divide, 0)) above = __fdiv_rn(n, (float)p2) > y;
    return above;
}

// A float32 band in front of sd_above (ff_mask_kernel), for y in [2^-100,
// 2^100] and a divisor p2 with r = RN(1 / p2) normal.  With rlo = RN(r (1 -
// 2^-20)) and rhi = RN(r (1 + 2^-20)), qlo = RN(n rlo) and qhi = RN(n rhi)
// are n / p2 (1 -+ 2^-20) within a relative 2^-22 (three roundings of at
// most 2^-24 each, n / p2 normal).  So qlo > y puts n / p2 above y (1 +
// 2^-21), beyond the midpoint m(y) <= y (1 + 2^-24): RN(n / p2) > y; and
// qhi < y puts n / p2 below y (1 - 2^-21): RN(n / p2) <= y.  A subnormal
// or zero qhi is below y, and n / p2 with it; qlo = +inf is above, and n /
// p2 with it (n = +inf).  Where neither holds (n / p2 within about 2^-20
// y of y, or n NaN) the band leaves the test undecided for sd_above.  The
// A and F tests pass |n|, the V test its signed n, as for sd_above.
__device__ __forceinline__ bool sd_band(float n, float rlo, float rhi,
                                        float y, bool &undecided)
{
    const bool above = __fmul_rn(n, rlo) > y;
    const bool below = __fmul_rn(n, rhi) < y;
    undecided |= !(above | below);
    return above;
}

// ---------------------------------------------------------------------------
// The silence counter and the clock of the envelope chain (NfcTech.cpp:
// 39-53): each step counts, an update resets the count, a step that does
// not update takes v while the clock is below one ETU, and the count
// forces an update once it passes the timeout.

// int32 pulse count and per-stream int32 clock, wrapping like the TPU
// kernel's int32 arithmetic
struct CondPulseCounter {
    uint32_t pulse, clock;
    int32_t etu, silence;

    __device__ __forceinline__ void tick() { pulse += 1u; }
    __device__ __forceinline__ bool seeding() const
    {
        return (int32_t)clock < etu;
    }
    __device__ __forceinline__ bool expired() const
    {
        return (int32_t)pulse > silence;
    }
    __device__ __forceinline__ void settle(bool update)
    {
        pulse = update ? 0u : pulse;
        clock += 1u;
    }
    // no step of the group starting here seeds, and the clock does not
    // wrap inside it
    __device__ __forceinline__ bool past_seeding() const
    {
        const int32_t c = (int32_t)clock;
        return (c >= etu) & (c <= INT32_MAX - (COND_UNROLL - 1));
    }
};

// an integer-valued float count (exact far beyond the timeout; at 2^24
// it stops counting, still above it) and an int32 clock
struct CondFloatCounter {
    float pcount, silence;
    uint32_t clock;
    int32_t etu;

    __device__ __forceinline__ void tick()
    {
        pcount = __fadd_rn(pcount, 1.0f);
    }
    __device__ __forceinline__ bool seeding() const
    {
        return (int32_t)clock < etu;
    }
    __device__ __forceinline__ bool expired() const
    {
        return pcount > silence;
    }
    __device__ __forceinline__ void settle(bool update)
    {
        pcount = update ? 0.0f : pcount;
        clock += 1u;
    }
    __device__ __forceinline__ bool past_seeding() const
    {
        const int32_t c = (int32_t)clock;
        return (c >= etu) & (c <= INT32_MAX - (COND_UNROLL - 1));
    }
};

// ---------------------------------------------------------------------------
// The three independent chains of a step, each run by its own warp.  A
// chain's outputs go through a sink, which receives k, the step's index in
// its group (a constant once the group's loop is unrolled), and moves on
// by n elements at advance(n); done() follows the ragged tail.

// the envelope and its silence counter (NfcTech.cpp:39-53)
template <class Counter, class Sink>
struct CondEnvChain {
    float env;
    Counter cnt;
    float w0, w1;
    bool weights_a, weights_b;  // the weights of group's cases (a), (b)
    Sink sink;

    __device__ __forceinline__ void set_weights(float ew0, float ew1)
    {
        w0 = ew0;
        w1 = ew1;
        weights_a = ew0 >= 0.0f && ew0 <= 1.0f && ew1 >= 0x1p-40f
            && ew1 <= 1.0f;
        weights_b = ew0 >= 0.25f && ew0 <= 1.0f && ew1 >= 0.0f
            && ew1 <= 1.0f;
    }

    // Pos: env is known to be positive and finite (see group), so the
    // test is cond_env_near_pos alone.  The update EMA and the seed-or-hold
    // value do not wait for the test; the test picks between them.
    template <bool Pos>
    __device__ __forceinline__ void step(float v, int k)
    {
        cnt.tick();
        const float ema = cond_ema(env, w0, v, w1);
        const float other = cnt.seeding() ? v : env;
        const bool near = Pos ? cond_env_near_pos(v, env) : cond_env_near(v, env);
        const bool update = near || cnt.expired();
        env = update ? ema : other;
        cnt.settle(update);
        sink.put(k, env, cnt);
    }
    __device__ __forceinline__ void step(float v, int k) { step<false>(v, k); }

    // A group takes the Pos steps when, on every lane of the warp, env
    // stays positive and finite through the group's COND_UNROLL (16)
    // steps.  Two cases show it, each with env at most 2^100 and the
    // group's samples at most 2^100, so that an update, at most
    // 2 (1 + 2^-23) times the larger of env and v, keeps env below 2^117:
    //   (a) 0 <= w0 <= 1, 2^-40 <= w1 <= 1, env > 0 and every sample at
    //       least 2^-100: an update is at least v * w1 >= 2^-140 > 0, a
    //       seed is v;
    //   (b) 1/4 <= w0 <= 1, 0 <= w1 <= 1, env >= 2^-60, every sample at
    //       least 0 and no seed in the group: an update is at least
    //       env * w0 >= env / 4, above 2^-93 after 16 steps.
    // Neither case reads the silence count: whatever forces an update,
    // an update, a hold and a seed are the only outcomes, so the cases
    // hold for the int32 pulse and the float count alike.  (b) needs the
    // clock at least ETU at the group's first step and no int32 wrap
    // inside the group (Counter::past_seeding), with the per-stream clock,
    // the absolute clock and the call-local clock alike.  Magnitude
    // captures meet (b) after the first ETU and (a) wherever the field is
    // on.  Any other group (a negative sample, a special value) takes
    // cond_env_near with its rarely taken divide.  `pass` votes yes for a
    // lane past the last stream, whose steps store nothing.
    __device__ __forceinline__ bool positive_group(
        const float (&v)[COND_UNROLL], bool pass) const
    {
        bool positive = true, nonneg = true;
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) {
            const bool small = v[k] <= 0x1p100f;
            positive &= small & (v[k] >= 0x1p-100f);
            nonneg &= small & (v[k] >= 0.0f);
        }
        const bool small_env = env <= 0x1p100f;
        const bool a = weights_a & positive & (env > 0.0f) & small_env;
        const bool b = weights_b & nonneg & (env >= 0x1p-60f) & small_env
                       & cnt.past_seeding();
        return __all_sync(__activemask(), a | b | pass);
    }
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL],
                                          bool pass = false)
    {
        if (positive_group(v, pass)) {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k) step<true>(v[k], k);
        } else {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k) step<false>(v[k], k);
        }
    }
    __device__ __forceinline__ void advance(size_t n) { sink.advance(n); }
    __device__ __forceinline__ void done(int rem) { sink.done(rem); }
};

// The envelope chain two samples a step, pairwise-speculative
// (experiments/probe_pair_spec.py, pair_body): the second sample's test is
// taken against each envelope the first can leave -- the update c_u, the
// seed v1 and the hold env -- before the first sample is resolved, and the
// selects then pick one.  The float operations are CondEnvChain::step's,
// so the bits are too.  The group's vote covers the three candidates: c_u
// and v1 are envelopes the first step can leave (an update; a seed, which
// case (b) rules out and case (a) keeps at least 2^-100), and both cases
// hold under every sequence of decisions, so wherever a candidate can be
// selected it is positive and finite.  T is even, so the ragged tail is
// whole pairs: step() holds a pair's first sample until its second.
template <class Counter, class Sink>
struct CondPairChain : CondEnvChain<Counter, Sink> {
    float held;

    template <bool Pos>
    static __device__ __forceinline__ bool near(float v, float env)
    {
        return Pos ? cond_env_near_pos(v, env) : cond_env_near(v, env);
    }

    template <bool Pos>
    __device__ __forceinline__ void pair(float v1, float v2, int k)
    {
        float &env = this->env;
        Counter &cnt = this->cnt;
        // the four tests, none waiting for the first sample's outcome
        const float c_u = cond_ema(env, this->w0, v1, this->w1);
        const bool n1 = near<Pos>(v1, env);
        const bool n_u = near<Pos>(v2, c_u);
        const bool n_s = near<Pos>(v2, v1);
        const bool n_h = near<Pos>(v2, env);
        cnt.tick();
        const bool u1 = n1 || cnt.expired();
        const bool s1 = cnt.seeding();
        const float env1 = u1 ? c_u : (s1 ? v1 : env);
        const bool n2 = u1 ? n_u : (s1 ? n_s : n_h);
        cnt.settle(u1);
        this->sink.put(k, env1, cnt);
        cnt.tick();
        const float c2u = cond_ema(env1, this->w0, v2, this->w1);
        const bool u2 = n2 || cnt.expired();
        env = u2 ? c2u : (cnt.seeding() ? v2 : env1);
        cnt.settle(u2);
        this->sink.put(k + 1, env, cnt);
    }

    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL],
                                          bool pass = false)
    {
        if (this->positive_group(v, pass)) {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; k += 2) pair<true>(v[k], v[k + 1], k);
        } else {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; k += 2) pair<false>(v[k], v[k + 1], k);
        }
    }
    __device__ __forceinline__ void step(float v, int k)
    {
        if (k & 1)
            pair<false>(held, v, k - 1);
        else
            held = v;
    }
};
static_assert(COND_UNROLL % 2 == 0, "a group holds whole pairs");

// IIR DC removal (NfcTech.cpp:56-62) and the deviation EMA (:65-66); the
// w1 output only where the kernel has one (W1)
template <bool W1>
struct CondFiltChain {
    float w1, mdev;
    float a, w0m, w1m;
    uint32_t B;  // row stride of the outputs
    float *__restrict__ out_w1;
    float *__restrict__ out_filt;
    float *__restrict__ out_mdev;

    __device__ __forceinline__ void step(float v, int k)
    {
        const uint32_t o = (uint32_t)k * B;
        float filt;
        w1 = cond_iir(v, w1, a, &filt);
        mdev = cond_ema(mdev, w0m, fabsf(filt), w1m);
        if (W1) out_w1[o] = w1;
        out_filt[o] = filt;
        out_mdev[o] = mdev;
    }
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL])
    {
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) step(v[k], k);
    }
    __device__ __forceinline__ void advance(size_t n)
    {
        if (W1) out_w1 += n;
        out_filt += n;
        out_mdev += n;
    }
    __device__ __forceinline__ void done(int) {}
};

// the average EMA (NfcTech.cpp:67-68)
struct CondAvgChain {
    float avg;
    float w0, w1;
    uint32_t B;
    float *__restrict__ out_avg;

    __device__ __forceinline__ void step(float v, int k)
    {
        avg = cond_ema(avg, w0, v, w1);
        out_avg[(uint32_t)k * B] = avg;
    }
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL])
    {
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) step(v[k], k);
    }
    __device__ __forceinline__ void advance(size_t n) { out_avg += n; }
    __device__ __forceinline__ void done(int) {}
};

// One chain over the T samples of one stream: vp points at the stream's
// first sample, B is the row stride.  Groups of COND_UNROLL steps (the
// chain's group), the ragged tail one step at a time; the next group's
// samples are in flight while this one is computed.  Every access is a
// 32-bit offset from a pointer moved once a group.
template <class Chain>
__device__ __forceinline__ void cond_run(Chain &c, const float *__restrict__ vp,
                                         uint32_t B, int64_t T)
{
    const int64_t groups = T / COND_UNROLL;
    const int rem = (int)(T - groups * COND_UNROLL);
    const size_t stride = (size_t)COND_UNROLL * B;
    float cur[COND_UNROLL];
#pragma unroll
    for (int k = 0; k < COND_UNROLL; ++k)
        cur[k] = (groups > 0 || k < rem) ? vp[(uint32_t)k * B] : 0.0f;
    for (int64_t g = 0; g < groups; ++g) {
        const float *__restrict__ np = vp + stride;
        float nxt[COND_UNROLL];
        if (g + 1 < groups) {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k) nxt[k] = np[(uint32_t)k * B];
        } else {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k)
                nxt[k] = k < rem ? np[(uint32_t)k * B] : 0.0f;
        }
        c.group(cur);
        c.advance(stride);
        vp = np;
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) cur[k] = nxt[k];
    }
#pragma unroll
    for (int k = 0; k < COND_UNROLL; ++k)
        if (k < rem) c.step(cur[k], k);
    c.done(rem);
}
