// The float arithmetic of one step of the NFC conditioning chain
// (NfcTech.cpp:39-68) and of mod_depth (NfcTech.cpp:71-74), shared by
// ff_scan_kernel and ff_mask_kernel (fused_frontend.cu), cond_scan_kernel
// (conditioner.cu), v2_scan_kernel (fused_v2.cu) and the conditioning
// probes (probes.cu).  The envelope test comes in two forms with the same
// result: ff_scan_kernel and cond_scan_kernel take cond_env_near and
// cond_env_near_pos (no divide where env is positive and finite),
// v2_scan_kernel and the probes the quotient cond_env_diff.
//
// The contract is bit-exactness with the C++ oracle, which is built with
// -ffp-contract=off: every operation is an explicit round-to-nearest
// intrinsic, so no FMA contraction or approximate division can creep in
// whatever the build flags.  The counter logic (silence timeout, seeding)
// stays with each kernel: the fused kernel keeps a float silence counter
// and an absolute clock base, the conditioning kernel an int32 pulse count
// and a per-stream int32 clock.

#pragma once

#include <math.h>

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

// (env - max(0, min(v, env))) / env, with NaN-propagating min and max
// (jnp.minimum / jnp.maximum and torch.minimum / clamp semantics)
__device__ __forceinline__ float cond_mod_depth(float v, float env)
{
    float c = (isnan(v) || isnan(env)) ? __int_as_float(0x7fc00000)
                                       : fminf(v, env);
    c = isnan(c) ? c : fmaxf(c, 0.0f);
    return __fdiv_rn(__fsub_rn(env, c), env);
}
