// The float arithmetic of one step of the NFC conditioning chain
// (NfcTech.cpp:39-68), shared by ff_scan_kernel (fused_frontend.cu) and
// cond_scan_kernel (conditioner.cu).
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
