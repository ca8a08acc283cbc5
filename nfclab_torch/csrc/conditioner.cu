// Conditioning scan for Hopper (sm_90a): the NFC conditioning chain alone
// (envelope, IIR DC filter, deviation and average EMAs, NfcTech.cpp:39-68)
// for many independent streams, each from its own initial state and clock.
//
// Replaces the Pallas kernel nfclab/dsp/pallas/conditioner_kernel.py::
// _kernel (launched by _jitted_kernel through condition_scan_pallas).
// Its contract is kept without its TPU tiling: the TPU kernel takes
// value[G, T, 8, 128] with B % 1024 == 0 and T % 256 == 0 because of its
// (8, 128) lane tiles and 256-sample time tiles; this one takes any
// 1 <= B <= 2^27 and T >= 1.
//
//   cond_scan_kernel  a block serves 32 streams, one lane each, with three
//                     warps, one for each independent chain of the step:
//                       warp 0  envelope + pulse count (the critical one),
//                       warp 1  w1 -> filt -> mdev,
//                       warp 2  avg.
//                     Each warp reads the same samples and writes only its
//                     own outputs, so the warps never wait for each other
//                     (no barrier, no shared memory).  Samples and outputs
//                     are time-major [T, B], so the 32 lanes of a warp load
//                     and store 32 neighbouring words at every step.
//                     Initial state: env, w1, mdev, avg (f32) and pulse,
//                     clock (i32), one [B] row each.  Outputs: env, w1,
//                     mdev, avg, filt (f32) and pulse (i32), each [T, B].
//
// What bounds it on this card: it moves 28 bytes per sample (4 in, 24
// out), so 1024 x 65536 samples take at least 0.56 ms at 3.35 TB/s, and
// it does ~20 float operations per sample, far below the 67 TFLOP/s f32
// peak; on paper it is memory-bound.  In fact it is latency-bound: the
// recurrence is serial in time, so one stream is one lane, and 1024
// streams are 32 blocks on 32 of the 132 SMs, each walking 65536 dependent
// steps, so the envelope chain's latency per step sets the time.  What
// this design does about that chain:
//   - No divide: |v - env| <= m * env in exact double arithmetic
//     (cond_env_near_pos) replaces the correctly rounded quotient.
//   - No branch in a step: the quotient's IEEE cases (env <= 0, +inf,
//     NaN) need one, so the warp decides once a group, with a vote,
//     whether env stays positive and finite through the group (it does
//     for magnitude samples after the first ETU, see CondEnvChain::group);
//     such groups take the test alone, any other group cond_env_near with
//     its rarely taken divide.
//   - Nothing waits for the test but the select: the update EMA and the
//     seed-or-hold value are computed beside it.
//   - The three chains issue from three warps, so the envelope warp
//     issues only its own chain and two stores.
//   - Loads run COND_UNROLL samples ahead in registers; whole groups run
//     without bounds checks (the ragged tail apart), and every access is a
//     32-bit offset, advanced by B, from a pointer moved once a group.
// What still bounds it: one serial chain per stream and 32 streams per SM,
// so at 1024 streams 100 SMs stay idle; time parallelism (a stream split
// across threads, as the block-parallel condition_jax does with halo
// blocks) is what fills the card.
//
// Numerics: bit-exact with the C++ oracle (built -ffp-contract=off); the
// float step is condition_step.cuh, all explicit round-to-nearest
// intrinsics, and the library is built -fmad=false -prec-div=true
// -ftz=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "condition_step.cuh"

#define COND_UNROLL 16
#define COND_WARPS 3   // envelope + pulse, w1 -> filt -> mdev, avg

extern "C" {

struct CondScanArgs {
    const float *value;      // [T, B]
    const float *env0;       // [B]
    const float *w10;        // [B]
    const float *mdev0;      // [B]
    const float *avg0;       // [B]
    const int32_t *pulse0;   // [B]
    const int32_t *clock0;   // [B]
    float *env;              // [T, B]
    float *w1;               // [T, B]
    float *mdev;             // [T, B]
    float *avg;              // [T, B]
    float *filt;             // [T, B]
    int32_t *pulse;          // [T, B]
    int64_t B;
    int64_t T;
    int32_t etu;
    float enve_w0, enve_w1, mdev_w0, mdev_w1, mean_w0, mean_w1, iir_a;
};

}  // extern "C"

// the envelope and its silence counter (NfcTech.cpp:39-53); the counters
// wrap like the TPU kernel's int32 arithmetic
struct CondEnvChain {
    float env;
    uint32_t pulse, clock;
    int32_t etu, silence;
    float w0, w1;
    bool weights_a, weights_b;  // the weights of group's cases (a), (b)
    float *__restrict__ out_env;
    int32_t *__restrict__ out_pulse;

    // Pos: env is known to be positive and finite (see group), so the
    // test is cond_env_near_pos alone.  The update EMA and the seed-or-hold
    // value do not wait for the test; the test picks between them.
    template <bool Pos>
    __device__ __forceinline__ void step(float v, uint32_t o)
    {
        pulse += 1u;
        const float ema = cond_ema(env, w0, v, w1);
        const float other = ((int32_t)clock < etu) ? v : env;
        const bool near = Pos ? cond_env_near_pos(v, env) : cond_env_near(v, env);
        const bool update = near || ((int32_t)pulse > silence);
        env = update ? ema : other;
        pulse = update ? 0u : pulse;
        clock += 1u;
        out_env[o] = env;
        out_pulse[o] = (int32_t)pulse;
    }
    __device__ __forceinline__ void step(float v, uint32_t o)
    {
        step<false>(v, o);
    }
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
    // Magnitude captures meet (b) after the first ETU and (a) wherever the
    // field is on.  Any other group (a negative sample, a special value)
    // takes cond_env_near with its rarely taken divide.
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL],
                                          uint32_t B)
    {
        bool positive = true, nonneg = true;
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) {
            const bool small = v[k] <= 0x1p100f;
            positive &= small & (v[k] >= 0x1p-100f);
            nonneg &= small & (v[k] >= 0.0f);
        }
        const int32_t c = (int32_t)clock;
        const bool small_env = env <= 0x1p100f;
        const bool a = weights_a & positive & (env > 0.0f) & small_env;
        const bool b = weights_b & nonneg & (env >= 0x1p-60f) & small_env
                       & (c >= etu) & (c <= INT32_MAX - (COND_UNROLL - 1));
        if (__all_sync(__activemask(), a | b)) {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k)
                step<true>(v[k], (uint32_t)k * B);
        } else {
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k)
                step<false>(v[k], (uint32_t)k * B);
        }
    }
    __device__ __forceinline__ void advance(size_t n)
    {
        out_env += n;
        out_pulse += n;
    }
};

// IIR DC removal (NfcTech.cpp:56-62) and the deviation EMA (:65-66)
struct CondFiltChain {
    float w1, mdev;
    float a, w0m, w1m;
    float *__restrict__ out_w1;
    float *__restrict__ out_filt;
    float *__restrict__ out_mdev;

    __device__ __forceinline__ void step(float v, uint32_t o)
    {
        float filt;
        w1 = cond_iir(v, w1, a, &filt);
        mdev = cond_ema(mdev, w0m, fabsf(filt), w1m);
        out_w1[o] = w1;
        out_filt[o] = filt;
        out_mdev[o] = mdev;
    }
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL],
                                          uint32_t B)
    {
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) step(v[k], (uint32_t)k * B);
    }
    __device__ __forceinline__ void advance(size_t n)
    {
        out_w1 += n;
        out_filt += n;
        out_mdev += n;
    }
};

// the average EMA (NfcTech.cpp:67-68)
struct CondAvgChain {
    float avg;
    float w0, w1;
    float *__restrict__ out_avg;

    __device__ __forceinline__ void step(float v, uint32_t o)
    {
        avg = cond_ema(avg, w0, v, w1);
        out_avg[o] = avg;
    }
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL],
                                          uint32_t B)
    {
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) step(v[k], (uint32_t)k * B);
    }
    __device__ __forceinline__ void advance(size_t n) { out_avg += n; }
};

// One chain over the T samples of one stream: vp points at the stream's
// first sample, B is the row stride.  Groups of COND_UNROLL steps (the
// chain's group), the ragged tail one step at a time; the next group's
// samples are in flight while this one is computed.
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
        c.group(cur, B);
        c.advance(stride);
        vp = np;
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) cur[k] = nxt[k];
    }
#pragma unroll
    for (int k = 0; k < COND_UNROLL; ++k)
        if (k < rem) c.step(cur[k], (uint32_t)k * B);
}

__global__ void __launch_bounds__(COND_WARPS * 32)
cond_scan_kernel(const CondScanArgs a)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t b = (int64_t)blockIdx.x * 32 + lane;
    if (b >= a.B) return;  // no barrier below: every warp walks on its own
    const uint32_t B = (uint32_t)a.B;
    const float *__restrict__ vp = a.value + b;

    if (warp == 0) {
        CondEnvChain c;
        c.env = a.env0[b];
        c.pulse = (uint32_t)a.pulse0[b];
        c.clock = (uint32_t)a.clock0[b];
        c.etu = a.etu;
        c.silence = a.etu * 10;
        c.w0 = a.enve_w0;
        c.w1 = a.enve_w1;
        c.weights_a = a.enve_w0 >= 0.0f && a.enve_w0 <= 1.0f
            && a.enve_w1 >= 0x1p-40f && a.enve_w1 <= 1.0f;
        c.weights_b = a.enve_w0 >= 0.25f && a.enve_w0 <= 1.0f
            && a.enve_w1 >= 0.0f && a.enve_w1 <= 1.0f;
        c.out_env = a.env + b;
        c.out_pulse = a.pulse + b;
        cond_run(c, vp, B, a.T);
    } else if (warp == 1) {
        CondFiltChain c;
        c.w1 = a.w10[b];
        c.mdev = a.mdev0[b];
        c.a = a.iir_a;
        c.w0m = a.mdev_w0;
        c.w1m = a.mdev_w1;
        c.out_w1 = a.w1 + b;
        c.out_filt = a.filt + b;
        c.out_mdev = a.mdev + b;
        cond_run(c, vp, B, a.T);
    } else {
        CondAvgChain c;
        c.avg = a.avg0[b];
        c.w0 = a.mean_w0;
        c.w1 = a.mean_w1;
        c.out_avg = a.avg + b;
        cond_run(c, vp, B, a.T);
    }
}

extern "C" {

// Queues the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 = queued).  `threads` must be COND_WARPS * 32 (a block serves
// 32 streams); B must lie in [1, 2^27] (32-bit offsets reach 32 rows) and
// T must be at least 1.
int nfclab_cond_scan(const CondScanArgs *a, int device, int threads,
                     void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (threads != COND_WARPS * 32 || a->B < 1 || a->B > (1LL << 27)
        || a->T < 1)
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (a->B + 31) / 32;
    cond_scan_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
