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
// The chains (CondEnvChain with CondPulseCounter, CondFiltChain,
// CondAvgChain) and cond_run live in condition_step.cuh, where
// serial_probe_kernel and v2_scan_kernel's envelope warp take them with
// their float silence count.
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

// where the envelope chain's outputs go: the envelope and the pulse count
// at each step
struct CondPulseSink {
    uint32_t B;
    float *__restrict__ out_env;
    int32_t *__restrict__ out_pulse;

    __device__ __forceinline__ void put(int k, float env,
                                        const CondPulseCounter &c)
    {
        const uint32_t o = (uint32_t)k * B;
        out_env[o] = env;
        out_pulse[o] = (int32_t)c.pulse;
    }
    __device__ __forceinline__ void advance(size_t n)
    {
        out_env += n;
        out_pulse += n;
    }
    __device__ __forceinline__ void done(int) {}
};

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
        CondEnvChain<CondPulseCounter, CondPulseSink> c;
        c.env = a.env0[b];
        c.cnt.pulse = (uint32_t)a.pulse0[b];
        c.cnt.clock = (uint32_t)a.clock0[b];
        c.cnt.etu = a.etu;
        c.cnt.silence = a.etu * 10;
        c.set_weights(a.enve_w0, a.enve_w1);
        c.sink.B = B;
        c.sink.out_env = a.env + b;
        c.sink.out_pulse = a.pulse + b;
        cond_run(c, vp, B, a.T);
    } else if (warp == 1) {
        CondFiltChain<true> c;
        c.w1 = a.w10[b];
        c.mdev = a.mdev0[b];
        c.a = a.iir_a;
        c.w0m = a.mdev_w0;
        c.w1m = a.mdev_w1;
        c.B = B;
        c.out_w1 = a.w1 + b;
        c.out_filt = a.filt + b;
        c.out_mdev = a.mdev + b;
        cond_run(c, vp, B, a.T);
    } else {
        CondAvgChain c;
        c.avg = a.avg0[b];
        c.w0 = a.mean_w0;
        c.w1 = a.mean_w1;
        c.B = B;
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
