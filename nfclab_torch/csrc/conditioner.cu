// Conditioning scan for Hopper (sm_90a): the NFC conditioning chain alone
// (envelope, IIR DC filter, deviation and average EMAs, NfcTech.cpp:39-68)
// for many independent streams, each from its own initial state and clock.
//
// Replaces the Pallas kernel nfclab/dsp/pallas/conditioner_kernel.py::
// _kernel (launched by _jitted_kernel through condition_scan_pallas).
// Its contract is kept without its TPU tiling: the TPU kernel takes
// value[G, T, 8, 128] with B % 1024 == 0 and T % 256 == 0 because of its
// (8, 128) lane tiles and 256-sample time tiles; this one takes any B >= 1
// and T >= 1.
//
//   cond_scan_kernel  one thread per stream, serial over T.  Samples and
//                     outputs are time-major [T, B], so the 32 threads of a
//                     warp load and store 32 neighbouring words at every
//                     step.  Initial state: env, w1, mdev, avg (f32) and
//                     pulse, clock (i32), one [B] row each.  Outputs: env,
//                     w1, mdev, avg, filt (f32) and pulse (i32), each
//                     [T, B].
//
// What bounds it on this card: it moves 28 bytes per sample (4 in, 24
// out), so 1024 x 65536 samples take at least 0.56 ms at 3.35 TB/s, and
// it does ~20 float operations per sample, far below the 67 TFLOP/s f32
// peak; on paper it is memory-bound.  In fact it is latency-bound: the
// recurrence is serial in time, so one stream is one thread, and 1024
// streams are 32 warps -- one warp on each of 32 of the 132 SMs, each
// walking 65536 dependent steps whose critical path (the envelope's
// subtract, correctly rounded divide, compare and select) is tens of
// cycles long.  The design keeps global-load latency off that path: each
// thread loads COND_UNROLL samples ahead into registers while it works on
// the current ones, and stores never wait.  More streams per call (or a
// stream split across threads, as the block-parallel condition_jax does
// with halo blocks) is what fills the card.
//
// Numerics: bit-exact with the C++ oracle (built -ffp-contract=off); the
// float step is condition_step.cuh, all explicit round-to-nearest
// intrinsics, and the library is built -fmad=false -prec-div=true.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "condition_step.cuh"

#define COND_UNROLL 16

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

__global__ void cond_scan_kernel(const CondScanArgs a)
{
    const int64_t B = a.B;
    const int64_t T = a.T;
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const float *__restrict__ value = a.value;
    float env = a.env0[b];
    float w1 = a.w10[b];
    float mdev = a.mdev0[b];
    float avg = a.avg0[b];
    // the counters wrap like the TPU kernel's int32 arithmetic
    uint32_t pulse = (uint32_t)a.pulse0[b];
    uint32_t clock = (uint32_t)a.clock0[b];
    const int32_t etu = a.etu;
    const int32_t silence = etu * 10;

    float cur[COND_UNROLL], nxt[COND_UNROLL];
#pragma unroll
    for (int k = 0; k < COND_UNROLL; ++k)
        cur[k] = k < T ? value[(int64_t)k * B + b] : 0.0f;

    for (int64_t j0 = 0; j0 < T; j0 += COND_UNROLL) {
        // the next samples are in flight while this group is computed
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) {
            const int64_t j = j0 + COND_UNROLL + k;
            nxt[k] = j < T ? value[j * B + b] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) {
            const int64_t j = j0 + k;
            if (j < T) {
                const float v = cur[k];
                // conditional envelope (NfcTech.cpp:39-53)
                pulse += 1u;
                const float diff = cond_env_diff(v, env);
                const bool update = (diff < 0.05f) || ((int32_t)pulse > silence);
                const bool seed = !update && ((int32_t)clock < etu);
                env = update ? cond_ema(env, a.enve_w0, v, a.enve_w1)
                             : (seed ? v : env);
                pulse = update ? 0u : pulse;
                // IIR DC removal (NfcTech.cpp:56-62)
                float filt;
                w1 = cond_iir(v, w1, a.iir_a, &filt);
                // deviation and average EMAs (NfcTech.cpp:65-68)
                mdev = cond_ema(mdev, a.mdev_w0, fabsf(filt), a.mdev_w1);
                avg = cond_ema(avg, a.mean_w0, v, a.mean_w1);
                clock += 1u;

                const int64_t o = j * B + b;
                a.env[o] = env;
                a.w1[o] = w1;
                a.mdev[o] = mdev;
                a.avg[o] = avg;
                a.filt[o] = filt;
                a.pulse[o] = (int32_t)pulse;
            }
        }
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) cur[k] = nxt[k];
    }
}

extern "C" {

// Queues the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 = queued).  B and T must be at least 1.
int nfclab_cond_scan(const CondScanArgs *a, int device, int threads,
                     void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->B + threads - 1) / threads;
    cond_scan_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
