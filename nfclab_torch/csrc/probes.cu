// The measurement probes of experiments/ for Hopper (sm_90a): an HBM
// streaming copy and two forms of the NFC conditioning chain alone.
//
//   copy_probe_kernel    replaces experiments/membw_probe.py::copy_kernel
//                        (in main, launched by chain -> pl.pallas_call):
//                        out_i = x * scale_i for NOUT outputs, `sweeps`
//                        full passes over x in one launch.
//   serial_probe_kernel  replaces experiments/probe_serial_floor.py::kernel
//                        (in main, built by build -> pl.pallas_call), and
//                        experiments/probe_pair_spec.py::kernel in its
//                        MODE=serial form (serial_body): the conditioning
//                        chain from a zero carry, one sample a step.
//   pair_probe_kernel    replaces experiments/probe_pair_spec.py::kernel in
//                        its MODE=pair form (pair_body): the same function,
//                        two samples a step, with the second sample's
//                        envelope quotient computed for all three outcomes
//                        of the first (update, seed, hold) before the first
//                        is resolved.
//
// The copy probe is bound by bytes: each sweep reads x once and writes
// NOUT outputs, 4 * (1 + NOUT) bytes per element, against 3.35 TB/s.  The
// design keeps every byte of every sweep on the bus: 16-byte loads and
// stores in a grid-stride loop with the sweep loop outermost, issued as
// volatile PTX, so the compiler can neither hoist the load out of the
// sweeps nor merge the sweeps' identical stores to one address.
//
// The conditioning probes are bound by latency, not by bytes (24 B per
// sample, 4 in and 20 out) or operations (~25 per sample): the recurrence
// is serial in time, so a lane is a thread and each thread walks T
// dependent steps whose critical path runs through the correctly rounded
// divide of the envelope test.  They measure that floor.  As in
// cond_scan_kernel, each thread loads PROBE_UNROLL samples ahead into
// registers, so global-load latency stays off the chain; the pair kernel
// keeps its three speculative quotients as separate divides that do not
// depend on the first sample's decision.
//
// Layout: value and outputs are [G, T, L] f32, lane l of group g at
// (g * T + t) * L + l, so a warp's 32 lanes load and store 32 neighbouring
// words at every step (the Pallas [g, t, sub, 128] tiles flattened in their
// last two axes).  Numerics: every float operation is an explicit
// round-to-nearest intrinsic (condition_step.cuh), the library is built
// -fmad=false -prec-div=true -ftz=false, and comparisons with NaN are
// false, as in IEEE and XLA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "condition_step.cuh"

#define PROBE_MAX_NOUT 32
#define PROBE_UNROLL 16   // even: the pair kernel consumes two at a time

extern "C" {

struct CopyProbeArgs {
    const float *x;                 // [n]
    float *out[PROBE_MAX_NOUT];     // nout x [n]
    float scale[PROBE_MAX_NOUT];    // float32(1 + 1e-7 * i), from the host
    int64_t n;
    int32_t nout;
    int32_t sweeps;
};

struct ProbeArgs {
    const float *value;             // [G, T, L]
    float *env, *filt, *mdev, *avg, *mod_depth;  // [G, T, L]
    int64_t G, T, L;
    int32_t etu;
    float silence;                  // float(etu * 10)
    float enve_w0, enve_w1, mdev_w0, mdev_w1, mean_w0, mean_w1, iir_a;
};

}  // extern "C"

__device__ __forceinline__ float4 probe_ld4(const float *p)
{
    float4 v;
    asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
}

__device__ __forceinline__ void probe_st4(float *p, float4 v)
{
    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
}

__global__ void copy_probe_kernel(const CopyProbeArgs a)
{
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t n4 = a.n / 4;  // x and every output are 16-byte aligned
    for (int k = 0; k < a.sweeps; ++k) {
        for (int64_t i = i0; i < n4; i += stride) {
            const float4 v = probe_ld4(a.x + 4 * i);
            for (int o = 0; o < a.nout; ++o) {
                const float s = a.scale[o];
                probe_st4(a.out[o] + 4 * i,
                          make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s),
                                      __fmul_rn(v.z, s), __fmul_rn(v.w, s)));
            }
        }
        for (int64_t i = 4 * n4 + i0; i < a.n; i += stride) {
            const float v = *(volatile const float *)(a.x + i);
            for (int o = 0; o < a.nout; ++o)
                *(volatile float *)(a.out[o] + i) = __fmul_rn(v, a.scale[o]);
        }
    }
}

// One conditioning step (NfcTech.cpp:39-68) on the probe's carry; t is
// the call-local clock.
__device__ __forceinline__ void probe_step(const ProbeArgs &a, float v,
                                            int64_t t, float &env,
                                            float &w1, float &mdev,
                                            float &avg, float &pcount,
                                            float &filt)
{
    const float diff = cond_env_diff(v, env);
    pcount = __fadd_rn(pcount, 1.0f);
    const bool update = (diff < 0.05f) || (pcount > a.silence);
    const bool seed = !update && (t < a.etu);
    env = update ? cond_ema(env, a.enve_w0, v, a.enve_w1) : (seed ? v : env);
    pcount = update ? 0.0f : pcount;
    w1 = cond_iir(v, w1, a.iir_a, &filt);
    mdev = cond_ema(mdev, a.mdev_w0, fabsf(filt), a.mdev_w1);
    avg = cond_ema(avg, a.mean_w0, v, a.mean_w1);
}

__device__ __forceinline__ void probe_store(const ProbeArgs &a, int64_t o,
                                            float v, float env, float filt,
                                            float mdev, float avg)
{
    a.env[o] = env;
    a.filt[o] = filt;
    a.mdev[o] = mdev;
    a.avg[o] = avg;
    a.mod_depth[o] = cond_mod_depth(v, env);
}

__global__ void serial_probe_kernel(const ProbeArgs a)
{
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= a.G * a.L) return;
    const int64_t g = idx / a.L;
    const int64_t L = a.L, T = a.T;
    const int64_t o0 = g * T * L + (idx - g * L);
    const float *__restrict__ value = a.value;

    float env = 0.0f, w1 = 0.0f, mdev = 0.0f, avg = 0.0f, pcount = 0.0f;
    float cur[PROBE_UNROLL], nxt[PROBE_UNROLL];
#pragma unroll
    for (int k = 0; k < PROBE_UNROLL; ++k)
        cur[k] = k < T ? value[o0 + k * L] : 0.0f;

    for (int64_t j0 = 0; j0 < T; j0 += PROBE_UNROLL) {
        // the next samples are in flight while this group is computed
#pragma unroll
        for (int k = 0; k < PROBE_UNROLL; ++k) {
            const int64_t j = j0 + PROBE_UNROLL + k;
            nxt[k] = j < T ? value[o0 + j * L] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < PROBE_UNROLL; ++k) {
            const int64_t j = j0 + k;
            if (j < T) {
                float filt;
                probe_step(a, cur[k], j, env, w1, mdev, avg, pcount, filt);
                probe_store(a, o0 + j * L, cur[k], env, filt, mdev, avg);
            }
        }
#pragma unroll
        for (int k = 0; k < PROBE_UNROLL; ++k) cur[k] = nxt[k];
    }
}

// T is even (checked by the wrapper)
__global__ void pair_probe_kernel(const ProbeArgs a)
{
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= a.G * a.L) return;
    const int64_t g = idx / a.L;
    const int64_t L = a.L, T = a.T;
    const int64_t o0 = g * T * L + (idx - g * L);
    const float *__restrict__ value = a.value;

    float env = 0.0f, w1 = 0.0f, mdev = 0.0f, avg = 0.0f, pcount = 0.0f;
    float cur[PROBE_UNROLL], nxt[PROBE_UNROLL];
#pragma unroll
    for (int k = 0; k < PROBE_UNROLL; ++k)
        cur[k] = k < T ? value[o0 + k * L] : 0.0f;

    for (int64_t j0 = 0; j0 < T; j0 += PROBE_UNROLL) {
#pragma unroll
        for (int k = 0; k < PROBE_UNROLL; ++k) {
            const int64_t j = j0 + PROBE_UNROLL + k;
            nxt[k] = j < T ? value[o0 + j * L] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < PROBE_UNROLL; k += 2) {
            const int64_t t = j0 + k;
            if (t < T) {
                const float v1 = cur[k], v2 = cur[k + 1];
                // envelope chain: sample 2's quotient for each outcome of
                // sample 1, before sample 1 is resolved
                const float c_u = cond_ema(env, a.enve_w0, v1, a.enve_w1);
                const float d1 = cond_env_diff(v1, env);
                const float e_u = cond_env_diff(v2, c_u);
                const float e_s = cond_env_diff(v2, v1);
                const float e_h = cond_env_diff(v2, env);
                const float p1 = __fadd_rn(pcount, 1.0f);
                const bool u1 = (d1 < 0.05f) || (p1 > a.silence);
                const bool s1 = !u1 && (t < a.etu);
                const float env1 = u1 ? c_u : (s1 ? v1 : env);
                const float pc1 = u1 ? 0.0f : p1;
                const float d2 = u1 ? e_u : (s1 ? e_s : e_h);
                const float p2 = __fadd_rn(pc1, 1.0f);
                const bool u2 = (d2 < 0.05f) || (p2 > a.silence);
                const bool s2 = !u2 && (t + 1 < a.etu);
                const float c2u = cond_ema(env1, a.enve_w0, v2, a.enve_w1);
                const float env2 = u2 ? c2u : (s2 ? v2 : env1);
                pcount = u2 ? 0.0f : p2;
                env = env2;

                // the linear chains, unrolled twice
                float filt1, filt2;
                const float w0a = cond_iir(v1, w1, a.iir_a, &filt1);
                w1 = cond_iir(v2, w0a, a.iir_a, &filt2);
                const float mdev1 = cond_ema(mdev, a.mdev_w0, fabsf(filt1),
                                             a.mdev_w1);
                mdev = cond_ema(mdev1, a.mdev_w0, fabsf(filt2), a.mdev_w1);
                const float avg1 = cond_ema(avg, a.mean_w0, v1, a.mean_w1);
                avg = cond_ema(avg1, a.mean_w0, v2, a.mean_w1);

                probe_store(a, o0 + t * L, v1, env1, filt1, mdev1, avg1);
                probe_store(a, o0 + (t + 1) * L, v2, env2, filt2, mdev, avg);
            }
        }
#pragma unroll
        for (int k = 0; k < PROBE_UNROLL; ++k) cur[k] = nxt[k];
    }
}

extern "C" {

// Each launcher queues its kernel on `stream` and returns
// cudaGetLastError() after the launch (0 = queued).
int nfclab_copy_probe(const CopyProbeArgs *a, int device, int blocks,
                      int threads, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    copy_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

int nfclab_cond_probe(const ProbeArgs *a, int pair, int device, int threads,
                      void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->G * a->L + threads - 1) / threads;
    if (pair)
        pair_probe_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(*a);
    else
        serial_probe_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
