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
//                        envelope test taken for all three outcomes of the
//                        first (update, seed, hold) before the first is
//                        resolved.
//
// The copy probe is bound by bytes: each sweep reads x once and writes
// NOUT outputs, 4 * (1 + NOUT) bytes per element, against 3.35 TB/s.  The
// design keeps every byte of every sweep on the bus: 16-byte loads and
// stores in a grid-stride loop with the sweep loop outermost, issued as
// volatile PTX, so the compiler can neither hoist the load out of the
// sweeps nor merge the sweeps' identical stores to one address.
//
// The conditioning probes are bound by latency, not by bytes (24 B per
// sample, 4 in and 20 out: 0.96 ms per 1 x 65536 x 2048 at 3.35 TB/s) or
// operations (~25 per sample): the recurrence is serial in time, so a lane
// is a thread, 2048 lanes are 64 blocks of 32 on 64 of the 132 SMs, and
// each walks T dependent steps.  The probes exist to read that floor, so
// both take the design cond_scan_kernel takes:
//   - No divide in the envelope test: |v - env| <= m * env in exact double
//     arithmetic (cond_env_near_pos).
//   - No branch in a step: a warp vote once per group of COND_UNROLL steps
//     (CondEnvChain::positive_group) decides that env stays positive and
//     finite; the cases hold for the probe's float count and call-local
//     clock.
//   - One warp per chain (envelope + count; w1 -> filt -> mdev; avg), so
//     the envelope warp issues only its own chain and one store a step.
//   - mod_depth's divide, which feeds nothing back, off the chain: two
//     warps take env from the envelope warp through a shared ring of
//     PROBE_ENV_STAGES groups behind mbarriers, and divide there, skipping
//     the zero numerator (cond_mod_depth_split).
//   - Samples loaded COND_UNROLL ahead in registers, 32-bit offsets, whole
//     groups without bounds checks and the ragged tail apart (cond_run).
// The two differ only in the envelope warp's chain: serial_probe_kernel
// steps one sample at a time (CondEnvChain), pair_probe_kernel two, with
// the second sample's test taken for each of the first's outcomes before
// the first is resolved (CondPairChain): the speculation its experiment
// measures, now against the same design without it.  What still bounds
// them: the envelope chain's latency per step, on 64 SMs at one group.

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

#include <type_traits>

#include "condition_step.cuh"
#include "smem_stage.cuh"

#define PROBE_MAX_NOUT 32

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

// ---------------------------------------------------------------------------
// The conditioning probes: the conditioning scan's design with the probe's
// float counter and call-local clock.  A block serves 32 lanes, one per
// thread, with PROBE_WARPS warps, one per chain, mod_depth on two:
//   warp 0     envelope + float silence counter (CondEnvChain, or
//              CondPairChain in the pair probe, with CondFloatCounter):
//              env, and env into the shared stage ring
//   warp 1     w1 -> filt -> mdev: filt, mdev
//   warp 2     avg
//   warps 3-4  mod_depth, from their own samples and env taken from the
//              ring, each every other group: a correctly rounded divide
//              ends in a branch, so one warp's divides run one after the
//              other (~27 ns a step on an H100, measured), above the
//              envelope chain's pace
// Each warp loads its own samples COND_UNROLL ahead (cond_run).  The ring
// holds PROBE_ENV_STAGES groups of COND_UNROLL rows x 32 lanes; each stage
// has a "full" mbarrier (the envelope warp wrote it) and an "empty" one
// (its mod_depth warp read it), each counting one arrival per lane of the
// block that holds a lane of the probe.

#define PROBE_DEPTH_WARPS 2
#define PROBE_WARPS (3 + PROBE_DEPTH_WARPS)
#define PROBE_ENV_STAGES 8
static_assert(PROBE_ENV_STAGES % PROBE_DEPTH_WARPS == 0,
              "each stage has one mod_depth warp");

struct ProbeStages {
    float *ring;      // [PROBE_ENV_STAGES][COND_UNROLL][32], at the lane
    uint64_t *full;
    uint64_t *empty;
};

// the envelope warp's sink: env to global memory and to the stage ring;
// a stage is handed over after its group (or the ragged tail)
struct ProbeEnvSink {
    uint32_t L;
    float *__restrict__ out;
    ProbeStages st;
    uint32_t stage, round;

    __device__ __forceinline__ void put(int k, float env,
                                        const CondFloatCounter &)
    {
        out[(uint32_t)k * L] = env;
        st.ring[(stage * COND_UNROLL + k) * 32] = env;
    }
    __device__ __forceinline__ void advance(size_t n)
    {
        out += n;
        mbar_arrive(st.full + stage);
        if (++stage == PROBE_ENV_STAGES) {
            stage = 0;
            ++round;
        }
        if (round > 0) mbar_wait(st.empty + stage, (round - 1) & 1u);
    }
    __device__ __forceinline__ void done(int rem)
    {
        if (rem > 0) mbar_arrive(st.full + stage);
    }
};

// mod_depth (NfcTech.cpp:71-74): the divide feeds nothing back, so it runs
// off the envelope chain, on the warp that owns the group's stage (stage
// % PROBE_DEPTH_WARPS == w); the other warps' groups pass by
struct ProbeDepthChain {
    uint32_t L;
    float *__restrict__ out;
    ProbeStages st;
    uint32_t stage, round, w;

    __device__ __forceinline__ bool mine() const
    {
        return stage % PROBE_DEPTH_WARPS == w;
    }

    __device__ __forceinline__ const float *wait_stage()
    {
        mbar_wait(st.full + stage, round & 1u);
        return st.ring + stage * COND_UNROLL * 32;
    }
    __device__ __forceinline__ void group(const float (&v)[COND_UNROLL])
    {
        if (!mine()) return;
        const float *e = wait_stage();
        float env[COND_UNROLL];
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k) env[k] = e[k * 32];
        mbar_arrive(st.empty + stage);
#pragma unroll
        for (int k = 0; k < COND_UNROLL; ++k)
            out[(uint32_t)k * L] = cond_mod_depth_split(v[k], env[k]);
    }
    // the ragged tail: the stage the envelope warp hands over in done()
    __device__ __forceinline__ void step(float v, int k)
    {
        if (!mine()) return;
        const float *e = wait_stage();
        out[(uint32_t)k * L] = cond_mod_depth_split(v, e[k * 32]);
    }
    __device__ __forceinline__ void advance(size_t n)
    {
        out += n;
        if (++stage == PROBE_ENV_STAGES) {
            stage = 0;
            ++round;
        }
    }
    __device__ __forceinline__ void done(int) {}
};

template <bool Pair>
__device__ __forceinline__ void probe_body(const ProbeArgs &a, float *ring,
                                           uint64_t *bars)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t n = a.G * a.L;
    const int64_t first = (int64_t)blockIdx.x * 32;
    const int64_t idx = first + lane;
    if (threadIdx.x == 0) {
        const uint32_t lanes = (uint32_t)(n - first < 32 ? n - first : 32);
        for (int s = 0; s < 2 * PROBE_ENV_STAGES; ++s)
            mbar_init(bars + s, lanes);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (idx >= n) return;  // no block-wide barrier below
    const int64_t g = idx / a.L;
    const uint32_t L = (uint32_t)a.L;
    const int64_t o0 = g * a.T * a.L + (idx - g * a.L);
    const float *__restrict__ vp = a.value + o0;
    const ProbeStages st = {ring + lane, bars, bars + PROBE_ENV_STAGES};

    if (warp == 0) {
        using Env = CondEnvChain<CondFloatCounter, ProbeEnvSink>;
        using PairEnv = CondPairChain<CondFloatCounter, ProbeEnvSink>;
        typename std::conditional<Pair, PairEnv, Env>::type c;
        c.env = 0.0f;
        c.cnt.pcount = 0.0f;
        c.cnt.silence = a.silence;
        c.cnt.clock = 0u;
        c.cnt.etu = a.etu;
        c.set_weights(a.enve_w0, a.enve_w1);
        c.sink.L = L;
        c.sink.out = a.env + o0;
        c.sink.st = st;
        c.sink.stage = c.sink.round = 0u;
        cond_run(c, vp, L, a.T);
    } else if (warp == 1) {
        CondFiltChain<false> c;
        c.w1 = c.mdev = 0.0f;
        c.a = a.iir_a;
        c.w0m = a.mdev_w0;
        c.w1m = a.mdev_w1;
        c.B = L;
        c.out_w1 = nullptr;
        c.out_filt = a.filt + o0;
        c.out_mdev = a.mdev + o0;
        cond_run(c, vp, L, a.T);
    } else if (warp == 2) {
        CondAvgChain c;
        c.avg = 0.0f;
        c.w0 = a.mean_w0;
        c.w1 = a.mean_w1;
        c.B = L;
        c.out_avg = a.avg + o0;
        cond_run(c, vp, L, a.T);
    } else {
        ProbeDepthChain c;
        c.L = L;
        c.out = a.mod_depth + o0;
        c.st = st;
        c.stage = c.round = 0u;
        c.w = (uint32_t)(warp - 3);
        cond_run(c, vp, L, a.T);
    }
}

__global__ void __launch_bounds__(PROBE_WARPS * 32)
serial_probe_kernel(const ProbeArgs a)
{
    __shared__ __align__(16) float ring[PROBE_ENV_STAGES * COND_UNROLL * 32];
    __shared__ __align__(8) uint64_t bars[2 * PROBE_ENV_STAGES];
    probe_body<false>(a, ring, bars);
}

// T is even (checked by the wrapper)
__global__ void __launch_bounds__(PROBE_WARPS * 32)
pair_probe_kernel(const ProbeArgs a)
{
    __shared__ __align__(16) float ring[PROBE_ENV_STAGES * COND_UNROLL * 32];
    __shared__ __align__(8) uint64_t bars[2 * PROBE_ENV_STAGES];
    probe_body<true>(a, ring, bars);
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
    const int64_t lanes = a->G * a->L;
    // a block of PROBE_WARPS warps for 32 lanes; 32-bit offsets reach
    // COND_UNROLL rows of L lanes, and the int32 clock the last group;
    // the pair probe steps whole pairs
    if (threads != PROBE_WARPS * 32 || a->L < 1 || a->L > (1LL << 27)
        || a->T > (int64_t)INT32_MAX - COND_UNROLL || (pair && a->T % 2))
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((lanes + 31) / 32);
    if (pair)
        pair_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*a);
    else
        serial_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
