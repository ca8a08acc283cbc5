// The earlier design of the fused NFC frontend (experiments/fused_v2.py) for
// Hopper (sm_90a): conditioning, nine running box sums, mod_depth and the
// all-tech detect mask as a float32 sum of bit weights, with the state
// layout of the Pallas kernel (NSTATE = 1285 rows per stream).
//
// Replaces the Pallas kernel experiments/fused_v2.py::_fused_kernel
// (launched by _jitted -> pl.pallas_call).  What sets it apart from the
// production kernel (fused_frontend.cu): rings of non-power-of-two sizes
// slotted by the absolute clock, t % RING; the mask computed inside the
// serial loop from rings of box values (rb: bv47/bv24/bv12 in rings of
// 64/128/160, rbv: bv94 in a ring of 474); carry rows 5-9 holding the
// previous step's bv47/bv24/bv12 and the d=94/141 NFC-A rates' b0; and a
// float32 mask.  The constants below are experiments/fused_v2.py's (the
// 10 MS/s set only); nfclab_v2_nstate() lets the binding check them.
//
// Two kernels, called in order for every chunk of T samples:
//
//   v2_scan_kernel  one thread per stream, serial over the chunk: the
//                   conditioning chain, mod_depth and the nine box sums.
//                   The value, filtered, squared and product rings (440
//                   rows) live in shared memory, one column per thread;
//                   carry and sums in registers.
//   v2_mask_kernel  one thread per (row, stream): detect_mask at every
//                   sample from the box and filtered channels at fixed
//                   lags, and the state rows the Pallas kernel's mask
//                   leaves behind -- the rb and rbv rings and carry rows
//                   5-9 -- each as the value the ring slot last received.
//                   Lookbacks before the chunk come from the input state's
//                   rf, rb and rbv rings, at the slot of their absolute
//                   clock, exactly where the Pallas kernel reads them.
//
// What bounds it on this card: the function moves 64 bytes per sample (4
// in, 60 out across the 15 outputs), 1.3 ms per 4096 x 16384 samples at
// 3.35 TB/s, and does ~90 float operations per sample, far below the f32
// peak; on paper it is memory-bound.  In fact the scan is latency-bound: one stream is one
// thread walking dependent steps, each with nine shared-memory ring reads
// and sixteen global stores.  Moving the mask out of the loop keeps the
// 826 rows of rb/rbv rings (3.3 KB per stream, 106 KB per warp) out of
// shared memory, so a warp's rings fit in 56 KB; the mask kernel is
// time-parallel and reads its lags from L2.
//
// Numerics: bit-exact with the plain PyTorch version (fused_v2.py of the
// port): explicit round-to-nearest intrinsics (condition_step.cuh for the
// conditioning step), `sd = ((b0 - bg) - (bg - b1)) / p2` as a correctly
// rounded divide, (filt*filt)*10 and (filt*lagged)*10 as two rounded
// multiplies, never an FMA; the library is built -fmad=false
// -prec-div=true -ftz=false.  The mask's bit weights are summed as an
// integer: every partial sum of the weights 1..128 is exact in float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "condition_step.cuh"

namespace {

constexpr int RV_RING = 96, RF_RING = 96, RQ_RING = 192;
constexpr int RP_RING0 = 8, RP_RING1 = 16, RP_RING2 = 32;
constexpr int RB_RING0 = 64, RB_RING1 = 128, RB_RING2 = 160;
constexpr int RB_TOTAL = RB_RING0 + RB_RING1 + RB_RING2;
constexpr int RBV_RING = 474;
constexpr int N_CARRY = 10;
constexpr int N_SUMS = 9;

constexpr int S_RV = N_CARRY;
constexpr int S_RF = S_RV + RV_RING;
constexpr int S_RQ = S_RF + RF_RING;
constexpr int S_RP0 = S_RQ + RQ_RING;
constexpr int S_RP1 = S_RP0 + RP_RING0;
constexpr int S_RP2 = S_RP1 + RP_RING1;
constexpr int S_RB = S_RP2 + RP_RING2;
constexpr int S_RBV = S_RB + RB_TOTAL;
constexpr int S_SUMS = S_RBV + RBV_RING;
constexpr int NSTATE = S_SUMS + N_SUMS;
static_assert(NSTATE == 1285, "state layout of experiments/fused_v2.py");

// the scan's shared-memory rings: rv, rf, rq, rp0-2
constexpr int SCAN_RING_ROWS = S_RB - S_RV;

// output rows, in OUTPUT_NAMES order
enum {
    O_ENV, O_FILT, O_MDEV, O_AVG, O_MOD_DEPTH,
    O_BV12, O_BV24, O_BV47, O_BV94,
    O_Q47, O_Q189,
    O_P24X6, O_P47X12, O_P94X24,
    O_MASK,
};

// the channels the mask looks back on, each with the state ring that
// holds it before the chunk
enum { LB_BV47, LB_BV24, LB_BV12, LB_BV94, LB_FILT };

}  // namespace

extern "C" {

struct V2Args {
    const float *value;      // [T, B]
    const float *state_in;   // [NSTATE, B]
    float *state_out;        // [NSTATE, B]
    float *out;              // [15, T, B], OUTPUT_NAMES order
    int64_t B;
    int64_t T;
    int32_t base;            // absolute clock of the chunk's first sample
    int32_t etu;
    float silence;           // float(etu * 10)
    float enve_w0, enve_w1, mdev_w0, mdev_w1, mean_w0, mean_w1, iir_a;
    float power_thr, a_thr, b_min_deep, f_thr, v_thr;
};

}  // extern "C"

__global__ void v2_scan_kernel(const V2Args a)
{
    extern __shared__ float rings[];  // [SCAN_RING_ROWS][blockDim.x]
    const int nt = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t B = a.B;
    const int64_t b = (int64_t)blockIdx.x * nt + tid;
    if (b >= B) return;  // no barrier below: each thread owns its column

    const float *st_in = a.state_in;
    float *st_out = a.state_out;
    for (int r = 0; r < SCAN_RING_ROWS; ++r)
        rings[r * nt + tid] = st_in[(int64_t)(S_RV + r) * B + b];
    float *rv = rings;
    float *rf = rings + (S_RF - S_RV) * nt;
    float *rq = rings + (S_RQ - S_RV) * nt;
    float *rp[3] = {rings + (S_RP0 - S_RV) * nt, rings + (S_RP1 - S_RV) * nt,
                    rings + (S_RP2 - S_RV) * nt};

    float env = st_in[0 * B + b];
    float w1 = st_in[1 * B + b];
    float mdev = st_in[2 * B + b];
    float avg = st_in[3 * B + b];
    float pcount = st_in[4 * B + b];
    float s[N_SUMS];
#pragma unroll
    for (int i = 0; i < N_SUMS; ++i) s[i] = st_in[(int64_t)(S_SUMS + i) * B + b];

    const int bv_w[4] = {12, 24, 47, 94};
    const int q_w[2] = {47, 189};
    const int pb_lag[3] = {24, 47, 94};
    const int pb_box[3] = {6, 12, 24};
    const int rp_ring[3] = {RP_RING0, RP_RING1, RP_RING2};
    const int64_t TB = a.T * B;
    float *out = a.out;

    for (int64_t j = 0; j < a.T; ++j) {
        const int t = a.base + (int)j;
        const int64_t o = j * B + b;
        const float v = a.value[o];

        // conditioning (NfcTech.cpp:39-68); the silence counter is an
        // integer-valued float
        const float diff = cond_env_diff(v, env);
        pcount = __fadd_rn(pcount, 1.0f);
        const bool update = (diff < 0.05f) || (pcount > a.silence);
        const bool seed = !update && (t < a.etu);
        env = update ? cond_ema(env, a.enve_w0, v, a.enve_w1)
                     : (seed ? v : env);
        pcount = update ? 0.0f : pcount;
        float filt;
        w1 = cond_iir(v, w1, a.iir_a, &filt);
        mdev = cond_ema(mdev, a.mdev_w0, fabsf(filt), a.mdev_w1);
        avg = cond_ema(avg, a.mean_w0, v, a.mean_w1);
        out[O_ENV * TB + o] = env;
        out[O_FILT * TB + o] = filt;
        out[O_MDEV * TB + o] = mdev;
        out[O_AVG * TB + o] = avg;
        out[O_MOD_DEPTH * TB + o] = cond_mod_depth(v, env);

        // raw-value boxes: (sum + v) - old
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float old = rv[((t - bv_w[i] + RV_RING) % RV_RING) * nt + tid];
            s[i] = __fsub_rn(__fadd_rn(s[i], v), old);
            out[(O_BV12 + i) * TB + o] = s[i];
        }
        rv[(t % RV_RING) * nt + tid] = v;

        // squared-filtered boxes over (filt*filt)*10
        const float q = __fmul_rn(__fmul_rn(filt, filt), 10.0f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float old = rq[((t - q_w[i] + RQ_RING) % RQ_RING) * nt + tid];
            s[4 + i] = __fsub_rn(__fadd_rn(s[4 + i], q), old);
            out[(O_Q47 + i) * TB + o] = s[4 + i];
        }
        rq[(t % RQ_RING) * nt + tid] = q;

        // BPSK product boxes over (filt*filt[t-lag])*10
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float lagged =
                rf[((t - pb_lag[i] + RF_RING) % RF_RING) * nt + tid];
            const float prod = __fmul_rn(__fmul_rn(filt, lagged), 10.0f);
            const int rs = rp_ring[i];
            const float old = rp[i][((t - pb_box[i] + rs) % rs) * nt + tid];
            s[6 + i] = __fsub_rn(__fadd_rn(s[6 + i], prod), old);
            out[(O_P24X6 + i) * TB + o] = s[6 + i];
            rp[i][(t % rs) * nt + tid] = prod;
        }
        rf[(t % RF_RING) * nt + tid] = filt;
    }

    // carry rows 0-4, the rings and the sums; v2_mask_kernel writes carry
    // rows 5-9 and the rb / rbv rings
    st_out[0 * B + b] = env;
    st_out[1 * B + b] = w1;
    st_out[2 * B + b] = mdev;
    st_out[3 * B + b] = avg;
    st_out[4 * B + b] = pcount;
    for (int r = 0; r < SCAN_RING_ROWS; ++r)
        st_out[(int64_t)(S_RV + r) * B + b] = rings[r * nt + tid];
#pragma unroll
    for (int i = 0; i < N_SUMS; ++i)
        st_out[(int64_t)(S_SUMS + i) * B + b] = s[i];
}

// channel `which` at c samples before chunk row j: from this chunk's
// output, or, before the chunk, from the state ring slot of its absolute
// clock (the slot the Pallas kernel reads)
__device__ __forceinline__ float v2_lag(const V2Args &a, int which,
                                        int64_t j, int c, int64_t b)
{
    int ch, off, ring;
    switch (which) {
    case LB_BV47: ch = O_BV47; off = S_RB; ring = RB_RING0; break;
    case LB_BV24: ch = O_BV24; off = S_RB + RB_RING0; ring = RB_RING1; break;
    case LB_BV12:
        ch = O_BV12; off = S_RB + RB_RING0 + RB_RING1; ring = RB_RING2; break;
    case LB_BV94: ch = O_BV94; off = S_RBV; ring = RBV_RING; break;
    default: ch = O_FILT; off = S_RF; ring = RF_RING; break;
    }
    const int64_t i = j - c;
    if (i >= 0) return a.out[((int64_t)ch * a.T + i) * a.B + b];
    int64_t slot = ((int64_t)a.base + i) % ring;
    if (slot < 0) slot += ring;
    return a.state_in[(off + slot) * a.B + b];
}

// sd = ((b0 - bg) - (bg - b1)) / p2 with b0 = B(t-d), bg = B(t-d-gap) and
// b1 = B(t-d-1), which the Pallas kernel carries from the previous step:
// at the chunk's first sample b1 is the state's carry row
__device__ __forceinline__ float v2_sd(const V2Args &a, int which, int64_t j,
                                       int d, int gap, int carry_row,
                                       float p2, int64_t b)
{
    const float b0 = v2_lag(a, which, j, d, b);
    const float b1 = j > 0 ? v2_lag(a, which, j, d + 1, b)
                           : a.state_in[(int64_t)carry_row * a.B + b];
    const float bg = v2_lag(a, which, j, d + gap, b);
    return __fdiv_rn(__fsub_rn(__fsub_rn(b0, bg), __fsub_rn(bg, b1)), p2);
}

__device__ __forceinline__ int64_t v2_mod(int64_t x, int m)
{
    const int64_t r = x % m;
    return r < 0 ? r + m : r;
}

__global__ void v2_mask_kernel(const V2Args a)
{
    const int64_t B = a.B;
    const int64_t T = a.T;
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (T + RB_TOTAL + RBV_RING + 5) * B) return;
    const int64_t r = idx / B;
    const int64_t b = idx - r * B;

    if (r >= T) {
        // state rows: ring slot s ends holding the value of the last clock
        // of the chunk that is s modulo the ring (or keeps its input)
        const int64_t last = T - 1;
        const int64_t t_last = (int64_t)a.base + last;
        int64_t k = r - T;
        int64_t row;
        float x;
        if (k < RB_TOTAL) {
            int which, ring;
            int64_t s;
            if (k < RB_RING0) {
                which = LB_BV47; ring = RB_RING0; s = k;
            } else if (k < RB_RING0 + RB_RING1) {
                which = LB_BV24; ring = RB_RING1; s = k - RB_RING0;
            } else {
                which = LB_BV12; ring = RB_RING2; s = k - RB_RING0 - RB_RING1;
            }
            x = v2_lag(a, which, last, (int)v2_mod(t_last - s, ring), b);
            row = S_RB + k;
        } else if (k < RB_TOTAL + RBV_RING) {
            const int64_t s = k - RB_TOTAL;
            x = v2_lag(a, LB_BV94, last, (int)v2_mod(t_last - s, RBV_RING), b);
            row = S_RBV + s;
        } else {
            // carry rows 5-7: the last step's bv47, bv24, bv12; rows 8-9:
            // its b0 of the NFC-A rates at d = 94 (bv24) and 141 (bv12)
            k -= RB_TOTAL + RBV_RING;
            switch (k) {
            case 0: x = v2_lag(a, LB_BV47, last, 0, b); break;
            case 1: x = v2_lag(a, LB_BV24, last, 0, b); break;
            case 2: x = v2_lag(a, LB_BV12, last, 0, b); break;
            case 3: x = v2_lag(a, LB_BV24, last, 94, b); break;
            default: x = v2_lag(a, LB_BV12, last, 141, b); break;
            }
            row = 5 + k;
        }
        a.state_out[row * B + b] = x;
        return;
    }

    const int64_t j = r;
    const float env = a.out[((int64_t)O_ENV * T + j) * B + b];
    const bool power_ok = env >= a.power_thr;
    int m = 0;
    // NFC-A, |SD| above the correlation threshold (NfcA.cpp:224-291):
    // (d, gap, p2) = (0, 47, 47) on bv47, (94, 23, 24) on bv24,
    // (141, 12, 12) on bv12
    const float min_corr_a = __fmul_rn(a.a_thr, env);
    if (power_ok && fabsf(v2_sd(a, LB_BV47, j, 0, 47, 5, 47.0f, b)) > min_corr_a)
        m += 1;
    if (power_ok && fabsf(v2_sd(a, LB_BV24, j, 94, 23, 8, 24.0f, b)) > min_corr_a)
        m += 2;
    if (power_ok && fabsf(v2_sd(a, LB_BV12, j, 141, 12, 9, 12.0f, b)) > min_corr_a)
        m += 4;
    // NFC-F: the same SD family at d = 0 over bv24 and bv12
    const float min_corr_f = __fmul_rn(a.f_thr, env);
    if (power_ok && fabsf(v2_sd(a, LB_BV24, j, 0, 23, 6, 24.0f, b)) > min_corr_f)
        m += 32;
    if (power_ok && fabsf(v2_sd(a, LB_BV12, j, 0, 12, 7, 12.0f, b)) > min_corr_f)
        m += 64;
    // NFC-B: falling edge filt[t-d] < -(minDeep*env) at d = 0, 94
    // (NfcB.cpp:283)
    const float edge_b = -__fmul_rn(a.b_min_deep, env);
    if (power_ok && v2_lag(a, LB_FILT, j, 0, b) < edge_b) m += 8;
    if (power_ok && v2_lag(a, LB_FILT, j, 94, b) < edge_b) m += 16;
    // NFC-V: signed SD = (B(t-d-gap) - B(t-d)) / p2 over bv94, d = 378,
    // gap = 95 (NfcV.cpp:236-435)
    {
        const float u0 = v2_lag(a, LB_BV94, j, 378, b);
        const float ug = v2_lag(a, LB_BV94, j, 378 + 95, b);
        const float sd_v = __fdiv_rn(__fsub_rn(ug, u0), 94.0f);
        if (power_ok && sd_v > __fmul_rn(a.v_thr, env)) m += 128;
    }
    a.out[((int64_t)O_MASK * T + j) * B + b] = (float)m;
}

extern "C" {

int nfclab_v2_nstate(void) { return NSTATE; }

// Each launcher queues its kernel on `stream` and returns
// cudaGetLastError() after the launch (0 = queued).  B and T >= 1.
int nfclab_v2_scan(const V2Args *a, int device, int threads, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)SCAN_RING_ROWS * threads * sizeof(float);
    e = cudaFuncSetAttribute(v2_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->B + threads - 1) / threads;
    v2_scan_kernel<<<(unsigned)blocks, threads, smem,
                     (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

int nfclab_v2_mask(const V2Args *a, int device, int threads, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int64_t total = (a->T + RB_TOTAL + RBV_RING + 5) * a->B;
    const int64_t blocks = (total + threads - 1) / threads;
    v2_mask_kernel<<<(unsigned)blocks, threads, 0,
                     (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
