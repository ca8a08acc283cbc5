// Fused NFC frontend for Hopper (sm_90a): conditioning, running box sums,
// mod_depth and the packed all-tech detect mask.
//
// Replaces the Pallas kernel nfclab/dsp/pallas/fused_frontend.py::
// _fused_kernel, in both of its launchers (_jitted, state resident in
// VMEM, and _jitted_dma, state in HBM behind async copies): one kernel
// here serves both, because the state layout is the same.
//
// Two kernels, called in order for every chunk of T samples:
//
//   ff_scan_kernel  one thread per stream, serial over the chunk: the
//                   conditioning chain (envelope, IIR DC filter, deviation
//                   and average EMAs, NfcTech.cpp:39-68) and the running
//                   box sums (sum + v) - old over rings indexed by the
//                   absolute clock.  Rings live in shared memory, one
//                   column per thread; carry and sums live in registers.
//   ff_mask_kernel  one thread per (sample, stream): mod_depth and the
//                   packed detect_mask from the box and filtered channels
//                   at fixed lags (lookbacks before the chunk come from the
//                   state's history sections), then the history advance.
//
// Layouts: samples and channels are time-major [T, B] and the state is
// section-major [nstate, B], so the 32 threads of a warp touch 32
// neighbouring floats at every step.  The wrapper (nfclab_torch/dsp/
// fused_frontend.py) transposes to and from the public [B, T] / [B, nstate].
//
// What bounds it on this card: the mask-only chunk must move about
// 5 bytes per sample (4 in, 1 out), 0.1 ms for 1024 x 65536 samples at
// 3.35 TB/s, and does ~60 float operations per sample, far below the
// 67 TFLOP/s f32 peak; so on paper it is memory-bound.  In fact it is
// latency-bound: the recurrence is serial in time, so one stream is one
// thread, and 1024 streams are 32 warps -- one warp on each of 32 of the
// 132 SMs, each warp waiting on its own dependent chain of shared-memory
// and global accesses at every sample.  Most of the card stays idle until
// more streams are batched, or a stream is split across threads (the
// segmented engine of the JAX package).  The two-pass design also writes
// and re-reads the six mask dependency channels (24 B/sample) through L2
// and HBM; that is the first thing to fuse once the serial phase is fast.
//
// Numerics: the contract is bit-exactness with the C++ oracle, which is
// built with -ffp-contract=off.  Build with -fmad=false -prec-div=true
// -ftz=false, and every operation of the chain is written as an explicit
// round-to-nearest intrinsic as well (condition_step.cuh holds the
// conditioning step), so no FMA contraction or approximate division can
// creep in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "condition_step.cuh"

#define FF_MAX_BV 8
#define FF_MAX_Q 4
#define FF_MAX_PB 8
#define FF_MAX_RATES 4
#define FF_MAX_HIST (FF_MAX_BV + 1)
#define FF_TILE 128

extern "C" {

struct FFScanArgs {
    const float *value;      // [T, B]
    const float *state_in;   // [nstate, B]
    float *state_out;        // [nstate, B]
    float *deps;             // [n_bv + 2, T, B]: bv..., filtered, envelope
    float *out_mdev;         // [T, B] or null
    float *out_avg;          // [T, B] or null
    float *out_q[FF_MAX_Q];  // [T, B] or null
    float *out_p[FF_MAX_PB]; // [T, B] or null
    int64_t B;
    int64_t T;
    int32_t base;            // absolute clock of the chunk's first sample
    int32_t etu;
    float enve_w0, enve_w1, mdev_w0, mdev_w1, mean_w0, mean_w1, iir_a;
    float silence;           // float(etu * 10)
    int32_t n_bv, n_q, n_pb;
    int32_t bv_w[FF_MAX_BV];
    int32_t q_w[FF_MAX_Q];
    int32_t pb_lag[FF_MAX_PB];
    int32_t pb_box[FF_MAX_PB];
    int32_t rv_ring, rf_ring, rq_ring;
    int32_t rp_ring[FF_MAX_PB];
    int32_t ring_off;        // first ring row; rv, rf, rq, rp... follow
    int32_t ring_rows;
    int32_t hist_off;        // history rows, copied through unchanged
    int32_t hist_rows;
    int32_t sums_off;
};

struct FFMaskArgs {
    const float *value;      // [T, B]
    const float *deps;       // [n_bv + 2, T, B]
    const float *state_in;   // [nstate, B]
    float *state_out;        // [nstate, B]: history rows written here
    uint8_t *out_mask;       // [T, B] or null
    float *out_mod_depth;    // [T, B] or null
    int64_t B;
    int64_t T;
    int32_t n_bv;            // history channels: bv widths, then filtered
    int32_t hist_off[FF_MAX_HIST];
    int32_t hist_len[FF_MAX_HIST];  // h + TILE per channel
    float power_thr, a_thr, b_min_deep, f_thr, v_thr;
    // detect cascades; *_ch is the history channel, *_hoff/_hlen its
    // section offset and length
    int32_t n_a;
    int32_t a_d[FF_MAX_RATES], a_gap[FF_MAX_RATES], a_ch[FF_MAX_RATES];
    int32_t a_hoff[FF_MAX_RATES], a_hlen[FF_MAX_RATES], a_bit[FF_MAX_RATES];
    float a_p2[FF_MAX_RATES];
    int32_t n_f;
    int32_t f_gap[FF_MAX_RATES], f_ch[FF_MAX_RATES];
    int32_t f_hoff[FF_MAX_RATES], f_hlen[FF_MAX_RATES], f_bit[FF_MAX_RATES];
    float f_p2[FF_MAX_RATES];
    int32_t n_b;             // NFC-B reads the filtered channel (n_bv)
    int32_t b_d[FF_MAX_RATES], b_bit[FF_MAX_RATES];
    int32_t b_hoff, b_hlen;
    int32_t v_d, v_gap, v_ch, v_hoff, v_hlen, v_bit;
    float v_p2;
    int32_t rows_main;       // T when mask or mod_depth is written, else 0
    int32_t hist_rows;       // sum of hist_len
};

}  // extern "C"

__global__ void ff_scan_kernel(const FFScanArgs a)
{
    extern __shared__ float rings[];  // [ring_rows][blockDim.x]
    const int nt = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t B = a.B;
    const int64_t b = (int64_t)blockIdx.x * nt + tid;
    if (b >= B) return;  // no barrier below: each thread owns its column

    const float *st_in = a.state_in;
    float *st_out = a.state_out;
    for (int r = 0; r < a.ring_rows; ++r)
        rings[r * nt + tid] = st_in[(int64_t)(a.ring_off + r) * B + b];
    float *rv = rings;
    float *rf = rv + a.rv_ring * nt;
    float *rq = rf + a.rf_ring * nt;
    float *rp[FF_MAX_PB];
    {
        float *p = rq + a.rq_ring * nt;
#pragma unroll
        for (int i = 0; i < FF_MAX_PB; ++i) {
            rp[i] = p;
            if (i < a.n_pb) p += a.rp_ring[i] * nt;
        }
    }

    float env = st_in[0 * B + b];
    float w1 = st_in[1 * B + b];
    float mdev = st_in[2 * B + b];
    float avg = st_in[3 * B + b];
    float pcount = st_in[4 * B + b];
    float s_bv[FF_MAX_BV], s_q[FF_MAX_Q], s_p[FF_MAX_PB];
#pragma unroll
    for (int i = 0; i < FF_MAX_BV; ++i)
        s_bv[i] = i < a.n_bv ? st_in[(int64_t)(a.sums_off + i) * B + b] : 0.f;
#pragma unroll
    for (int i = 0; i < FF_MAX_Q; ++i)
        s_q[i] = i < a.n_q
            ? st_in[(int64_t)(a.sums_off + a.n_bv + i) * B + b] : 0.f;
#pragma unroll
    for (int i = 0; i < FF_MAX_PB; ++i)
        s_p[i] = i < a.n_pb
            ? st_in[(int64_t)(a.sums_off + a.n_bv + a.n_q + i) * B + b] : 0.f;

    const int RV = a.rv_ring - 1, RF = a.rf_ring - 1, RQ = a.rq_ring - 1;
    const int64_t TB = a.T * B;
    float *d_filt = a.deps + (int64_t)a.n_bv * TB;
    float *d_env = d_filt + TB;

    for (int64_t j = 0; j < a.T; ++j) {
        const int t = a.base + (int)j;
        const int64_t o = j * B + b;
        const float v = a.value[o];

        // conditioning (NfcTech.cpp:39-68); the silence counter is an
        // integer-valued float, exact far beyond the 10*ETU timeout
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
        d_env[o] = env;
        d_filt[o] = filt;
        if (a.out_mdev) a.out_mdev[o] = mdev;
        if (a.out_avg) a.out_avg[o] = avg;

        // raw-value boxes
#pragma unroll
        for (int i = 0; i < FF_MAX_BV; ++i) {
            if (i < a.n_bv) {
                const float old = rv[((t - a.bv_w[i] + a.rv_ring) & RV) * nt + tid];
                s_bv[i] = __fsub_rn(__fadd_rn(s_bv[i], v), old);
                a.deps[(int64_t)i * TB + o] = s_bv[i];
            }
        }
        rv[(t & RV) * nt + tid] = v;

        // squared-filtered boxes over (filt*filt)*10
        const float q = __fmul_rn(__fmul_rn(filt, filt), 10.0f);
#pragma unroll
        for (int i = 0; i < FF_MAX_Q; ++i) {
            if (i < a.n_q) {
                const float old = rq[((t - a.q_w[i] + a.rq_ring) & RQ) * nt + tid];
                s_q[i] = __fsub_rn(__fadd_rn(s_q[i], q), old);
                if (a.out_q[i]) a.out_q[i][o] = s_q[i];
            }
        }
        rq[(t & RQ) * nt + tid] = q;

        // BPSK product boxes over (filt*filt[t-lag])*10
#pragma unroll
        for (int i = 0; i < FF_MAX_PB; ++i) {
            if (i < a.n_pb) {
                const float lagged =
                    rf[((t - a.pb_lag[i] + a.rf_ring) & RF) * nt + tid];
                const float prod = __fmul_rn(__fmul_rn(filt, lagged), 10.0f);
                const int rs = a.rp_ring[i];
                const float old = rp[i][((t - a.pb_box[i] + rs) & (rs - 1)) * nt + tid];
                s_p[i] = __fsub_rn(__fadd_rn(s_p[i], prod), old);
                if (a.out_p[i]) a.out_p[i][o] = s_p[i];
                rp[i][(t & (rs - 1)) * nt + tid] = prod;
            }
        }
        rf[(t & RF) * nt + tid] = filt;
    }

    st_out[0 * B + b] = env;
    st_out[1 * B + b] = w1;
    st_out[2 * B + b] = mdev;
    st_out[3 * B + b] = avg;
    st_out[4 * B + b] = pcount;
    for (int r = 5; r < 8; ++r) st_out[r * B + b] = st_in[r * B + b];
    for (int r = 0; r < a.ring_rows; ++r)
        st_out[(int64_t)(a.ring_off + r) * B + b] = rings[r * nt + tid];
#pragma unroll
    for (int i = 0; i < FF_MAX_BV; ++i)
        if (i < a.n_bv) st_out[(int64_t)(a.sums_off + i) * B + b] = s_bv[i];
#pragma unroll
    for (int i = 0; i < FF_MAX_Q; ++i)
        if (i < a.n_q)
            st_out[(int64_t)(a.sums_off + a.n_bv + i) * B + b] = s_q[i];
#pragma unroll
    for (int i = 0; i < FF_MAX_PB; ++i)
        if (i < a.n_pb)
            st_out[(int64_t)(a.sums_off + a.n_bv + a.n_q + i) * B + b] = s_p[i];
    for (int r = 0; r < a.hist_rows; ++r) {
        const int64_t k = (int64_t)(a.hist_off + r) * B + b;
        st_out[k] = st_in[k];
    }
}

// value of history channel `ch` c samples before chunk row j: from this
// chunk's channel, or from the channel's history section in the state
__device__ __forceinline__ float ff_lagged(const float *deps,
                                           const float *state_in, int64_t T,
                                           int64_t B, int ch, int hoff,
                                           int hlen, int64_t j, int c,
                                           int64_t b)
{
    const int64_t i = j - c;
    if (i >= 0) return deps[((int64_t)ch * T + i) * B + b];
    return state_in[(int64_t)(hoff + hlen + i) * B + b];
}

// NaN-propagating min/max (torch.minimum, clamp and jnp semantics)
__device__ __forceinline__ float ff_min(float x, float y)
{
    return (isnan(x) || isnan(y)) ? __int_as_float(0x7fc00000) : fminf(x, y);
}

__device__ __forceinline__ float ff_clamp0(float x)
{
    return isnan(x) ? x : fmaxf(x, 0.0f);
}

__global__ void ff_mask_kernel(const FFMaskArgs a)
{
    const int64_t B = a.B;
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t rows = (int64_t)a.rows_main + a.hist_rows;
    if (idx >= rows * B) return;
    const int64_t r = idx / B;
    const int64_t b = idx - r * B;

    if (r >= a.rows_main) {
        // history advance: section k keeps the last hist_len[k] values of
        // its channel, oldest first
        int64_t i = r - a.rows_main;
#pragma unroll
        for (int k = 0; k < FF_MAX_HIST; ++k) {
            if (k <= a.n_bv) {
                const int n = a.hist_len[k];
                if (i < n) {
                    const int64_t p = a.T + i - n;
                    const float x = p >= 0
                        ? a.deps[((int64_t)k * a.T + p) * B + b]
                        : a.state_in[(int64_t)(a.hist_off[k] + n + p) * B + b];
                    a.state_out[(int64_t)(a.hist_off[k] + i) * B + b] = x;
                    return;
                }
                i -= n;
            }
        }
        return;
    }

    const int64_t j = r;
    const int64_t o = j * B + b;
    const int64_t T = a.T;
    const float *deps = a.deps;
    const float *st_in = a.state_in;
    const float env = a.deps[((int64_t)(a.n_bv + 1) * a.T) * B + o];
    if (a.out_mod_depth) {
        const float c = ff_clamp0(ff_min(a.value[o], env));
        a.out_mod_depth[o] = __fdiv_rn(__fsub_rn(env, c), env);
    }
    if (!a.out_mask) return;

    const bool power_ok = env >= a.power_thr;
    int m = 0;
    const float min_corr_a = __fmul_rn(a.a_thr, env);
#pragma unroll
    for (int q = 0; q < FF_MAX_RATES; ++q) {
        if (q < a.n_a) {
            const float b0 = ff_lagged(deps, st_in, T, B, a.a_ch[q], a.a_hoff[q], a.a_hlen[q], j, a.a_d[q], b);
            const float b1 = ff_lagged(deps, st_in, T, B, a.a_ch[q], a.a_hoff[q], a.a_hlen[q], j, a.a_d[q] + 1, b);
            const float bg = ff_lagged(deps, st_in, T, B, a.a_ch[q], a.a_hoff[q], a.a_hlen[q], j, a.a_d[q] + a.a_gap[q], b);
            const float sd = __fdiv_rn(__fsub_rn(__fsub_rn(b0, bg), __fsub_rn(bg, b1)), a.a_p2[q]);
            if (power_ok && fabsf(sd) > min_corr_a) m += a.a_bit[q];
        }
    }
    const float min_corr_f = __fmul_rn(a.f_thr, env);
#pragma unroll
    for (int q = 0; q < FF_MAX_RATES; ++q) {
        if (q < a.n_f) {
            const float b0 = ff_lagged(deps, st_in, T, B, a.f_ch[q], a.f_hoff[q], a.f_hlen[q], j, 0, b);
            const float b1 = ff_lagged(deps, st_in, T, B, a.f_ch[q], a.f_hoff[q], a.f_hlen[q], j, 1, b);
            const float bg = ff_lagged(deps, st_in, T, B, a.f_ch[q], a.f_hoff[q], a.f_hlen[q], j, a.f_gap[q], b);
            const float sd = __fdiv_rn(__fsub_rn(__fsub_rn(b0, bg), __fsub_rn(bg, b1)), a.f_p2[q]);
            if (power_ok && fabsf(sd) > min_corr_f) m += a.f_bit[q];
        }
    }
    const float edge_b = -__fmul_rn(a.b_min_deep, env);
    const int fch = a.n_bv;
#pragma unroll
    for (int q = 0; q < FF_MAX_RATES; ++q) {
        if (q < a.n_b) {
            const float fd = ff_lagged(deps, st_in, T, B, fch, a.b_hoff, a.b_hlen, j, a.b_d[q], b);
            if (power_ok && fd < edge_b) m += a.b_bit[q];
        }
    }
    {
        const float u0 = ff_lagged(deps, st_in, T, B, a.v_ch, a.v_hoff, a.v_hlen, j, a.v_d, b);
        const float ug = ff_lagged(deps, st_in, T, B, a.v_ch, a.v_hoff, a.v_hlen, j, a.v_d + a.v_gap, b);
        const float sd_v = __fdiv_rn(__fsub_rn(ug, u0), a.v_p2);
        if (power_ok && sd_v > __fmul_rn(a.v_thr, env)) m += a.v_bit;
    }
    a.out_mask[o] = (uint8_t)m;
}

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = queued).
int nfclab_ff_scan(const FFScanArgs *a, int device, int threads,
                   int64_t smem_bytes, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ff_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->B + threads - 1) / threads;
    ff_scan_kernel<<<(unsigned)blocks, threads, (size_t)smem_bytes,
                     (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

int nfclab_ff_mask(const FFMaskArgs *a, int device, int threads,
                   void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int64_t total = ((int64_t)a->rows_main + a->hist_rows) * a->B;
    const int64_t blocks = (total + threads - 1) / threads;
    ff_mask_kernel<<<(unsigned)blocks, threads, 0,
                     (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

const char *nfclab_ff_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
