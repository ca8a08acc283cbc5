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
//   ff_scan_kernel  serial over the chunk, 32 streams per block, one lane
//                   each, with the work split over warps: the conditioning
//                   chain (envelope, IIR DC filter, deviation and average
//                   EMAs, NfcTech.cpp:39-68) and the running box sums
//                   (sum + v) - old over rings indexed by the absolute
//                   clock.  Rings live in shared memory, one column per
//                   lane; carry and sums live in registers.  The layout of
//                   the block is described above the kernel below.
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
// 67 TFLOP/s f32 peak; so on paper it is memory-bound.  In fact the scan
// is bound by the latency and issue of one step: the recurrence is serial
// in time, so one stream is one lane, and 1024 streams are 32 blocks on 32
// of the 132 SMs.  What the scan's design does about the step:
//   - No global load on a step's path: a producer warp stages the samples
//     of the block's 32 streams, FF_TILE_ROWS rows at a time, into a ring
//     of FF_STAGES shared-memory stages with cp.async (chosen over TMA: it
//     takes any B and any alignment, with 16-byte copies where rows are
//     aligned and 4-byte ones where not, and needs no driver entry point),
//     each stage behind mbarriers.  Every pointer is __restrict__.
//   - Ring reads ahead of ring writes: a warp runs its steps in groups of
//     U (6 at 10 MS/s, where the least box width and lag is 6; 2 at
//     3.2 MS/s), and issues all shared-ring reads of a group before its
//     first ring write, so they overlap instead of serialising behind the
//     step before.
//   - Warp specialisation: the envelope, the filter chain with the q
//     boxes, the product boxes, and the raw-value boxes are four warps
//     that issue from four schedulers; the box counts are template
//     arguments, so no runtime loop bound is left in a step.
//   - The envelope test has no divide for 0 < env < inf (cond_env_near).
// What still bounds it: one stream per lane and 32 streams per SM, so at
// 1024 streams 100 SMs stay idle, and the step of the busiest warp sets
// the pace.  That is the product-box warp, by issue: at 10 MS/s its
// group of 6 steps is ~480 instructions, ~80 a step, most of them ring
// and row address arithmetic (the raw-value warp ~52 a step, the filter
// warp ~61, the envelope warp ~44; counted in the sm_90a SASS), against
// ~92 ns a step measured on an H100 (PERF.md).  Fewer address operations
// a step, or the product boxes split over two warps, come next; more
// streams per call, or a stream split across threads (the segmented
// engine of the JAX package), fill the card.  The two-pass design also
// writes and re-reads the six mask dependency channels (24 B/sample)
// through L2 and HBM.
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
#include "smem_stage.cuh"

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
    int32_t group;           // steps per ring-read group (ff_scan_kernel)
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

// ---------------------------------------------------------------------------
// ff_scan_kernel: the serial phase, warp-specialised
//
// Block of FF_SCAN_WARPS warps for 32 streams (lane = stream).  Warp 4
// stages [FF_TILE_ROWS, 32] sample tiles into a ring of FF_STAGES shared
// stages with cp.async, each stage behind a "full" mbarrier (the copies
// landed) and an "empty" one (the four consumer warps are done with it).
// The consumers each read every staged sample and own disjoint outputs,
// state rows and rings, so nothing but the stages is shared:
//   warp 0  envelope + float silence counter: deps envelope; rows 0, 4
//   warp 1  w1 -> filt -> mdev, avg, the q boxes over the rq ring: deps
//           filtered, out_mdev, out_avg, out_q; rows 1-3, rq, q sums
//   warp 2  its own w1 -> filt (the same operations, the same bits), the
//           product boxes over the rf and rp rings: out_p; rf, rp, p sums
//   warp 3  the raw-value boxes over the rv ring: deps bv rows; rv, bv sums
//   warp 4  the producer; then the rows copied through (5-7, histories)
// Each ring is [rows][32] floats, lane = column.  A consumer takes its steps
// in groups of U: every ring read of the group is issued before any ring
// write, which is the sequential order as long as U <= the least box
// width and lag of the plan (the launcher checks it), so the shared loads
// of a group overlap instead of waiting on the stores of the step before.

#define FF_SCAN_WARPS 5
#define FF_CONSUMERS 4
#define FF_STAGES 4
#define FF_TILE_ROWS 120  // a multiple of every group size (1, 2, 6)

// What a consumer warp shares with the others: the staged tiles.
struct FFStages {
    float *tiles;         // [FF_STAGES][FF_TILE_ROWS][32]
    uint64_t *full;
    uint64_t *empty;
};

// Walk the chunk tile by tile: wait for the tile, run its rows through the
// role in groups of U (the ragged rest one by one), hand the stage back.
template <int U, class Role>
__device__ __forceinline__ void ff_consume(Role &role, const FFStages &st,
                                           int64_t T, int32_t base, int lane)
{
    const int ntiles = (int)((T + FF_TILE_ROWS - 1) / FF_TILE_ROWS);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % FF_STAGES;
        mbar_wait(st.full + s, (uint32_t)(i / FF_STAGES) & 1u);
        const float *sv = st.tiles + s * (FF_TILE_ROWS * 32) + lane;
        const int64_t j0 = (int64_t)i * FF_TILE_ROWS;
        const int n = T - j0 < FF_TILE_ROWS ? (int)(T - j0) : FF_TILE_ROWS;
        const int t0 = base + (int)j0;
        role.tile(j0);
        int r = 0;
        for (; r + U <= n; r += U) role.template steps<U>(sv, r, t0 + r);
        for (; r < n; ++r) role.template steps<1>(sv, r, t0 + r);
        __syncwarp();
        if (lane == 0) mbar_arrive(st.empty + s);
    }
}

// Row pointer of a [T, B] output at stream b, moved to each tile's first
// row; null stays null (an output not selected).  Stores are st.global
// (they cannot alias the shared stages and rings) and stream through L2.
struct FFOut {
    float *__restrict__ row0;
    float *__restrict__ cur;
    __device__ __forceinline__ void init(float *p, int64_t b)
    {
        row0 = p ? p + b : nullptr;
        cur = row0;
    }
    __device__ __forceinline__ void tile(int64_t j0, uint32_t B)
    {
        if (row0) cur = row0 + (size_t)j0 * B;
    }
    __device__ __forceinline__ void put(uint32_t o, float v)
    {
        __stcg(cur + o, v);
    }
};

// warp 0: the envelope (NfcTech.cpp:39-53) with the float silence
// counter, an integer-valued float exact far beyond the 10*ETU timeout
struct FFEnvRole {
    float env, pcount;
    float ew0, ew1, silence;
    int32_t etu;
    uint32_t B;
    bool valid;
    FFOut out;

    __device__ __forceinline__ void tile(int64_t j0) { out.tile(j0, B); }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const float v = sv[(r + k) * 32];
            pcount = __fadd_rn(pcount, 1.0f);
            const bool update = cond_env_near(v, env) || (pcount > silence);
            const bool seed = !update && (t + k < etu);
            env = update ? cond_ema(env, ew0, v, ew1) : (seed ? v : env);
            pcount = update ? 0.0f : pcount;
            if (valid) out.put((uint32_t)(r + k) * B, env);
        }
    }
};

// warp 1: IIR DC removal, the deviation and average EMAs
// (NfcTech.cpp:56-68) and the squared-filtered boxes over (filt*filt)*10
template <int NQ>
struct FFFiltRole {
    float w1, mdev, avg;
    float s[NQ];
    float iir_a, mw0, mw1, aw0, aw1;
    int32_t w[NQ];
    float *ring;          // rq, at this lane's column
    int32_t mask;         // rq_ring - 1
    uint32_t B;
    bool valid;
    FFOut filt_out, mdev_out, avg_out, q_out[NQ];

    __device__ __forceinline__ void tile(int64_t j0)
    {
        filt_out.tile(j0, B);
        mdev_out.tile(j0, B);
        avg_out.tile(j0, B);
#pragma unroll
        for (int i = 0; i < NQ; ++i) q_out[i].tile(j0, B);
    }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
        float v[N], old[NQ][N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = sv[(r + k) * 32];
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
            for (int k = 0; k < N; ++k)
                old[i][k] = ring[((t + k - w[i]) & mask) * 32];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float filt;
            w1 = cond_iir(v[k], w1, iir_a, &filt);
            mdev = cond_ema(mdev, mw0, fabsf(filt), mw1);
            avg = cond_ema(avg, aw0, v[k], aw1);
            const float q = __fmul_rn(__fmul_rn(filt, filt), 10.0f);
#pragma unroll
            for (int i = 0; i < NQ; ++i)
                s[i] = __fsub_rn(__fadd_rn(s[i], q), old[i][k]);
            ring[((t + k) & mask) * 32] = q;
            if (valid) {
                const uint32_t o = (uint32_t)(r + k) * B;
                filt_out.put(o, filt);
                if (mdev_out.cur) mdev_out.put(o, mdev);
                if (avg_out.cur) avg_out.put(o, avg);
#pragma unroll
                for (int i = 0; i < NQ; ++i)
                    if (q_out[i].cur) q_out[i].put(o, s[i]);
            }
        }
    }
};

// warp 2: the BPSK product boxes over (filt*filt[t-lag])*10
template <int NPB>
struct FFProdRole {
    float w1, iir_a;
    float s[NPB];
    int32_t lag[NPB], box[NPB], pmask[NPB];
    float *rf;            // filtered ring, at this lane's column
    float *rp[NPB];       // product rings, at this lane's column
    int32_t fmask;        // rf_ring - 1
    uint32_t B;
    bool valid;
    FFOut p_out[NPB];

    __device__ __forceinline__ void tile(int64_t j0)
    {
#pragma unroll
        for (int i = 0; i < NPB; ++i) p_out[i].tile(j0, B);
    }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
        float v[N], lagged[NPB][N], old[NPB][N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = sv[(r + k) * 32];
#pragma unroll
        for (int i = 0; i < NPB; ++i)
#pragma unroll
            for (int k = 0; k < N; ++k) {
                lagged[i][k] = rf[((t + k - lag[i]) & fmask) * 32];
                old[i][k] = rp[i][((t + k - box[i]) & pmask[i]) * 32];
            }
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float filt;
            w1 = cond_iir(v[k], w1, iir_a, &filt);
#pragma unroll
            for (int i = 0; i < NPB; ++i) {
                const float prod =
                    __fmul_rn(__fmul_rn(filt, lagged[i][k]), 10.0f);
                s[i] = __fsub_rn(__fadd_rn(s[i], prod), old[i][k]);
                rp[i][((t + k) & pmask[i]) * 32] = prod;
                if (valid && p_out[i].cur)
                    p_out[i].put((uint32_t)(r + k) * B, s[i]);
            }
            rf[((t + k) & fmask) * 32] = filt;
        }
    }
};

// warp 3: the raw-value boxes (sum + v) - v[t - w]
template <int NBV>
struct FFBvRole {
    float s[NBV];
    int32_t w[NBV];
    float *ring;          // rv, at this lane's column
    int32_t mask;         // rv_ring - 1
    uint32_t B;
    bool valid;
    FFOut out[NBV];

    __device__ __forceinline__ void tile(int64_t j0)
    {
#pragma unroll
        for (int i = 0; i < NBV; ++i) out[i].tile(j0, B);
    }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
        float v[N], old[NBV][N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = sv[(r + k) * 32];
#pragma unroll
        for (int i = 0; i < NBV; ++i)
#pragma unroll
            for (int k = 0; k < N; ++k)
                old[i][k] = ring[((t + k - w[i]) & mask) * 32];
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int i = 0; i < NBV; ++i) {
                s[i] = __fsub_rn(__fadd_rn(s[i], v[k]), old[i][k]);
                if (valid) out[i].put((uint32_t)(r + k) * B, s[i]);
            }
            ring[((t + k) & mask) * 32] = v[k];
        }
    }
};

// state row r of stream b, 0 for a lane past the last stream
__device__ __forceinline__ float ff_row(const float *st, int64_t r, int64_t B,
                                        int64_t b, bool valid)
{
    return valid ? st[r * B + b] : 0.0f;
}

// load `rows` ring rows from state row `off` on into shared memory at this
// lane's column
__device__ __forceinline__ void ff_ring_in(float *ring, const float *st,
                                           int off, int rows, int64_t B,
                                           int64_t b, bool valid)
{
    for (int r = 0; r < rows; ++r)
        ring[r * 32] = ff_row(st, off + r, B, b, valid);
}

__device__ __forceinline__ void ff_ring_out(const float *ring, float *st,
                                            int off, int rows, int64_t B,
                                            int64_t b, bool valid)
{
    if (!valid) return;
    for (int r = 0; r < rows; ++r) st[(int64_t)(off + r) * B + b] = ring[r * 32];
}

// warp 4: keep FF_STAGES tiles in flight, then copy the rows the scan
// passes through unchanged.  16-byte copies when every row of the block's
// 32 columns is 16-byte aligned (B % 4 == 0, aligned samples), else 4-byte
// ones; columns past the last stream are not copied.
__device__ __forceinline__ void ff_produce(const FFScanArgs &a,
                                           const FFStages &st, int lane,
                                           int64_t b0)
{
    const int64_t B = a.B, T = a.T;
    const float *src0 = a.value + b0;
    const bool wide = (B % 4 == 0) && ((uintptr_t)a.value % 16 == 0);
    const int ntiles = (int)((T + FF_TILE_ROWS - 1) / FF_TILE_ROWS);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % FF_STAGES;
        if (i >= FF_STAGES)
            mbar_wait(st.empty + s, (uint32_t)(i / FF_STAGES - 1) & 1u);
        const int64_t j0 = (int64_t)i * FF_TILE_ROWS;
        const int n = T - j0 < FF_TILE_ROWS ? (int)(T - j0) : FF_TILE_ROWS;
        float *dst = st.tiles + s * (FF_TILE_ROWS * 32);
        const float *src = src0 + j0 * B;
        if (wide) {
            for (int c = lane; c < n * 8; c += 32) {
                const int r = c >> 3, col = (c & 7) * 4;
                if (b0 + col < B)
                    cp_async16(dst + r * 32 + col, src + (int64_t)r * B + col);
            }
        } else if (b0 + lane < B) {
            for (int r = 0; r < n; ++r)
                cp_async4(dst + r * 32 + lane, src + (int64_t)r * B + lane);
        }
        cp_async_arrive(st.full + s);
    }
    const int64_t b = b0 + lane;
    if (b < B) {
        for (int r = 5; r < 8; ++r) a.state_out[r * B + b] = a.state_in[r * B + b];
        for (int r = 0; r < a.hist_rows; ++r) {
            const int64_t k = (int64_t)(a.hist_off + r) * B + b;
            a.state_out[k] = a.state_in[k];
        }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
}

extern __shared__ __align__(16) unsigned char ff_dyn_smem[];

template <int U, int NBV, int NQ, int NPB>
__global__ void __launch_bounds__(FF_SCAN_WARPS * 32)
ff_scan_kernel(const FFScanArgs a)
{
    uint64_t *bars = reinterpret_cast<uint64_t *>(ff_dyn_smem);
    FFStages st;
    st.full = bars;
    st.empty = bars + FF_STAGES;
    st.tiles = reinterpret_cast<float *>(ff_dyn_smem + 16 * FF_STAGES);
    float *rings = st.tiles + FF_STAGES * FF_TILE_ROWS * 32;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t B = a.B;
    const int64_t b0 = (int64_t)blockIdx.x * 32;
    const int64_t b = b0 + lane;
    const bool valid = b < B;  // every lane runs: the warps meet at barriers
    const uint32_t Bu = (uint32_t)B;
    const float *sti = a.state_in;
    float *sto = a.state_out;

    if (threadIdx.x == 0) {
        for (int s = 0; s < FF_STAGES; ++s) {
            mbar_init(st.full + s, 32);
            mbar_init(st.empty + s, FF_CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // shared rings in state order: rv, rf, rq, then the product rings
    float *rv = rings + lane;
    float *rf = rv + a.rv_ring * 32;
    float *rq = rf + a.rf_ring * 32;
    float *rp0 = rq + a.rq_ring * 32;
    const int rv_off = a.ring_off;
    const int rf_off = rv_off + a.rv_ring;
    const int rq_off = rf_off + a.rf_ring;
    const int rp_off = rq_off + a.rq_ring;
    const int64_t TB = a.T * B;

    if (warp == 0) {
        FFEnvRole r;
        r.env = ff_row(sti, 0, B, b, valid);
        r.pcount = ff_row(sti, 4, B, b, valid);
        r.ew0 = a.enve_w0;
        r.ew1 = a.enve_w1;
        r.silence = a.silence;
        r.etu = a.etu;
        r.B = Bu;
        r.valid = valid;
        r.out.init(a.deps + (int64_t)(NBV + 1) * TB, b);
        ff_consume<U>(r, st, a.T, a.base, lane);
        if (valid) {
            sto[0 * B + b] = r.env;
            sto[4 * B + b] = r.pcount;
        }
    } else if (warp == 1) {
        FFFiltRole<NQ> r;
        r.w1 = ff_row(sti, 1, B, b, valid);
        r.mdev = ff_row(sti, 2, B, b, valid);
        r.avg = ff_row(sti, 3, B, b, valid);
        r.iir_a = a.iir_a;
        r.mw0 = a.mdev_w0;
        r.mw1 = a.mdev_w1;
        r.aw0 = a.mean_w0;
        r.aw1 = a.mean_w1;
        r.ring = rq;
        r.mask = a.rq_ring - 1;
        r.B = Bu;
        r.valid = valid;
        r.filt_out.init(a.deps + (int64_t)NBV * TB, b);
        r.mdev_out.init(a.out_mdev, b);
        r.avg_out.init(a.out_avg, b);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
            r.s[i] = ff_row(sti, a.sums_off + NBV + i, B, b, valid);
            r.w[i] = a.q_w[i];
            r.q_out[i].init(a.out_q[i], b);
        }
        ff_ring_in(rq, sti, rq_off, a.rq_ring, B, b, valid);
        ff_consume<U>(r, st, a.T, a.base, lane);
        if (valid) {
            sto[1 * B + b] = r.w1;
            sto[2 * B + b] = r.mdev;
            sto[3 * B + b] = r.avg;
#pragma unroll
            for (int i = 0; i < NQ; ++i)
                sto[(int64_t)(a.sums_off + NBV + i) * B + b] = r.s[i];
        }
        ff_ring_out(rq, sto, rq_off, a.rq_ring, B, b, valid);
    } else if (warp == 2) {
        FFProdRole<NPB> r;
        r.w1 = ff_row(sti, 1, B, b, valid);
        r.iir_a = a.iir_a;
        r.rf = rf;
        r.fmask = a.rf_ring - 1;
        r.B = Bu;
        r.valid = valid;
        int rows = 0;
#pragma unroll
        for (int i = 0; i < NPB; ++i) {
            r.s[i] = ff_row(sti, a.sums_off + NBV + NQ + i, B, b, valid);
            r.lag[i] = a.pb_lag[i];
            r.box[i] = a.pb_box[i];
            r.pmask[i] = a.rp_ring[i] - 1;
            r.rp[i] = rp0 + rows * 32;
            rows += a.rp_ring[i];
            r.p_out[i].init(a.out_p[i], b);
        }
        ff_ring_in(rf, sti, rf_off, a.rf_ring, B, b, valid);
        ff_ring_in(rp0, sti, rp_off, rows, B, b, valid);
        ff_consume<U>(r, st, a.T, a.base, lane);
        if (valid) {
#pragma unroll
            for (int i = 0; i < NPB; ++i)
                sto[(int64_t)(a.sums_off + NBV + NQ + i) * B + b] = r.s[i];
        }
        ff_ring_out(rf, sto, rf_off, a.rf_ring, B, b, valid);
        ff_ring_out(rp0, sto, rp_off, rows, B, b, valid);
    } else if (warp == 3) {
        FFBvRole<NBV> r;
        r.ring = rv;
        r.mask = a.rv_ring - 1;
        r.B = Bu;
        r.valid = valid;
#pragma unroll
        for (int i = 0; i < NBV; ++i) {
            r.s[i] = ff_row(sti, a.sums_off + i, B, b, valid);
            r.w[i] = a.bv_w[i];
            r.out[i].init(a.deps + (int64_t)i * TB, b);
        }
        ff_ring_in(rv, sti, rv_off, a.rv_ring, B, b, valid);
        ff_consume<U>(r, st, a.T, a.base, lane);
        if (valid) {
#pragma unroll
            for (int i = 0; i < NBV; ++i)
                sto[(int64_t)(a.sums_off + i) * B + b] = r.s[i];
        }
        ff_ring_out(rv, sto, rv_off, a.rv_ring, B, b, valid);
    } else {
        ff_produce(a, st, lane, b0);
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
    if (a.out_mod_depth) a.out_mod_depth[o] = cond_mod_depth(a.value[o], env);
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

typedef void (*FFScanKernel)(const FFScanArgs);

// the instantiated kernels: every plan from 0.5 to 40 MS/s has 3 or 4 raw
// boxes, 2 squared and 3 product boxes; groups of 6 serve 10 MS/s, of 2
// 3.2 MS/s, of 1 any plan
static FFScanKernel ff_scan_pick(int group, int nbv, int nq, int npb)
{
    if (nq != 2 || npb != 3) return nullptr;
#define FF_PICK(U_, NBV_) \
    if (group == U_ && nbv == NBV_) return ff_scan_kernel<U_, NBV_, 2, 3>;
    FF_PICK(6, 4) FF_PICK(2, 4) FF_PICK(1, 4)
    FF_PICK(6, 3) FF_PICK(2, 3) FF_PICK(1, 3)
#undef FF_PICK
    return nullptr;
}

// the least distance, in steps, between a ring write and a read of the
// same ring (at least 1: a group of one step is the sequential order)
static int ff_min_distance(const FFScanArgs *a)
{
    int d = 1 << 30;
    const auto least = [&d](int x) { d = x < d ? x : d; };
    for (int i = 0; i < a->n_bv && i < FF_MAX_BV; ++i) least(a->bv_w[i]);
    for (int i = 0; i < a->n_q && i < FF_MAX_Q; ++i) least(a->q_w[i]);
    for (int i = 0; i < a->n_pb && i < FF_MAX_PB; ++i) {
        least(a->pb_lag[i]);
        least(a->pb_box[i]);
    }
    return d < 1 ? 1 : d;
}

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = queued).

// Queues ff_scan_kernel for the plan's box counts and group size.  Refused
// (cudaErrorInvalidValue) unless `threads` is FF_SCAN_WARPS * 32,
// `smem_bytes` holds the barriers, stages and rings, 1 <= B <= 2^25 (32-bit
// offsets within a tile), the counts and group size are instantiated
// below, and the group is no longer than the least box width and lag.
int nfclab_ff_scan(const FFScanArgs *a, int device, int threads,
                   int64_t smem_bytes, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int64_t need = 16LL * FF_STAGES
        + 128LL * ((int64_t)FF_STAGES * FF_TILE_ROWS + a->ring_rows);
    const FFScanKernel k = ff_scan_pick(a->group, a->n_bv, a->n_q, a->n_pb);
    if (k == nullptr || threads != FF_SCAN_WARPS * 32 || smem_bytes < need
        || a->B < 1 || a->B > (1LL << 25)
        || a->group > ff_min_distance(a))
        return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute((const void *)k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->B + 31) / 32;
    k<<<(unsigned)blocks, threads, (size_t)smem_bytes,
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
