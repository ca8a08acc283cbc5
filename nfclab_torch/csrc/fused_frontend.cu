// Fused NFC frontend for Hopper (sm_90a): conditioning, running box sums,
// mod_depth and the packed all-tech detect mask.
//
// Replaces the Pallas kernel nfclab/dsp/pallas/fused_frontend.py::
// _fused_kernel, in both of its launchers (_jitted, state resident in
// VMEM, and _jitted_dma, state in HBM behind async copies): one kernel
// here serves both, because the state layout is the same.
//
// For every chunk of T samples one of the two scans, then the mask:
//
//   ff_scan_kernel  serial over the chunk, 32 streams per block, one lane
//                   each, with the work split over warps: the conditioning
//                   chain (envelope, IIR DC filter, deviation and average
//                   EMAs, NfcTech.cpp:39-68) and the running box sums
//                   (sum + v) - old over rings indexed by the absolute
//                   clock.  Rings live in shared memory, one column per
//                   lane; carry and sums live in registers.  The layout of
//                   the block is described above the kernel below.
//   ff_scan_kernel_narrow
//                   the same chains and boxes in the same order, bit for
//                   bit, 8 streams per block and a lane per (stream, box)
//                   in the box warps; taken while its blocks fill no more
//                   than one per SM (kernels/fused.py scan_narrow), where
//                   it measured faster: the live path (B = 1 and 4) and
//                   every B up to 8 x the SMs.  The layout of the block is
//                   described above the kernel.
//   ff_mask_kernel  parallel in time, W streams (32, or 16 for the plans
//                   whose rings need it) and a span of rows per block: the
//                   packed detect_mask and mod_depth from the box, filtered
//                   and envelope channels at the plan's lags, each lag
//                   window of a channel staged into a shared ring and read
//                   from memory once per span (lookbacks before the chunk
//                   from the state's history sections), every threshold
//                   test without a divide; then the history advance.  The
//                   layout of the block is described above the kernel.
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
// What still bounds the scans (clock64 laps a role on an H100 at 1.98
// GHz, PERF.md): the step of the slowest warp, the others waiting for
// it at the stages.  ff_scan_kernel takes ~92 ns a step, its filter warp
// (w1 -> filt -> mdev, avg, the two q boxes, the filtered store) ~148
// cycles, the envelope and product warps ~120, the raw-value warp ~99;
// one stream per lane and 32 per SM, so at 1024 streams 100 SMs stay
// idle.  Below 32 streams a block, its lanes past the last stream start
// from env = 0 and read stage columns the producer never fills: where
// that shared memory holds zeros, as on an SM no kernel used before, the
// envelope warp takes cond_env_near's divide at every step (375 cycles,
// 12.6 ms a 65536-sample chunk at B = 1 against 6.1 where an earlier
// kernel left samples there).  ff_scan_kernel_narrow takes ~50 ns a step
// at any B up to 8 x the SMs: a box warp's step is its stream's chain and
// one box, the envelope warp's (~94 cycles, its chain F2F -> DMUL ->
// DSETP -> select) sets the pace, the filter warp ~86, the box warps
// 41-52; no lane takes a branch, so neither a missing stream nor an
// envelope <= 0 costs a divide.  A shorter envelope chain comes next;
// more streams than one narrow block an SM go to ff_scan_kernel.
// The two-pass design also writes and re-reads the six mask dependency
// channels (24 B/sample) through L2 and HBM: the mask kernel reads them
// once and writes the
// packed mask, 25 B a sample (33 with mod_depth), 0.50 ms per 1024 x
// 65536 at 3.35 TB/s, the floor of the two-kernel split.  What the mask
// kernel does about it: each row of a lag window is copied into shared
// memory once per span by producer warps, a sub-tile ahead, so the
// consumers' lookbacks (20 a sample at 10 MS/s) are shared loads; no SD
// test divides (sd_above), nor mod_depth where its numerator is +0.
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

// ---------------------------------------------------------------------------
// ff_scan_kernel_narrow: the serial phase for a few streams, a lane per
// (stream, box)
//
// Block of FFN_WARPS warps for FFN_STREAMS (8) streams; the operations of
// every chain and box are ff_scan_kernel's, in its order, so the two are
// bit for bit alike and share the state layout.  The envelope test is
// ffn_env_near, the same decision with neither a divide nor a branch.  A
// lane runs stream s = lane % 8 of the block and, in a box warp, box i =
// lane / 8; where the block has fewer streams than 8, lane s runs the
// block's first stream instead, and where a role has fewer boxes than 4,
// box i runs box 0: such a lane computes what a live lane computes, on
// samples the producer staged, and stores nothing.  Every store is one
// instruction under a condition fixed before the chunk, so no step
// branches.
//   warp 0  envelope + float silence counter: deps envelope; rows 0, 4
//   warp 1  w1 -> filt -> mdev, avg: deps filtered, out_mdev, out_avg;
//           rows 1-3
//   warp 2  the product boxes: its own w1 -> filt, its box over its copy
//           of the rf ring and its rp ring: out_p; rf, rp, p sums
//   warp 3  the q boxes: its own w1 -> filt, its box over its copy of the
//           rq ring: out_q; rq, q sums
//   warp 4  the raw-value boxes over its copy of the rv ring: deps bv
//           rows; rv, bv sums
//   warp 5  the producer: [FF_TILE_ROWS, 8] tiles, as warp 4 of
//           ff_scan_kernel; then the rows copied through
// Each box lane keeps its own copy of its stream's ring in its own column
// of a [rows][32] ring, so every ring read and write is one conflict-free
// shared access of its own; the stages are [rows][8], lane = column % 8.
// Warp w issues from scheduler w % 4: the raw-value warp, the lightest of
// the box warps, shares the envelope warp's, and the producer the filter
// warp's.

#define FFN_STREAMS 8
#define FFN_BOXES (32 / FFN_STREAMS)
#define FFN_WARPS 6
#define FFN_CONSUMERS 5

template <int U, class Role>
__device__ __forceinline__ void ffn_consume(Role &role, const FFStages &st,
                                            int64_t T, int32_t base, int col,
                                            int lane)
{
    const int ntiles = (int)((T + FF_TILE_ROWS - 1) / FF_TILE_ROWS);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % FF_STAGES;
        mbar_wait(st.full + s, (uint32_t)(i / FF_STAGES) & 1u);
        const float *sv = st.tiles + s * (FF_TILE_ROWS * FFN_STREAMS) + col;
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

// cond_env_near(v, env), exactly, for every env, with neither a divide nor
// a branch: the quotient |v - env| / env < 0.05f decided by env's class.
// For 0 < env < inf the divide-free test of cond_env_near_pos; for a
// negative finite env the quotient is -0, negative or -inf (below 0.05)
// unless |v - env| is NaN; for env = -0 it is -inf where |v - env| > 0,
// else NaN; for env = +0, +-inf or NaN it is +inf or NaN (not below).
__device__ __forceinline__ bool ffn_env_near(float v, float env)
{
    const float ad = fabsf(__fsub_rn(v, env));
    const double m = 26843545.0 / 536870912.0;  // as cond_env_near_pos
    const bool near_pos = (double)ad <= __dmul_rn(m, (double)env);
    const bool pos = env > 0.0f && env < INFINITY;
    const bool neg = env < 0.0f && env > -INFINITY;
    const bool minus_zero = __float_as_uint(env) == 0x80000000u;
    return pos ? near_pos : neg ? (ad == ad) : (minus_zero && ad > 0.0f);
}

// warp 0: FFEnvRole's step on the narrow stage, its test ffn_env_near; the
// update EMA and the seed-or-hold value do not wait for the test
struct FFNEnvRole {
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
            const float v = sv[(r + k) * FFN_STREAMS];
            pcount = __fadd_rn(pcount, 1.0f);
            const float ema = cond_ema(env, ew0, v, ew1);
            const float other = t + k < etu ? v : env;
            const bool update = ffn_env_near(v, env) || (pcount > silence);
            env = update ? ema : other;
            pcount = update ? 0.0f : pcount;
            if (valid) out.put((uint32_t)(r + k) * B, env);
        }
    }
};

// warp 1: FFFiltRole's chains without the q boxes.  Each store's
// condition is fixed before the chunk (put_*), so that a store is one
// predicated instruction and no step branches on it.
struct FFNFiltRole {
    float w1, mdev, avg;
    float iir_a, mw0, mw1, aw0, aw1;
    uint32_t B;
    bool valid, put_mdev, put_avg;
    FFOut filt_out, mdev_out, avg_out;

    __device__ __forceinline__ void tile(int64_t j0)
    {
        filt_out.tile(j0, B);
        mdev_out.tile(j0, B);
        avg_out.tile(j0, B);
    }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const float v = sv[(r + k) * FFN_STREAMS];
            float filt;
            w1 = cond_iir(v, w1, iir_a, &filt);
            mdev = cond_ema(mdev, mw0, fabsf(filt), mw1);
            avg = cond_ema(avg, aw0, v, aw1);
            const uint32_t o = (uint32_t)(r + k) * B;
            if (valid) filt_out.put(o, filt);
            if (put_mdev) mdev_out.put(o, mdev);
            if (put_avg) avg_out.put(o, avg);
        }
    }
};

// warp 3: one q box (FFFiltRole's) over (filt*filt)*10, w1 -> filt of its
// own
struct FFNQRole {
    float w1, iir_a, s;
    int32_t w, mask;      // rq_ring - 1
    float *ring;          // rq, at this lane's column
    uint32_t B;
    bool valid, put;      // put: valid, and the output selected
    FFOut out;

    __device__ __forceinline__ void tile(int64_t j0) { out.tile(j0, B); }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
        float v[N], old[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            v[k] = sv[(r + k) * FFN_STREAMS];
            old[k] = ring[((t + k - w) & mask) * 32];
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float filt;
            w1 = cond_iir(v[k], w1, iir_a, &filt);
            const float q = __fmul_rn(__fmul_rn(filt, filt), 10.0f);
            s = __fsub_rn(__fadd_rn(s, q), old[k]);
            ring[((t + k) & mask) * 32] = q;
            if (put) out.put((uint32_t)(r + k) * B, s);
        }
    }
};

// warp 2: one product box (FFProdRole's) over (filt*filt[t-lag])*10
struct FFNProdRole {
    float w1, iir_a, s;
    int32_t lag, box, pmask, fmask;
    float *rf;            // filtered ring, at this lane's column
    float *rp;            // this box's product ring, at this lane's column
    uint32_t B;
    bool valid, put;      // put: valid, and the output selected
    FFOut out;

    __device__ __forceinline__ void tile(int64_t j0) { out.tile(j0, B); }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
        float v[N], lagged[N], old[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            v[k] = sv[(r + k) * FFN_STREAMS];
            lagged[k] = rf[((t + k - lag) & fmask) * 32];
            old[k] = rp[((t + k - box) & pmask) * 32];
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float filt;
            w1 = cond_iir(v[k], w1, iir_a, &filt);
            const float prod = __fmul_rn(__fmul_rn(filt, lagged[k]), 10.0f);
            s = __fsub_rn(__fadd_rn(s, prod), old[k]);
            rp[((t + k) & pmask) * 32] = prod;
            if (put) out.put((uint32_t)(r + k) * B, s);
            rf[((t + k) & fmask) * 32] = filt;
        }
    }
};

// warp 5: one raw-value box (FFBvRole's), (sum + v) - v[t - w]
struct FFNBvRole {
    float s;
    int32_t w, mask;      // rv_ring - 1
    float *ring;          // rv, at this lane's column
    uint32_t B;
    bool valid;
    FFOut out;

    __device__ __forceinline__ void tile(int64_t j0) { out.tile(j0, B); }

    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int t)
    {
        float v[N], old[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            v[k] = sv[(r + k) * FFN_STREAMS];
            old[k] = ring[((t + k - w) & mask) * 32];
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
            s = __fsub_rn(__fadd_rn(s, v[k]), old[k]);
            if (valid) out.put((uint32_t)(r + k) * B, s);
            ring[((t + k) & mask) * 32] = v[k];
        }
    }
};

// warp 4: keep FF_STAGES [FF_TILE_ROWS, 8] tiles in flight, then copy the
// rows the scan passes through unchanged, for the block's nb streams.
// 16-byte copies where the block's row is whole 16-byte pieces (B % 4 ==
// 0, nb % 4 == 0, aligned samples), a lane a piece, 16 rows at once; else
// 4-byte ones, a lane a (row, stream), 4 rows at once.
__device__ __forceinline__ void ffn_produce(const FFScanArgs &a,
                                            const FFStages &st, int lane,
                                            int64_t b0, int nb)
{
    const int64_t B = a.B, T = a.T;
    const float *src0 = a.value + b0;
    const bool wide = (B % 4 == 0) && (nb % 4 == 0)
                      && ((uintptr_t)a.value % 16 == 0);
    const int q = lane % FFN_STREAMS, rr = lane / FFN_STREAMS;
    const int ntiles = (int)((T + FF_TILE_ROWS - 1) / FF_TILE_ROWS);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % FF_STAGES;
        if (i >= FF_STAGES)
            mbar_wait(st.empty + s, (uint32_t)(i / FF_STAGES - 1) & 1u);
        const int64_t j0 = (int64_t)i * FF_TILE_ROWS;
        const int n = T - j0 < FF_TILE_ROWS ? (int)(T - j0) : FF_TILE_ROWS;
        float *dst = st.tiles + s * (FF_TILE_ROWS * FFN_STREAMS);
        const float *src = src0 + j0 * B;
        if (wide) {
            // lane: piece lane % 2 of row lane / 2, sixteen rows at once
            const int c = (lane % 2) * 4;
            if (c < nb)
                for (int r = lane / 2; r < n; r += 16)
                    cp_async16(dst + r * FFN_STREAMS + c, src + (int64_t)r * B + c);
        } else if (q < nb) {
            for (int r = rr; r < n; r += 32 / FFN_STREAMS)
                cp_async4(dst + r * FFN_STREAMS + q, src + (int64_t)r * B + q);
        }
        cp_async_arrive(st.full + s);
    }
    if (q < nb) {
        for (int r = rr; r < 3 + a.hist_rows; r += 32 / FFN_STREAMS) {
            const int64_t k = (int64_t)(r < 3 ? 5 + r : a.hist_off + r - 3) * B
                              + b0 + q;
            a.state_out[k] = a.state_in[k];
        }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int U, int NBV, int NQ, int NPB>
__global__ void __launch_bounds__(FFN_WARPS * 32)
ff_scan_kernel_narrow(const FFScanArgs a)
{
    static_assert(NBV <= FFN_BOXES && NQ <= FFN_BOXES && NPB <= FFN_BOXES,
                  "a box warp holds FFN_BOXES boxes of 8 streams");
    uint64_t *bars = reinterpret_cast<uint64_t *>(ff_dyn_smem);
    FFStages st;
    st.full = bars;
    st.empty = bars + FF_STAGES;
    st.tiles = reinterpret_cast<float *>(ff_dyn_smem + 16 * FF_STAGES);
    float *rings = st.tiles + FF_STAGES * FF_TILE_ROWS * FFN_STREAMS;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t B = a.B;
    const int64_t b0 = (int64_t)blockIdx.x * FFN_STREAMS;
    const int nb = B - b0 < FFN_STREAMS ? (int)(B - b0) : FFN_STREAMS;
    const int s = lane % FFN_STREAMS;
    const int col = s < nb ? s : 0;   // the stream this lane runs
    const int box = lane / FFN_STREAMS;
    const bool live = s < nb;         // lanes 8-31 of warps 0-1 run copies
    const int64_t b = b0 + col;
    const uint32_t Bu = (uint32_t)B;
    const float *sti = a.state_in;
    float *sto = a.state_out;

    if (threadIdx.x == 0) {
        for (int i = 0; i < FF_STAGES; ++i) {
            mbar_init(st.full + i, 32);
            mbar_init(st.empty + i, FFN_CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // shared rings, [rows][32] each, lane = column: rv (warp 4), rq (warp
    // 3), rf and the product ring of the lane's box (warp 2)
    float *rv = rings + lane;
    float *rq = rv + a.rv_ring * 32;
    float *rf = rq + a.rq_ring * 32;
    float *rp = rf + a.rf_ring * 32;
    const int rv_off = a.ring_off;
    const int rf_off = rv_off + a.rv_ring;
    const int rq_off = rf_off + a.rf_ring;
    const int rp_off = rq_off + a.rq_ring;
    const int64_t TB = a.T * B;

    if (warp == 0) {
        FFNEnvRole r;
        r.env = ff_row(sti, 0, B, b, true);
        r.pcount = ff_row(sti, 4, B, b, true);
        r.ew0 = a.enve_w0;
        r.ew1 = a.enve_w1;
        r.silence = a.silence;
        r.etu = a.etu;
        r.B = Bu;
        r.valid = live && box == 0;
        r.out.init(a.deps + (int64_t)(NBV + 1) * TB, b);
        ffn_consume<U>(r, st, a.T, a.base, col, lane);
        if (r.valid) {
            sto[0 * B + b] = r.env;
            sto[4 * B + b] = r.pcount;
        }
    } else if (warp == 1) {
        FFNFiltRole r;
        r.w1 = ff_row(sti, 1, B, b, true);
        r.mdev = ff_row(sti, 2, B, b, true);
        r.avg = ff_row(sti, 3, B, b, true);
        r.iir_a = a.iir_a;
        r.mw0 = a.mdev_w0;
        r.mw1 = a.mdev_w1;
        r.aw0 = a.mean_w0;
        r.aw1 = a.mean_w1;
        r.B = Bu;
        r.valid = live && box == 0;
        r.filt_out.init(a.deps + (int64_t)NBV * TB, b);
        r.mdev_out.init(a.out_mdev, b);
        r.avg_out.init(a.out_avg, b);
        r.put_mdev = r.valid && a.out_mdev != nullptr;
        r.put_avg = r.valid && a.out_avg != nullptr;
        ffn_consume<U>(r, st, a.T, a.base, col, lane);
        if (r.valid) {
            sto[1 * B + b] = r.w1;
            sto[2 * B + b] = r.mdev;
            sto[3 * B + b] = r.avg;
        }
    } else if (warp == 2) {
        const int i = box < NPB ? box : 0;
        int off = rp_off;
        for (int j = 0; j < i; ++j) off += a.rp_ring[j];
        FFNProdRole r;
        r.w1 = ff_row(sti, 1, B, b, true);
        r.iir_a = a.iir_a;
        r.s = ff_row(sti, a.sums_off + NBV + NQ + i, B, b, true);
        r.lag = a.pb_lag[i];
        r.box = a.pb_box[i];
        r.pmask = a.rp_ring[i] - 1;
        r.fmask = a.rf_ring - 1;
        r.rf = rf;
        r.rp = rp;
        r.B = Bu;
        r.valid = live && box < NPB;
        r.out.init(a.out_p[i], b);
        r.put = r.valid && a.out_p[i] != nullptr;
        ff_ring_in(rf, sti, rf_off, a.rf_ring, B, b, true);
        ff_ring_in(rp, sti, off, a.rp_ring[i], B, b, true);
        ffn_consume<U>(r, st, a.T, a.base, col, lane);
        if (r.valid) {
            sto[(int64_t)(a.sums_off + NBV + NQ + i) * B + b] = r.s;
            ff_ring_out(rp, sto, off, a.rp_ring[i], B, b, true);
        }
        ff_ring_out(rf, sto, rf_off, a.rf_ring, B, b, live && box == 0);
    } else if (warp == 3) {
        const int i = box < NQ ? box : 0;
        FFNQRole r;
        r.w1 = ff_row(sti, 1, B, b, true);
        r.iir_a = a.iir_a;
        r.s = ff_row(sti, a.sums_off + NBV + i, B, b, true);
        r.w = a.q_w[i];
        r.mask = a.rq_ring - 1;
        r.ring = rq;
        r.B = Bu;
        r.valid = live && box < NQ;
        r.out.init(a.out_q[i], b);
        r.put = r.valid && a.out_q[i] != nullptr;
        ff_ring_in(rq, sti, rq_off, a.rq_ring, B, b, true);
        ffn_consume<U>(r, st, a.T, a.base, col, lane);
        if (r.valid) sto[(int64_t)(a.sums_off + NBV + i) * B + b] = r.s;
        ff_ring_out(rq, sto, rq_off, a.rq_ring, B, b, live && box == 0);
    } else if (warp == 4) {
        const int i = box < NBV ? box : 0;
        FFNBvRole r;
        r.s = ff_row(sti, a.sums_off + i, B, b, true);
        r.w = a.bv_w[i];
        r.mask = a.rv_ring - 1;
        r.ring = rv;
        r.B = Bu;
        r.valid = live && box < NBV;
        r.out.init(a.deps + (int64_t)i * TB, b);
        ff_ring_in(rv, sti, rv_off, a.rv_ring, B, b, true);
        ffn_consume<U>(r, st, a.T, a.base, col, lane);
        if (r.valid) sto[(int64_t)(a.sums_off + i) * B + b] = r.s;
        ff_ring_out(rv, sto, rv_off, a.rv_ring, B, b, live && box == 0);
    } else {
        ffn_produce(a, st, lane, b0, nb);
    }
}

// ---------------------------------------------------------------------------
// ff_mask_kernel: mod_depth, detect_mask and the history advance, parallel
// in time
//
// A block owns W streams (W = 32, 128-byte rows, lane = stream; or W = 16,
// 64-byte rows, for the plans whose rings do not fit at 32) and a span of
// FF_MASK_SPAN chunk rows, walked in sub-tiles of FF_MASK_TILE rows.  The
// lags come from the plan at run time, and each channel's lags are grouped
// into lag windows: a window is a run of one channel's lags lmin..lmax,
// staged into a shared ring of its own.  The launcher splits each
// channel's sorted lags where that needs the fewest ring rows
// (ff_mask_plan): at 10 MS/s every channel is one window (bv12's A lags
// 141..153 and F lags 0..12 share a ring of 512 rows), at 40 MS/s bv47's A
// lags 567..614 and F lags 0..47 are two rings of 256.
//
// The FF_MASK_PRODUCERS producer warps copy every window's rows of every
// sub-tile, in order, with cp.async, taking the rows in turn: a window
// with lags lmin..lmax gets rows [J - lmin, J + n - lmin) for the sub-tile
// of rows [J, J + n), and the span's first sub-tile also the spread behind
// them, so each row is read from memory once per span.  Row r lands at
// slot r & (P - 1) of a ring of P >= spread + STAGES * TILE slots.  Each
// of the FF_MASK_STAGES stages has a "full" mbarrier (every producer
// lane's copies landed) and an "empty" one (the sub-tile's consumers are
// done).  A producer waits for a stage's previous sub-tile before it
// refills it; since it takes the sub-tiles in order, every older sub-tile
// is done too, so no slot is rewritten before every sub-tile that reads it
// is done.  Rows before the chunk (r < 0) come from the channel's history
// section of the input state, at the plain offset hist_off + hist_len + r.
// Each ring is followed by FF_MASK_PAD rows that mirror its first (the
// producer copies a row there too), so that a thread's FF_MASK_ROWS / S
// rows j, j + S, ... (S = 32 / W) load from one slot at fixed offsets.
//
// The FF_MASK_WARPS consumer warps form FF_MASK_TEAMS teams of
// FF_MASK_CPS warps that take the sub-tiles in turn (one team of 16 as
// built: smaller sub-tiles in more teams cost the producers more per row
// than they gain, PERF.md); a warp takes the groups of FF_MASK_ROWS rows of
// its team's sub-tile in turn (W = 16: each half-warp every other row of
// the group, so that the two halves read slots of unlike parity, with no
// bank conflict).  Every lookback is one slot computed a group and a
// shared load a row; every SD threshold test is decided by the float32
// band of sd_band (condition_step.cuh), and a row the band leaves
// undecided is decided again, exactly, by the divide-free sd_above;
// mod_depth is cond_mod_depth_split.  Last, every warp of the grid copies
// its share of the history rows into state_out: section k keeps the last
// hist_len[k] values of channel k, oldest first.  The lookbacks read
// state_in only, so the order between blocks does not matter while
// state_in and state_out are apart (the launcher checks).

#define FF_MASK_WARPS 16    // consumers, then the producers
#define FF_MASK_PRODUCERS 4
#define FF_MASK_THREADS ((FF_MASK_WARPS + FF_MASK_PRODUCERS) * 32)
#define FF_MASK_TILE 64     // rows of a sub-tile
#define FF_MASK_STAGES 2    // sub-tiles in flight
#define FF_MASK_SPAN 2048   // rows of a block's span, a multiple of the tile
#define FF_MASK_ROWS 4      // rows a consumer warp takes at once
#define FF_MASK_PAD 3       // rows after each ring that mirror its first
#define FF_MASK_MAX_WIN 16
// the detect cascades of every plan from 0.5 to 40 MS/s: three NFC-A
// rates, two NFC-F, two NFC-B delays (the launcher refuses other counts)
#define FF_MASK_NA 3
#define FF_MASK_NF 2
#define FF_MASK_NB 2
#define FF_MASK_CHANNELS (FF_MAX_BV + 3)  // raw boxes, filtered, env, samples
#define FF_MASK_MAX_LAGS 16               // distinct lags of one channel
#define FF_SMEM_LIMIT 232448              // shared memory a block may use
static_assert(FF_MASK_SPAN % FF_MASK_TILE == 0, "whole sub-tiles in a span");
static_assert(FF_MASK_TILE % FF_MASK_ROWS == 0, "whole row groups");
// groups of FF_MASK_ROWS rows a sub-tile, consumer warps a sub-tile (each
// taking its groups in turn), and the teams of them that take the
// sub-tiles in turn
#define FF_MASK_GROUPS (FF_MASK_TILE / FF_MASK_ROWS)
#define FF_MASK_CPS \
    (FF_MASK_WARPS < FF_MASK_GROUPS ? FF_MASK_WARPS : FF_MASK_GROUPS)
#define FF_MASK_TEAMS (FF_MASK_WARPS / FF_MASK_CPS)
static_assert(FF_MASK_WARPS % FF_MASK_CPS == 0, "whole teams");
// a full and an empty mbarrier per stage, padded to 16 B, before the rings
#define FF_MASK_BARS (((2 * FF_MASK_STAGES * 8 + 15) / 16) * 16)

// a staged lag window of one channel
struct FFMaskWin {
    const float *src;   // the channel's chunk rows [T, B]
    const float *hist;  // its history row of chunk row 0 (row r < 0 at
                        // hist + r B), or null (never read before the chunk)
    int32_t ch, lmin, lmax, base, rows;  // rows: a power of two
};

// one lookback: channel row j - lag, in the ring at rows base..base + mask
// of window `win`
struct FFMaskLag {
    int32_t base, mask, lag, win;
};

// what the launcher derives from FFMaskArgs for the kernel
struct FFMaskLaunch {
    FFMaskArgs a;
    int32_t n_win;
    FFMaskWin win[FF_MASK_MAX_WIN];
    FFMaskLag env, val;
    FFMaskLag ra[FF_MASK_NA][3];    // NFC-A: b0, b1, bg
    FFMaskLag rf[FF_MASK_NF][3];    // NFC-F: b0, b1, bg
    FFMaskLag rb[FF_MASK_NB];       // NFC-B: the filtered row
    FFMaskLag rv[2];                // NFC-V: u0, ug
    double p2a[FF_MASK_NA], p2f[FF_MASK_NF], p2v;  // the SD divisors
    // the band's RN(RN(1 / p2) (1 -+ 2^-20)) per test (sd_band)
    float rla[FF_MASK_NA], rha[FF_MASK_NA], rlf[FF_MASK_NF], rhf[FF_MASK_NF];
    float rlv, rhv;
    float env_lo, env_hi;  // the band decides where env lies in between
    int32_t streams;                // W, 0 where the rings do not fit
    int64_t smem;
    int32_t wide;                   // 16-byte copies
};
static_assert(sizeof(FFMaskLaunch) <= 4096, "one kernel parameter block");

template <int W, bool WIDE>
__device__ __forceinline__ void ff_mask_copy(const FFMaskWin &g, float *rings,
                                             int lo, int hi, int64_t B,
                                             int64_t b, int col, int p,
                                             int lane)
{
    constexpr int NP = FF_MASK_PRODUCERS;
    constexpr int CPR = WIDE ? W / 4 : W;   // lanes a row
    constexpr int RPI = 32 / CPR;           // rows a warp copies at once
    float *ring = rings + g.base * W + col;
    const int mask = g.rows - 1;
    const int stop = hi < 0 ? hi : 0;   // rows before the chunk
    int r = lo + p * RPI + lane / CPR;
    const auto put = [&](const float *src) {
        const int slot = r & mask;
        float *dst = ring + slot * W;
        if (WIDE) {
            cp_async16(dst, src);
            if (slot < FF_MASK_PAD) cp_async16(dst + g.rows * W, src);
        } else {
            cp_async4(dst, src);
            if (slot < FF_MASK_PAD) cp_async4(dst + g.rows * W, src);
        }
    };
    const int64_t step = (int64_t)NP * RPI * B;
    if (r < stop) {
        const float *src = g.hist + (int64_t)r * B + b;
        for (; r < stop; r += NP * RPI, src += step) put(src);
    }
    const float *src = g.src + (int64_t)r * B + b;
    for (; r < hi; r += NP * RPI, src += step) put(src);
}

// Producer warp p: for each sub-tile of the span in order, once its stage
// is handed back, its share of the copies of every window's rows [lo, hi)
// into their rings (a row whose slot is below FF_MASK_PAD also into the
// mirror after the ring), the producers taking the rows in turn: WIDE,
// 16-byte copies where every row of the block's columns is 16-byte
// aligned (W / 4 lanes a row), else one 4-byte column a lane; columns past
// the last stream are not copied.
template <int W, bool WIDE>
__device__ __forceinline__ void ff_mask_produce(const FFMaskLaunch &k,
                                                float *rings, uint64_t *full,
                                                uint64_t *empty, int span0,
                                                int span1, int ntiles, int p,
                                                int lane)
{
    constexpr int NP = FF_MASK_PRODUCERS;
    constexpr int CPR = WIDE ? W / 4 : W;   // lanes a row
    constexpr int RPI = 32 / CPR;           // rows a warp copies at once
    const int64_t B = k.a.B;
    const int col = WIDE ? (lane % CPR) * 4 : lane % CPR;
    const int64_t b = (int64_t)blockIdx.x * W + col;
    const bool lane_ok = b < B;
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % FF_MASK_STAGES;
        if (i >= FF_MASK_STAGES)
            mbar_wait(empty + s, (uint32_t)(i / FF_MASK_STAGES - 1) & 1u);
        const int J = span0 + i * FF_MASK_TILE;
        const int n = span1 - J < FF_MASK_TILE ? span1 - J : FF_MASK_TILE;
        for (int w = 0; w < k.n_win && lane_ok; ++w) {
            const FFMaskWin &g = k.win[w];
            float *ring = rings + g.base * W + col;
            const int mask = g.rows - 1;
            const int hi = J + n - g.lmin;
            const int stop = hi < 0 ? hi : 0;   // rows before the chunk
            int r = (i == 0 ? J - g.lmax : J - g.lmin) + p * RPI + lane / CPR;
            const auto put = [&](const float *src) {
                const int slot = r & mask;
                float *dst = ring + slot * W;
                if (WIDE) {
                    cp_async16(dst, src);
                    if (slot < FF_MASK_PAD) cp_async16(dst + g.rows * W, src);
                } else {
                    cp_async4(dst, src);
                    if (slot < FF_MASK_PAD) cp_async4(dst + g.rows * W, src);
                }
            };
            const int64_t step = (int64_t)NP * RPI * B;
            if (r < stop) {
                const float *src = g.hist + (int64_t)r * B + b;
                for (; r < stop; r += NP * RPI, src += step) put(src);
            }
            const float *src = g.src + (int64_t)r * B + b;
            for (; r < hi; r += NP * RPI, src += step) put(src);
        }
        cp_async_arrive(full + s);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// the lookback l of chunk row j, from its ring at this lane's column
template <int W>
__device__ __forceinline__ float ff_mask_at(const float *col,
                                            const FFMaskLag &l, int j)
{
    return col[(l.base + ((j - l.lag) & l.mask)) * W];
}

// rows j0 + k S (k < G, S = 32 / W) of lookback l, from one slot: G
// loads, 32 floats (128 bytes) apart
template <int W, int G>
__device__ __forceinline__ void ff_mask_load(const float *col,
                                             const FFMaskLag &l, int j0,
                                             float (&v)[G])
{
    const float *p = col + (l.base + ((j0 - l.lag) & l.mask)) * W;
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = p[32 * k];
}

// detect_mask at chunk row j of this lane's stream (NfcA.cpp:224-291,
// NfcB.cpp:283, NfcF, NfcV.cpp:236-435), every test decided by sd_above:
// the rows the band leaves undecided.  Every bit is gated by env >=
// power_thr.
template <int W>
__device__ __noinline__ int ff_mask_row(const FFMaskLaunch &k,
                                           const float *col, int j,
                                           float env)
{
    const FFMaskArgs &a = k.a;
    const bool power_ok = env >= a.power_thr;
    const auto at = [&](const FFMaskLag &l) {
        return ff_mask_at<W>(col, l, j);
    };
    // NFC-A and NFC-F: |((b0 - bg) - (bg - b1)) / p2| > thr * env
    const float ya = __fmul_rn(a.a_thr, env);
    const float yf = __fmul_rn(a.f_thr, env);
    const double ma = sd_midpoint(ya), mf = sd_midpoint(yf);
    const bool da = power_ok & sd_special(ya), df = power_ok & sd_special(yf);
    int m = 0;
#pragma unroll
    for (int q = 0; q < FF_MASK_NA; ++q) {
        const float b0 = at(k.ra[q][0]), b1 = at(k.ra[q][1]);
        const float bg = at(k.ra[q][2]);
        const float n = __fsub_rn(__fsub_rn(b0, bg), __fsub_rn(bg, b1));
        m += sd_above(fabsf(n), ya, ma, k.p2a[q], da) ? a.a_bit[q] : 0;
    }
#pragma unroll
    for (int q = 0; q < FF_MASK_NF; ++q) {
        const float b0 = at(k.rf[q][0]), b1 = at(k.rf[q][1]);
        const float bg = at(k.rf[q][2]);
        const float n = __fsub_rn(__fsub_rn(b0, bg), __fsub_rn(bg, b1));
        m += sd_above(fabsf(n), yf, mf, k.p2f[q], df) ? a.f_bit[q] : 0;
    }
    // NFC-B: falling edge filtered[j - d] < -(b_min_deep * env)
    const float edge_b = -__fmul_rn(a.b_min_deep, env);
#pragma unroll
    for (int q = 0; q < FF_MASK_NB; ++q)
        m += at(k.rb[q]) < edge_b ? a.b_bit[q] : 0;
    // NFC-V: signed (u[j - d - gap] - u[j - d]) / p2 > thr * env
    const float yv = __fmul_rn(a.v_thr, env);
    m += sd_above(__fsub_rn(at(k.rv[1]), at(k.rv[0])), yv, sd_midpoint(yv),
                  k.p2v, power_ok & sd_special(yv)) ? a.v_bit : 0;
    return power_ok ? m : 0;
}

// The rows j0 + k S (k < G, the first nv of them in the sub-tile) of this
// lane's stream: mod_depth, and detect_mask with every SD test decided by
// the band (sd_band), a row it leaves undecided, or whose env lies outside
// [env_lo, env_hi], by ff_mask_row.
template <int W>
__device__ __forceinline__ void ff_mask_group(const FFMaskLaunch &k,
                                              const float *col, int j0,
                                              int nv, int64_t b, bool valid)
{
    constexpr int S = 32 / W;
    constexpr int G = FF_MASK_ROWS / S;
    const FFMaskArgs &a = k.a;
    const int64_t B = a.B;
    float env[G];
    ff_mask_load<W>(col, k.env, j0, env);
    if (a.out_mod_depth) {
        float v[G];
        ff_mask_load<W>(col, k.val, j0, v);
#pragma unroll
        for (int r = 0; r < G; ++r) {
            const float md = cond_mod_depth_split(v[r], env[r]);
            if (valid && r < nv)
                __stcg(a.out_mod_depth + (int64_t)(j0 + r * S) * B + b, md);
        }
    }
    if (!a.out_mask) return;
    int m[G];
    bool slow[G];
    float y[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
        m[r] = 0;
        slow[r] = !(env[r] >= k.env_lo && env[r] <= k.env_hi);
        y[r] = __fmul_rn(a.a_thr, env[r]);
    }
    // NFC-A and NFC-F: |((b0 - bg) - (bg - b1)) / p2| > thr * env
#pragma unroll
    for (int q = 0; q < FF_MASK_NA; ++q) {
        float b0[G], b1[G], bg[G];
        ff_mask_load<W>(col, k.ra[q][0], j0, b0);
        ff_mask_load<W>(col, k.ra[q][1], j0, b1);
        ff_mask_load<W>(col, k.ra[q][2], j0, bg);
#pragma unroll
        for (int r = 0; r < G; ++r) {
            const float n = __fsub_rn(__fsub_rn(b0[r], bg[r]),
                                      __fsub_rn(bg[r], b1[r]));
            m[r] += sd_band(fabsf(n), k.rla[q], k.rha[q], y[r], slow[r])
                        ? a.a_bit[q] : 0;
        }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) y[r] = __fmul_rn(a.f_thr, env[r]);
#pragma unroll
    for (int q = 0; q < FF_MASK_NF; ++q) {
        float b0[G], b1[G], bg[G];
        ff_mask_load<W>(col, k.rf[q][0], j0, b0);
        ff_mask_load<W>(col, k.rf[q][1], j0, b1);
        ff_mask_load<W>(col, k.rf[q][2], j0, bg);
#pragma unroll
        for (int r = 0; r < G; ++r) {
            const float n = __fsub_rn(__fsub_rn(b0[r], bg[r]),
                                      __fsub_rn(bg[r], b1[r]));
            m[r] += sd_band(fabsf(n), k.rlf[q], k.rhf[q], y[r], slow[r])
                        ? a.f_bit[q] : 0;
        }
    }
    // NFC-B: falling edge filtered[j - d] < -(b_min_deep * env)
#pragma unroll
    for (int q = 0; q < FF_MASK_NB; ++q) {
        float f[G];
        ff_mask_load<W>(col, k.rb[q], j0, f);
#pragma unroll
        for (int r = 0; r < G; ++r)
            m[r] += f[r] < -__fmul_rn(a.b_min_deep, env[r]) ? a.b_bit[q] : 0;
    }
    // NFC-V: signed (u[j - d - gap] - u[j - d]) / p2 > thr * env
    {
        float u0[G], ug[G];
        ff_mask_load<W>(col, k.rv[0], j0, u0);
        ff_mask_load<W>(col, k.rv[1], j0, ug);
#pragma unroll
        for (int r = 0; r < G; ++r)
            m[r] += sd_band(__fsub_rn(ug[r], u0[r]), k.rlv, k.rhv,
                            __fmul_rn(a.v_thr, env[r]), slow[r])
                        ? a.v_bit : 0;
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
        if (r >= nv) break;
        const bool power_ok = env[r] >= a.power_thr;
        int mr = m[r];
        if (__builtin_expect(power_ok & slow[r], 0))
            mr = ff_mask_row<W>(k, col, j0 + r * S, env[r]);
        if (valid)
            a.out_mask[(int64_t)(j0 + r * S) * B + b] =
                (uint8_t)(power_ok ? mr : 0);
    }
}

// The history advance, spread over every warp of the grid: history row q
// (section k, row i) is channel k's row T - hist_len[k] + i, from this
// chunk or, before it, from the input section shifted by T.
template <int W>
__device__ __forceinline__ void ff_mask_history(const FFMaskArgs &a,
                                                int warp, int lane)
{
    constexpr int RPI = 32 / W;   // rows a warp copies at once
    constexpr int NW = FF_MASK_THREADS / 32;
    const int64_t B = a.B, T = a.T;
    const int64_t b = (int64_t)blockIdx.x * W + lane % W;
    if (b >= B) return;
    const int step = (int)gridDim.y * NW * RPI;
    for (int q = ((int)blockIdx.y * NW + warp) * RPI + lane / W;
         q < a.hist_rows; q += step) {
        int i = q, ch = 0, n = a.hist_len[0], off = a.hist_off[0];
#pragma unroll
        for (int c = 1; c < FF_MAX_HIST; ++c) {
            if (i >= n) {
                i -= n;
                ch = c;
                n = a.hist_len[c];
                off = a.hist_off[c];
            }
        }
        const int64_t p = T + i - n;
        const float x = p >= 0
            ? a.deps[((int64_t)ch * T + p) * B + b]
            : a.state_in[(off + n + p) * B + b];
        a.state_out[(int64_t)(off + i) * B + b] = x;
    }
}

template <int W>
__global__ void __launch_bounds__(FF_MASK_THREADS, 1)
ff_mask_kernel(const __grid_constant__ FFMaskLaunch k)
{
    const FFMaskArgs &a = k.a;
    uint64_t *full = reinterpret_cast<uint64_t *>(ff_dyn_smem);
    uint64_t *empty = full + FF_MASK_STAGES;
    float *rings = reinterpret_cast<float *>(ff_dyn_smem + FF_MASK_BARS);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t B = a.B;
    const int T = (int)a.T;
    const int64_t b0 = (int64_t)blockIdx.x * W;
    const int span0 = (int)blockIdx.y * FF_MASK_SPAN;
    const int span1 = T - span0 < FF_MASK_SPAN ? T : span0 + FF_MASK_SPAN;
    const int ntiles = a.rows_main == 0 ? 0
        : (span1 - span0 + FF_MASK_TILE - 1) / FF_MASK_TILE;

    if (threadIdx.x == 0) {
        for (int s = 0; s < FF_MASK_STAGES; ++s) {
            mbar_init(full + s, 32 * FF_MASK_PRODUCERS);
            mbar_init(empty + s, FF_MASK_CPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= FF_MASK_WARPS) {
        const int p = warp - FF_MASK_WARPS;
        if (k.wide)
            ff_mask_produce<W, true>(k, rings, full, empty, span0, span1,
                                     ntiles, p, lane);
        else
            ff_mask_produce<W, false>(k, rings, full, empty, span0, span1,
                                      ntiles, p, lane);
    } else {
        constexpr int S = 32 / W;   // rows between a thread's rows
        const int64_t b = b0 + lane % W;
        const bool valid = b < B;
        const float *col = rings + lane % W;
        for (int i = warp / FF_MASK_CPS; i < ntiles; i += FF_MASK_TEAMS) {
            const int s = i % FF_MASK_STAGES;
            mbar_wait(full + s, (uint32_t)(i / FF_MASK_STAGES) & 1u);
            const int J = span0 + i * FF_MASK_TILE;
            const int n = span1 - J < FF_MASK_TILE ? span1 - J : FF_MASK_TILE;
            for (int g = warp % FF_MASK_CPS; g * FF_MASK_ROWS < n;
                 g += FF_MASK_CPS) {
                const int r0 = g * FF_MASK_ROWS + lane / W;
                // rows of the group within the sub-tile
                const int nv = r0 < n ? (n - r0 + S - 1) / S : 0;
                ff_mask_group<W>(k, col, J + r0, nv, b, valid);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s);
        }
    }
    ff_mask_history<W>(a, warp, lane);
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

// ff_scan_kernel_narrow's instantiations: those of ff_scan_kernel
static FFScanKernel ffn_scan_pick(int group, int nbv, int nq, int npb)
{
    if (nq != 2 || npb != 3) return nullptr;
#define FFN_PICK(U_, NBV_) \
    if (group == U_ && nbv == NBV_) return ff_scan_kernel_narrow<U_, NBV_, 2, 3>;
    FFN_PICK(6, 4) FFN_PICK(2, 4) FFN_PICK(1, 4)
    FFN_PICK(6, 3) FFN_PICK(2, 3) FFN_PICK(1, 3)
#undef FFN_PICK
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

// the ring rows of a lag window of spread lmax - lmin: a power of two that
// holds the spread and the sub-tiles in flight
static int ff_mask_ring(int spread)
{
    int p = 1;
    while (p < spread + FF_MASK_STAGES * FF_MASK_TILE) p <<= 1;
    return p;
}

static int64_t ff_mask_smem(int ring_rows, int streams)
{
    return FF_MASK_BARS + 4LL * streams * ring_rows;
}

// the distinct lags a selection reads, by channel: the raw boxes
// 0..n_bv-1, filtered n_bv, env n_bv + 1, the samples n_bv + 2
struct FFMaskLagSets {
    int n[FF_MASK_CHANNELS];
    int lag[FF_MASK_CHANNELS][FF_MASK_MAX_LAGS];
    bool ok;

    void add(int ch, int l)
    {
        if (ch < 0 || ch >= FF_MASK_CHANNELS || l < 0) {
            ok = false;
            return;
        }
        for (int i = 0; i < n[ch]; ++i)
            if (lag[ch][i] == l) return;
        if (n[ch] == FF_MASK_MAX_LAGS) {
            ok = false;
            return;
        }
        lag[ch][n[ch]++] = l;
    }
};

// the window of channel ch that holds lag l, as a lookback
static FFMaskLag ff_mask_lag(const FFMaskLaunch &k, int ch, int l)
{
    for (int w = 0; w < k.n_win; ++w) {
        const FFMaskWin &g = k.win[w];
        if (g.ch == ch && g.lmin <= l && l <= g.lmax)
            return FFMaskLag{g.base, g.rows - 1, l, w};
    }
    return FFMaskLag{0, 0, l, -1};
}

// The kernel's geometry for the lags of a plan and a selection: each
// channel's sorted lags split into windows where that takes the fewest
// ring rows (of equal splits the one with fewer windows, then the first in
// the order of the cut masks), windows in channel and lag order, rings in
// that order; every lookback resolved to its window; W = 32 streams a block
// where the rings fit in FF_SMEM_LIMIT, else 16, else 0.  Pointers are not
// set here.  Returns false for a plan outside the kernel's limits.
static bool ff_mask_plan(const FFMaskArgs *a, bool want_mask, bool want_md,
                         FFMaskLaunch *k)
{
    *k = FFMaskLaunch{};
    k->a = *a;
    const int nbv = a->n_bv;
    if (nbv < 1 || nbv > FF_MAX_BV || a->n_a != FF_MASK_NA
        || a->n_f != FF_MASK_NF || a->n_b != FF_MASK_NB)
        return false;
    FFMaskLagSets ls{};
    ls.ok = true;
    const auto box = [&](int ch, int l) { ls.add(ch < nbv ? ch : -1, l); };
    if (want_mask || want_md) ls.add(nbv + 1, 0);
    if (want_md) ls.add(nbv + 2, 0);
    if (want_mask) {
        for (int q = 0; q < a->n_a; ++q) {
            box(a->a_ch[q], a->a_d[q]);
            box(a->a_ch[q], a->a_d[q] + 1);
            box(a->a_ch[q], a->a_d[q] + a->a_gap[q]);
        }
        for (int q = 0; q < a->n_f; ++q) {
            box(a->f_ch[q], 0);
            box(a->f_ch[q], 1);
            box(a->f_ch[q], a->f_gap[q]);
        }
        for (int q = 0; q < a->n_b; ++q) ls.add(nbv, a->b_d[q]);
        box(a->v_ch, a->v_d);
        box(a->v_ch, a->v_d + a->v_gap);
    }
    if (!ls.ok) return false;
    int rows = 0;
    for (int ch = 0; ch < FF_MASK_CHANNELS; ++ch) {
        const int n = ls.n[ch];
        if (n == 0) continue;
        int *l = ls.lag[ch];
        for (int i = 1; i < n; ++i)
            for (int j = i; j > 0 && l[j - 1] > l[j]; --j) {
                const int t = l[j];
                l[j] = l[j - 1];
                l[j - 1] = t;
            }
        // bit i of `cuts`: a window ends at lag i
        int best = -1, best_cost = 0, best_nw = 0;
        for (int cuts = 0; cuts < (1 << (n - 1)); ++cuts) {
            int cost = 0, nw = 0, first = 0;
            for (int i = 0; i < n; ++i)
                if (i == n - 1 || ((cuts >> i) & 1)) {
                    cost += ff_mask_ring(l[i] - l[first]);
                    ++nw;
                    first = i + 1;
                }
            if (best < 0 || cost < best_cost
                || (cost == best_cost && nw < best_nw)) {
                best = cuts;
                best_cost = cost;
                best_nw = nw;
            }
        }
        int first = 0;
        for (int i = 0; i < n; ++i)
            if (i == n - 1 || ((best >> i) & 1)) {
                if (k->n_win == FF_MASK_MAX_WIN) return false;
                FFMaskWin &g = k->win[k->n_win++];
                g.ch = ch;
                g.lmin = l[first];
                g.lmax = l[i];
                g.rows = ff_mask_ring(g.lmax - g.lmin);
                g.base = rows;
                rows += g.rows + FF_MASK_PAD;
                first = i + 1;
            }
    }
    k->env = ff_mask_lag(*k, nbv + 1, 0);
    k->val = ff_mask_lag(*k, nbv + 2, 0);
    if (want_mask) {
        for (int q = 0; q < a->n_a; ++q) {
            k->ra[q][0] = ff_mask_lag(*k, a->a_ch[q], a->a_d[q]);
            k->ra[q][1] = ff_mask_lag(*k, a->a_ch[q], a->a_d[q] + 1);
            k->ra[q][2] = ff_mask_lag(*k, a->a_ch[q], a->a_d[q] + a->a_gap[q]);
        }
        for (int q = 0; q < a->n_f; ++q) {
            k->rf[q][0] = ff_mask_lag(*k, a->f_ch[q], 0);
            k->rf[q][1] = ff_mask_lag(*k, a->f_ch[q], 1);
            k->rf[q][2] = ff_mask_lag(*k, a->f_ch[q], a->f_gap[q]);
        }
        for (int q = 0; q < a->n_b; ++q)
            k->rb[q] = ff_mask_lag(*k, nbv, a->b_d[q]);
        k->rv[0] = ff_mask_lag(*k, a->v_ch, a->v_d);
        k->rv[1] = ff_mask_lag(*k, a->v_ch, a->v_d + a->v_gap);
    }
    // the band: RN(1 / p2) scaled by 1 -+ 2^-20, each rounded (host float
    // arithmetic is IEEE single here), for env in [2^-60, 2^60] where every
    // threshold lies in [2^-40, 2^40], so that y = thr env lies in
    // [2^-100, 2^100]; else no env (every row through sd_above)
    const auto band = [](float p2, float *lo, float *hi) {
        const float r = 1.0f / p2;
        *lo = r * 0x1.ffffep-1f;
        *hi = r * 0x1.00001p0f;
    };
    for (int q = 0; q < FF_MASK_NA; ++q) {
        k->p2a[q] = a->a_p2[q];
        band(a->a_p2[q], &k->rla[q], &k->rha[q]);
    }
    for (int q = 0; q < FF_MASK_NF; ++q) {
        k->p2f[q] = a->f_p2[q];
        band(a->f_p2[q], &k->rlf[q], &k->rhf[q]);
    }
    k->p2v = a->v_p2;
    band(a->v_p2, &k->rlv, &k->rhv);
    // (and the divisors in [1, 2^20], so that each r is normal)
    const auto moderate = [](float t) {
        return t >= 0x1p-40f && t <= 0x1p40f;
    };
    const auto divisor = [](float p2) { return p2 >= 1.0f && p2 <= 0x1p20f; };
    bool fast = moderate(a->a_thr) && moderate(a->f_thr)
                && moderate(a->v_thr) && divisor(a->v_p2);
    for (int q = 0; q < FF_MASK_NA; ++q) fast = fast && divisor(a->a_p2[q]);
    for (int q = 0; q < FF_MASK_NF; ++q) fast = fast && divisor(a->f_p2[q]);
    k->env_lo = fast ? 0x1p-60f : INFINITY;
    k->env_hi = fast ? 0x1p60f : -INFINITY;
    k->streams = ff_mask_smem(rows, 32) <= FF_SMEM_LIMIT ? 32
        : ff_mask_smem(rows, 16) <= FF_SMEM_LIMIT ? 16 : 0;
    k->smem = ff_mask_smem(rows, k->streams ? k->streams : 16);
    return true;
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

// Queues ff_scan_kernel_narrow, as nfclab_ff_scan queues ff_scan_kernel:
// refused (cudaErrorInvalidValue) unless `threads` is FFN_WARPS * 32,
// `smem_bytes` holds the barriers, the [FF_TILE_ROWS, 8] stages and the
// rings (rv, rq, rf and the largest product ring, 32 columns each), 1 <= B
// <= 2^25, the counts and group size are instantiated, and the group is no
// longer than the least box width and lag.
int nfclab_ff_scan_narrow(const FFScanArgs *a, int device, int threads,
                          int64_t smem_bytes, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    int rp = 0;
    for (int i = 0; i < a->n_pb && i < FF_MAX_PB; ++i)
        rp = a->rp_ring[i] > rp ? a->rp_ring[i] : rp;
    const int64_t need = 16LL * FF_STAGES
        + 4LL * FF_STAGES * FF_TILE_ROWS * FFN_STREAMS
        + 128LL * (a->rv_ring + a->rq_ring + a->rf_ring + rp);
    const FFScanKernel k = ffn_scan_pick(a->group, a->n_bv, a->n_q, a->n_pb);
    if (k == nullptr || threads != FFN_WARPS * 32 || smem_bytes < need
        || a->B < 1 || a->B > (1LL << 25)
        || a->group > ff_min_distance(a))
        return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute((const void *)k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->B + FFN_STREAMS - 1) / FFN_STREAMS;
    k<<<(unsigned)blocks, threads, (size_t)smem_bytes,
        (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

// The mask kernel's geometry for the lags in `a` and a selection, for the
// binding to hold its mirror to: consumer and producer warps, sub-tile
// rows, stages, span rows, streams a block (0: the rings do not fit),
// shared memory per block (at 16 streams where none fit), the window count,
// then per window its channel, least and largest lag, ring rows and first
// ring row.  Returns the count written (at most n), -1 for a plan outside
// the kernel's limits.
int nfclab_ff_mask_geometry(const FFMaskArgs *a, int want_mask, int want_md,
                            int32_t *g, int n)
{
    FFMaskLaunch k;
    if (!ff_mask_plan(a, want_mask != 0, want_md != 0, &k)) return -1;
    int32_t v[8 + 5 * FF_MASK_MAX_WIN] = {
        FF_MASK_WARPS, FF_MASK_PRODUCERS, FF_MASK_TILE, FF_MASK_STAGES,
        FF_MASK_SPAN, k.streams, (int32_t)k.smem, k.n_win};
    for (int w = 0; w < k.n_win; ++w) {
        const FFMaskWin &x = k.win[w];
        const int32_t row[5] = {x.ch, x.lmin, x.lmax, x.rows, x.base};
        for (int i = 0; i < 5; ++i) v[8 + 5 * w + i] = row[i];
    }
    const int m = n < 8 + 5 * k.n_win ? n : 8 + 5 * k.n_win;
    for (int i = 0; i < m; ++i) g[i] = v[i];
    return m;
}

// Queues ff_mask_kernel for the selection that out_mask and out_mod_depth
// make (neither: the history advance alone).  Refused
// (cudaErrorInvalidValue) unless `threads` is FF_MASK_THREADS, 1 <= B <=
// 2^25, 1 <= T <= 65535 spans, rows_main is T with an output and 0
// without, the plan is within the kernel's limits and
// its rings fit a block at 16 streams or more, every lookback before the
// chunk lies in its channel's history section, hist_rows is the sections'
// total, and the state rows that state_in and state_out span do not
// overlap.
int nfclab_ff_mask(const FFMaskArgs *a, int device, int threads,
                   void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    FFMaskLaunch k;
    const bool want_mask = a->out_mask != nullptr;
    const bool want_md = a->out_mod_depth != nullptr;
    const int64_t B = a->B, T = a->T;
    const int64_t spans = (T + FF_MASK_SPAN - 1) / FF_MASK_SPAN;
    if (threads != FF_MASK_THREADS || B < 1 || B > (1LL << 25) || T < 1
        || spans > 65535 || a->rows_main != (want_mask || want_md ? T : 0)
        || !ff_mask_plan(a, want_mask, want_md, &k) || k.streams == 0)
        return (int)cudaErrorInvalidValue;
    int hist = 0, top = 0;
    for (int ch = 0; ch <= a->n_bv; ++ch) {
        hist += a->hist_len[ch];
        const int end = a->hist_off[ch] + a->hist_len[ch];
        top = end > top ? end : top;
    }
    const int64_t span_bytes = 4LL * top * B;
    const char *in = reinterpret_cast<const char *>(a->state_in);
    const char *out = reinterpret_cast<const char *>(a->state_out);
    if (hist != a->hist_rows
        || (in < out + span_bytes && out < in + span_bytes))
        return (int)cudaErrorInvalidValue;
    const auto aligned = [](const void *p) { return (uintptr_t)p % 16 == 0; };
    k.wide = B % 4 == 0 && aligned(a->deps) && aligned(a->state_in)
             && (!want_md || aligned(a->value));
    for (int w = 0; w < k.n_win; ++w) {
        FFMaskWin &g = k.win[w];
        if (g.ch <= a->n_bv) {
            if (g.lmax > a->hist_len[g.ch]) return (int)cudaErrorInvalidValue;
            g.src = a->deps + (int64_t)g.ch * T * B;
            g.hist = a->state_in
                + (int64_t)(a->hist_off[g.ch] + a->hist_len[g.ch]) * B;
        } else {
            g.src = g.ch == a->n_bv + 1 ? a->deps + (int64_t)g.ch * T * B
                                        : a->value;
            g.hist = nullptr;  // lag 0 only: never before the chunk
        }
    }
    const auto kern =
        k.streams == 32 ? ff_mask_kernel<32> : ff_mask_kernel<16>;
    e = cudaFuncSetAttribute((const void *)kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k.smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((B + k.streams - 1) / k.streams),
                    (unsigned)spans);
    kern<<<grid, threads, (size_t)k.smem, (cudaStream_t)stream>>>(k);
    return (int)cudaGetLastError();
}

const char *nfclab_ff_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
