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
//   v2_scan_kernel  serial over the chunk, 32 streams per block, one lane
//                   each, the work split over six warps (described above
//                   the kernel): the conditioning chain, mod_depth and the
//                   nine box sums.  Samples are staged in shared memory;
//                   the value, filtered, squared and product rings live
//                   there too, rotated to the chunk; carry and sums in
//                   registers.
//   v2_mask_kernel  parallel in time, 32 streams and a span of rows per
//                   block (described above the kernel): detect_mask at
//                   every sample from the box and filtered channels at
//                   fixed lags, each channel staged into a shared ring and
//                   read from memory once per span, every threshold test
//                   without a divide; and the state rows the Pallas
//                   kernel's mask leaves behind -- the rb and rbv rings and
//                   carry rows 5-9 -- each as the value the ring slot last
//                   received.  Lookbacks before the chunk come from the
//                   input state's rf, rb and rbv rings, at the slot of their
//                   absolute clock, exactly where the Pallas kernel reads
//                   them.
//
// What bounds the scan on this card: it moves 60 bytes per sample (4 in,
// 56 out across 14 channels), 1.21 ms per 4096 x 16384 samples at
// 3.35 TB/s, and does ~50 float operations per sample, far below the f32
// peak: it is bound by bytes, once a step is short enough.  At 4096
// streams it is 128 blocks on 128 of the 132 SMs.  What the design does
// about the step:
//   - No global load on a step's path: a producer warp stages the samples
//     of the block's 32 streams, V2_TILE_ROWS rows at a time, into
//     V2_STAGES shared stages with cp.async behind mbarriers; every
//     pointer is __restrict__.
//   - No modulo in a step: the rings sit in shared memory rotated to the
//     chunk, each in a power-of-two ring at least its state size, so a
//     slot is a mask of the chunk row; the state rings (slot t % R) are
//     rotated in and out once per call.
//   - Ring reads ahead of ring writes in groups of 6, the least read
//     distance (the product box of 6).
//   - Warp specialisation: envelope; filter + mdev/avg + q boxes; product
//     boxes (recomputing the filter to the same bits); raw-value boxes;
//     mod_depth; the producer.  Each owns its outputs and state rows.
//   - The envelope test has no divide, and no branch in a group that the
//     warp vote (CondEnvChain::group) finds positive and finite.
//   - mod_depth's divide, which feeds nothing back, runs on its own warp
//     from the staged sample and the envelope the envelope warp writes
//     into the stage's env tile (an mbarrier per stage), and skips the
//     divide where the numerator is +0 (cond_mod_depth_split), which
//     would otherwise send it down its slow path on about half the steps.
// What still bounds it: its stores.  On an H100 (PERF.md) a step takes
// ~108 ns, ~1.78 ms per 4096 x 16384 chunk, ~2.4 TB/s of the ~2.7 TB/s
// the copy probe reaches; without its per-step stores it takes ~69 ns.
// Moving the mask out of the loop keeps the 826 rows of rb/rbv rings
// (3.3 KB per stream) out of shared memory.  The mask kernel, bound by
// bytes too, reads env and its five lookback channels once and writes the
// mask: 28 B a sample, 0.56 ms per 4096 x 16384 at 3.35 TB/s, the floor of
// the two-kernel split.
//
// Numerics: bit-exact with the plain PyTorch version (fused_v2.py of the
// port): explicit round-to-nearest intrinsics (condition_step.cuh for the
// conditioning step), `|sd| > y` for `sd = ((b0 - bg) - (bg - b1)) / p2`
// decided exactly without the divide (sd_above), (filt*filt)*10 and
// (filt*lagged)*10 as two rounded multiplies, never an FMA; the library
// is built -fmad=false -prec-div=true -ftz=false.  The mask's bit weights are summed as an
// integer: every partial sum of the weights 1..128 is exact in float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "condition_step.cuh"
#include "smem_stage.cuh"

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

// output rows, in OUTPUT_NAMES order
enum {
    O_ENV, O_FILT, O_MDEV, O_AVG, O_MOD_DEPTH,
    O_BV12, O_BV24, O_BV47, O_BV94,
    O_Q47, O_Q189,
    O_P24X6, O_P47X12, O_P94X24,
    O_MASK,
};

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

// ---------------------------------------------------------------------------
// v2_scan_kernel: the serial phase, warp-specialised (the design of
// ff_scan_kernel on v2's state layout)
//
// Block of V2_SCAN_WARPS warps for 32 streams (lane = stream).  Warp 5
// stages [V2_TILE_ROWS, 32] sample tiles into V2_STAGES shared stages with
// cp.async, each behind a "full" mbarrier (the copies landed) and an
// "empty" one (the five consumer warps are done with it).  The consumers
// each read every staged sample and own disjoint outputs, state rows and
// rings:
//   warp 0  envelope + float silence counter (CondEnvChain, groups of
//           COND_UNROLL behind the warp vote): envelope; env into the
//           stage's env tile; rows 0, 4
//   warp 1  w1 -> filt -> mdev, avg, the q boxes over the rq ring:
//           filtered, deviation, average, q47, q189; rows 1-3, rq, q sums
//   warp 2  its own w1 -> filt (the same operations, the same bits), the
//           product boxes over the rf and rp rings: p24x6, p47x12, p94x24;
//           rf, rp, p sums
//   warp 3  the raw-value boxes over the rv ring: bv12..bv94; rv, bv sums
//   warp 4  mod_depth from the staged samples and the env tile, behind the
//           stage's "env" mbarrier (the envelope warp wrote the tile)
//   warp 5  the producer
// Rings sit in shared memory rotated to the chunk: a power-of-two ring of
// P >= R slots holds the value of clock base + j at slot j & (P - 1), so
// a step reads and writes with a mask and no modulo.  The state ring of R
// slots (slot t % R holds clock t) is rotated in when the kernel starts
// and back out when it ends, one modulo per slot, outside the steps.  A
// consumer takes its steps in groups of U = 6: every ring read of the
// group is issued before any ring write, which is the sequential order as
// long as U <= the least read distance (the product box of 6) and every
// distance is below its ring (a slot read at j - w keeps its value until
// j - w + P).

#define V2_SCAN_WARPS 6
#define V2_CONSUMERS 5
#define V2_STAGES 4
#define V2_TILE_ROWS 96   // a multiple of the ring group (6) and of COND_UNROLL
constexpr int V2_GROUP = 6;   // the least read distance: the box of p24x6

// the shared rings: power-of-two sizes at least the state rings'
constexpr int PV_RING = 128, PF_RING = 128, PQ_RING = 256;
constexpr int PP_RING0 = RP_RING0, PP_RING1 = RP_RING1, PP_RING2 = RP_RING2;
constexpr int V2_SHARED_RING_ROWS =
    PV_RING + PF_RING + PQ_RING + PP_RING0 + PP_RING1 + PP_RING2;
static_assert(PV_RING >= RV_RING && PF_RING >= RF_RING && PQ_RING >= RQ_RING,
              "shared rings hold the state rings");
static_assert((PP_RING0 & (PP_RING0 - 1)) == 0 && (PP_RING1 & (PP_RING1 - 1)) == 0
              && (PP_RING2 & (PP_RING2 - 1)) == 0, "product rings are powers of two");
static_assert(V2_TILE_ROWS % V2_GROUP == 0 && V2_TILE_ROWS % COND_UNROLL == 0,
              "whole groups in a tile");
// barriers (full, empty, env per stage, padded to 16 B), the sample and
// env tiles, the rings
constexpr int64_t V2_SCAN_SMEM =
    ((3 * V2_STAGES * 8 + 15) / 16) * 16
    + 128LL * (2 * V2_STAGES * V2_TILE_ROWS + V2_SHARED_RING_ROWS);

// the box constants of the 10 MS/s set (fused_v2.py: BV_WIDTHS, Q_WIDTHS, PB)
__device__ __forceinline__ constexpr int v2_bv_w(int i)
{
    return i == 0 ? 12 : i == 1 ? 24 : i == 2 ? 47 : 94;
}
__device__ __forceinline__ constexpr int v2_q_w(int i) { return i == 0 ? 47 : 189; }
__device__ __forceinline__ constexpr int v2_pb_lag(int i)
{
    return i == 0 ? 24 : i == 1 ? 47 : 94;
}
__device__ __forceinline__ constexpr int v2_pb_box(int i)
{
    return i == 0 ? 6 : i == 1 ? 12 : 24;
}
__device__ __forceinline__ constexpr int v2_pb_ring(int i)
{
    return i == 0 ? PP_RING0 : i == 1 ? PP_RING1 : PP_RING2;
}

// the slot of chunk row j (any int, negative before the chunk) in a
// shared ring of p slots (a constant once inlined)
__device__ __forceinline__ int v2_slot(int j, int p)
{
    return j & (p - 1);
}

// what a consumer warp shares with the others
struct V2Stages {
    float *tiles;      // [V2_STAGES][V2_TILE_ROWS][32] samples
    float *envs;       // [V2_STAGES][V2_TILE_ROWS][32] env, for warp 4
    uint64_t *full;
    uint64_t *empty;
    uint64_t *env;     // the env tile of the stage is written
};

// Row pointer of one output channel ([T, B]) at stream b, moved to each
// tile's first row; stores stream through L2.
struct V2Out {
    float *__restrict__ row0;
    float *__restrict__ cur;
    __device__ __forceinline__ void init(float *p, int64_t b)
    {
        row0 = p + b;
        cur = row0;
    }
    __device__ __forceinline__ void tile(int64_t j0, uint32_t B)
    {
        cur = row0 + (size_t)j0 * B;
    }
    __device__ __forceinline__ void put(uint32_t o, float v)
    {
        __stcg(cur + o, v);
    }
};

// Walk the chunk tile by tile: wait for the tile, run its rows through
// the role in groups of U (the ragged rest one by one), hand the stage
// back.  j counts the chunk's rows.
template <int U, class Role>
__device__ __forceinline__ void v2_consume(Role &role, const V2Stages &st,
                                           int64_t T, int lane)
{
    const int ntiles = (int)((T + V2_TILE_ROWS - 1) / V2_TILE_ROWS);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % V2_STAGES;
        const uint32_t parity = (uint32_t)(i / V2_STAGES) & 1u;
        mbar_wait(st.full + s, parity);
        const float *sv = st.tiles + s * (V2_TILE_ROWS * 32) + lane;
        const int j0 = i * V2_TILE_ROWS;
        const int n = T - j0 < V2_TILE_ROWS ? (int)(T - j0) : V2_TILE_ROWS;
        role.tile(j0, s, parity);
        int r = 0;
        for (; r + U <= n; r += U) role.template steps<U>(sv, r, j0 + r);
        for (; r < n; ++r) role.template steps<1>(sv, r, j0 + r);
        role.tile_done(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(st.empty + s);
    }
}

// warp 0's sink: env to the envelope channel and to the stage's env tile
struct V2EnvSink {
    uint32_t B;
    bool valid;
    int r;             // the group's first row in the tile
    float *etile;      // the stage's env tile, at this lane's column
    V2Out out;

    __device__ __forceinline__ void put(int k, float env,
                                        const CondFloatCounter &)
    {
        etile[(r + k) * 32] = env;
        if (valid) out.put((uint32_t)(r + k) * B, env);
    }
};

// warp 0: the envelope (NfcTech.cpp:39-53), groups of COND_UNROLL steps
// behind the warp vote; the clock is absolute, base + j
struct V2EnvRole {
    CondEnvChain<CondFloatCounter, V2EnvSink> c;
    float *envs;          // the env tiles, at this lane's column
    uint64_t *env_bar;

    __device__ __forceinline__ void tile(int64_t j0, int s, uint32_t)
    {
        c.sink.out.tile(j0, c.sink.B);
        c.sink.etile = envs + s * (V2_TILE_ROWS * 32);
    }
    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int)
    {
        c.sink.r = r;
        if constexpr (N == COND_UNROLL) {
            float v[COND_UNROLL];
#pragma unroll
            for (int k = 0; k < COND_UNROLL; ++k) v[k] = sv[(r + k) * 32];
            c.group(v, !c.sink.valid);
        } else {
#pragma unroll
            for (int k = 0; k < N; ++k) c.step(sv[(r + k) * 32], k);
        }
    }
    __device__ __forceinline__ void tile_done(int s)
    {
        mbar_arrive(env_bar + s);  // one arrival per lane
    }
};

// warp 4: mod_depth (NfcTech.cpp:71-74); its divide feeds nothing back,
// so it runs here, off the envelope chain
struct V2DepthRole {
    const float *envs;    // the env tiles, at this lane's column
    uint64_t *env_bar;
    uint32_t B;
    bool valid;
    const float *etile;
    V2Out out;

    __device__ __forceinline__ void tile(int64_t j0, int s, uint32_t parity)
    {
        out.tile(j0, B);
        mbar_wait(env_bar + s, parity);
        etile = envs + s * (V2_TILE_ROWS * 32);
    }
    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int)
    {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const float md =
                cond_mod_depth_split(sv[(r + k) * 32], etile[(r + k) * 32]);
            if (valid) out.put((uint32_t)(r + k) * B, md);
        }
    }
    __device__ __forceinline__ void tile_done(int) {}
};

// warp 1: IIR DC removal, the deviation and average EMAs
// (NfcTech.cpp:56-68) and the squared-filtered boxes over (filt*filt)*10
struct V2FiltRole {
    float w1, mdev, avg;
    float s[2];
    float iir_a, mw0, mw1, aw0, aw1;
    float *ring;          // rq, at this lane's column
    uint32_t B;
    bool valid;
    V2Out filt_out, mdev_out, avg_out, q_out[2];

    __device__ __forceinline__ void tile(int64_t j0, int, uint32_t)
    {
        filt_out.tile(j0, B);
        mdev_out.tile(j0, B);
        avg_out.tile(j0, B);
        q_out[0].tile(j0, B);
        q_out[1].tile(j0, B);
    }
    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int j)
    {
        float v[N], old[2][N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = sv[(r + k) * 32];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int k = 0; k < N; ++k)
                old[i][k] = ring[v2_slot(j + k - v2_q_w(i), PQ_RING) * 32];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float filt;
            w1 = cond_iir(v[k], w1, iir_a, &filt);
            mdev = cond_ema(mdev, mw0, fabsf(filt), mw1);
            avg = cond_ema(avg, aw0, v[k], aw1);
            const float q = __fmul_rn(__fmul_rn(filt, filt), 10.0f);
#pragma unroll
            for (int i = 0; i < 2; ++i)
                s[i] = __fsub_rn(__fadd_rn(s[i], q), old[i][k]);
            ring[v2_slot(j + k, PQ_RING) * 32] = q;
            if (valid) {
                const uint32_t o = (uint32_t)(r + k) * B;
                filt_out.put(o, filt);
                mdev_out.put(o, mdev);
                avg_out.put(o, avg);
                q_out[0].put(o, s[0]);
                q_out[1].put(o, s[1]);
            }
        }
    }
    __device__ __forceinline__ void tile_done(int) {}
};

// warp 2: the BPSK product boxes over (filt*filt[t-lag])*10
struct V2ProdRole {
    float w1, iir_a;
    float s[3];
    float *rf;            // filtered ring, at this lane's column
    float *rp[3];         // product rings, at this lane's column
    uint32_t B;
    bool valid;
    V2Out p_out[3];

    __device__ __forceinline__ void tile(int64_t j0, int, uint32_t)
    {
#pragma unroll
        for (int i = 0; i < 3; ++i) p_out[i].tile(j0, B);
    }
    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int j)
    {
        float v[N], lagged[3][N], old[3][N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = sv[(r + k) * 32];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int k = 0; k < N; ++k) {
                lagged[i][k] = rf[v2_slot(j + k - v2_pb_lag(i), PF_RING) * 32];
                old[i][k] =
                    rp[i][v2_slot(j + k - v2_pb_box(i), v2_pb_ring(i)) * 32];
            }
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float filt;
            w1 = cond_iir(v[k], w1, iir_a, &filt);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                const float prod =
                    __fmul_rn(__fmul_rn(filt, lagged[i][k]), 10.0f);
                s[i] = __fsub_rn(__fadd_rn(s[i], prod), old[i][k]);
                rp[i][v2_slot(j + k, v2_pb_ring(i)) * 32] = prod;
                if (valid) p_out[i].put((uint32_t)(r + k) * B, s[i]);
            }
            rf[v2_slot(j + k, PF_RING) * 32] = filt;
        }
    }
    __device__ __forceinline__ void tile_done(int) {}
};

// warp 3: the raw-value boxes (sum + v) - v[t - w]
struct V2BvRole {
    float s[4];
    float *ring;          // rv, at this lane's column
    uint32_t B;
    bool valid;
    V2Out out[4];

    __device__ __forceinline__ void tile(int64_t j0, int, uint32_t)
    {
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i].tile(j0, B);
    }
    template <int N>
    __device__ __forceinline__ void steps(const float *sv, int r, int j)
    {
        float v[N], old[4][N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = sv[(r + k) * 32];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < N; ++k)
                old[i][k] = ring[v2_slot(j + k - v2_bv_w(i), PV_RING) * 32];
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                s[i] = __fsub_rn(__fadd_rn(s[i], v[k]), old[i][k]);
                if (valid) out[i].put((uint32_t)(r + k) * B, s[i]);
            }
            ring[v2_slot(j + k, PV_RING) * 32] = v[k];
        }
    }
    __device__ __forceinline__ void tile_done(int) {}
};

// state row r of stream b, 0 for a lane past the last stream
__device__ __forceinline__ float v2_row(const float *st, int64_t r, int64_t B,
                                        int64_t b, bool valid)
{
    return valid ? st[r * B + b] : 0.0f;
}

// Rotate a state ring of R slots (slot t % R holds clock t) into a shared
// ring of P slots at this lane's column: the slot holds the value of the
// last clock before the chunk that is s modulo R, clock base - 1 - d, which
// goes to j = -1 - d.
template <int R, int P>
__device__ __forceinline__ void v2_ring_in(float *ring, const float *st,
                                           int off, int64_t B, int64_t b,
                                           bool valid, int32_t base)
{
    for (int s = 0; s < R; ++s) {
        const int d = (int)((((int64_t)base - 1 - s) % R + R) % R);
        ring[v2_slot(-1 - d, P) * 32] = v2_row(st, off + s, B, b, valid);
    }
}

// and back: slot s ends holding the value of the last clock of the chunk
// that is s modulo R, at j = T - 1 - d (d < R, so it was not overwritten;
// for j < 0 it is the value rotated in)
template <int R, int P>
__device__ __forceinline__ void v2_ring_out(const float *ring, float *st,
                                            int off, int64_t B, int64_t b,
                                            bool valid, int32_t base,
                                            int64_t T)
{
    if (!valid) return;
    const int64_t last = (int64_t)base + T - 1;
    for (int s = 0; s < R; ++s) {
        const int64_t j = T - 1 - ((last - s) % R + R) % R;
        st[(int64_t)(off + s) * B + b] = ring[v2_slot((int)j, P) * 32];
    }
}

// warp 5: keep V2_STAGES tiles in flight.  16-byte copies when every row
// of the block's 32 columns is 16-byte aligned (B % 4 == 0, aligned
// samples), else 4-byte ones; columns past the last stream are not copied.
__device__ __forceinline__ void v2_produce(const V2Args &a, const V2Stages &st,
                                           int lane, int64_t b0)
{
    const int64_t B = a.B, T = a.T;
    const float *src0 = a.value + b0;
    const bool wide = (B % 4 == 0) && ((uintptr_t)a.value % 16 == 0);
    const int ntiles = (int)((T + V2_TILE_ROWS - 1) / V2_TILE_ROWS);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % V2_STAGES;
        if (i >= V2_STAGES)
            mbar_wait(st.empty + s, (uint32_t)(i / V2_STAGES - 1) & 1u);
        const int64_t j0 = (int64_t)i * V2_TILE_ROWS;
        const int n = T - j0 < V2_TILE_ROWS ? (int)(T - j0) : V2_TILE_ROWS;
        float *dst = st.tiles + s * (V2_TILE_ROWS * 32);
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
    asm volatile("cp.async.wait_all;" ::: "memory");
}

extern __shared__ __align__(16) unsigned char v2_dyn_smem[];

__global__ void __launch_bounds__(V2_SCAN_WARPS * 32)
v2_scan_kernel(const V2Args a)
{
    uint64_t *bars = reinterpret_cast<uint64_t *>(v2_dyn_smem);
    V2Stages st;
    st.full = bars;
    st.empty = bars + V2_STAGES;
    st.env = bars + 2 * V2_STAGES;
    st.tiles = reinterpret_cast<float *>(
        v2_dyn_smem + ((3 * V2_STAGES * 8 + 15) / 16) * 16);
    st.envs = st.tiles + V2_STAGES * V2_TILE_ROWS * 32;
    float *rings = st.envs + V2_STAGES * V2_TILE_ROWS * 32;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t B = a.B;
    const int64_t b0 = (int64_t)blockIdx.x * 32;
    const int64_t b = b0 + lane;
    const bool valid = b < B;  // every lane runs: the warps meet at barriers
    const uint32_t Bu = (uint32_t)B;
    const float *sti = a.state_in;
    float *sto = a.state_out;
    const int64_t TB = a.T * B;

    if (threadIdx.x == 0) {
        for (int s = 0; s < V2_STAGES; ++s) {
            mbar_init(st.full + s, 32);
            mbar_init(st.empty + s, V2_CONSUMERS);
            mbar_init(st.env + s, 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // shared rings: rv, rf, rq, then the product rings
    float *rv = rings + lane;
    float *rf = rv + PV_RING * 32;
    float *rq = rf + PF_RING * 32;
    float *rp0 = rq + PQ_RING * 32;
    float *rp1 = rp0 + PP_RING0 * 32;
    float *rp2 = rp1 + PP_RING1 * 32;

    if (warp == 0) {
        V2EnvRole r;
        r.envs = st.envs + lane;
        r.env_bar = st.env;
        r.c.env = v2_row(sti, 0, B, b, valid);
        r.c.cnt.pcount = v2_row(sti, 4, B, b, valid);
        r.c.cnt.silence = a.silence;
        r.c.cnt.clock = (uint32_t)a.base;
        r.c.cnt.etu = a.etu;
        r.c.set_weights(a.enve_w0, a.enve_w1);
        r.c.sink.B = Bu;
        r.c.sink.valid = valid;
        r.c.sink.out.init(a.out + O_ENV * TB, b);
        v2_consume<COND_UNROLL>(r, st, a.T, lane);
        if (valid) {
            sto[0 * B + b] = r.c.env;
            sto[4 * B + b] = r.c.cnt.pcount;
        }
    } else if (warp == 1) {
        V2FiltRole r;
        r.w1 = v2_row(sti, 1, B, b, valid);
        r.mdev = v2_row(sti, 2, B, b, valid);
        r.avg = v2_row(sti, 3, B, b, valid);
        r.iir_a = a.iir_a;
        r.mw0 = a.mdev_w0;
        r.mw1 = a.mdev_w1;
        r.aw0 = a.mean_w0;
        r.aw1 = a.mean_w1;
        r.ring = rq;
        r.B = Bu;
        r.valid = valid;
        r.filt_out.init(a.out + O_FILT * TB, b);
        r.mdev_out.init(a.out + O_MDEV * TB, b);
        r.avg_out.init(a.out + O_AVG * TB, b);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            r.s[i] = v2_row(sti, S_SUMS + 4 + i, B, b, valid);
            r.q_out[i].init(a.out + (O_Q47 + i) * TB, b);
        }
        v2_ring_in<RQ_RING, PQ_RING>(rq, sti, S_RQ, B, b, valid, a.base);
        v2_consume<V2_GROUP>(r, st, a.T, lane);
        if (valid) {
            sto[1 * B + b] = r.w1;
            sto[2 * B + b] = r.mdev;
            sto[3 * B + b] = r.avg;
#pragma unroll
            for (int i = 0; i < 2; ++i)
                sto[(int64_t)(S_SUMS + 4 + i) * B + b] = r.s[i];
        }
        v2_ring_out<RQ_RING, PQ_RING>(rq, sto, S_RQ, B, b, valid, a.base, a.T);
    } else if (warp == 2) {
        V2ProdRole r;
        r.w1 = v2_row(sti, 1, B, b, valid);
        r.iir_a = a.iir_a;
        r.rf = rf;
        r.rp[0] = rp0;
        r.rp[1] = rp1;
        r.rp[2] = rp2;
        r.B = Bu;
        r.valid = valid;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            r.s[i] = v2_row(sti, S_SUMS + 6 + i, B, b, valid);
            r.p_out[i].init(a.out + (O_P24X6 + i) * TB, b);
        }
        v2_ring_in<RF_RING, PF_RING>(rf, sti, S_RF, B, b, valid, a.base);
        v2_ring_in<RP_RING0, PP_RING0>(rp0, sti, S_RP0, B, b, valid, a.base);
        v2_ring_in<RP_RING1, PP_RING1>(rp1, sti, S_RP1, B, b, valid, a.base);
        v2_ring_in<RP_RING2, PP_RING2>(rp2, sti, S_RP2, B, b, valid, a.base);
        v2_consume<V2_GROUP>(r, st, a.T, lane);
        if (valid) {
#pragma unroll
            for (int i = 0; i < 3; ++i)
                sto[(int64_t)(S_SUMS + 6 + i) * B + b] = r.s[i];
        }
        v2_ring_out<RF_RING, PF_RING>(rf, sto, S_RF, B, b, valid, a.base, a.T);
        v2_ring_out<RP_RING0, PP_RING0>(rp0, sto, S_RP0, B, b, valid, a.base,
                                        a.T);
        v2_ring_out<RP_RING1, PP_RING1>(rp1, sto, S_RP1, B, b, valid, a.base,
                                        a.T);
        v2_ring_out<RP_RING2, PP_RING2>(rp2, sto, S_RP2, B, b, valid, a.base,
                                        a.T);
    } else if (warp == 3) {
        V2BvRole r;
        r.ring = rv;
        r.B = Bu;
        r.valid = valid;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            r.s[i] = v2_row(sti, S_SUMS + i, B, b, valid);
            r.out[i].init(a.out + (O_BV12 + i) * TB, b);
        }
        v2_ring_in<RV_RING, PV_RING>(rv, sti, S_RV, B, b, valid, a.base);
        v2_consume<V2_GROUP>(r, st, a.T, lane);
        if (valid) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                sto[(int64_t)(S_SUMS + i) * B + b] = r.s[i];
        }
        v2_ring_out<RV_RING, PV_RING>(rv, sto, S_RV, B, b, valid, a.base, a.T);
    } else if (warp == 4) {
        V2DepthRole r;
        r.envs = st.envs + lane;
        r.env_bar = st.env;
        r.B = Bu;
        r.valid = valid;
        r.out.init(a.out + O_MOD_DEPTH * TB, b);
        v2_consume<1>(r, st, a.T, lane);
    } else {
        v2_produce(a, st, lane, b0);
    }
}

// ---------------------------------------------------------------------------
// v2_mask_kernel: the mask half of the Pallas kernel, parallel in time
//
// A block owns 32 streams (128-byte rows, lane = stream) and a span of
// V2_MASK_SPAN chunk rows, walked in sub-tiles of V2_MASK_TILE rows.  Each
// of the six channels it reads (env and the five lookback channels) is
// staged into a shared ring of its own, read from memory once per span:
// V2_MASK_PRODUCERS producer warps copy each row with cp.async when a
// sub-tile first needs it, V2_MASK_STAGES sub-tiles ahead, behind a "full"
// mbarrier per stage (the copies landed) and an "empty" one (the consumer
// warps are done with the sub-tile).  (One producer warp bounded the
// kernel, as did sub-tiles of 32 rows; 128-byte bulk copies, one a row,
// were slower still.)  A
// channel with lags Lmin..Lmax (V2Lags) gets rows [J - Lmin, J + n - Lmin)
// for the sub-tile of rows [J, J + n), and the span's first sub-tile also
// the spread behind them;
// row r lands at slot r & (P - 1) of a ring of P >= spread + STAGES * TILE
// slots, so no slot is rewritten before every sub-tile that reads it is
// done.  Rows before the chunk are copied from the state ring slot of
// their absolute clock, (base + r) mod R, one int32 modulo a row, at the
// span's first sub-tile only.  The consumer warps take the sub-tile's rows
// in turn: every lookback is a shared load at a mask, and every threshold
// test the divide-free sd_above (condition_step.cuh).  The block of each
// column's last span then writes the state rows the mask owns (rb, rbv,
// carry rows 5-9), one int32 modulo a slot.

#define V2_MASK_WARPS 16    // consumers, then the producers
#define V2_MASK_PRODUCERS 4
#define V2_MASK_TILE 64     // rows of a sub-tile
#define V2_MASK_STAGES 2    // sub-tiles in flight
#define V2_MASK_SPAN 2048   // rows of a block's span, a multiple of the tile
static_assert(V2_MASK_SPAN % V2_MASK_TILE == 0, "whole sub-tiles in a span");

// the staged channels: output row, least and largest lag, shared ring,
// state ring (offset, size) holding the channel before the chunk
enum { MC_ENV, MC_BV47, MC_BV24, MC_BV12, MC_FILT, MC_BV94, MC_N };
struct V2Lags {
    int ch, lmin, lmax, ring, off, r;
};
__host__ __device__ constexpr V2Lags v2_mask_lags(int c)
{
    return c == MC_ENV ? V2Lags{O_ENV, 0, 0, 128, 0, 1}
        : c == MC_BV47 ? V2Lags{O_BV47, 0, 47, 256, S_RB, RB_RING0}
        : c == MC_BV24 ? V2Lags{O_BV24, 0, 117, 256, S_RB + RB_RING0, RB_RING1}
        : c == MC_BV12 ? V2Lags{O_BV12, 0, 153, 512,
                                S_RB + RB_RING0 + RB_RING1, RB_RING2}
        : c == MC_FILT ? V2Lags{O_FILT, 0, 94, 256, S_RF, RF_RING}
                       : V2Lags{O_BV94, 378, 473, 256, S_RBV, RBV_RING};
}
__host__ __device__ constexpr int v2_mask_ring_base(int c)
{
    return c == 0 ? 0 : v2_mask_ring_base(c - 1) + v2_mask_lags(c - 1).ring;
}
constexpr int V2_MASK_RING_ROWS = v2_mask_ring_base(MC_N);
static_assert(V2_MASK_RING_ROWS == 128 + 4 * 256 + 512, "the rings' rows");
#define V2_MASK_RING_OK(c)                                                   \
    static_assert((v2_mask_lags(c).ring & (v2_mask_lags(c).ring - 1)) == 0   \
                  && v2_mask_lags(c).ring >= v2_mask_lags(c).lmax            \
                     - v2_mask_lags(c).lmin + V2_MASK_STAGES * V2_MASK_TILE  \
                  && v2_mask_lags(c).r > v2_mask_lags(c).lmax,               \
                  "ring of channel " #c)
V2_MASK_RING_OK(MC_ENV);
V2_MASK_RING_OK(MC_BV47);
V2_MASK_RING_OK(MC_BV24);
V2_MASK_RING_OK(MC_BV12);
V2_MASK_RING_OK(MC_FILT);
V2_MASK_RING_OK(MC_BV94);
// barriers (full, empty per stage, padded to 16 B), then the rings
constexpr int64_t V2_MASK_SMEM =
    ((2 * V2_MASK_STAGES * 8 + 15) / 16) * 16 + 128LL * V2_MASK_RING_ROWS;

// the slot of clock t in a state ring of r slots (t >= -r)
__device__ __forceinline__ int v2_state_slot(int32_t t, int r)
{
    const int s = t % r;
    return s < 0 ? s + r : s;
}

// row r of channel c at this block's 32 columns: a chunk row of `out`, or
// before the chunk the state ring slot of its clock
template <int C>
__device__ __forceinline__ const float *v2_mask_src(const V2Args &a, int r,
                                                    int64_t b0)
{
    constexpr V2Lags g = v2_mask_lags(C);
    if (r >= 0) return a.out + ((int64_t)g.ch * a.T + r) * a.B + b0;
    return a.state_in + (int64_t)(g.off + v2_state_slot(a.base + r, g.r)) * a.B
           + b0;
}

// the rows of channel c that sub-tile [J, J + n) stages: [J - lmin,
// J + n - lmin), and in a span's first sub-tile also the spread behind
template <int C>
__device__ __forceinline__ int v2_mask_lo(int J, bool first)
{
    constexpr V2Lags g = v2_mask_lags(C);
    return first ? J - g.lmax : J - g.lmin;
}
template <int C>
__device__ __forceinline__ int v2_mask_hi(int J, int n)
{
    return J + n - v2_mask_lags(C).lmin;
}

// Producer warp p's copies of channel c's rows [lo, hi) into its ring:
// rows before the chunk (a first span's first sub-tile) from their state
// slots, one 4-byte copy a lane and row; chunk rows as a pointer walk,
// 16-byte copies where every row of the block's columns is 16-byte aligned
// (lane: column (lane & 7) * 4 of every 4th row), else one 4-byte column a
// lane.  The V2_MASK_PRODUCERS warps take the rows in turn.
template <int C>
__device__ __forceinline__ void v2_mask_stage(const V2Args &a, float *rings,
                                              int lo, int hi, int64_t b0,
                                              bool wide, int p, int lane)
{
    constexpr V2Lags g = v2_mask_lags(C);
    constexpr int NP = V2_MASK_PRODUCERS;
    float *ring = rings + v2_mask_ring_base(C) * 32;
    const bool lane_ok = b0 + lane < a.B;
    const int r0 = hi < 0 ? hi : 0;
    for (int r = lo + p; r < r0; r += NP)
        if (lane_ok)
            cp_async4(ring + (r & (g.ring - 1)) * 32 + lane,
                      v2_mask_src<C>(a, r, b0) + lane);
    lo = lo > 0 ? lo : 0;
    if (lo >= hi) return;
    if (wide) {
        const int col = (lane & 7) * 4;
        if (b0 + col >= a.B) return;
        const size_t step = 4 * NP * (size_t)a.B;
        int r = lo + 4 * p + (lane >> 3);
        const float *src = v2_mask_src<C>(a, lo, b0) + (r - lo) * a.B + col;
        for (; r < hi; r += 4 * NP, src += step)
            cp_async16(ring + (r & (g.ring - 1)) * 32 + col, src);
    } else if (lane_ok) {
        const float *src = v2_mask_src<C>(a, lo, b0) + p * a.B + lane;
        for (int r = lo + p; r < hi; r += NP, src += NP * a.B)
            cp_async4(ring + (r & (g.ring - 1)) * 32 + lane, src);
    }
}

template <int C>
__device__ __forceinline__ void v2_mask_stage_tile(const V2Args &a,
                                                   float *rings, int J, int n,
                                                   bool first, int64_t b0,
                                                   bool wide, int p, int lane)
{
    v2_mask_stage<C>(a, rings, v2_mask_lo<C>(J, first), v2_mask_hi<C>(J, n),
                     b0, wide, p, lane);
}

// channel c at lag l behind row j of stream b, from its ring at this
// lane's column
template <int C>
__device__ __forceinline__ float v2_mask_at(const V2Args &a,
                                            const float *rings, int64_t b,
                                            int j, int l)
{
    constexpr V2Lags g = v2_mask_lags(C);
    return rings[(v2_mask_ring_base(C) + ((j - l) & (g.ring - 1))) * 32];
}

// |sd| > y for sd = ((b0 - bg) - (bg - b1)) / p2
__device__ __forceinline__ bool v2_sd_above(float b0, float bg, float b1,
                                            double p2, float y, double mid,
                                            bool divide)
{
    const float n = __fsub_rn(__fsub_rn(b0, bg), __fsub_rn(bg, b1));
    return sd_above(fabsf(n), y, mid, p2, divide);
}

// detect_mask at chunk row j of this lane's stream; carry: the state's
// carry rows 5-9, b1 at the chunk's first row
__device__ __forceinline__ float v2_mask_row(const V2Args &a,
                                             const float *rings, int64_t b,
                                             int j, const float (&carry)[5])
{
    const auto bv47 = [&](int l) { return v2_mask_at<MC_BV47>(a, rings, b, j, l); };
    const auto bv24 = [&](int l) { return v2_mask_at<MC_BV24>(a, rings, b, j, l); };
    const auto bv12 = [&](int l) { return v2_mask_at<MC_BV12>(a, rings, b, j, l); };
    const auto filt = [&](int l) { return v2_mask_at<MC_FILT>(a, rings, b, j, l); };
    const auto bv94 = [&](int l) { return v2_mask_at<MC_BV94>(a, rings, b, j, l); };
    const float env = v2_mask_at<MC_ENV>(a, rings, b, j, 0);
    const bool power_ok = env >= a.power_thr;
    const bool j0 = j == 0;
    // NFC-A, |SD| above the correlation threshold (NfcA.cpp:224-291):
    // (d, gap, p2) = (0, 47, 47) on bv47, (94, 23, 24) on bv24,
    // (141, 12, 12) on bv12; NFC-F the same family at d = 0 over bv24 and
    // bv12.  b1 = B(t-d-1) is the carry row at the chunk's first row.
    const float ya = __fmul_rn(a.a_thr, env);
    const float yf = __fmul_rn(a.f_thr, env);
    const double ma = sd_midpoint(ya), mf = sd_midpoint(yf);
    const bool da = power_ok & sd_special(ya), df = power_ok & sd_special(yf);
    int m = 0;
    m += v2_sd_above(bv47(0), bv47(47), j0 ? carry[0] : bv47(1), 47.0, ya,
                     ma, da) ? 1 : 0;
    m += v2_sd_above(bv24(94), bv24(117), j0 ? carry[3] : bv24(95), 24.0, ya,
                     ma, da) ? 2 : 0;
    m += v2_sd_above(bv12(141), bv12(153), j0 ? carry[4] : bv12(142), 12.0,
                     ya, ma, da) ? 4 : 0;
    m += v2_sd_above(bv24(0), bv24(23), j0 ? carry[1] : bv24(1), 24.0, yf,
                     mf, df) ? 32 : 0;
    m += v2_sd_above(bv12(0), bv12(12), j0 ? carry[2] : bv12(1), 12.0, yf,
                     mf, df) ? 64 : 0;
    // NFC-B: falling edge filt[t-d] < -(minDeep*env) at d = 0, 94
    // (NfcB.cpp:283)
    const float edge_b = -__fmul_rn(a.b_min_deep, env);
    m += filt(0) < edge_b ? 8 : 0;
    m += filt(94) < edge_b ? 16 : 0;
    // NFC-V: signed SD = (B(t-d-gap) - B(t-d)) / p2 over bv94, d = 378,
    // gap = 95 (NfcV.cpp:236-435)
    const float yv = __fmul_rn(a.v_thr, env);
    m += sd_above(__fsub_rn(bv94(473), bv94(378)), yv, sd_midpoint(yv), 94.0,
                  power_ok & sd_special(yv)) ? 128 : 0;
    // every bit is gated by env >= power_thr
    return power_ok ? (float)m : 0.0f;
}

// channel c at lag l behind the chunk's last row, from `out` or the state
// ring slot of its clock (the state rows' pass)
template <int C>
__device__ __forceinline__ float v2_mask_last(const V2Args &a, int l,
                                              int64_t b)
{
    return v2_mask_src<C>(a, (int)a.T - 1 - l, b)[0];
}

// state ring slot s (of r) ends holding the value of the chunk's last clock
// that is s modulo r, or keeps its input
template <int C>
__device__ __forceinline__ void v2_mask_ring_out(const V2Args &a, int off,
                                                 int r, int k, int64_t b)
{
    const int32_t t_last = a.base + (int32_t)a.T - 1;
    const int d = v2_state_slot(t_last - k, r);
    a.state_out[(int64_t)(off + k) * a.B + b] = v2_mask_last<C>(a, d, b);
}

__device__ __forceinline__ void v2_mask_state_rows(const V2Args &a, int w,
                                                   int64_t b)
{
    for (int k = w; k < RB_TOTAL + RBV_RING + 5; k += V2_MASK_WARPS) {
        if (k < RB_RING0) {
            v2_mask_ring_out<MC_BV47>(a, S_RB, RB_RING0, k, b);
        } else if (k < RB_RING0 + RB_RING1) {
            v2_mask_ring_out<MC_BV24>(a, S_RB + RB_RING0, RB_RING1,
                                      k - RB_RING0, b);
        } else if (k < RB_TOTAL) {
            v2_mask_ring_out<MC_BV12>(a, S_RB + RB_RING0 + RB_RING1, RB_RING2,
                                      k - RB_RING0 - RB_RING1, b);
        } else if (k < RB_TOTAL + RBV_RING) {
            v2_mask_ring_out<MC_BV94>(a, S_RBV, RBV_RING, k - RB_TOTAL, b);
        } else {
            // carry rows 5-7: the last step's bv47, bv24, bv12; rows 8-9:
            // its b0 of the NFC-A rates at d = 94 (bv24) and 141 (bv12)
            const int c = k - RB_TOTAL - RBV_RING;
            const float x = c == 0 ? v2_mask_last<MC_BV47>(a, 0, b)
                : c == 1 ? v2_mask_last<MC_BV24>(a, 0, b)
                : c == 2 ? v2_mask_last<MC_BV12>(a, 0, b)
                : c == 3 ? v2_mask_last<MC_BV24>(a, 94, b)
                         : v2_mask_last<MC_BV12>(a, 141, b);
            a.state_out[(int64_t)(5 + c) * a.B + b] = x;
        }
    }
}

__global__ void __launch_bounds__((V2_MASK_WARPS + V2_MASK_PRODUCERS) * 32)
v2_mask_kernel(const V2Args a)
{
    uint64_t *full = reinterpret_cast<uint64_t *>(v2_dyn_smem);
    uint64_t *empty = full + V2_MASK_STAGES;
    float *rings = reinterpret_cast<float *>(
        v2_dyn_smem + ((2 * V2_MASK_STAGES * 8 + 15) / 16) * 16);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t b0 = (int64_t)blockIdx.x * 32;
    const int64_t b = b0 + lane;
    const bool valid = b < a.B;
    const int span0 = (int)blockIdx.y * V2_MASK_SPAN;
    const int span1 = (int)(a.T - span0 < V2_MASK_SPAN ? a.T
                                                        : span0 + V2_MASK_SPAN);
    const int ntiles = (span1 - span0 + V2_MASK_TILE - 1) / V2_MASK_TILE;

    if (threadIdx.x == 0) {
        for (int s = 0; s < V2_MASK_STAGES; ++s) {
            mbar_init(full + s, 32 * V2_MASK_PRODUCERS);
            mbar_init(empty + s, V2_MASK_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= V2_MASK_WARPS) {
        const int p = warp - V2_MASK_WARPS;
        const bool wide = (a.B % 4 == 0) && ((uintptr_t)a.out % 16 == 0)
                          && ((uintptr_t)a.state_in % 16 == 0);
        for (int i = 0; i < ntiles; ++i) {
            const int s = i % V2_MASK_STAGES;
            if (i >= V2_MASK_STAGES)
                mbar_wait(empty + s, (uint32_t)(i / V2_MASK_STAGES - 1) & 1u);
            const int J = span0 + i * V2_MASK_TILE;
            const int n = span1 - J < V2_MASK_TILE ? span1 - J : V2_MASK_TILE;
            const bool first = i == 0;
#define V2_MASK_STAGE(c) \
    v2_mask_stage_tile<c>(a, rings, J, n, first, b0, wide, p, lane)
            V2_MASK_STAGE(MC_ENV);
            V2_MASK_STAGE(MC_BV47);
            V2_MASK_STAGE(MC_BV24);
            V2_MASK_STAGE(MC_BV12);
            V2_MASK_STAGE(MC_FILT);
            V2_MASK_STAGE(MC_BV94);
#undef V2_MASK_STAGE
            cp_async_arrive(full + s);
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        return;
    }

    float carry[5];
#pragma unroll
    for (int c = 0; c < 5; ++c)
        carry[c] = (span0 == 0 && valid) ? a.state_in[(5 + c) * a.B + b]
                                         : 0.0f;
    float *mask = a.out + (int64_t)O_MASK * a.T * a.B + b;
    const float *col = rings + lane;
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % V2_MASK_STAGES;
        mbar_wait(full + s, (uint32_t)(i / V2_MASK_STAGES) & 1u);
        const int J = span0 + i * V2_MASK_TILE;
        const int n = span1 - J < V2_MASK_TILE ? span1 - J : V2_MASK_TILE;
        for (int k = warp; k < n; k += V2_MASK_WARPS) {
            const float m = v2_mask_row(a, col, b, J + k, carry);
            if (valid) __stcg(mask + (int64_t)(J + k) * a.B, m);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
    }
    if (span1 == a.T && valid) v2_mask_state_rows(a, warp, b);
}

extern "C" {

int nfclab_v2_nstate(void) { return NSTATE; }

// Each launcher queues its kernel on `stream` and returns
// cudaGetLastError() after the launch (0 = queued).
int64_t nfclab_v2_scan_smem(void) { return V2_SCAN_SMEM; }

// Queues v2_scan_kernel.  Refused (cudaErrorInvalidValue) unless `threads`
// is V2_SCAN_WARPS * 32, `smem_bytes` holds the barriers, tiles and rings,
// 1 <= B <= 2^25 (32-bit offsets within a tile), T >= 1, and the clock
// stays in int32: 0 <= base and base + T + 2 * RBV_RING <= 2^31 (the
// wrapper's guard).
int nfclab_v2_scan(const V2Args *a, int device, int threads,
                   int64_t smem_bytes, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (threads != V2_SCAN_WARPS * 32 || smem_bytes < V2_SCAN_SMEM
        || a->B < 1 || a->B > (1LL << 25) || a->T < 1 || a->base < 0
        || (int64_t)a->base + a->T + 2 * RBV_RING > (1LL << 31))
        return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(v2_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (a->B + 31) / 32;
    v2_scan_kernel<<<(unsigned)blocks, threads, (size_t)smem_bytes,
                     (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

int64_t nfclab_v2_mask_smem(void) { return V2_MASK_SMEM; }

// The mask kernel's geometry, for the binding to hold its mirror to:
// consumer and producer warps, sub-tile rows, stages, span rows, then per
// staged channel (env, bv47, bv24, bv12, filtered, bv94) its least and
// largest lag, its shared ring and its state ring (0 for env).  Returns the count written
// (at most n).
int nfclab_v2_mask_geometry(int32_t *g, int n)
{
    int32_t v[5 + 4 * MC_N] = {V2_MASK_WARPS, V2_MASK_PRODUCERS, V2_MASK_TILE,
                               V2_MASK_STAGES, V2_MASK_SPAN};
    for (int c = 0; c < MC_N; ++c) {
        const V2Lags l = v2_mask_lags(c);
        v[5 + 4 * c] = l.lmin;
        v[6 + 4 * c] = l.lmax;
        v[7 + 4 * c] = l.ring;
        v[8 + 4 * c] = c == MC_ENV ? 0 : l.r;
    }
    const int m = n < 5 + 4 * MC_N ? n : 5 + 4 * MC_N;
    for (int i = 0; i < m; ++i) g[i] = v[i];
    return m;
}

// Queues v2_mask_kernel.  Refused (cudaErrorInvalidValue) unless `threads`
// is (V2_MASK_WARPS + V2_MASK_PRODUCERS) * 32, 1 <= B <= 2^25, 1 <= T <=
// 65535 spans, and
// the clock stays in int32 as for the scan.
int nfclab_v2_mask(const V2Args *a, int device, int threads, void *stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int64_t spans = (a->T + V2_MASK_SPAN - 1) / V2_MASK_SPAN;
    if (threads != (V2_MASK_WARPS + V2_MASK_PRODUCERS) * 32 || a->B < 1
        || a->B > (1LL << 25) || a->T < 1 || spans > 65535 || a->base < 0
        || (int64_t)a->base + a->T + 2 * RBV_RING > (1LL << 31))
        return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(v2_mask_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)V2_MASK_SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((a->B + 31) / 32), (unsigned)spans);
    v2_mask_kernel<<<grid, threads, (size_t)V2_MASK_SMEM,
                     (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
