// K16: the stats accumulators and the gated true-peak estimator, float64
// and float32, for Hopper (sm_90a).
//
// Replaces dsp_tpu/effects/stats.py:266 `StatsEffect.step`, with
// `_step_plain` (:159) and `_step_interp` (:197). Per selected channel, over
// the block's active samples (index samples + b < limit, both read on the
// device):
//   sum, sum_sq    += x, x²
//   plain          a sample is a peak event when it is a new min (x <= the
//                  running min) or else a new max (x >= the running max);
//                  peak = the largest |x| of an event; peak_count and
//                  peak_frame count and place the events equal to the final
//                  peak (exact comparison), restarting when it grew;
//                  min/max order -0.0 below +0.0, as jnp.minimum does
//   -i             the reference's gated estimator (stats.c:76-164): for 18
//                  samples after a sample crosses 0.5·min or 0.5·max, insert
//                  the 9-sample-delayed input into a 64-slot polyphase
//                  buffer, shift 6 interpolated points and fit 4 parabolas,
//                  each fit's vertex yq an event as above; the last event's
//                  kind wins the count.
//   samples' = min(samples + B, limit)
//
// What bounds it on the card: in -i every decision depends on the one
// before it (the gate opens on the thresholds the last fits set), so a
// channel is one dependent chain of B samples, with 64 + 3 fused
// multiply-adds and 4 fits a gated sample: latency, not the 32 KB it reads
// at B = 2048. Plain mode's running min and max are scans of exact
// operations, and its peak, count and first frame an exact reduction, so
// nothing in it is serial but the order of the float64 sums: the bytes it
// reads bound it.
// Design, plain mode: one launch of tiles over the card, the
// partition and look-back described at stats_plain_kernel below (model:
// tests/test_torch_stats_plain_tiles.py): a tile's min and max published
// first, its events found against the running min and max before it, its
// (pk, cnt, first) and sums published, the last tile of each channel group
// adding every tile's sums in tile order; stats -i, the state's pointers
// and its rows are passed as they are, with no struct built a call.
// Design, -i (a block a channel): the walk shortens the chain to
// what must be serial: the gate test and the fits' compares
// against the running min and max. The buffer, y and the four vertices of a
// gated sample depend only on the delayed inputs and on which samples were
// gated, so warp 0 computes them for 32 samples at once on the assumption
// that the gate stays open, finds by ballots where that holds, and runs in
// order only the samples whose fits can move the min or max (rare once a
// stream has played a while); a vertex's division runs only where a bound
// without it lets the vertex cross the running min or max; warp 1 sums.
// No lane branches on its own data (the per-lane logic is bitwise), since
// a divergent branch cost more than the arithmetic it guarded. The
// redesign and its model: interp_channel below,
// tests/test_torch_stats_window.py.
//
// Rounding. dsp_tpu's XLA fuses three of the estimator's sums into FMAs
// (the buffer insert M + x·H, the direct taps M[k] + c_k·x, and the vertex
// yq = y - dy·p4) and rounds everything else on its own: the kernel writes
// exactly those as __fma_rn and the rest with __dmul_rn / __dadd_rn /
// __dsub_rn, so nvcc contracts nothing, every yq equals dsp_tpu's, and the
// peak count (an integer decided by exact equality) comes out the same.
//
// float32 (dsp_stats_f32): the same kernels with T = float. Every comparison
// and the -i estimator's arithmetic run in float32 with the same three FMAs,
// so the decisions, min, max, peak, counts, frames and the estimator's
// state equal dsp_tpu float32's. The sums and sums of squares are taken in
// float64 from the float32 samples and rounded to float32 once, when they
// are added to the carried sums (dsp_tpu float32 sums in float32, in
// XLA's order): the printed DC offset and RMS agree to their last digit
// or one unit in it.
//
// The stream axis (batched processing): S independent streams in one
// launch, xs [S, B, n] and every leaf of the state with a leading S
// (samples and limit [S]); the new state's float leaves are the rows of
// fout [rows, S, n] and its matrices after them ([S, 64, n], [S, 6, n],
// [S, 9, n] with -i), its int64 leaves those of iout [2, S, n], then
// samples' [S]. A stream keeps the partition of a one-stream launch: plain
// mode's tiles follow its own B and n, never S·n, its look-back slots are
// its own (stream s's tile t of group g at s·ntiles·groups + t·groups + g)
// and its tickets run tile-major ((t·S + s)·groups + g), so a block only
// waits on earlier tickets; -i runs a block a channel of each stream. So
// each stream gets the bits of a one-stream launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lookback.cuh"
#include "tile_slab.cuh"
#include "rn.cuh"

// one stats state's device pointers, by value in the kernel's arguments
// (T the sample type); outside the anonymous namespace, so the extern "C"
// entries keep external linkage
template <typename T>
struct StatsState {
    T *sum, *sum_sq, *mn, *mx, *peak;
    long long *peak_count, *peak_frame, *samples;
    T *m, *y, *z;
    int* nctr;
    T *tmin, *tmax;

    // stream s's leaves, each stream's [n] rows n apart, its m, y and z
    // [64, n], [6, n], [9, n] apart and its samples one apart (the state in,
    // and the new state's buffers alike)
    __host__ __device__ StatsState at(int s, int n) const {
        const size_t r = (size_t)s * n;
        return {sum + r, sum_sq + r, mn + r, mx + r, peak + r, peak_count + r,
                peak_frame + r, samples + s, m + 64 * r, y + 6 * r, z + 9 * r, nctr + r,
                tmin + r, tmax + r};
    }
};

namespace {

constexpr int INTERP_DELAY = 18;
// -i stages this many of a channel's samples in shared memory at a time
constexpr int kStage = 2048;

// -i's insert template H in the constant bank, so that the nest's fused
// multiply-adds take their H operand with no load of their own. The
// wrapper (kernels.py launch_stats) uploads the call's table with
// dsp_stats_set_insert_f64/_f32, stream-ordered, whenever it is another
// table than the one uploaded last; the table's three direct taps are read
// where they lie
__constant__ double kInsertF64[64];
__constant__ float kInsertF32[64];
template <typename T>
__device__ __forceinline__ T insert_h(int k);
template <>
__device__ __forceinline__ double insert_h<double>(int k) { return kInsertF64[k]; }
template <>
__device__ __forceinline__ float insert_h<float>(int k) { return kInsertF32[k]; }

// A fit's vertex, exactly as stats.py:222-250 computes it. Kept out of line,
// so that the compiler cannot hoist its division out of the rare branch
// that needs it.
template <typename T>
__device__ __noinline__ T fit_vertex(T yc, T dy, T den) {
    const T p4 = div_rn(dy, mul_rn((T)8, den == 0 ? (T)1 : den));
    return fma_rn(-dy, p4, yc);
}

// Whether a fit's vertex yq = RN(yc - dy·RN(dy / (8·den))) (den != 0) can
// be a new min or max. |yq - yc| <= X = dy²/(8|den|)(1+u)² + u|yc| (u the
// sample type's unit roundoff; 8·den exact), so yq >= mx needs yc + X >= mx
// and yq <= mn needs yc - X <= mn. The test runs in float64 with a slack of
// 2^-20 for its own roundings, and answers true (the exact vertex is then
// computed) outside the ranges where its products neither overflow nor
// underflow and where a subnormal p4 or yq could round by more than X
// (|yc| below 1e-290, float32 1e-30), and on a NaN. A false rules an
// event out, so the division it spares could not have changed a decision.
template <typename T>
__device__ __forceinline__ bool may_cross(T yc, T dy, T den, T mn, T mx) {
    const double u = sizeof(T) == 4 ? 0x1p-24 : 0x1p-53, s = 0x1p-20;
    const double tiny = sizeof(T) == 4 ? 1e-30 : 1e-290;
    const double a = fabs((double)dy), b = fabs((double)den), c = (double)yc;
    const bool safe = (a >= 1e-140) & (a <= 1e140) & (b >= 1e-280) & (b <= 1e280) &
                      (fabs(c) >= tiny) & (fabs(c) <= 1e280);
    const double lhs = a * a * (1.0 + s) + 8.0 * b * (4.0 * u * fabs(c));
    const double rhs = 8.0 * b * (1.0 - s);
    const bool below_mx = ((double)mx - c) * rhs > lhs, above_mn = (c - (double)mn) * rhs > lhs;
    return !(safe & below_mx & above_mn);
}

// jnp.minimum / jnp.maximum: -0.0 orders below +0.0
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
    return (a < b || (a == b && signbit(a))) ? a : b;
}
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
    return (a > b || (a == b && !signbit(a))) ? a : b;
}

// plain mode, the tiles. A launch cuts the block's samples into tiles of
// kTile samples of up to kGroup channels (a tile a thread block, numbered
// by csrc/lookback.cuh's tickets: tile = ticket / groups, group = ticket %
// groups). A tile
//  1. stages its active samples' [rows, channels] slab in shared memory
//     (16-byte loads where the slab is one contiguous, aligned run), each
//     channel's row padded so that the lanes' 8-sample segments sit in
//     distinct banks;
//  2. publishes its channels' min and max (jnp's order, -0.0 < +0.0);
//  3. takes the running min and max before it: the carried state's and every
//     earlier tile's, folded in any order (min and max are exact);
//  4. finds its events against them (a warp a channel, a lane a segment of
//     8 samples, a warp scan of the segments' min and max giving each
//     segment its start), keeping (pk, cnt, first): the largest |x| of an
//     event, how many events equal it and the first, which combine exactly
//     (the larger pk; on a tie the counts add and the earlier frame stays),
//     and the float64 sums of x and x² (in order within a segment, the
//     segments in a fixed tree), and publishes them;
//  5. the channel group's last tile adds every tile's sums to the carried
//     ones in tile order and writes the state (and ticket 0 samples').
// So one launch does the block, and every run gives the same bits.
using tile_slab::kGroup;
using tile_slab::kPad;
using tile_slab::kSeg;
using tile_slab::kTile;
constexpr int kPubWidth = 5 * kGroup;  // doubles a tile publishes, each time
constexpr int kLook = 64;              // tiles' results staged at a time
// threads a tile: the warps past its channels stage the slab, wait on the
// earlier tiles and read their publications, whose latency sets the pace
constexpr int kPlainThreads = 256;

// a tile publishes twice, kPubWidth doubles each: its channels' min, then
// max; later cnt, first, sum, sum of squares and pk (kGroup each)
template <typename T>
struct PlainScratch {
    T x[kGroup * kPad];
    double pub[kPubWidth];
    double look[kLook * kPubWidth];
    T lim[4 * kGroup];  // the tile's min and max, then the running ones before it
    unsigned tk[2];
};

// the plain state's leaves in, one pointer each (the float leaves of T)
template <typename T>
struct PlainIn {
    const T *sum, *sum_sq, *mn, *mx, *peak;
    const long long *peak_count, *peak_frame, *samples;
};

// (pk, cnt, first) of one segment or tile combined with another's
template <typename T>
__device__ __forceinline__ void pk_combine(T& pk, int& cnt, int& first, T opk, int ocnt, int ofirst) {
    if (opk > pk) {
        pk = opk;
        cnt = ocnt;
        first = ofirst;
    } else if (opk == pk) {
        cnt += ocnt;
        first = min(first, ofirst);
    }
}

template <typename T>
__global__ void stats_plain_kernel(PlainIn<T> in, T* __restrict__ fout, long long* __restrict__ iout,
                                   const long long* __restrict__ limit, const T* __restrict__ xs,
                                   int B, int n, int groups, int ntiles, int S,
                                   lookback::Scratch lb) {
    __shared__ PlainScratch<T> sh;
    const unsigned full = 0xffffffffu;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    lookback::begin(lb, sh.tk);
    const unsigned ticket = sh.tk[0], tag = sh.tk[1];
    const int tile = (int)(ticket / ((unsigned)groups * S));
    const int st = (int)(ticket / groups % S), grp = (int)(ticket % groups);
    // the stream's leaves; fout's and iout's rows S·n apart
    const size_t r0 = (size_t)st * n, rs = (size_t)S * n;
    in.sum += r0;
    in.sum_sq += r0;
    in.mn += r0;
    in.mx += r0;
    in.peak += r0;
    in.peak_count += r0;
    in.peak_frame += r0;
    in.samples += st;
    fout += r0;
    xs += r0 * B;
    const long long s0 = *in.samples, lim = limit[st];
    const long long left = lim - s0;
    const int n_act = left <= 0 ? 0 : (left < B ? (int)left : B);
    const int c0 = grp * kGroup, ng = min(kGroup, n - c0);
    const int t0 = tile * kTile, rows = max(0, min(kTile, n_act - t0));
    // the stream's slots: its tile's at slot, every earlier one's `groups`
    // apart from base; the second publications nslots on
    const long long nslots = (long long)ntiles * groups * S;
    const long long base = (long long)st * ntiles * groups + grp;
    const long long slot = base + (long long)tile * groups;
    if (tile == 0 && grp == 0 && threadIdx.x == 0) iout[2 * rs + st] = s0 + B < lim ? s0 + B : lim;
    iout += r0;
    // 1. the slab
    tile_slab::load(sh.x, xs, n, groups, c0, ng, t0, rows);
    __syncthreads();
    // 2. the tile's min and max, published
    const int sb = lane * kSeg, se = min(rows, sb + kSeg);  // this lane's segment
    for (int c = warp; c < ng; c += nw) {
        T mn = (T)CUDART_INF, mx = (T)-CUDART_INF;
        for (int t = sb; t < se; ++t) {
            const T v = sh.x[tile_slab::at(c, t)];
            mn = jmin(mn, v);
            mx = jmax(mx, v);
        }
        for (int d = 16; d > 0; d >>= 1) {
            mn = jmin(mn, __shfl_xor_sync(full, mn, d));
            mx = jmax(mx, __shfl_xor_sync(full, mx, d));
        }
        if (lane == 0) {
            sh.pub[c] = (double)mn;
            sh.pub[kGroup + c] = (double)mx;
            sh.lim[c] = mn;
            sh.lim[kGroup + c] = mx;
        }
    }
    lookback::publish(lb, slot, tag, sh.pub, kPubWidth);
    // 3. the running min and max before the tile
    for (int j = threadIdx.x; j < tile; j += blockDim.x) lookback::wait(lb, base + (long long)j * groups, tag);
    __syncthreads();
    for (int c = warp; c < ng; c += nw) {
        T pmn = in.mn[c0 + c], pmx = in.mx[c0 + c];
#pragma unroll 4
        for (int j = lane; j < tile; j += 32) {
            const double* a = lb.agg + (base + (long long)j * groups) * kPubWidth;
            pmn = jmin(pmn, (T)__ldcg(a + c));
            pmx = jmax(pmx, (T)__ldcg(a + kGroup + c));
        }
        for (int d = 16; d > 0; d >>= 1) {
            pmn = jmin(pmn, __shfl_xor_sync(full, pmn, d));
            pmx = jmax(pmx, __shfl_xor_sync(full, pmx, d));
        }
        if (lane == 0) {
            sh.lim[2 * kGroup + c] = pmn;
            sh.lim[3 * kGroup + c] = pmx;
        }
        // 4. the segments' starts (an exclusive warp scan), then the events
        T smin = (T)CUDART_INF, smax = (T)-CUDART_INF;
        for (int t = sb; t < se; ++t) {
            const T v = sh.x[tile_slab::at(c, t)];
            smin = fmin_t(smin, v);
            smax = fmax_t(smax, v);
        }
        for (int d = 1; d < 32; d <<= 1) {
            const T omin = __shfl_up_sync(full, smin, d), omax = __shfl_up_sync(full, smax, d);
            if (lane >= d) {
                smin = fmin_t(omin, smin);
                smax = fmax_t(omax, smax);
            }
        }
        const T emin = __shfl_up_sync(full, smin, 1), emax = __shfl_up_sync(full, smax, 1);
        T run_mn = lane == 0 ? pmn : fmin_t(pmn, emin);
        T run_mx = lane == 0 ? pmx : fmax_t(pmx, emax);
        T pk = 0;
        int cnt = 0, first = B;  // B: no event
        double sum = 0.0, sq = 0.0;
        for (int t = sb; t < se; ++t) {
            const T v = sh.x[tile_slab::at(c, t)];
            sum = __dadd_rn(sum, (double)v);
            sq = __dadd_rn(sq, __dmul_rn((double)v, (double)v));
            if (v <= run_mn || v >= run_mx) {
                const T a = fabs_t(v);
                if (a > pk) {
                    pk = a;
                    cnt = 1;
                    first = t0 + t;
                } else if (a == pk && a > 0) {
                    ++cnt;
                }
            }
            run_mn = fmin_t(run_mn, v);
            run_mx = fmax_t(run_mx, v);
        }
        for (int d = 16; d > 0; d >>= 1) {
            pk_combine(pk, cnt, first, __shfl_xor_sync(full, pk, d), __shfl_xor_sync(full, cnt, d),
                       __shfl_xor_sync(full, first, d));
            sum = __dadd_rn(sum, __shfl_xor_sync(full, sum, d));
            sq = __dadd_rn(sq, __shfl_xor_sync(full, sq, d));
        }
        if (lane == 0) {
            sh.pub[c] = (double)cnt;
            sh.pub[kGroup + c] = (double)first;
            sh.pub[2 * kGroup + c] = sum;
            sh.pub[3 * kGroup + c] = sq;
            sh.pub[4 * kGroup + c] = (double)pk;
        }
    }
    if (tile < ntiles - 1) {
        lookback::publish(lb, nslots + slot, tag, sh.pub, kPubWidth);
        lookback::end(lb);
        return;
    }
    // 5. the group's last tile: every tile's results in tile order
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
        lookback::wait(lb, nslots + base + (long long)j * groups, tag);
    __syncthreads();
    double sum = 0.0, sq = 0.0;
    T pk = 0;
    int cnt = 0, first = B;
    const int c = threadIdx.x;
    for (int j0 = 0; j0 <= tile; j0 += kLook) {
        const int m = min(kLook, tile + 1 - j0);
        __syncthreads();
#pragma unroll 4
        for (int q = threadIdx.x; q < m * kPubWidth; q += blockDim.x) {
            const int j = j0 + q / kPubWidth;
            sh.look[q] = j == tile ? sh.pub[q % kPubWidth]
                                   : __ldcg(lb.agg + (nslots + base + (long long)j * groups) * kPubWidth +
                                            q % kPubWidth);
        }
        __syncthreads();
        if (c < ng) {
            for (int i = 0; i < m; ++i) {
                const double* r = sh.look + i * kPubWidth;
                sum = __dadd_rn(sum, r[2 * kGroup + c]);
                sq = __dadd_rn(sq, r[3 * kGroup + c]);
                pk_combine(pk, cnt, first, (T)r[4 * kGroup + c], (int)r[c], (int)r[kGroup + c]);
            }
        }
    }
    if (c < ng) {
        const int ch = c0 + c;
        const T pk0 = in.peak[ch], peak = fmax_t(pk0, pk);
        const bool higher = peak > pk0;
        const long long bc = pk == peak ? cnt : 0;
        fout[ch] = (T)__dadd_rn((double)in.sum[ch], sum);
        fout[rs + ch] = (T)__dadd_rn((double)in.sum_sq[ch], sq);
        // the carried and earlier tiles' min and max, then this tile's
        fout[2 * rs + ch] = jmin(sh.lim[2 * kGroup + c], sh.lim[c]);
        fout[3 * rs + ch] = jmax(sh.lim[3 * kGroup + c], sh.lim[kGroup + c]);
        fout[4 * rs + ch] = peak;
        iout[ch] = higher ? bc : in.peak_count[ch] + bc;
        iout[rs + ch] = higher ? s0 + first : in.peak_frame[ch];
    }
    lookback::end(lb);
}

// -i, the windowed walk. The block's two warps stage the channel's input in
// shared memory, kStage samples at a time (seq: the carried z, then the
// samples; x of sample j is seq[j], its sv seq[j + 9]); warp 1 then adds
// the stage's samples to the sums one by one, in order (the order their
// bits depend on), while warp 0 walks them 32 at a time, one a lane.
//
// While the gate stays open, slot k of the 64-slot buffer M before a sample
// is a fixed nest of fused multiply-adds over the gated inputs before it,
// fma(x_1, H[k], fma(x_2, H[k+4], ...)), x_1 the latest, at most 16 levels
// deep, down to the block's carried M (M0[k + 4g] after g gated samples,
// g < 16) or a zero slot (stats.py:212-217). So the walk keeps, instead of
// M, the last 16 gated inputs (gx[0..15], the latest last) and their count
// since the block began (tg, at most 16), and builds M from them once, at
// the end of the block.
//
//  1. gate closed (nc == 0): the thresholds cannot move, so a ballot of the
//     window's triggers finds the first one; none skips the window (z, M
//     and y do not change while the gate is closed).
//  2. gate open: every lane assumes every sample of the window from its
//     start is gated. Lane l computes its sample's slots 0-3 as the nest
//     over the 16 gated inputs before it (the history, then the window's
//     earlier lanes: gx[16 + l - 1 - i] at level i), with the operations
//     of the plain version in its order (so the same bits; H from the
//     constant bank), its y[2..5] from them, y[0..1] from lane l-1, and its
//     four fits, each vertex divided out only where may_cross lets it be a
//     new min or max (NaN elsewhere, which no compare takes).
//  3. decide: until the first sample whose fits can be a new min or max
//     (a ballot of yq <= min or yq >= max), nothing moves the thresholds,
//     so the trigger count alone gates the samples (a ballot of the
//     triggers and each lane's distance to the last one). That sample's
//     fits run on every lane in order (stats_interp_peak's serial part),
//     and the ballots run again over the lanes after it.
//  4. close at the first sample the gate leaves, or at the window's end:
//     y from the last gated lane; the window's gated inputs join the
//     history.
template <typename T>
struct InterpScratch {
    T seq[kStage + 9 + 32];
    T gx[16 + 32];  // the last 16 gated inputs, then the open window's inputs
    T m[64];        // the block's carried M
};

// The stage seq[cs .. ce + 9) of channel c, by the block's 64 threads.
template <typename T>
__device__ void stage_in(const StatsState<T>& in, const T* __restrict__ xs, T* seq, int c,
                         int n, int cs, int ce) {
    constexpr int kBatch = 8;
    const int cnt = ce - cs + 9;
    for (int b = 0; b < cnt; b += 64 * kBatch) {
        T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = b + u * 64 + (int)threadIdx.x, j = cs + i;
            v[u] = i >= cnt ? (T)0 : (j < 9 ? in.z[j * n + c] : xs[(size_t)(j - 9) * n + c]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = b + u * 64 + (int)threadIdx.x;
            if (i < cnt) seq[i] = v[u];
        }
    }
}

// The stage's samples added in order (warp 1, every lane alike).
template <typename T>
__device__ void stage_sums(const T* w, int m, double& sum, double& sq) {
    int k = 0;
    for (; k + 8 <= m; k += 8) {
        T v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = w[k + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            sum = __dadd_rn(sum, (double)v[u]);
            sq = __dadd_rn(sq, __dmul_rn((double)v[u], (double)v[u]));
        }
    }
    for (; k < m; ++k) {
        const double v = (double)w[k];
        sum = __dadd_rn(sum, v);
        sq = __dadd_rn(sq, __dmul_rn(v, v));
    }
}

template <typename T>
__device__ void interp_channel(const StatsState<T>& in, const StatsState<T>& out,
                               const T* __restrict__ xs, const T* __restrict__ hc,
                               InterpScratch<T>& sh, int c, int n, int n_act, long long s0) {
    const unsigned full = 0xffffffffu;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {
        sh.m[lane] = in.m[lane * n + c];
        sh.m[lane + 32] = in.m[(lane + 32) * n + c];
    }
    const T c0 = hc[64], c1 = hc[65], c2 = hc[66];
    T y[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) y[k] = in.y[k * n + c];
    int nc = in.nctr[c], tg = 0;
    T tmin = in.tmin[c], tmax = in.tmax[c];
    T mn = in.mn[c], mx = in.mx[c], pk = in.peak[c];
    long long cnt = in.peak_count[c], frm = in.peak_frame[c];
    double sum = 0.0, sq = 0.0;
    const unsigned upto = (2u << lane) - 1u;  // this lane and the ones before it
    for (int cs = 0; cs < n_act; cs += kStage) {
        const int ce = min(n_act, cs + kStage);
        __syncthreads();
        stage_in(in, xs, sh.seq, c, n, cs, ce);
        __syncthreads();
        if (warp == 1) {
            stage_sums(sh.seq + 9, ce - cs, sum, sq);
            continue;
        }
        int p = cs;
        while (p < ce) {
            const int L = min(32, ce - p);
            const bool valid = lane < L;
            const T* w = sh.seq + (p - cs);  // w[l] = x of lane l, w[l + 9] its sv
            const T sv = w[lane + 9];
            if (nc == 0) {
                // 1. the gate is closed: the first trigger, or the next window
                const unsigned tm = __ballot_sync(full, valid & ((sv < tmin) | (sv > tmax)));
                if (tm == 0u) {
                    p += L;
                    continue;
                }
                const int f = __ffs(tm) - 1;
                if (f > 0) {
                    p += f;
                    continue;
                }
            }
            // 2. every sample from p assumed gated: slots 0-3 before lane's
            const T x = w[lane];
            sh.gx[16 + lane] = x;
            __syncwarp();
            const T* gl = sh.gx + 15 + lane;  // gl[-i]: the input i + 1 gated inputs back
            T mb[4];
            if (tg >= 16) {
                T xi[16];
#pragma unroll
                for (int i = 0; i < 16; ++i) xi[i] = gl[-i];
#pragma unroll
                for (int k = 0; k < 4; ++k) mb[k] = (T)0;
#pragma unroll
                for (int i = 15; i >= 0; --i) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) mb[k] = fma_rn(xi[i], insert_h<T>(k + 4 * i), mb[k]);
                }
            } else {
                // fewer than 16 gated inputs since the block began: the nest
                // ends at the carried M
                const int g = tg + lane;
#pragma unroll
                for (int k = 0; k < 4; ++k) mb[k] = g < 16 ? sh.m[k + 4 * g] : (T)0;
#pragma unroll
                for (int i = 15; i >= 0; --i) {
                    const T xi = gl[-i];
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const T v = fma_rn(xi, insert_h<T>(k + 4 * i), mb[k]);
                        mb[k] = i < g ? v : mb[k];
                    }
                }
            }
            T yy[6];
            yy[2] = fma_rn(c0, x, mb[0]);
            yy[3] = fma_rn(c1, x, mb[1]);
            yy[4] = fma_rn(c2, x, mb[2]);
            yy[5] = mb[3];
            yy[0] = __shfl_up_sync(full, yy[4], 1);
            yy[1] = __shfl_up_sync(full, yy[5], 1);
            if (lane == 0) {
                yy[0] = y[4];
                yy[1] = y[5];
            }
            // the fits: the vertex only where it can be a new min or max
            // (may_cross; NaN elsewhere, which no compare takes), so the
            // divisions run only in the windows that can hold an event
            T yq[4], dyv[4], denv[4];
            unsigned skip = 0, need = 0;
#pragma unroll
            for (int i = 1; i < 5; ++i) {
                // (bitwise logic, so that no lane branches)
                const T d0 = sub_rn(yy[i], yy[i - 1]);
                const T d1 = sub_rn(yy[i], yy[i + 1]);
                const bool sk = ((d0 > 0) & (d1 < 0)) | ((d0 < 0) & (d1 > 0)) | ((d0 == 0) & (d1 == 0));
                dyv[i - 1] = sub_rn(yy[i - 1], yy[i + 1]);
                denv[i - 1] = add_rn(sub_rn(yy[i - 1], mul_rn((T)2, yy[i])), yy[i + 1]);
                yq[i - 1] = (T)CUDART_NAN;
                skip |= (unsigned)sk << (i - 1);
                need |= (unsigned)(!sk & ((denv[i - 1] == 0) |
                                          may_cross(yy[i], dyv[i - 1], denv[i - 1], mn, mx)))
                        << (i - 1);
            }
            if (__any_sync(full, valid & (need != 0u))) {
#pragma unroll
                for (int i = 1; i < 5; ++i) {
                    if ((need >> (i - 1)) & 1u) yq[i - 1] = fit_vertex(yy[i], dyv[i - 1], denv[i - 1]);
                }
            }
            // 3. decide, from lane q on
            int q = 0, ncq = nc, G = 0;
            while (true) {
                const bool on = valid & (lane >= q);
                const unsigned tm = __ballot_sync(full, on & ((sv < tmin) | (sv > tmax))) & upto;
                const int ncb = tm != 0u ? INTERP_DELAY - (lane - (31 - __clz((int)tm)))
                                         : ncq - (lane - q);
                const unsigned offm = __ballot_sync(full, on & (ncb <= 0));
                const int close = offm != 0u ? __ffs(offm) - 1 : L;
                bool cand = false;
#pragma unroll
                for (int i = 0; i < 4; ++i) cand |= (yq[i] <= mn) | (yq[i] >= mx);
                const unsigned evm = __ballot_sync(full, on & cand);
                const int ev = evm != 0u ? __ffs(evm) - 1 : L;
                if (ev >= close) {
                    G = close;
                    const int nlast = __shfl_sync(full, ncb, G > 0 ? G - 1 : 0);
                    nc = G > q ? nlast - 1 : ncq;
                    break;
                }
                // the sample at ev, in order, on every lane
                const unsigned sk = __shfl_sync(full, skip, ev);
                int r = 0;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const T v = __shfl_sync(full, yq[i], ev);
                    if ((sk >> i) & 1u) continue;
                    if (v <= mn) {
                        mn = v;
                        tmin = mul_rn((T)0.5, v);
                    } else if (v >= mx) {
                        mx = v;
                        tmax = mul_rn((T)0.5, v);
                    } else {
                        continue;
                    }
                    const T a = fabs_t(v);
                    if (a > pk) {
                        pk = a;
                        r = 2;
                    } else if (a > 0 && a == pk) {
                        r = 1;
                    }
                }
                if (r == 2) {
                    frm = s0 + p + ev - (INTERP_DELAY - 1);
                    cnt = 1;
                } else if (r == 1) {
                    ++cnt;
                }
                q = ev + 1;
                ncq = __shfl_sync(full, ncb, ev) - 1;
                if (q == L) {
                    G = L;
                    nc = ncq;
                    break;
                }
            }
            // 4. close after G gated samples: y, and the history
#pragma unroll
            for (int k = 0; k < 6; ++k) y[k] = __shfl_sync(full, yy[k], G - 1);
            const T keep = sh.gx[G + (lane & 15)];
            __syncwarp();
            if (lane < 16) sh.gx[lane] = keep;
            __syncwarp();
            tg = min(16, tg + G);
            p += G;
        }
    }
    if (warp == 1) {
        if (lane == 0) {
            out.sum[c] = (T)__dadd_rn((double)in.sum[c], sum);
            out.sum_sq[c] = (T)__dadd_rn((double)in.sum_sq[c], sq);
        }
        return;
    }
    // M after the block's last gated sample: slots lane and lane + 32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int sl = lane + 32 * h, nlev = 16 - sl / 4, d = min(tg, nlev);
        T v = tg < nlev ? sh.m[sl + 4 * tg] : (T)0;
        for (int i = d - 1; i >= 0; --i) v = fma_rn(sh.gx[15 - i], insert_h<T>(sl + 4 * i), v);
        out.m[sl * n + c] = v;
    }
    if (lane >= 9) return;
    // z: the last 9 of the carried z and the samples
    const int j = n_act + lane;
    out.z[lane * n + c] = j < 9 ? in.z[j * n + c] : xs[(size_t)(j - 9) * n + c];
    if (lane != 0) return;
#pragma unroll
    for (int k = 0; k < 6; ++k) out.y[k * n + c] = y[k];
    out.nctr[c] = nc;
    out.tmin[c] = tmin;
    out.tmax[c] = tmax;
    out.mn[c] = mn;
    out.mx[c] = mx;
    out.peak[c] = pk;
    out.peak_count[c] = cnt;
    out.peak_frame[c] = frm;
}

template <typename T>
__global__ void stats_interp_kernel(StatsState<T> in, StatsState<T> out,
                                    const long long* __restrict__ limit, const T* __restrict__ xs,
                                    const T* __restrict__ hc, int B, int n) {
    __shared__ InterpScratch<T> sh;
    const int c = blockIdx.x, st = blockIdx.y;  // a block a channel of a stream
    in = in.at(st, n);
    out = out.at(st, n);
    xs += (size_t)st * B * n;
    const long long s0 = *in.samples, lim = limit[st];
    if (c == 0 && threadIdx.x == 0) *out.samples = s0 + B < lim ? s0 + B : lim;
    if (c >= n) return;
    const long long left = lim - s0;
    const int n_act = left <= 0 ? 0 : (left < B ? (int)left : B);
    interp_channel<T>(in, out, xs, hc, sh, c, n, n_act, s0);
}

// The kernels this file has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long stats_launches = 0;

// The state's pointers in, as the caller passes them: the plain leaves, then
// (-i) m, y, z, nctr, tmin, tmax
struct StatsPtrs {
    const void *sum, *sum_sq, *mn, *mx, *peak, *peak_count, *peak_frame, *samples;
    const void *m, *y, *z, *nctr, *tmin, *tmax;
};

template <typename T>
int launch_stats(const StatsPtrs& p, T* fout, long long* iout, int* nctr_out,
                 const long long* limit, const T* xs, const T* hc, int B, int n, int S,
                 unsigned* flags, long long flag_slots, double* agg, long long agg_doubles,
                 void* stream) {
    if (B <= 0 || n < 0 || S <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (hc == nullptr) {
        // one launch: tiles of kTile samples of kGroup channels of each
        // stream; no channel selected, one block a stream that writes its
        // samples'
        const int groups = n > 0 ? (n + kGroup - 1) / kGroup : 1;
        const int ntiles = n > 0 ? (B + kTile - 1) / kTile : 1;
        const long long nslots = (long long)ntiles * groups * S;
        if (flags == nullptr || agg == nullptr || 2 * nslots > flag_slots ||
            2 * nslots * kPubWidth > agg_doubles || nslots > 0x7fffffffLL)
            return (int)cudaErrorInvalidValue;
        const PlainIn<T> in = {(const T*)p.sum, (const T*)p.sum_sq, (const T*)p.mn, (const T*)p.mx,
                               (const T*)p.peak, (const long long*)p.peak_count,
                               (const long long*)p.peak_frame, (const long long*)p.samples};
        stats_plain_kernel<T><<<(unsigned)nslots, kPlainThreads, 0, st>>>(
            in, fout, iout, limit, xs, B, n, groups, ntiles, S, lookback::carve(flags, agg));
    } else {
        // -i: a block (two warps) a channel of a stream; one block a stream
        // when no channel is selected. The outputs are rows of fout, S·n
        // apart (the five plain leaves, tmin, tmax), then m [S, 64, n], y
        // [S, 6, n] and z [S, 9, n]; iout (peak_count, peak_frame rows, then
        // samples [S]) and nctr_out [S, n]
        const size_t rs = (size_t)S * n;
        StatsState<T> in = {(T*)p.sum, (T*)p.sum_sq, (T*)p.mn, (T*)p.mx, (T*)p.peak,
                            (long long*)p.peak_count, (long long*)p.peak_frame,
                            (long long*)p.samples, (T*)p.m, (T*)p.y, (T*)p.z, (int*)p.nctr,
                            (T*)p.tmin, (T*)p.tmax};
        StatsState<T> out = {fout, fout + rs, fout + 2 * rs, fout + 3 * rs, fout + 4 * rs, iout,
                             iout + rs, iout + 2 * rs, fout + 7 * rs, fout + 71 * rs,
                             fout + 77 * rs, nctr_out, fout + 5 * rs, fout + 6 * rs};
        stats_interp_kernel<T><<<dim3(n > 0 ? n : 1, S), 64, 0, st>>>(in, out, limit, xs, hc, B,
                                                                       n);
    }
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++stats_launches;
    return (int)err;
}

}  // namespace

// The -i insert template H[64] (the first 64 of a [67] table on the device)
// into the constant bank, on the stream; returns the copy's error code.
extern "C" int dsp_stats_set_insert_f64(const double* hc, void* stream) {
    return (int)cudaMemcpyToSymbolAsync(kInsertF64, hc, 64 * sizeof(double), 0,
                                        cudaMemcpyDeviceToDevice,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int dsp_stats_set_insert_f32(const float* hc, void* stream) {
    return (int)cudaMemcpyToSymbolAsync(kInsertF32, hc, 64 * sizeof(float), 0,
                                        cudaMemcpyDeviceToDevice,
                                        static_cast<cudaStream_t>(stream));
}

// One block of stats on S streams (S = 1: the shapes below without their
// S). The state in, a pointer a leaf (sum, sum_sq, min, max, peak,
// peak_count, peak_frame, samples; with -i also m, y, z, nctr, tmin, tmax,
// else null), each led by S; the state out as the rows of two buffers,
// fout [5, S, n] (-i: [7, S, n] sum, sum_sq, min, max, peak, tmin, tmax,
// then m [S, 64, n], y [S, 6, n], z [S, 9, n]) of the sample type and iout
// [2, S, n] of int64 (peak_count, peak_frame), then samples [S], and
// nctr_out [S, n] (-i); limit the int64 limit [S]; hc null in plain mode,
// else [67]: the insert template H[64], then the direct taps r0..r2; flags
// and agg the look-back scratch of csrc/lookback.cuh (plain mode). Returns
// cudaGetLastError() after the launch (0 on success). The caller
// (dsp_tpu_torch/ops/time_domain.py) checks shapes, dtypes and contiguity.
extern "C" int dsp_stats_f64(const void* sum, const void* sum_sq, const void* mn, const void* mx,
                             const void* peak, const void* peak_count, const void* peak_frame,
                             const void* samples, const void* m, const void* y, const void* z,
                             const void* nctr, const void* tmin, const void* tmax, double* fout,
                             long long* iout, int* nctr_out, const long long* limit,
                             const double* xs, const double* hc, int B, int n, int S,
                             unsigned* flags, long long flag_slots, double* agg,
                             long long agg_doubles, void* stream) {
    const StatsPtrs p = {sum, sum_sq, mn, mx, peak, peak_count, peak_frame, samples,
                         m, y, z, nctr, tmin, tmax};
    return launch_stats<double>(p, fout, iout, nctr_out, limit, xs, hc, B, n, S, flags, flag_slots,
                                agg, agg_doubles, stream);
}

extern "C" int dsp_stats_f32(const void* sum, const void* sum_sq, const void* mn, const void* mx,
                             const void* peak, const void* peak_count, const void* peak_frame,
                             const void* samples, const void* m, const void* y, const void* z,
                             const void* nctr, const void* tmin, const void* tmax, float* fout,
                             long long* iout, int* nctr_out, const long long* limit,
                             const float* xs, const float* hc, int B, int n, int S,
                             unsigned* flags, long long flag_slots, double* agg,
                             long long agg_doubles, void* stream) {
    const StatsPtrs p = {sum, sum_sq, mn, mx, peak, peak_count, peak_frame, samples,
                         m, y, z, nctr, tmin, tmax};
    return launch_stats<float>(p, fout, iout, nctr_out, limit, xs, hc, B, n, S, flags, flag_slots,
                               agg, agg_doubles, stream);
}

extern "C" unsigned long long dsp_stats_launches() { return stats_launches; }
