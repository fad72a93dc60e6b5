// K17: the levels meters, float64 and float32, for Hopper (sm_90a).
//
// Replaces dsp_tpu/effects/levels.py:62 `LevelsEffect.step`. Per selected
// channel, over the block's samples s = x²:
//   avg' = (1 - g)·avg + g·s                 (EWMA of the square)
//   m'   = max(s, (1 - g)·m + g·s)           (set-min EWMA: the peak meter)
//   block_peak' = max(block_peak, every m of the block)
// dsp_tpu ran this as an associative scan of (a, b, c) triples under
// m -> max(c, a·m + b) with (a, b, c) = (1 - g, g·s, s); the kernel scans the
// same maps in another grouping, so the two agree to rounding (held to
// 1e-12 relative).
//
// What bounds it on the card: the maps compose associatively, so nothing
// is serial but the order in which they meet the carried value; the 32 KB
// it reads at B = 2048 (stereo) bound it. Design: one launch of
// tiles of 256 samples of up to 8 channels over the card (levels_kernel
// below; model: tests/test_torch_levels_tiles.py). A lane composes its
// segment of 8 samples into one map (a, b, c), a warp-shuffle scan gives
// each segment its map from the tile's start, the tile publishes its map,
// and csrc/lookback.cuh's carry_max_affine applies every earlier tile's map
// to the carried (avg, m) in tile order, so the same operations run in the
// same order whatever the card's timing; each lane reruns its segment from
// its start value, and the block's peak (an exact max) is reduced over the
// tiles by each channel group's last tile, which writes the state.
//
// float32 (dsp_levels_f32): samples and meters are read as float32 and
// stored as float32, and the scan runs in float64 registers with g
// unrounded, so each meter rounds once, where it is stored. dsp_tpu float32
// scans in float32; the two differ by float32 rounding, not by decisions
// (a meter decides nothing).
//
// The stream axis (batched processing): S independent streams in one
// launch, xs [S, B, n], the meters [S, n] and out [3, S, n]. A stream keeps
// the partition of a one-stream launch (its tiles follow its own B and n,
// never S·n), and its look-back slots are its own (stream s's tile t of
// group g at s·ntiles·groups + t·groups + g), so it gets the same bits.
// The tickets run tile-major (tile t of stream s, group g is ticket
// (t·S + s)·groups + g), so a block only waits on earlier tickets.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lookback.cuh"
#include "tile_slab.cuh"

namespace {

// the map m -> max(c, a·m + b); avg uses its affine part a·avg + b
struct MaxAffine {
    double a, b, c;
};

// `second` after `first`
__device__ __forceinline__ MaxAffine compose(const MaxAffine& first, const MaxAffine& second) {
    return {second.a * first.a, fma(second.a, first.b, second.b),
            fmax(second.c, fma(second.a, first.c, second.b))};
}

using tile_slab::kGroup;
using tile_slab::kPad;
using tile_slab::kSeg;
using tile_slab::kTile;

constexpr int kSlot = 3 * kGroup;  // doubles a tile publishes, each time
// threads a tile: the warps past its channels stage the slab, wait on the
// earlier tiles and read their maps, whose latency sets the pace
constexpr int kThreads = 256;

template <typename T>
struct Smem {
    T x[kGroup * kPad];
    double pre[kGroup][3][32];  // each lane's map from the tile's start
    double pub[kSlot];
    double v[2 * kGroup];       // the carried (avg, m), then the tile's start
    double buf[lookback::kMaxAffineLook * kSlot];
    unsigned tk[2];
};

// One launch: tiles of kTile samples of up to kGroup channels over the card,
// a tile a thread block, numbered by csrc/lookback.cuh's tickets. A tile
// stages its [rows, channels] slab in shared memory (16-byte loads where it
// is one aligned run); a warp a channel, a lane a segment of 8 samples
// composed into one map, a warp scan giving each segment its map from the
// tile's start; the tile publishes its maps, carry_max_affine applies every
// earlier tile's to the carried (avg, m) in tile order, each lane reruns its
// segment from its start value, and the tile publishes the largest m it
// saw; the channel group's last tile writes the end state and the largest
// of every tile's and the carried block_peak.
template <typename T>
__global__ void levels_kernel(const T* __restrict__ avg_in, const T* __restrict__ peak_in,
                              const T* __restrict__ bp_in, T* __restrict__ out,
                              const T* __restrict__ xs, double g, int B, int n, int groups,
                              int ntiles, int S, lookback::Scratch lb) {
    __shared__ Smem<T> sh;
    const unsigned full = 0xffffffffu;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    const double a = 1.0 - g;
    lookback::begin(lb, sh.tk);
    const unsigned ticket = sh.tk[0], tag = sh.tk[1];
    const int tile = (int)(ticket / ((unsigned)groups * S));
    const int st = (int)(ticket / groups % S), grp = (int)(ticket % groups);
    const int c0 = grp * kGroup, ng = min(kGroup, n - c0);
    const int t0 = tile * kTile, rows = min(kTile, B - t0);
    // the stream's slots: its tile's at slot, every earlier one's `groups`
    // apart from base; the second publications nslots on
    const long long nslots = (long long)ntiles * groups * S;
    const long long base = (long long)st * ntiles * groups + grp;
    const long long slot = base + (long long)tile * groups;
    avg_in += (size_t)st * n;
    peak_in += (size_t)st * n;
    bp_in += (size_t)st * n;
    out += (size_t)st * n;
    xs += (size_t)st * B * n;
    // the slab
    tile_slab::load(sh.x, xs, n, groups, c0, ng, t0, rows);
    if (threadIdx.x < kGroup) {
        // identity maps and zero values for channels past the group's end
        const int c = threadIdx.x;
        sh.pub[c] = 1.0;
        sh.pub[kGroup + c] = 0.0;
        sh.pub[2 * kGroup + c] = -CUDART_INF;
        sh.v[c] = c < ng ? (double)avg_in[c0 + c] : 0.0;
        sh.v[kGroup + c] = c < ng ? (double)peak_in[c0 + c] : 0.0;
    }
    __syncthreads();
    // each segment as one map, the warp's scan, the tile's map published
    const int sb = lane * kSeg, se = min(rows, sb + kSeg);
    for (int c = warp; c < ng; c += nw) {
        MaxAffine f = {1.0, 0.0, -CUDART_INF};
        for (int t = sb; t < se; ++t) {
            const double v = (double)sh.x[tile_slab::at(c, t)];
            const double s = v * v;
            f = compose(f, {a, g * s, s});
        }
        for (int d = 1; d < 32; d <<= 1) {
            const MaxAffine o = {__shfl_up_sync(full, f.a, d), __shfl_up_sync(full, f.b, d),
                                 __shfl_up_sync(full, f.c, d)};
            if (lane >= d) f = compose(o, f);
        }
        MaxAffine pre = {__shfl_up_sync(full, f.a, 1), __shfl_up_sync(full, f.b, 1),
                         __shfl_up_sync(full, f.c, 1)};
        if (lane == 0) pre = {1.0, 0.0, -CUDART_INF};
        sh.pre[c][0][lane] = pre.a;
        sh.pre[c][1][lane] = pre.b;
        sh.pre[c][2][lane] = pre.c;
        if (lane == 31) {
            sh.pub[c] = f.a;
            sh.pub[kGroup + c] = f.b;
            sh.pub[2 * kGroup + c] = f.c;
        }
    }
    if (tile < ntiles - 1) lookback::publish(lb, slot, tag, sh.pub, kSlot);
    // the carried value through every earlier tile's maps, in tile order
    lookback::carry_max_affine(lb, base, groups, tile, tag, kGroup, sh.v, sh.buf);
    // rerun each segment from its start; the largest m of the tile
    for (int c = warp; c < ng; c += nw) {
        const double pa = sh.pre[c][0][lane], pb = sh.pre[c][1][lane], pc = sh.pre[c][2][lane];
        double avg = fma(pa, sh.v[c], pb);
        double m = fmax(pc, fma(pa, sh.v[kGroup + c], pb));
        double bp = 0.0;
        for (int t = sb; t < se; ++t) {
            const double v = (double)sh.x[tile_slab::at(c, t)];
            const double s = v * v;
            const double gs = g * s;
            avg = fma(a, avg, gs);
            m = fmax(s, fma(a, m, gs));
            bp = fmax(bp, m);
        }
        for (int d = 16; d > 0; d >>= 1) bp = fmax(bp, __shfl_xor_sync(full, bp, d));
        // the last lane's segment ends at the tile's end (or is empty, past
        // it): its state is the tile's end state
        if (lane == 31) {
            sh.pub[c] = bp;
            sh.v[c] = avg;
            sh.v[kGroup + c] = m;
        }
    }
    if (tile < ntiles - 1) {
        lookback::publish(lb, nslots + slot, tag, sh.pub, kSlot);
        lookback::end(lb);
        return;
    }
    // the group's last tile: the end state, and block_peak over every tile
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
        lookback::wait(lb, nslots + base + (long long)j * groups, tag);
    __syncthreads();
    const size_t row = (size_t)S * n;  // out's rows: avg, peak, block_peak
    for (int c = warp; c < ng; c += nw) {
        double bp = lane == 0 ? fmax((double)bp_in[c0 + c], sh.pub[c]) : 0.0;
#pragma unroll 4
        for (int j = lane; j < tile; j += 32)
            bp = fmax(bp, __ldcg(lb.agg + (nslots + base + (long long)j * groups) * kSlot + c));
        for (int d = 16; d > 0; d >>= 1) bp = fmax(bp, __shfl_xor_sync(full, bp, d));
        if (lane == 0) {
            out[c0 + c] = (T)sh.v[c];
            out[row + c0 + c] = (T)sh.v[kGroup + c];
            out[2 * row + c0 + c] = (T)bp;
        }
    }
    lookback::end(lb);
}

// The kernels this file has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long levels_launches = 0;

template <typename T>
int launch_levels(const T* avg_in, const T* peak_in, const T* bp_in, T* out, const T* xs,
                  double g, int B, int n, int S, unsigned* flags, long long flag_slots,
                  double* agg, long long agg_doubles, void* stream) {
    if (B <= 0 || n <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
    // a stream's partition: its tiles and groups follow its own B and n
    const int groups = (n + kGroup - 1) / kGroup, ntiles = (B + kTile - 1) / kTile;
    const long long nslots = (long long)ntiles * groups * S;
    if (flags == nullptr || agg == nullptr || 2 * nslots > flag_slots ||
        2 * nslots * kSlot > agg_doubles || nslots > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    levels_kernel<T><<<(unsigned)nslots, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        avg_in, peak_in, bp_in, out, xs, g, B, n, groups, ntiles, S,
        lookback::carve(flags, agg));
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++levels_launches;
    return (int)err;
}

}  // namespace

// One block of the meters of S streams: avg_in, peak_in, bp_in [S, n]; out
// [3, S, n] the new avg, peak and block_peak as rows; xs [S, B, n]; flags
// (flag_slots slots after its head) and agg (agg_doubles long) the
// look-back scratch of csrc/lookback.cuh. Returns cudaGetLastError() after the launch (0 on
// success). The caller (dsp_tpu_torch/ops/time_domain.py) checks shapes,
// dtypes and contiguity.
extern "C" int dsp_levels_f64(const double* avg_in, const double* peak_in, const double* bp_in,
                              double* out, const double* xs, double g, int B, int n, int S,
                              unsigned* flags, long long flag_slots, double* agg,
                              long long agg_doubles, void* stream) {
    return launch_levels<double>(avg_in, peak_in, bp_in, out, xs, g, B, n, S, flags, flag_slots,
                                 agg, agg_doubles, stream);
}

extern "C" int dsp_levels_f32(const float* avg_in, const float* peak_in, const float* bp_in,
                              float* out, const float* xs, double g, int B, int n, int S,
                              unsigned* flags, long long flag_slots, double* agg,
                              long long agg_doubles, void* stream) {
    return launch_levels<float>(avg_in, peak_in, bp_in, out, xs, g, B, n, S, flags, flag_slots,
                                agg, agg_doubles, stream);
}

extern "C" unsigned long long dsp_levels_launches() { return levels_launches; }
