// K11: matrix4's envelope followers, float64 or float32, for Hopper (sm_90a).
//
// Replaces dsp_tpu/ops/m4_engine.py:267 `env_ewma_scan` as matrix4 calls it
// (effects/matrix4.py:444-456): from the band-limited pair (l, r) of a
// block, the eight audio-rate EWMAs
//   m' = (1 - g)·m + g·s,  s in |l|, |r|, |l+r|, |l-r|, l², r², (l+r)², (l-r)²
// and their values at the control ticks D-1, 2D-1, ... (D = 32), which is
// all the event engine reads. dsp_tpu ran an associative scan of the affine
// maps over the block and then took every D-th row; this kernel writes only
// those rows and the carried m.
//
// matrix4_mb (dsp_tpu/effects/matrix4_mb.py:397-432) runs the same EWMAs on
// each of its 13 bands: the input is G lanes of pairs [B, G, 2] (G = 1 for
// matrix4), and with freq_mask the lanes are first mixed by the
// lower-triangular weights w [G, G] (lane k's pair is sum over j <= k of
// w[k, j]·pair_j, summed from j = 0 up with each product rounded, as the
// plain version sums it). The outputs are [G, 8] and [B/D, G, 8].
//
// The stream axis (batched processing): NS independent streams of G lanes
// each in one launch, the input [NS, B, G, 2], the envelopes [NS, G, 8] and
// the ticks [NS, B/D, G, 8]; w mixes within each stream's G lanes. A
// stream keeps the partition of a one-stream launch: nseg follows G, never
// NS·G, so its tiles, its scan and its look-back's combine order are those
// of a one-stream call, and its slots of the look-back scratch are its own
// (stream s's tile t at s·ntiles + t): the same bits.
//
// What bounds it on the card: each envelope is a dependent chain of B
// samples (two operations a sample) over 16·G·B bytes: latency, unless the
// chain is cut up. With the constant a = 1 - g, a segment of D samples maps
// m to a^D·m + b, and equal segments share a^D, so only the b's need a
// scan; and a segment ends on a tick, so the scan's values are the ticks.
//
// Design: one launch, a block a tile of nseg segments (nseg·D samples) of
// all G lanes, tiles in ticket order over the card:
//   1. the tile's pairs are read once, coalesced and kStage loads a
//      thread in flight, into shared memory (a segment's rows at an odd
//      stride, so the segments' threads hit distinct banks); with w, all
//      the block's threads mix each (sample, lane) pair once, into a
//      second such buffer (the powers a^(D·k) come from the host);
//   2. a thread a (lane, segment) forms the eight inputs once a sample and
//      runs the eight EWMAs of its segment from zero side by side: its b's;
//   3. a shuffle scan over the tile's segments (a^(D·d) the multiplier)
//      gives each segment's value from the tile's start; a tile with tiles
//      after it publishes its last segment's as its aggregate;
//   4. the look-back (csrc/lookback.cuh) gives the tile's start values:
//      a^(nseg·D·t)·m_0 plus each earlier tile's aggregate times
//      a^(nseg·D·distance), in tile order, whatever the card's timing;
//   5. each segment's end, a^(D·(k+1))·start + b, is its tick, and the last
//      tile's last is the carried envelope.
// nseg is the caller's (dsp_tpu_torch/ops/m4_engine.py env_partition, a
// power of two up to 32): small blocks spread over the card, large ones
// look back over few tiles, and a tile's pairs (and mixed pairs) fit
// shared memory beside the look-back's values.
//
// float32 (`dsp_m4_env_f32`; dsp_tpu's env_ewma_scan(..., df=True), whose
// input is the band-limit's or the bank's two-float32 output): the input is
// the float32 (hi, lo) pair of that output and the carried envelopes the
// (env_m, env_m_lo) pair. Each sample is hi + lo in float64, the mix, the
// envelope inputs and the EWMAs run in float64 as above, the ticks are
// written in float64 (control-rate scratch) and the carried envelopes
// stored split. The kernel is a template on the storage type.

#include <cuda_runtime.h>

#include <cmath>

#include "f32_pair.cuh"
#include "lookback.cuh"

namespace {

constexpr int kLook = 32;  // earlier tiles combined at a time
constexpr size_t kMaxShared = 232448;  // a block's shared memory on the H100

constexpr int kStage = 16;  // loads a thread has in flight while staging

// a^(D·(k+1)) for the tile's segments k < nseg <= 32, computed on the host
struct SegPowers {
    double p[32];
};

// the tile's pairs, and with the mix its mixed pairs beside them
__host__ __device__ inline size_t shared_doubles(int G, int D, int nseg, bool mix) {
    return (size_t)nseg * (2 * G * D + 1) * (mix ? 2 : 1) + (size_t)G * G +
           (size_t)kLook * (8 * G + 1) + 8 * G;
}

template <class T>
__global__ void m4_env_tiles(const T* __restrict__ ybp, const T* __restrict__ ybp_lo,
                             const double* __restrict__ w, const T* __restrict__ env_in,
                             const T* __restrict__ env_in_lo, T* __restrict__ env_out,
                             T* __restrict__ env_out_lo, double* __restrict__ env_ds, double g,
                             SegPowers pw, int B, int G, int NS, int D, int nseg, int ntiles,
                             lookback::Scratch lb) {
    extern __shared__ double smem[];
    __shared__ unsigned tk[2];
    const unsigned full = 0xffffffffu;
    const int W8 = 8 * G;  // the values a tile carries
    lookback::begin(lb, tk);
    // tile t of stream st: the tickets run tile-major, so every tile a
    // block waits on has a ticket before its own
    const int t = (int)(tk[0] / NS), st = (int)(tk[0] % NS);
    const unsigned tag = tk[1];
    const long long slot0 = (long long)st * ntiles;  // the stream's look-back slots
    {   // this stream's pairs, envelopes and ticks
        const size_t in = (size_t)st * B * G * 2, env = (size_t)st * G * 8;
        ybp += in;
        if (ybp_lo != nullptr) ybp_lo += in;
        env_in += env;
        env_out += env;
        if (env_in_lo != nullptr) {
            env_in_lo += env;
            env_out_lo += env;
        }
        env_ds += (size_t)st * (B / D) * G * 8;
    }
    const int TS = nseg * D;
    const int nsv = min(TS, B - t * TS) / D;  // segments in this tile
    const bool last = t == ntiles - 1;
    const int RS = 2 * G * D + 1;      // a segment's rows in shared memory
    double* raw = smem;                // [nseg·RS] the tile's pairs
    double* ws = raw + nseg * RS;      // [G·G] the mix
    double* lv = ws + G * G;           // [kLook·W8] earlier tiles' aggregates
    double* fac = lv + kLook * W8;     // [kLook] their factors
    double* start = fac + kLook;       // [W8] the tile's start values
    double* mixed = start + W8;        // [nseg·RS] the mixed pairs, with w
    const double a = 1.0 - g;

    // 1. the tile's pairs, coalesced, kStage loads a thread in flight
    const size_t base = (size_t)t * TS * G * 2;
    const int seg = D * G * 2;  // a segment's doubles
    const int count = nsv * seg;
    for (int q0 = threadIdx.x; q0 < count; q0 += kStage * blockDim.x) {
        double r[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
            const int q = q0 + u * blockDim.x;
            r[u] = q < count ? pair_load(ybp, ybp_lo, base + q) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
            const int q = q0 + u * blockDim.x;
            if (q < count) raw[q + q / seg] = r[u];  // a segment's rows RS = seg + 1 apart
        }
    }
    if (w != nullptr)
        for (int q = threadIdx.x; q < G * G; q += blockDim.x) ws[q] = w[q];
    __syncthreads();

    // the mix, once a sample and lane, over all the block's threads, lane
    // by lane so that a warp's chains are equally long: lane s's pair is
    // sum over j <= s of w[s, j]·pair_j, from j = 0 up
    const double* src = raw;
    if (w != nullptr) {
        const int rows = nsv * D;
        for (int q = threadIdx.x; q < rows * G; q += blockDim.x) {
            const int sl = q / rows, row = q - sl * rows;
            const double* in = raw + (row / D) * RS + (row % D) * 2 * G;
            const double* wr = ws + sl * G;
            double l = __dmul_rn(in[0], wr[0]), r = __dmul_rn(in[1], wr[0]);
            for (int j = 1; j <= sl; ++j) {
                l = __dadd_rn(l, __dmul_rn(in[2 * j], wr[j]));
                r = __dadd_rn(r, __dmul_rn(in[2 * j + 1], wr[j]));
            }
            double* out = mixed + (in - raw) + 2 * sl;
            out[0] = l;
            out[1] = r;
        }
        __syncthreads();
        src = mixed;
    }

    // 2. a thread's segment: the eight EWMAs from zero
    const int s = threadIdx.x / nseg, k = threadIdx.x - s * nseg;
    double b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = 0.0;
    if (s < G && k < nsv) {
        const double* sg = src + k * RS + 2 * s;
        for (int i = 0; i < D; ++i) {
            const double l = sg[i * 2 * G], r = sg[i * 2 * G + 1];
            const double sum = l + r, diff = l - r;
            const double in[8] = {fabs(l), fabs(r), fabs(sum), fabs(diff),
                                  l * l,   r * r,   sum * sum, diff * diff};
#pragma unroll
            for (int j = 0; j < 8; ++j) b[j] = a * b[j] + g * in[j];
        }
    }

    // 3. the scan over the tile's segments (nseg lanes of a warp a lane s)
    for (int d = 1; d < nseg; d <<= 1) {
        const double f = pw.p[d - 1];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const double o = __shfl_up_sync(full, b[j], d, nseg);
            if (k >= d) b[j] = fma(f, o, b[j]);
        }
    }
    if (!last) {
        if (s < G && k == nseg - 1)
            for (int j = 0; j < 8; ++j) lv[s * 8 + j] = b[j];
        lookback::publish(lb, slot0 + t, tag, lv, W8);
        __syncthreads();  // lv is the look-back's next
    }

    // 4. the look-back: start = a^(TS·t)·m0 + sum over j < t of
    // a^(TS·(t-1-j))·agg_j, in tile order; the first window's factors are
    // computed before the wait
    const double f0 = t == 0 ? 1.0 : pow(a, (double)TS * t);
    for (int i = threadIdx.x; i < min(kLook, t); i += blockDim.x)
        fac[i] = pow(a, (double)TS * (t - 1 - i));
    for (int e = threadIdx.x; e < W8; e += blockDim.x)
        start[e] = f0 * pair_load(env_in, env_in_lo, (size_t)e);
    for (int j = threadIdx.x; j < t; j += blockDim.x) lookback::wait(lb, slot0 + j, tag);
    __syncthreads();
    for (int j0 = 0; j0 < t; j0 += kLook) {
        const int cnt = min(kLook, t - j0);
        for (int q = threadIdx.x; q < cnt * W8; q += blockDim.x)
            lv[q] = __ldcg(lb.agg + (size_t)(slot0 + j0) * W8 + q);
        if (j0 > 0)
            for (int i = threadIdx.x; i < cnt; i += blockDim.x)
                fac[i] = pow(a, (double)TS * (t - 1 - j0 - i));
        __syncthreads();
        for (int e = threadIdx.x; e < W8; e += blockDim.x) {
            double acc = start[e];
            for (int i = 0; i < cnt; ++i) acc = fma(fac[i], lv[i * W8 + e], acc);
            start[e] = acc;
        }
        __syncthreads();
    }

    // 5. each segment's end is a tick
    if (s < G && k < nsv) {
        const double fk = pw.p[k];
        double* out = env_ds + ((size_t)(t * nseg + k) * G + s) * 8;
        double m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            m[j] = fma(fk, start[s * 8 + j], b[j]);
            out[j] = m[j];
        }
        if (last && k == nsv - 1)
            for (int j = 0; j < 8; ++j) pair_store(env_out, env_out_lo, (size_t)s * 8 + j, m[j]);
    }
    lookback::end(lb);
}

// The kernels launch has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long env_launches = 0;

template <class T>
int launch(const T* ybp, const T* ybp_lo, const double* w, const T* env_in, const T* env_in_lo,
           T* env_out, T* env_out_lo, double* env_ds, double g, int B, int G, int NS, int D,
           int nseg, unsigned* flags, long long flag_slots, double* agg, long long agg_doubles,
           void* stream) {
    if (B <= 0 || G <= 0 || NS <= 0 || D <= 0 || B % D || nseg <= 0 || nseg > 32 ||
        (nseg & (nseg - 1)) ||
        flags == nullptr || agg == nullptr)
        return (int)cudaErrorInvalidValue;
    const int used = ((G * nseg + 31) / 32) * 32;
    const int least = G == 1 ? 128 : 256;  // threads for the staging and the mix
    const int threads = used < least ? least : used;
    const int ntiles = (B + nseg * D - 1) / (nseg * D);
    const size_t smem = shared_doubles(G, D, nseg, w != nullptr) * sizeof(double);
    if (threads > 1024 || smem > kMaxShared || (long long)ntiles * NS > flag_slots ||
        (long long)ntiles * NS * 8 * G > agg_doubles)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            m4_env_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    SegPowers pw;
    for (int k = 0; k < nseg; ++k) pw.p[k] = std::pow(1.0 - g, (double)D * (k + 1));
    m4_env_tiles<T><<<ntiles * NS, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        ybp, ybp_lo, w, env_in, env_in_lo, env_out, env_out_lo, env_ds, g, pw, B, G, NS, D, nseg,
        ntiles, lookback::carve(flags, agg));
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++env_launches;
    return (int)err;
}

}  // namespace

// ybp [NS, B, G, 2], w [G, G] or null, env_in and env_out [NS, G, 8],
// env_ds [NS, B / D, G, 8]: NS streams of G lanes; tiles of nseg segments
// of D samples (the partition of one stream); flags (flag_slots
// slots after its head) and agg (agg_doubles long) the look-back scratch of
// csrc/lookback.cuh. Returns cudaGetLastError() after the launch (0 on
// success). The caller (dsp_tpu_torch/ops/m4_engine.py) checks shapes,
// dtypes and contiguity.
extern "C" int dsp_m4_env_f64(const double* ybp, const double* w, const double* env_in,
                              double* env_out, double* env_ds, double g, int B, int G, int NS,
                              int D, int nseg, unsigned* flags, long long flag_slots, double* agg,
                              long long agg_doubles, void* stream) {
    return launch<double>(ybp, nullptr, w, env_in, nullptr, env_out, nullptr, env_ds, g, B, G, NS,
                          D, nseg, flags, flag_slots, agg, agg_doubles, stream);
}

// The same from float32 pairs: the input (ybp, ybp_lo) [NS, B, G, 2] and
// the envelopes (env_in, env_in_lo) in and (env_out, env_out_lo) out,
// [NS, G, 8] each; env_ds float64.
extern "C" int dsp_m4_env_f32(const float* ybp, const float* ybp_lo, const double* w,
                              const float* env_in, const float* env_in_lo, float* env_out,
                              float* env_out_lo, double* env_ds, double g, int B, int G, int NS,
                              int D, int nseg, unsigned* flags, long long flag_slots, double* agg,
                              long long agg_doubles, void* stream) {
    return launch<float>(ybp, ybp_lo, w, env_in, env_in_lo, env_out, env_out_lo, env_ds, g, B, G,
                         NS, D, nseg, flags, flag_slots, agg, agg_doubles, stream);
}

extern "C" unsigned long long dsp_m4_env_launches() { return env_launches; }
