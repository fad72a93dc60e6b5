// K14: the randomly modulated delay line, float64 and float32, for Hopper
// (sm_90a).
//
// Replaces dsp_tpu/effects/delay.py:292 `_mod_noise_block` and :337
// `ModDelayEffect.step` (the -m/-M options of delay). Per block:
//   1. knots: key, sub = split(key); n_new = ceil(B·step) + 1 new knots per
//      lane, each Σ_j (u[i, j, 0] - u[i, j, 1])·0.77/6/0x7FFFFFFF over six
//      uniform pairs in [0, 0x7FFFFFFF] (counter ((i·6 + j)·2 + s)·lanes + l),
//      after the 4 carried ones; the next window starts at
//      floor(t0 + step·B), the next phase is its fraction.
//   2. read: sample n evaluates the cubic B-spline of knots
//      [k, k + 4) at k = floor(t0 + step·n), clamps to [0, 1], scales by the
//      depth, and reads the line [buf | x] that many samples back: cubic
//      Hermite (q0), or four polyphase FIR dot products (6 x 16 taps at q1,
//      16 x 32 at q2) joined by a cubic B-spline. -M reads one lane's
//      modulation for every channel.
//   3. the carried line: the last H rows of [buf | x], into a new tensor.
//
// What bounds it on the card: at B = 2048, C = 2, q2 reads 4 x 32 taps a
// sample from the line and does 256 multiply-adds; the knots are a few
// dozen threefry calls. Launch latency bounds it at this size.
// Design: one launch, a block a tile of 128 samples of every channel:
//   - the block draws only the knots its samples read, rows floor(t0 +
//     step·n0) .. floor(t0 + step·n1) + 3 (the last tile's also reach the
//     next window), into shared memory: a knot's twelve draws are fixed by
//     their counters, so any block can draw any knot. A thread draws one
//     pair's difference, a thread a knot sums its six in the order of the
//     plain version, so each knot has the same bits in every block;
//   - it stages the polyphase table and, where it fits, the line window
//     its reads reach, [H + n0 - depth - taps, H + n1) of [buf | x], in
//     shared memory (a long depth reads the line through L1 instead);
//   - a thread a (sample, channel) evaluates the modulation and the read,
//     each tap sum in the plain version's order;
//   - the blocks copy the carried line to a new tensor (every block still
//     reads the old one), and the last tile writes the carried key, knot
//     window and phase.
// Everything stays on the device: t0 is read there, not on the host.
// Rounding (float64): every operation is an intrinsic, so nvcc contracts
// nothing on its own. The FMAs are the ones dsp_tpu's XLA:CPU takes when
// the chain's scan runs the step (measured; PERF.md §6): each
// knot's six terms, the B-splines' c0 and two of their Horner steps, and
// the Hermite read's; the phase t0 + step·n rounds twice (the scan hoists
// step·n out of its loop). The plain version writes the same operations
// in the same order, and each polyphase filter's taps are summed from tap
// 0, one FMA a tap, in both (XLA:CPU reduces them in an order of its own).
//
// float32 (dsp_mod_delay_f32): the knots are jax's float32 draws; every
// value on the way to a read position (the knots' products and six-term
// sums, the phase t0 + float32(step·n) and its floor, the B-spline, z·depth,
// its integer part and, at q1/q2, the polyphase phase
// float32(d_frac·n_phases)) is a float32 operation rounded on its own, in
// dsp_tpu's order, as the plain version (ops/time_domain.py) rounds it, so
// the two take the same read positions. dsp_tpu float32's XLA:CPU contracts
// some of these into FMAs and sums the knots in an order of its own, which
// changes with the fusion around them: the knots and modulation differ from
// its in the last bits, the draws, keys and phases not. The read itself
// (Hermite or the four polyphase dot products and their B-spline) runs in
// float64 registers on the float32 line and table and rounds to float32
// once, when stored.
//
// The stream axis (batched processing): S independent streams in one
// launch, x and y [S, B, C], the key [S, 2], the knot window [S, 4, lanes],
// the phase [S], the line and the carried line [S, H, C] (sel and the
// table one for all; n_new and step_b the host's, the same for every
// stream, whose blocks are all B long). A stream is the grid's y index and
// runs the tiles of a one-stream launch on its own key, phase, knots and
// line, every operation in the same order: the same bits.

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "rn.cuh"
#include "threefry.cuh"

namespace {

constexpr int NOISE_N = 6;
constexpr double MOD_MAX = 2147483647.0;
constexpr int kTile = 128;     // samples a block
constexpr int kThreads = 256;
// a block stages its line window where it takes at most this many bytes
constexpr size_t kWindowBytes = 96 * 1024;
// a block's dynamic shared memory on the H100: 232,448 bytes less the
// static key words
constexpr size_t kMaxShared = 232448 - 64;

template <typename T>
__device__ __forceinline__ double line_at(const T* __restrict__ buf, const T* __restrict__ x,
                                          int H, int C, int k, int c) {
    return (double)(k < H ? buf[(size_t)k * C + c] : x[(size_t)(k - H) * C + c]);
}

// the cubic B-spline of z0..z3 at t (plus 0.5 for the modulator), with the
// FMAs dsp_tpu's XLA:CPU takes in the chain's scan (measured; PERF.md §6):
// c0 = fma(2/3, z1, a/6), then fma(c3, t, c2), a rounded product and sum,
// and fma(·, t, c0); every other operation rounded on its own
template <bool kHalf>
__device__ __forceinline__ double bspline(double z0, double z1, double z2, double z3, double t) {
    const double a = __dadd_rn(z0, z2);
    double c0 = __fma_rn(2.0 / 3.0, z1, __dmul_rn(1.0 / 6.0, a));
    if (kHalf) c0 = __dadd_rn(c0, 0.5);
    const double c1 = __dmul_rn(0.5, __dsub_rn(z2, z0));
    const double c2 = __dsub_rn(__dmul_rn(0.5, a), z1);
    const double c3 = __dadd_rn(__dmul_rn(0.5, __dsub_rn(z1, z2)),
                                __dmul_rn(1.0 / 6.0, __dsub_rn(z3, z0)));
    return __fma_rn(__dadd_rn(__dmul_rn(__fma_rn(c3, t, c2), t), c1), t, c0);
}

// the modulator's B-spline (offset 0.5) in float32, each product and sum
// rounded on its own, in dsp_tpu's order
__device__ __forceinline__ float bspline_mod_f32(float z0, float z1, float z2, float z3,
                                                 float t) {
    const float sixth = (float)(1.0 / 6.0), two3 = (float)(2.0 / 3.0);
    const float a = __fadd_rn(z0, z2);
    const float c0 = __fadd_rn(__fadd_rn(__fmul_rn(sixth, a), __fmul_rn(two3, z1)), 0.5f);
    const float c1 = __fmul_rn(0.5f, __fsub_rn(z2, z0));
    const float c2 = __fsub_rn(__fmul_rn(0.5f, a), z1);
    const float c3 = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(z1, z2)),
                               __fmul_rn(sixth, __fsub_rn(z3, z0)));
    return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(c3, t), c2), t), c1), t),
                     c0);
}

// the modulator's phase at sample n, the product and the sum each rounded
// (the chain's scan hoists step·n out of its loop: no FMA); float32 adds
// step·n, a float64 product (dsp_tpu's jnp.arange is int64), to the
// float32 phase
__device__ __forceinline__ double phase(double t0, double step, int n) {
    return __dadd_rn(t0, __dmul_rn(step, (double)n));
}
__device__ __forceinline__ float phase(float t0, double step, int n) {
    return __fadd_rn(t0, (float)(step * (double)n));
}

// the line a block reads: staged rows [lo, lo + rows) of [buf | x] in
// shared memory, or (win null) the tensors themselves
template <typename T>
struct Line {
    const T* buf;
    const T* x;
    const T* win;
    int H, C, lo;

    __device__ __forceinline__ double at(int k, int c) const {
        return win != nullptr ? (double)win[(size_t)(k - lo) * C + c] : line_at(buf, x, H, C, k, c);
    }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mod_delay_kernel(const uint32_t* __restrict__ key_in, uint32_t* __restrict__ key_out,
                 const T* __restrict__ y_in, T* __restrict__ y_out, const T* __restrict__ t_in,
                 T* __restrict__ t_out, const T* __restrict__ buf, const T* __restrict__ x,
                 T* __restrict__ out, T* __restrict__ line_out, const bool* __restrict__ sel,
                 const T* __restrict__ table, int H, int B, int C, int lanes, int n_new,
                 int n_phases, int taps, int reach, int rows_cap, int staged, double depth,
                 double step, double step_b) {
    constexpr bool f32 = std::is_same<T, float>::value;
    {   // the stream: the grid's y index
        const int s = blockIdx.y;
        key_in += 2 * s;
        key_out += 2 * s;
        y_in += (size_t)s * 4 * lanes;
        y_out += (size_t)s * 4 * lanes;
        t_in += s;
        t_out += s;
        buf += (size_t)s * H * C;
        line_out += (size_t)s * H * C;
        x += (size_t)s * B * C;
        out += (size_t)s * B * C;
    }
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* diffs = reinterpret_cast<T*>(smem_raw);    // [rows_cap][6][lanes]
    T* knots = diffs + (size_t)rows_cap * NOISE_N * lanes;  // [rows_cap][lanes]
    T* tab = knots + (size_t)rows_cap * lanes;    // [n_phases·taps]
    T* win = tab + (size_t)n_phases * taps;       // the staged line window
    __shared__ uint32_t k[2][2];
    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * kTile, n1 = min(n0 + kTile, B);  // this tile's samples
    const bool last = n1 == B;
    if (tid < 2) dsp_threefry::split(key_in, tid, k[tid]);
    // the knot rows this tile reads (the phase rises with n), and the last
    // tile's next window
    const T tin = *t_in;
    const int k_lo = (int)floor(phase(tin, step, n0));
    int k_hi = (int)floor(phase(tin, step, n1 - 1));
    // float32: (t0 + float32(step·B)) in float32, as dsp_tpu float32
    const T tb = add_rn(tin, (T)step_b);
    const int consumed = (int)floor(tb);
    if (last) k_hi = max(k_hi, consumed);
    const int rows = k_hi + 4 - k_lo;
    if (rows > rows_cap || k_hi + 4 > 4 + n_new) __trap();  // the host's bounds are wrong
    // the line window [lo, hi) of [buf | x] the tile's reads reach
    const int w_lo = max(H + n0 - reach, 0), w_hi = H + n1;
    for (int q = tid; q < n_phases * taps; q += kThreads) tab[q] = table[q];
    if (staged) {
        for (int q = tid; q < (w_hi - w_lo) * C; q += kThreads) {
            const int row = w_lo + q / C, c = q - (q / C) * C;
            win[q] = row < H ? buf[(size_t)row * C + c] : x[(size_t)(row - H) * C + c];
        }
    }
    __syncthreads();
    // each new knot's six differences, a thread a pair of draws
    const T scale = (T)(0.77 / NOISE_N / MOD_MAX);
    for (int q = tid; q < rows * NOISE_N * lanes; q += kThreads) {
        const int r = q / (NOISE_N * lanes), row = k_lo + r;
        if (row < 4) continue;
        const int j = (q / lanes) % NOISE_N, l = q % lanes;
        const unsigned long long base = ((unsigned long long)(row - 4) * NOISE_N + j) * 2;
        const T u0 = dsp_threefry::uniform(k[1][0], k[1][1], base * lanes + l, (T)MOD_MAX);
        const T u1 = dsp_threefry::uniform(k[1][0], k[1][1], (base + 1) * lanes + l, (T)MOD_MAX);
        diffs[q] = sub_rn(u0, u1);
    }
    __syncthreads();
    // a thread a knot: the carried window's rows, or the six-term sum from 0
    for (int q = tid; q < rows * lanes; q += kThreads) {
        const int r = q / lanes, row = k_lo + r, l = q - r * lanes;
        if (row < 4) {
            knots[q] = y_in[row * lanes + l];
            continue;
        }
        const T* d = diffs + (size_t)r * NOISE_N * lanes + l;
        T acc = 0;
        for (int j = 0; j < NOISE_N; ++j) {
            // float32 rounds each operation; float64 takes an FMA a term,
            // as dsp_tpu's XLA:CPU reduces the six
            acc = f32 ? add_rn(acc, mul_rn(d[j * lanes], scale)) : fma_rn(d[j * lanes], scale, acc);
        }
        knots[q] = acc;
    }
    __syncthreads();
    if (last) {
        if (tid < 2) key_out[tid] = k[0][tid];
        for (int q = tid; q < 4 * lanes; q += kThreads) y_out[q] = knots[(consumed - k_lo) * lanes + q];
        if (tid == 0) *t_out = sub_rn(tb, (T)consumed);
    }
    // the carried line, the last H rows of [buf | x], shared by the blocks
    for (long long q = (long long)blockIdx.x * kThreads + tid; q < (long long)H * C;
         q += (long long)gridDim.x * kThreads) {
        const int row = (int)(q / C) + B, c = (int)(q % C);
        line_out[q] = row < H ? buf[(size_t)row * C + c] : x[(size_t)(row - H) * C + c];
    }
    const Line<T> ln = {buf, x, staged ? win : nullptr, H, C, w_lo};
    for (int q = tid; q < (n1 - n0) * C; q += kThreads) {
        const int n = n0 + q / C, c = q % C;
        const size_t i = (size_t)n * C + c;
        if (!sel[c]) {
            out[i] = x[i];
            continue;
        }
        const int l = lanes == 1 ? 0 : c;
        // the read position: its integer part d_int and its fraction d_frac
        int d_int;
        double d_frac;
        float d_frac32 = 0.0f;
        if constexpr (f32) {
            const float tev = phase(tin, step, n);
            const float kf = floorf(tev);
            const float frac = __fsub_rn(tev, kf);
            const float* kn = knots + (size_t)((int)kf - k_lo) * lanes + l;
            float z = bspline_mod_f32(kn[0], kn[lanes], kn[2 * lanes], kn[3 * lanes], frac);
            z = fminf(fmaxf(z, 0.0f), 1.0f);
            const float mod = __fmul_rn(z, (float)depth);
            d_int = (int)mod;  // truncation, like (ssize_t) mod
            d_frac32 = __fsub_rn(mod, (float)d_int);  // exact
            d_frac = d_frac32;
        } else {
            const double tev = phase(tin, step, n);
            const double kf = floor(tev);
            const int kidx = (int)kf;
            const double frac = __dsub_rn(tev, kf);
            const double* kn = knots + (size_t)(kidx - k_lo) * lanes + l;
            double z = bspline<true>(kn[0], kn[lanes], kn[2 * lanes], kn[3 * lanes], frac);
            z = fmin(fmax(z, 0.0), 1.0);
            const double mod = __dmul_rn(z, depth);
            d_int = (int)mod;  // truncation, like (ssize_t) mod
            d_frac = __dsub_rn(mod, (double)d_int);
        }
        const int base = H + n - d_int;
        double y;
        if (table == nullptr) {
            // cubic Hermite on y[-3..0] at t = d_frac (delay.c:454-459)
            const double ym3 = ln.at(base - 3, c);
            const double ym2 = ln.at(base - 2, c);
            const double ym1 = ln.at(base - 1, c);
            const double y0 = ln.at(base, c);
            // with dsp_tpu's FMAs (measured), every other operation rounded
            const double h1 = __dmul_rn(0.5, __dsub_rn(ym2, y0));
            const double h2 = __dsub_rn(__dadd_rn(__fma_rn(-2.5, ym1, y0), __dmul_rn(2.0, ym2)),
                                        __dmul_rn(0.5, ym3));
            const double h3 = __dadd_rn(__dmul_rn(0.5, __dsub_rn(ym3, y0)),
                                        __dmul_rn(1.5, __dsub_rn(ym1, ym2)));
            y = __fma_rn(__dadd_rn(__dmul_rn(__fma_rn(h3, d_frac, h2), d_frac), h1), d_frac, ym1);
        } else {
            // the polyphase phase: in float32 for a float32 line (its integer
            // part picks the filters)
            double t_os;
            if constexpr (f32) {
                t_os = __fmul_rn(d_frac32, (float)n_phases);
            } else {
                t_os = __dmul_rn(d_frac, (double)n_phases);
            }
            const int ph0 = (int)t_os;
            double zs[4];
            for (int kk = 0; kk < 4; ++kk) {
                const int phi = ph0 + kk;
                const T* flt = tab + (size_t)(phi % n_phases) * taps;
                const int top = base - phi / n_phases;  // tap j reads the line at top - j
                double acc = 0.0;
                // in order from tap 0, one FMA a tap
                for (int j = 0; j < taps; ++j) acc = __fma_rn(ln.at(top - j, c), (double)flt[j], acc);
                zs[kk] = acc;
            }
            y = bspline<false>(zs[0], zs[1], zs[2], zs[3], __dsub_rn(t_os, (double)ph0));
        }
        out[i] = (T)y;
    }
}

// The kernels launch has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long mod_launches = 0;

template <typename T>
int launch_mod_delay(const uint32_t* key_in, uint32_t* key_out, const T* y_in, T* y_out,
                     const T* t_in, T* t_out, const T* buf, const T* x, T* out, T* line_out,
                     const bool* sel, const T* table, int H, int B, int C, int lanes, int n_new,
                     int n_phases, int taps, double depth, double step, double step_b, int S,
                     void* stream) {
    if (B <= 0 || C <= 0 || H <= 0 || lanes <= 0 || n_new <= 0 || step < 0 || depth < 0 ||
        S <= 0 || S > 65535 ||
        (table != nullptr && (n_phases <= 0 || taps <= 0)))
        return (int)cudaErrorInvalidValue;
    if (table == nullptr) n_phases = taps = 0;
    // a tile's knot rows: its phases span at most step·kTile + 1 rows, the
    // last tile's next window one more, each read 4 rows on
    const int rows_cap = (int)std::ceil(step * kTile) + 6;
    // the rows a read reaches below its sample: the depth (and one for a
    // float32 depth rounded up) and the taps (3 for the Hermite read)
    const int reach = (int)std::floor(depth) + 1 + (table == nullptr ? 3 : taps);
    const size_t fixed = ((size_t)rows_cap * (NOISE_N + 1) * lanes + (size_t)n_phases * taps) *
                         sizeof(T);
    const size_t window = (size_t)(kTile + reach) * C * sizeof(T);
    const int staged = window <= kWindowBytes && fixed + window <= kMaxShared;
    const size_t smem = fixed + (staged ? window : 0);
    if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
    static size_t sized = 48 * 1024;  // the function's attribute, raised as launches need
    if (smem > sized) {
        const cudaError_t err = cudaFuncSetAttribute(
            mod_delay_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        sized = smem;
    }
    mod_delay_kernel<T><<<dim3((B + kTile - 1) / kTile, S), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        key_in, key_out, y_in, y_out, t_in, t_out, buf, x, out, line_out, sel, table, H, B, C,
        lanes, n_new, n_phases, taps, reach, rows_cap, staged, depth, step, step_b);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++mod_launches;
    return (int)err;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). line_out: the
// carried line [H, C], a tensor other than buf; table: null for q0, else
// [n_phases, taps]; all of the sample type. step_b = step·B, as the host
// computes it. S streams: each tensor but sel and table led by S (the knot
// window [S, 4, lanes], the phase [S]). The caller
// (dsp_tpu_torch/ops/time_domain.py) checks shapes, dtypes, contiguity and
// that the read stays inside the line.
extern "C" int dsp_mod_delay_f64(const uint32_t* key_in, uint32_t* key_out, const double* y_in,
                                 double* y_out, const double* t_in, double* t_out,
                                 const double* buf, const double* x, double* out,
                                 double* line_out, const bool* sel, const double* table, int H,
                                 int B, int C, int lanes, int n_new, int n_phases, int taps,
                                 double depth, double step, double step_b, int S,
                                 void* stream) {
    return launch_mod_delay<double>(key_in, key_out, y_in, y_out, t_in, t_out, buf, x, out,
                                    line_out, sel, table, H, B, C, lanes, n_new, n_phases, taps,
                                    depth, step, step_b, S, stream);
}

extern "C" int dsp_mod_delay_f32(const uint32_t* key_in, uint32_t* key_out, const float* y_in,
                                 float* y_out, const float* t_in, float* t_out, const float* buf,
                                 const float* x, float* out, float* line_out, const bool* sel,
                                 const float* table, int H, int B, int C, int lanes, int n_new,
                                 int n_phases, int taps, double depth, double step,
                                 double step_b, int S, void* stream) {
    return launch_mod_delay<float>(key_in, key_out, y_in, y_out, t_in, t_out, buf, x, out,
                                   line_out, sel, table, H, B, C, lanes, n_new, n_phases, taps,
                                   depth, step, step_b, S, stream);
}

extern "C" unsigned long long dsp_mod_delay_launches() { return mod_launches; }
