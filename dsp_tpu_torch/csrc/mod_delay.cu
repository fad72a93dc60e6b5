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
// The carried line (the last H rows of [buf | x]) is written by the splice
// kernel of fft_conv.cu, launched by the effect.
//
// What bounds it on the card: at B = 2048, C = 2, q2 reads 4 x 32 taps a
// sample from the line (1 MB of loads, mostly from L1: the taps of
// neighbouring samples overlap) and does 256 multiply-adds; the knots are
// a few dozen threefry calls. Launch latency bounds it at this size.
// Design: two launches. One block makes the knots into a scratch the
// wrapper allocates and writes the carried key, window and phase; then a
// grid of one thread per (n, c) evaluates the modulation and the read.
// Everything stays on the device: t0 is read there, not on the host.
// Modulated reads are held to the plain version within a tolerance (sums
// of taps in another order), not bit for bit.
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

#include <cuda_runtime.h>

#include <type_traits>

#include "rn.cuh"
#include "threefry.cuh"

namespace {

constexpr int NOISE_N = 6;
constexpr double MOD_MAX = 2147483647.0;

template <typename T>
__global__ void mod_knots_kernel(const uint32_t* __restrict__ key_in,
                                 uint32_t* __restrict__ key_out, const T* __restrict__ y_in,
                                 T* __restrict__ y_out, const T* __restrict__ t_in,
                                 T* __restrict__ t_out, T* __restrict__ knots, int n_new,
                                 int lanes, double step_b) {
    constexpr bool f32 = std::is_same<T, float>::value;
    __shared__ uint32_t k[2][2];
    const int tid = threadIdx.x;
    if (tid < 2) dsp_threefry::split(key_in, tid, k[tid]);
    __syncthreads();
    if (tid < 2) key_out[tid] = k[0][tid];
    const T scale = (T)(0.77 / NOISE_N / MOD_MAX);
    const int total = (4 + n_new) * lanes;
    for (int idx = tid; idx < total; idx += blockDim.x) {
        const int row = idx / lanes, l = idx % lanes;
        if (row < 4) {
            knots[idx] = y_in[idx];
            continue;
        }
        const unsigned long long i = row - 4;
        T acc = 0;
        for (int j = 0; j < NOISE_N; ++j) {
            const unsigned long long base = (i * NOISE_N + j) * 2;
            const T u0 = dsp_threefry::uniform(k[1][0], k[1][1], base * lanes + l, (T)MOD_MAX);
            const T u1 = dsp_threefry::uniform(k[1][0], k[1][1], (base + 1) * lanes + l,
                                               (T)MOD_MAX);
            if constexpr (f32) {
                acc = add_rn(acc, mul_rn(sub_rn(u0, u1), scale));
            } else {
                acc += (u0 - u1) * scale;
            }
        }
        knots[idx] = acc;
    }
    __syncthreads();
    // float32: (t0 + float32(step·B)) in float32, as dsp_tpu float32
    const T tb = f32 ? add_rn(*t_in, (T)step_b) : *t_in + (T)step_b;
    const int consumed = (int)floor(tb);
    for (int idx = tid; idx < 4 * lanes; idx += blockDim.x) y_out[idx] = knots[consumed * lanes + idx];
    if (tid == 0) *t_out = f32 ? sub_rn(tb, (T)consumed) : tb - (T)consumed;
}

template <typename T>
__device__ __forceinline__ double line_at(const T* __restrict__ buf, const T* __restrict__ x,
                                          int H, int C, int k, int c) {
    return (double)(k < H ? buf[(size_t)k * C + c] : x[(size_t)(k - H) * C + c]);
}

__device__ __forceinline__ double bspline(double z0, double z1, double z2, double z3, double t,
                                          double offset) {
    const double a = z0 + z2;
    const double c0 = (1.0 / 6.0) * a + (2.0 / 3.0) * z1 + offset;
    const double c1 = 0.5 * (z2 - z0);
    const double c2 = 0.5 * a - z1;
    const double c3 = 0.5 * (z1 - z2) + (1.0 / 6.0) * (z3 - z0);
    return ((c3 * t + c2) * t + c1) * t + c0;
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

template <typename T>
__global__ void mod_read_kernel(const T* __restrict__ knots, const T* __restrict__ t_in,
                                const T* __restrict__ buf, const T* __restrict__ x,
                                T* __restrict__ out, const bool* __restrict__ sel,
                                const T* __restrict__ table, int H, int B, int C, int lanes,
                                int n_phases, int taps, double depth, double step) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)B * C) return;
    const int n = (int)(i / C), c = (int)(i % C);
    if (!sel[c]) {
        out[i] = x[i];
        return;
    }
    const int l = lanes == 1 ? 0 : c;
    // the read position: its integer part d_int and its fraction d_frac
    int d_int;
    double d_frac;
    float d_frac32 = 0.0f;
    if constexpr (std::is_same<T, float>::value) {
        // step·n in float64 (dsp_tpu's jnp.arange is int64), rounded to
        // float32 where it meets the float32 phase
        const float tev = __fadd_rn(*t_in, (float)(step * (double)n));
        const float kf = floorf(tev);
        const float frac = __fsub_rn(tev, kf);
        const float* kn = knots + (size_t)(int)kf * lanes + l;
        float z = bspline_mod_f32(kn[0], kn[lanes], kn[2 * lanes], kn[3 * lanes], frac);
        z = fminf(fmaxf(z, 0.0f), 1.0f);
        const float mod = __fmul_rn(z, (float)depth);
        d_int = (int)mod;  // truncation, like (ssize_t) mod
        d_frac32 = __fsub_rn(mod, (float)d_int);  // exact
        d_frac = d_frac32;
    } else {
        const double tev = *t_in + step * n;
        const double kf = floor(tev);
        const int kidx = (int)kf;
        const double frac = tev - kf;
        const double* kn = knots + (size_t)kidx * lanes + l;
        double z = bspline(kn[0], kn[lanes], kn[2 * lanes], kn[3 * lanes], frac, 0.5);
        z = fmin(fmax(z, 0.0), 1.0);
        const double mod = z * depth;
        d_int = (int)mod;  // truncation, like (ssize_t) mod
        d_frac = mod - d_int;
    }
    const int base = H + n - d_int;
    double y;
    if (table == nullptr) {
        // cubic Hermite on y[-3..0] at t = d_frac (delay.c:454-459)
        const double ym3 = line_at(buf, x, H, C, base - 3, c);
        const double ym2 = line_at(buf, x, H, C, base - 2, c);
        const double ym1 = line_at(buf, x, H, C, base - 1, c);
        const double y0 = line_at(buf, x, H, C, base, c);
        const double h1 = 0.5 * (ym2 - y0);
        const double h2 = y0 - 2.5 * ym1 + 2.0 * ym2 - 0.5 * ym3;
        const double h3 = 0.5 * (ym3 - y0) + 1.5 * (ym1 - ym2);
        y = ((h3 * d_frac + h2) * d_frac + h1) * d_frac + ym1;
    } else {
        // the polyphase phase: in float32 for a float32 line (its integer
        // part picks the filters)
        double t_os;
        if constexpr (std::is_same<T, float>::value) {
            t_os = __fmul_rn(d_frac32, (float)n_phases);
        } else {
            t_os = d_frac * n_phases;
        }
        const int ph0 = (int)t_os;
        double zs[4];
        for (int k = 0; k < 4; ++k) {
            const int phi = ph0 + k;
            const T* flt = table + (size_t)(phi % n_phases) * taps;
            const int top = base - phi / n_phases;  // tap j reads the line at top - j
            double acc = 0.0;
            for (int j = 0; j < taps; ++j)
                acc += line_at(buf, x, H, C, top - j, c) * (double)flt[j];
            zs[k] = acc;
        }
        y = bspline(zs[0], zs[1], zs[2], zs[3], t_os - ph0, 0.0);
    }
    out[i] = (T)y;
}

template <typename T>
int launch_mod_delay(const uint32_t* key_in, uint32_t* key_out, const T* y_in, T* y_out,
                     const T* t_in, T* t_out, T* knots, const T* buf, const T* x, T* out,
                     const bool* sel, const T* table, int H, int B, int C, int lanes, int n_new,
                     int n_phases, int taps, double depth, double step, double step_b,
                     void* stream) {
    if (B <= 0 || C <= 0 || lanes <= 0 || n_new <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    mod_knots_kernel<T><<<1, 256, 0, s>>>(key_in, key_out, y_in, y_out, t_in, t_out, knots,
                                          n_new, lanes, step_b);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long N = (long long)B * C;
    const int T_ = 256;
    mod_read_kernel<T><<<(int)((N + T_ - 1) / T_), T_, 0, s>>>(
        knots, t_in, buf, x, out, sel, table, H, B, C, lanes, n_phases, taps, depth, step);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns the first cudaGetLastError() after the two launches (0 on
// success). knots: scratch [4 + n_new, lanes]; table: null for q0, else
// [n_phases, taps]; all of the sample type. step_b = step·B, as the host
// computes it. The caller (dsp_tpu_torch/ops/time_domain.py) checks shapes,
// dtypes, contiguity and that the read stays inside the line.
extern "C" int dsp_mod_delay_f64(const uint32_t* key_in, uint32_t* key_out, const double* y_in,
                                 double* y_out, const double* t_in, double* t_out,
                                 double* knots, const double* buf, const double* x, double* out,
                                 const bool* sel, const double* table, int H, int B, int C,
                                 int lanes, int n_new, int n_phases, int taps, double depth,
                                 double step, double step_b, void* stream) {
    return launch_mod_delay<double>(key_in, key_out, y_in, y_out, t_in, t_out, knots, buf, x,
                                    out, sel, table, H, B, C, lanes, n_new, n_phases, taps,
                                    depth, step, step_b, stream);
}

extern "C" int dsp_mod_delay_f32(const uint32_t* key_in, uint32_t* key_out, const float* y_in,
                                 float* y_out, const float* t_in, float* t_out, float* knots,
                                 const float* buf, const float* x, float* out, const bool* sel,
                                 const float* table, int H, int B, int C, int lanes, int n_new,
                                 int n_phases, int taps, double depth, double step,
                                 double step_b, void* stream) {
    return launch_mod_delay<float>(key_in, key_out, y_in, y_out, t_in, t_out, knots, buf, x,
                                   out, sel, table, H, B, C, lanes, n_new, n_phases, taps,
                                   depth, step, step_b, stream);
}
