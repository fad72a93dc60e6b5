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
// each of its 13 bands: the input is S lanes of pairs [B, S, 2] (S = 1 for
// matrix4), a block of the grid a lane, and with freq_mask the lanes are
// first mixed by the lower-triangular weights w [S, S] (lane k's pair is
// sum over j <= k of w[k, j]·pair_j, summed from j = 0 up with each product
// rounded, as the plain version sums it). The outputs are [S, 8] and
// [B/D, S, 8].
//
// What bounds it on the card: each envelope is a dependent chain of B
// samples (two operations a sample) and reads 16·B bytes: latency. Design:
// one block of eight warps, a warp an envelope. Each lane composes its
// segment of B/32 samples into one map (A, b), a shuffle scan gives each
// segment its start value, and each lane reruns its segment, writing the
// ticks that fall in it. The chain a lane walks is 2·B/32 + 5 steps long.
//
// float32 (`dsp_m4_env_f32`; dsp_tpu's env_ewma_scan(..., df=True), whose
// input is the band-limit's or the bank's two-float32 output): the input is
// the float32 (hi, lo) pair of that output and the carried envelopes the
// (env_m, env_m_lo) pair. Each sample is hi + lo in float64, the mix, the
// envelope inputs and the EWMAs run in float64 as above, the ticks are
// written in float64 (control-rate scratch) and the carried envelopes
// stored split. The kernel is a template on the storage type.

#include <cuda_runtime.h>

#include "f32_pair.cuh"

namespace {

__device__ __forceinline__ double env_input(int j, double l, double r) {
    switch (j) {
        case 0: return fabs(l);
        case 1: return fabs(r);
        case 2: return fabs(l + r);
        case 3: return fabs(l - r);
        case 4: return l * l;
        case 5: return r * r;
        case 6: { const double s = l + r; return s * s; }
        default: { const double d = l - r; return d * d; }
    }
}

// lane s's pair at sample t (hi + lo), mixed by w when given
template <class T>
__device__ __forceinline__ void lane_pair(const T* __restrict__ ybp, const T* __restrict__ ybp_lo,
                                          const double* __restrict__ w, int S, int s, int t,
                                          double& l, double& r) {
    const size_t row = (size_t)t * S * 2;
    if (w == nullptr) {
        l = pair_load(ybp, ybp_lo, row + 2 * s);
        r = pair_load(ybp, ybp_lo, row + 2 * s + 1);
        return;
    }
    const double* ws = w + (size_t)s * S;
    l = __dmul_rn(pair_load(ybp, ybp_lo, row), ws[0]);
    r = __dmul_rn(pair_load(ybp, ybp_lo, row + 1), ws[0]);
    for (int j = 1; j <= s; ++j) {
        l = __dadd_rn(l, __dmul_rn(pair_load(ybp, ybp_lo, row + 2 * j), ws[j]));
        r = __dadd_rn(r, __dmul_rn(pair_load(ybp, ybp_lo, row + 2 * j + 1), ws[j]));
    }
}

template <class T>
__global__ void m4_env_kernel(const T* __restrict__ ybp, const T* __restrict__ ybp_lo,
                              const double* __restrict__ w, const T* __restrict__ env_in,
                              const T* __restrict__ env_in_lo, T* __restrict__ env_out,
                              T* __restrict__ env_out_lo, double* __restrict__ env_ds, double g,
                              int B, int S, int D) {
    const unsigned full = 0xffffffffu;
    const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s = blockIdx.x;
    const double a = 1.0 - g;
    const int seg = B / 32;  // B % 32 == 0 (the host checks)
    const int t0 = lane * seg, t1 = t0 + seg;
    // 1. this lane's segment as one map m -> A·m + b
    double A = 1.0, b = 0.0;
    for (int t = t0; t < t1; ++t) {
        double l, r;
        lane_pair(ybp, ybp_lo, w, S, s, t, l, r);
        const double in = env_input(j, l, r);
        A = a * A;
        b = a * b + g * in;
    }
    // 2. inclusive scan of the lanes' maps, then shift to exclusive
    for (int d = 1; d < 32; d <<= 1) {
        const double Ao = __shfl_up_sync(full, A, d), bo = __shfl_up_sync(full, b, d);
        if (lane >= d) {
            b = A * bo + b;
            A = A * Ao;
        }
    }
    double Ap = __shfl_up_sync(full, A, 1), bp = __shfl_up_sync(full, b, 1);
    if (lane == 0) {
        Ap = 1.0;
        bp = 0.0;
    }
    // 3. rerun the segment from its start value; write the ticks in it
    double m = Ap * pair_load(env_in, env_in_lo, (size_t)s * 8 + j) + bp;
    for (int t = t0; t < t1; ++t) {
        double l, r;
        lane_pair(ybp, ybp_lo, w, S, s, t, l, r);
        m = a * m + g * env_input(j, l, r);
        if ((t + 1) % D == 0) env_ds[((size_t)((t + 1) / D - 1) * S + s) * 8 + j] = m;
    }
    if (lane == 31) pair_store(env_out, env_out_lo, (size_t)s * 8 + j, m);
}

template <class T>
int launch(const T* ybp, const T* ybp_lo, const double* w, const T* env_in, const T* env_in_lo,
           T* env_out, T* env_out_lo, double* env_ds, double g, int B, int S, int D,
           void* stream) {
    if (B <= 0 || B % 32 || S <= 0 || D <= 0 || B % D) return (int)cudaErrorInvalidValue;
    m4_env_kernel<T><<<S, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        ybp, ybp_lo, w, env_in, env_in_lo, env_out, env_out_lo, env_ds, g, B, S, D);
    return (int)cudaGetLastError();
}

}  // namespace

// ybp [B, S, 2], w [S, S] or null, env_in and env_out [S, 8], env_ds
// [B / D, S, 8]. Returns cudaGetLastError() after the launch (0 on
// success). The caller (dsp_tpu_torch/ops/m4_engine.py) checks shapes,
// dtypes and contiguity.
extern "C" int dsp_m4_env_f64(const double* ybp, const double* w, const double* env_in,
                              double* env_out, double* env_ds, double g, int B, int S, int D,
                              void* stream) {
    return launch<double>(ybp, nullptr, w, env_in, nullptr, env_out, nullptr, env_ds, g, B, S, D,
                          stream);
}

// The same from float32 pairs: the input (ybp, ybp_lo) [B, S, 2] and the
// envelopes (env_in, env_in_lo) in and (env_out, env_out_lo) out, [S, 8]
// each; env_ds float64.
extern "C" int dsp_m4_env_f32(const float* ybp, const float* ybp_lo, const double* w,
                              const float* env_in, const float* env_in_lo, float* env_out,
                              float* env_out_lo, double* env_ds, double g, int B, int S, int D,
                              void* stream) {
    return launch<float>(ybp, ybp_lo, w, env_in, env_in_lo, env_out, env_out_lo, env_ds, g, B, S,
                         D, stream);
}
