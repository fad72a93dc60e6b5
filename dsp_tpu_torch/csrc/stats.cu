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
// multiply-adds and 4 fits a gated sample; plain mode's running min and max
// are scans. Latency bounds both, not the 32 KB they read at B = 2048.
// Design: one warp a channel. Plain mode splits the block into 32 segments:
// a warp scan of the segments' min and max gives each sample the running
// min and max the sequential rule compares it with (min and max are exact,
// so any grouping gives the same numbers), then one pass finds the peak and
// one counts the events equal to it. -i walks the block in order (its gate
// depends on every fit before it): the 64-slot buffer lives in the warp's
// registers, two slots a lane, so a gated sample's 64 FMAs run in parallel
// and the shift is two shuffles; the gate and the fits run on every lane.
//
// Rounding. dsp_tpu's XLA fuses three of the estimator's sums into FMAs
// (the buffer insert M + x·H, the direct taps M[k] + c_k·x, and the vertex
// yq = y - dy·p4) and rounds everything else on its own: the kernel writes
// exactly those as __fma_rn and the rest with __dmul_rn / __dadd_rn /
// __dsub_rn, so nvcc contracts nothing, every yq equals dsp_tpu's, and the
// peak count (an integer decided by exact equality) comes out the same.
//
// float32 (dsp_stats_f32): the same kernel with T = float. Every comparison
// and the -i estimator's arithmetic run in float32 with the same three FMAs,
// so the decisions, min, max, peak, counts, frames and the estimator's
// state equal dsp_tpu float32's. The sums and sums of squares are taken in
// float64 from the float32 samples and rounded to float32 once, when they
// are added to the carried sums (dsp_tpu float32 sums in float32, in
// XLA's order): the printed DC offset and RMS agree to their last digit
// or one unit in it.

#include <cuda_runtime.h>
#include <math_constants.h>

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
};

namespace {

constexpr int INTERP_DELAY = 18;

// jnp.minimum / jnp.maximum: -0.0 orders below +0.0
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
    return (a < b || (a == b && signbit(a))) ? a : b;
}
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
    return (a > b || (a == b && !signbit(a))) ? a : b;
}

// plain: one warp a channel, each lane a contiguous segment of the active
// samples. The running min and max a sample is compared with are the
// carried state's and every earlier sample's, so the lanes scan their
// segments' min and max (exact operations) before they look for events.
template <typename T>
__device__ void plain_channel(const StatsState<T>& in, const StatsState<T>& out,
                              const T* __restrict__ xs, int c, int n, int n_act,
                              long long s0) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int seg = (n_act + 31) / 32;
    const int t0 = min(n_act, lane * seg), t1 = min(n_act, t0 + seg);
    const T mn0 = in.mn[c], mx0 = in.mx[c], pk0 = in.peak[c];
    // 1. the segment's sums, min and max
    // the sums in float64 whatever T is
    double sum = 0.0, sq = 0.0;
    T smin = (T)CUDART_INF, smax = (T)-CUDART_INF;
    T mn = (T)CUDART_INF, mx = (T)-CUDART_INF;  // in jnp's order, -0.0 < +0.0
    for (int t = t0; t < t1; ++t) {
        const T v = xs[(size_t)t * n + c];
        sum = __dadd_rn(sum, (double)v);
        sq = __dadd_rn(sq, __dmul_rn((double)v, (double)v));
        smin = fmin_t(smin, v);
        smax = fmax_t(smax, v);
        mn = jmin(mn, v);
        mx = jmax(mx, v);
    }
    // 2. the min and max before the segment: the carried state's and the
    //    earlier lanes' (an exclusive scan)
    for (int d = 1; d < 32; d <<= 1) {
        const T omin = __shfl_up_sync(full, smin, d), omax = __shfl_up_sync(full, smax, d);
        if (lane >= d) {
            smin = fmin_t(omin, smin);
            smax = fmax_t(omax, smax);
        }
    }
    const T pmin = __shfl_up_sync(full, smin, 1), pmax = __shfl_up_sync(full, smax, 1);
    const T run_mn0 = lane == 0 ? mn0 : fmin_t(mn0, pmin);
    const T run_mx0 = lane == 0 ? mx0 : fmax_t(mx0, pmax);
    // 3. the events: a new min, or else a new max; the peak is their largest |x|
    T pk = 0, run_mn = run_mn0, run_mx = run_mx0;
    for (int t = t0; t < t1; ++t) {
        const T v = xs[(size_t)t * n + c];
        if (v <= run_mn || v >= run_mx) pk = fmax_t(pk, fabs_t(v));
        run_mn = fmin_t(run_mn, v);
        run_mx = fmax_t(run_mx, v);
    }
    for (int d = 16; d > 0; d >>= 1) pk = fmax_t(pk, __shfl_xor_sync(full, pk, d));
    const T peak = fmax_t(pk0, pk);
    // 4. the events equal to the block's peak: how many, and the first
    long long cnt = 0, first = 1LL << 62;
    run_mn = run_mn0;
    run_mx = run_mx0;
    for (int t = t0; t < t1; ++t) {
        const T v = xs[(size_t)t * n + c];
        const T a = fabs_t(v);
        if ((v <= run_mn || v >= run_mx) && a == peak && a > 0) {
            if (cnt == 0) first = s0 + t;
            ++cnt;
        }
        run_mn = fmin_t(run_mn, v);
        run_mx = fmax_t(run_mx, v);
    }
    for (int d = 16; d > 0; d >>= 1) {
        cnt += __shfl_xor_sync(full, cnt, d);
        first = min(first, __shfl_xor_sync(full, first, d));
        sum = __dadd_rn(sum, __shfl_xor_sync(full, sum, d));
        sq = __dadd_rn(sq, __shfl_xor_sync(full, sq, d));
        mn = jmin(mn, __shfl_xor_sync(full, mn, d));
        mx = jmax(mx, __shfl_xor_sync(full, mx, d));
    }
    if (lane != 0) return;
    const bool higher = peak > pk0;
    out.sum[c] = (T)__dadd_rn((double)in.sum[c], sum);
    out.sum_sq[c] = (T)__dadd_rn((double)in.sum_sq[c], sq);
    out.mn[c] = jmin(mn0, mn);
    out.mx[c] = jmax(mx0, mx);
    out.peak[c] = peak;
    out.peak_count[c] = higher ? cnt : in.peak_count[c] + cnt;
    out.peak_frame[c] = higher ? first : in.peak_frame[c];
}

// -i: one warp a channel. Lane l keeps slots l and l + 32 of the 64-slot
// buffer in registers; the shift by 4 is two warp shuffles, the insert two
// FMAs a lane, and every lane runs the (uniform) gate, fits and counts on
// its own copy of y, z and the scalars, so the warp never diverges. The
// input comes 32 samples at a time, one load a lane, then a shuffle.
template <typename T>
__device__ void interp_channel(const StatsState<T>& in, const StatsState<T>& out,
                               const T* __restrict__ xs, const T* __restrict__ hc,
                               int c, int n, int n_act, long long s0) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    T mA = in.m[lane * n + c], mB = in.m[(lane + 32) * n + c];
    const T hA = hc[lane], hB = hc[lane + 32];
    T y[6], z[9];
#pragma unroll
    for (int k = 0; k < 6; ++k) y[k] = in.y[k * n + c];
#pragma unroll
    for (int k = 0; k < 9; ++k) z[k] = in.z[k * n + c];
    const T c0 = hc[64], c1 = hc[65], c2 = hc[66];
    int nc = in.nctr[c];
    T tmin = in.tmin[c], tmax = in.tmax[c];
    T mn = in.mn[c], mx = in.mx[c], pk = in.peak[c];
    long long cnt = in.peak_count[c], frm = in.peak_frame[c];
    double sum = 0.0, sq = 0.0;
    for (int b0 = 0; b0 < n_act; b0 += 32) {
        const T mine = b0 + lane < n_act ? xs[(size_t)(b0 + lane) * n + c] : (T)0;
        const int m = n_act - b0 < 32 ? n_act - b0 : 32;
        for (int k = 0; k < m; ++k) {
            const T sv = __shfl_sync(full, mine, k);
            sum = __dadd_rn(sum, (double)sv);
            sq = __dadd_rn(sq, __dmul_rn((double)sv, (double)sv));
            if (sv < tmin || sv > tmax) nc = INTERP_DELAY;
            if (nc > 0) {
                const T x = z[0];
                const T m0 = __shfl_sync(full, mA, 0), m1 = __shfl_sync(full, mA, 1);
                const T m2 = __shfl_sync(full, mA, 2), m3 = __shfl_sync(full, mA, 3);
                // shift by 4: slot j takes slot j + 4; the last 4 take zero
                const T a4 = __shfl_down_sync(full, mA, 4);
                const T b4 = __shfl_sync(full, mB, (lane + 4) & 31);
                mA = fma_rn(x, hA, lane < 28 ? a4 : b4);
                mB = fma_rn(x, hB, lane < 28 ? b4 : (T)0);
                y[0] = y[4];
                y[1] = y[5];
                y[2] = fma_rn(c0, x, m0);
                y[3] = fma_rn(c1, x, m1);
                y[4] = fma_rn(c2, x, m2);
                y[5] = m3;
                int r = 0;
#pragma unroll
                for (int i = 1; i < 5; ++i) {
                    const T d0 = sub_rn(y[i], y[i - 1]);
                    const T d1 = sub_rn(y[i], y[i + 1]);
                    if ((d0 > 0 && d1 < 0) || (d0 < 0 && d1 > 0) || (d0 == 0 && d1 == 0))
                        continue;
                    const T dy = sub_rn(y[i - 1], y[i + 1]);
                    const T den = add_rn(sub_rn(y[i - 1], mul_rn((T)2, y[i])), y[i + 1]);
                    const T p4 = div_rn(dy, mul_rn((T)8, den == 0 ? (T)1 : den));
                    const T yq = fma_rn(-dy, p4, y[i]);
                    if (yq <= mn) {
                        mn = yq;
                        tmin = mul_rn((T)0.5, yq);
                    } else if (yq >= mx) {
                        mx = yq;
                        tmax = mul_rn((T)0.5, yq);
                    } else {
                        continue;
                    }
                    const T ayq = fabs_t(yq);
                    if (ayq > pk) {
                        pk = ayq;
                        r = 2;
                    } else if (ayq > 0 && ayq == pk) {
                        r = 1;
                    }
                }
                if (r == 2) {
                    frm = s0 + b0 + k - (INTERP_DELAY - 1);
                    cnt = 1;
                } else if (r == 1) {
                    ++cnt;
                }
                --nc;
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) z[q] = z[q + 1];
            z[8] = sv;
        }
    }
    out.m[lane * n + c] = mA;
    out.m[(lane + 32) * n + c] = mB;
    if (lane != 0) return;
#pragma unroll
    for (int k = 0; k < 6; ++k) out.y[k * n + c] = y[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) out.z[k * n + c] = z[k];
    out.nctr[c] = nc;
    out.tmin[c] = tmin;
    out.tmax[c] = tmax;
    out.sum[c] = (T)__dadd_rn((double)in.sum[c], sum);
    out.sum_sq[c] = (T)__dadd_rn((double)in.sum_sq[c], sq);
    out.mn[c] = mn;
    out.mx[c] = mx;
    out.peak[c] = pk;
    out.peak_count[c] = cnt;
    out.peak_frame[c] = frm;
}

template <typename T>
__global__ void stats_kernel(StatsState<T> in, StatsState<T> out,
                             const long long* __restrict__ limit, const T* __restrict__ xs,
                             const T* __restrict__ hc, int B, int n) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int c = blockIdx.x;  // a warp (a block of 32) a channel
    const long long s0 = *in.samples, lim = *limit;
    if (tid == 0) *out.samples = s0 + B < lim ? s0 + B : lim;
    if (c >= n) return;
    const long long left = lim - s0;
    const int n_act = left <= 0 ? 0 : (left < B ? (int)left : B);
    if (hc == nullptr) {
        plain_channel<T>(in, out, xs, c, n, n_act, s0);
    } else {
        interp_channel<T>(in, out, xs, hc, c, n, n_act, s0);
    }
}

template <typename T>
int launch_stats(const StatsState<T>* in, const StatsState<T>* out, const long long* limit,
                 const T* xs, const T* hc, int B, int n, void* stream) {
    if (B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
    // a warp (a block of 32) a channel; one block when no channel is selected
    stats_kernel<T><<<n > 0 ? n : 1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        *in, *out, limit, xs, hc, B, n);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). in and out
// point to host structs of device pointers (the -i fields null in plain
// mode), of the sample type; hc is null in plain mode, else [67]: the insert template H[64],
// then the direct taps r0..r2. The caller (dsp_tpu_torch/ops/time_domain.py)
// checks shapes, dtypes and contiguity.
extern "C" int dsp_stats_f64(const StatsState<double>* in, const StatsState<double>* out,
                             const long long* limit, const double* xs, const double* hc, int B,
                             int n, void* stream) {
    return launch_stats<double>(in, out, limit, xs, hc, B, n, stream);
}

extern "C" int dsp_stats_f32(const StatsState<float>* in, const StatsState<float>* out,
                             const long long* limit, const float* xs, const float* hc, int B,
                             int n, void* stream) {
    return launch_stats<float>(in, out, limit, xs, hc, B, n, stream);
}
