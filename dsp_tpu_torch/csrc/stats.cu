// K16: the stats accumulators and the gated true-peak estimator, float64,
// for Hopper (sm_90a).
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

#include <cuda_runtime.h>
#include <math_constants.h>

// one stats state's device pointers, by value in the kernel's arguments;
// outside the anonymous namespace, so the extern "C" entry keeps external
// linkage
struct StatsState {
    double *sum, *sum_sq, *mn, *mx, *peak;
    long long *peak_count, *peak_frame, *samples;
    double *m, *y, *z;
    int* nctr;
    double *tmin, *tmax;
};

namespace {

constexpr int INTERP_DELAY = 18;

// jnp.minimum / jnp.maximum: -0.0 orders below +0.0
__device__ __forceinline__ double jmin(double a, double b) {
    return (a < b || (a == b && signbit(a))) ? a : b;
}
__device__ __forceinline__ double jmax(double a, double b) {
    return (a > b || (a == b && !signbit(a))) ? a : b;
}

// plain: one warp a channel, each lane a contiguous segment of the active
// samples. The running min and max a sample is compared with are the
// carried state's and every earlier sample's, so the lanes scan their
// segments' min and max (exact operations) before they look for events.
__device__ void plain_channel(const StatsState& in, const StatsState& out,
                              const double* __restrict__ xs, int c, int n, int n_act,
                              long long s0) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int seg = (n_act + 31) / 32;
    const int t0 = min(n_act, lane * seg), t1 = min(n_act, t0 + seg);
    const double mn0 = in.mn[c], mx0 = in.mx[c], pk0 = in.peak[c];
    // 1. the segment's sums, min and max
    double sum = 0.0, sq = 0.0, smin = CUDART_INF, smax = -CUDART_INF;
    double mn = CUDART_INF, mx = -CUDART_INF;  // in jnp's order, -0.0 < +0.0
    for (int t = t0; t < t1; ++t) {
        const double v = xs[(size_t)t * n + c];
        sum = __dadd_rn(sum, v);
        sq = __dadd_rn(sq, __dmul_rn(v, v));
        smin = fmin(smin, v);
        smax = fmax(smax, v);
        mn = jmin(mn, v);
        mx = jmax(mx, v);
    }
    // 2. the min and max before the segment: the carried state's and the
    //    earlier lanes' (an exclusive scan)
    for (int d = 1; d < 32; d <<= 1) {
        const double omin = __shfl_up_sync(full, smin, d), omax = __shfl_up_sync(full, smax, d);
        if (lane >= d) {
            smin = fmin(omin, smin);
            smax = fmax(omax, smax);
        }
    }
    double pmin = __shfl_up_sync(full, smin, 1), pmax = __shfl_up_sync(full, smax, 1);
    const double run_mn0 = lane == 0 ? mn0 : fmin(mn0, pmin);
    const double run_mx0 = lane == 0 ? mx0 : fmax(mx0, pmax);
    // 3. the events: a new min, or else a new max; the peak is their largest |x|
    double pk = 0.0, run_mn = run_mn0, run_mx = run_mx0;
    for (int t = t0; t < t1; ++t) {
        const double v = xs[(size_t)t * n + c];
        if (v <= run_mn || v >= run_mx) pk = fmax(pk, fabs(v));
        run_mn = fmin(run_mn, v);
        run_mx = fmax(run_mx, v);
    }
    for (int d = 16; d > 0; d >>= 1) pk = fmax(pk, __shfl_xor_sync(full, pk, d));
    const double peak = fmax(pk0, pk);
    // 4. the events equal to the block's peak: how many, and the first
    long long cnt = 0, first = 1LL << 62;
    run_mn = run_mn0;
    run_mx = run_mx0;
    for (int t = t0; t < t1; ++t) {
        const double v = xs[(size_t)t * n + c];
        const double a = fabs(v);
        if ((v <= run_mn || v >= run_mx) && a == peak && a > 0.0) {
            if (cnt == 0) first = s0 + t;
            ++cnt;
        }
        run_mn = fmin(run_mn, v);
        run_mx = fmax(run_mx, v);
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
    out.sum[c] = __dadd_rn(in.sum[c], sum);
    out.sum_sq[c] = __dadd_rn(in.sum_sq[c], sq);
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
__device__ void interp_channel(const StatsState& in, const StatsState& out,
                               const double* __restrict__ xs, const double* __restrict__ hc,
                               int c, int n, int n_act, long long s0) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    double mA = in.m[lane * n + c], mB = in.m[(lane + 32) * n + c];
    const double hA = hc[lane], hB = hc[lane + 32];
    double y[6], z[9];
#pragma unroll
    for (int k = 0; k < 6; ++k) y[k] = in.y[k * n + c];
#pragma unroll
    for (int k = 0; k < 9; ++k) z[k] = in.z[k * n + c];
    const double c0 = hc[64], c1 = hc[65], c2 = hc[66];
    int nc = in.nctr[c];
    double tmin = in.tmin[c], tmax = in.tmax[c];
    double mn = in.mn[c], mx = in.mx[c], pk = in.peak[c];
    long long cnt = in.peak_count[c], frm = in.peak_frame[c];
    double sum = 0.0, sq = 0.0;
    for (int b0 = 0; b0 < n_act; b0 += 32) {
        const double mine = b0 + lane < n_act ? xs[(size_t)(b0 + lane) * n + c] : 0.0;
        const int m = n_act - b0 < 32 ? n_act - b0 : 32;
        for (int k = 0; k < m; ++k) {
            const double sv = __shfl_sync(full, mine, k);
            sum = __dadd_rn(sum, sv);
            sq = __dadd_rn(sq, __dmul_rn(sv, sv));
            if (sv < tmin || sv > tmax) nc = INTERP_DELAY;
            if (nc > 0) {
                const double x = z[0];
                const double m0 = __shfl_sync(full, mA, 0), m1 = __shfl_sync(full, mA, 1);
                const double m2 = __shfl_sync(full, mA, 2), m3 = __shfl_sync(full, mA, 3);
                // shift by 4: slot j takes slot j + 4; the last 4 take zero
                const double a4 = __shfl_down_sync(full, mA, 4);
                const double b4 = __shfl_sync(full, mB, (lane + 4) & 31);
                mA = __fma_rn(x, hA, lane < 28 ? a4 : b4);
                mB = __fma_rn(x, hB, lane < 28 ? b4 : 0.0);
                y[0] = y[4];
                y[1] = y[5];
                y[2] = __fma_rn(c0, x, m0);
                y[3] = __fma_rn(c1, x, m1);
                y[4] = __fma_rn(c2, x, m2);
                y[5] = m3;
                int r = 0;
#pragma unroll
                for (int i = 1; i < 5; ++i) {
                    const double d0 = __dsub_rn(y[i], y[i - 1]);
                    const double d1 = __dsub_rn(y[i], y[i + 1]);
                    if ((d0 > 0.0 && d1 < 0.0) || (d0 < 0.0 && d1 > 0.0) ||
                        (d0 == 0.0 && d1 == 0.0))
                        continue;
                    const double dy = __dsub_rn(y[i - 1], y[i + 1]);
                    const double den =
                        __dadd_rn(__dsub_rn(y[i - 1], __dmul_rn(2.0, y[i])), y[i + 1]);
                    const double p4 = __ddiv_rn(dy, __dmul_rn(8.0, den == 0.0 ? 1.0 : den));
                    const double yq = __fma_rn(-dy, p4, y[i]);
                    if (yq <= mn) {
                        mn = yq;
                        tmin = __dmul_rn(0.5, yq);
                    } else if (yq >= mx) {
                        mx = yq;
                        tmax = __dmul_rn(0.5, yq);
                    } else {
                        continue;
                    }
                    const double ayq = fabs(yq);
                    if (ayq > pk) {
                        pk = ayq;
                        r = 2;
                    } else if (ayq > 0.0 && ayq == pk) {
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
    out.sum[c] = __dadd_rn(in.sum[c], sum);
    out.sum_sq[c] = __dadd_rn(in.sum_sq[c], sq);
    out.mn[c] = mn;
    out.mx[c] = mx;
    out.peak[c] = pk;
    out.peak_count[c] = cnt;
    out.peak_frame[c] = frm;
}

__global__ void stats_kernel(StatsState in, StatsState out, const long long* __restrict__ limit,
                             const double* __restrict__ xs, const double* __restrict__ hc, int B,
                             int n) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int c = blockIdx.x;  // a warp (a block of 32) a channel
    const long long s0 = *in.samples, lim = *limit;
    if (tid == 0) *out.samples = s0 + B < lim ? s0 + B : lim;
    if (c >= n) return;
    const long long left = lim - s0;
    const int n_act = left <= 0 ? 0 : (left < B ? (int)left : B);
    if (hc == nullptr) {
        plain_channel(in, out, xs, c, n, n_act, s0);
    } else {
        interp_channel(in, out, xs, hc, c, n, n_act, s0);
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). in and out
// point to host structs of device pointers (the -i fields null in plain
// mode); hc is null in plain mode, else [67]: the insert template H[64],
// then the direct taps r0..r2. The caller (dsp_tpu_torch/ops/time_domain.py)
// checks shapes, dtypes and contiguity.
extern "C" int dsp_stats_f64(const StatsState* in, const StatsState* out,
                             const long long* limit, const double* xs, const double* hc, int B,
                             int n, void* stream) {
    if (B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
    // a warp (a block of 32) a channel; one block when no channel is selected
    stats_kernel<<<n > 0 ? n : 1, 32, 0, static_cast<cudaStream_t>(stream)>>>(*in, *out, limit,
                                                                              xs, hc, B, n);
    return (int)cudaGetLastError();
}
