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
// What bounds it on the card: a dependent chain of B samples per channel
// (two multiply-adds and a max a sample), with 2 channels on the main path:
// latency, not the 32 KB it reads at B = 2048. Design: one warp a channel.
// Each lane composes its segment of B/32 samples into one map (a, b, c),
// a warp-shuffle scan gives each segment its start state, and each lane
// reruns its segment; the chain a lane walks is 2·B/32 + 5 steps long.
//
// float32 (dsp_levels_f32): samples and meters are read as float32 and
// stored as float32, and the scan runs in float64 registers with g
// unrounded, so each meter rounds once, where it is stored. dsp_tpu float32
// scans in float32; the two differ by float32 rounding, not by decisions
// (a meter decides nothing).

#include <cuda_runtime.h>
#include <math_constants.h>

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

template <typename T>
__global__ void levels_kernel(const T* __restrict__ avg_in, const T* __restrict__ peak_in,
                              const T* __restrict__ bp_in, T* __restrict__ avg_out,
                              T* __restrict__ peak_out, T* __restrict__ bp_out,
                              const T* __restrict__ xs, double g, int B, int n) {
    const unsigned full = 0xffffffffu;
    const int c = blockIdx.x, lane = threadIdx.x;
    const double a = 1.0 - g;
    const int seg = (B + 31) / 32;
    const int t0 = min(B, lane * seg), t1 = min(B, t0 + seg);
    // 1. this lane's segment as one map
    MaxAffine f = {1.0, 0.0, -CUDART_INF};
    for (int t = t0; t < t1; ++t) {
        const double v = (double)xs[(size_t)t * n + c];
        const double s = v * v;
        f = compose(f, {a, g * s, s});
    }
    // 2. exclusive scan of the lanes' maps
    for (int d = 1; d < 32; d <<= 1) {
        const MaxAffine o = {__shfl_up_sync(full, f.a, d), __shfl_up_sync(full, f.b, d),
                             __shfl_up_sync(full, f.c, d)};
        if (lane >= d) f = compose(o, f);
    }
    MaxAffine pre = {__shfl_up_sync(full, f.a, 1), __shfl_up_sync(full, f.b, 1),
                     __shfl_up_sync(full, f.c, 1)};
    if (lane == 0) pre = {1.0, 0.0, -CUDART_INF};
    // 3. rerun the segment from its start state; the block peak is the max
    //    of every m
    const double avg0 = (double)avg_in[c], m0 = (double)peak_in[c];
    double avg = fma(pre.a, avg0, pre.b);
    double m = fmax(pre.c, fma(pre.a, m0, pre.b));
    double bp = lane == 0 ? (double)bp_in[c] : 0.0;
    for (int t = t0; t < t1; ++t) {
        const double v = (double)xs[(size_t)t * n + c];
        const double s = v * v;
        const double gs = g * s;
        avg = fma(a, avg, gs);
        m = fmax(s, fma(a, m, gs));
        bp = fmax(bp, m);
    }
    for (int d = 16; d > 0; d >>= 1) bp = fmax(bp, __shfl_xor_sync(full, bp, d));
    // the last lane's segment ends at B (or is empty, past B): its state is
    // the channel's end state
    if (lane == 31) {
        avg_out[c] = (T)avg;
        peak_out[c] = (T)m;
    }
    if (lane == 0) bp_out[c] = (T)bp;
}

template <typename T>
int launch_levels(const T* avg_in, const T* peak_in, const T* bp_in, T* avg_out, T* peak_out,
                  T* bp_out, const T* xs, double g, int B, int n, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    levels_kernel<T><<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        avg_in, peak_in, bp_in, avg_out, peak_out, bp_out, xs, g, B, n);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// (dsp_tpu_torch/ops/time_domain.py) checks shapes, dtypes and contiguity.
extern "C" int dsp_levels_f64(const double* avg_in, const double* peak_in, const double* bp_in,
                              double* avg_out, double* peak_out, double* bp_out,
                              const double* xs, double g, int B, int n, void* stream) {
    return launch_levels<double>(avg_in, peak_in, bp_in, avg_out, peak_out, bp_out, xs, g, B, n,
                                 stream);
}

extern "C" int dsp_levels_f32(const float* avg_in, const float* peak_in, const float* bp_in,
                              float* avg_out, float* peak_out, float* bp_out, const float* xs,
                              double g, int B, int n, void* stream) {
    return launch_levels<float>(avg_in, peak_in, bp_in, avg_out, peak_out, bp_out, xs, g, B, n,
                                stream);
}
