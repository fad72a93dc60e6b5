// K2: per-sample biquad scan over lanes, float64, for Hopper (sm_90a).
//
// Replaces dsp_tpu/ops/iir.py:77 `_biquad_scan_impl` (entered through
// `biquad_scan`, iir.py:61). For each lane c, with any 2x2 A (the coupled
// form from BiquadEffect or the companion form from crossfeed; the kernel
// assumes neither):
//   y[t] = c0·x[t] + s[t-1][0],   s[t] = A·s[t-1] + Bv·x[t]
// The TPU version ran a log-depth associative scan of the affine maps
// (A, Bv·x[t]) over all B samples at once.
//
// What bounds it on the card: the recurrence is serial per lane, and the
// main path has few lanes (crossfeed: 4). At B = 65536 a lane is 512 KB of
// input, so the work is latency-bound, not bandwidth- or FLOP-bound.
//
// Design: one block per lane, T threads (T a multiple of 32, at most 1024),
// each thread owning a contiguous segment of about B/T samples.
//   1. Each thread composes its segment's affine map (M = A^len, v).
//   2. A block-wide exclusive scan of the maps: warp shuffles inside each
//      warp, then one thread scans the per-warp totals in shared memory.
//      That gives each segment its start state from the incoming state.
//   3. Each thread reruns its segment from its start state and writes y.
// x and y are [B, C] row-major and are accessed strided by C; the last
// thread writes the end state [C, 2].

#include <cuda_runtime.h>

namespace {

struct Affine {
    double m00, m01, m10, m11, v0, v1;
};

__device__ __forceinline__ Affine identity() { return {1.0, 0.0, 0.0, 1.0, 0.0, 0.0}; }

// `second` after `first`: x -> M2 (M1 x + v1) + v2
__device__ __forceinline__ Affine compose(const Affine& first, const Affine& second) {
    Affine r;
    r.m00 = second.m00 * first.m00 + second.m01 * first.m10;
    r.m01 = second.m00 * first.m01 + second.m01 * first.m11;
    r.m10 = second.m10 * first.m00 + second.m11 * first.m10;
    r.m11 = second.m10 * first.m01 + second.m11 * first.m11;
    r.v0 = second.m00 * first.v0 + second.m01 * first.v1 + second.v0;
    r.v1 = second.m10 * first.v0 + second.m11 * first.v1 + second.v1;
    return r;
}

__device__ __forceinline__ Affine shfl_up(const Affine& a, int d) {
    const unsigned full = 0xffffffffu;
    return {__shfl_up_sync(full, a.m00, d), __shfl_up_sync(full, a.m01, d),
            __shfl_up_sync(full, a.m10, d), __shfl_up_sync(full, a.m11, d),
            __shfl_up_sync(full, a.v0, d),  __shfl_up_sync(full, a.v1, d)};
}

__global__ void biquad_scan_kernel(const double* __restrict__ A, const double* __restrict__ Bv,
                                   const double* __restrict__ c0,
                                   const double* __restrict__ state_in,
                                   double* __restrict__ state_out, const double* __restrict__ x,
                                   double* __restrict__ y, int B, int C) {
    __shared__ Affine warp_prefix[32];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = T >> 5;
    const double a00 = A[c * 4 + 0], a01 = A[c * 4 + 1];
    const double a10 = A[c * 4 + 2], a11 = A[c * 4 + 3];
    const double b0 = Bv[c * 2 + 0], b1 = Bv[c * 2 + 1];
    const double g = c0[c];
    const int seg = (B + T - 1) / T;
    const int t0 = min(B, tid * seg);
    const int t1 = min(B, t0 + seg);

    // 1. this segment's map
    Affine f = identity();
    for (int t = t0; t < t1; ++t) {
        const double xt = x[(size_t)t * C + c];
        const double v0 = a00 * f.v0 + a01 * f.v1 + b0 * xt;
        const double v1 = a10 * f.v0 + a11 * f.v1 + b1 * xt;
        const double m00 = a00 * f.m00 + a01 * f.m10;
        const double m01 = a00 * f.m01 + a01 * f.m11;
        const double m10 = a10 * f.m00 + a11 * f.m10;
        const double m11 = a10 * f.m01 + a11 * f.m11;
        f = {m00, m01, m10, m11, v0, v1};
    }

    // 2. exclusive scan over the block's segments
    for (int d = 1; d < 32; d <<= 1) {
        const Affine o = shfl_up(f, d);
        if (lane >= d) f = compose(o, f);
    }
    if (lane == 31) warp_prefix[warp] = f;
    Affine excl = shfl_up(f, 1);
    if (lane == 0) excl = identity();
    __syncthreads();
    if (tid == 0) {
        Affine run = identity();
        for (int w = 0; w < nwarps; ++w) {
            const Affine total = warp_prefix[w];
            warp_prefix[w] = run;
            run = compose(run, total);
        }
    }
    __syncthreads();
    const Affine pre = compose(warp_prefix[warp], excl);

    // 3. rerun the segment from its start state
    const double si0 = state_in[c * 2 + 0], si1 = state_in[c * 2 + 1];
    double u0 = pre.m00 * si0 + pre.m01 * si1 + pre.v0;
    double u1 = pre.m10 * si0 + pre.m11 * si1 + pre.v1;
    for (int t = t0; t < t1; ++t) {
        const double xt = x[(size_t)t * C + c];
        y[(size_t)t * C + c] = g * xt + u0;
        const double n0 = a00 * u0 + a01 * u1 + b0 * xt;
        const double n1 = a10 * u0 + a11 * u1 + b1 * xt;
        u0 = n0;
        u1 = n1;
    }
    // the last thread's segment ends at B (or is empty, past B): its state
    // is the lane's end state
    if (tid == T - 1) {
        state_out[c * 2 + 0] = u0;
        state_out[c * 2 + 1] = u1;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks shapes, dtypes and contiguity.
extern "C" int dsp_biquad_scan_f64(const double* A, const double* Bv, const double* c0,
                                   const double* state_in, double* state_out, const double* x,
                                   double* y, int B, int C, void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    // about 16 samples a thread, 32..1024 threads a lane
    int T = ((B + 15) / 16 + 31) / 32 * 32;
    T = T < 32 ? 32 : (T > 1024 ? 1024 : T);
    biquad_scan_kernel<<<C, T, 0, static_cast<cudaStream_t>(stream)>>>(A, Bv, c0, state_in,
                                                                        state_out, x, y, B, C);
    return (int)cudaGetLastError();
}
