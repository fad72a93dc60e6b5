// K2 and K3: per-sample biquad scan over lanes, for Hopper (sm_90a).
//
// K2 replaces dsp_tpu/ops/iir.py:77 `_biquad_scan_impl` (entered through
// `biquad_scan`, iir.py:61), in float64 (dsp_biquad_scan_f64) and in
// float32 (dsp_biquad_scan_f32: samples, coefficients, state and every
// product and sum in float32, as the TPU runs it under dsp_tpu's float32
// for crossfeed, crossfeed.py:42-48, and the Thiran delay, delay.py:172).
// K3 replaces iir.py:89 `biquad_scan_df` (dsp_biquad_scan_df): float32
// samples and a [2, C, 2] float32 (hi, lo) state, with float64
// coefficients; dsp_biquad_scan_df1 takes a single [C, 2] float32 state,
// as `biquad_scan_auto` (iir.py:129) hands it in and out. dsp_tpu composes
// its affine maps in two-float32 arithmetic there, because the TPU has no
// usable float64 and a plain float32 scan of a near-DC pole loses ~60 dB;
// here the same kernel runs with float64 registers, reads x and the state
// (hi + lo) into float64, and stores y rounded once and the end state
// split hi = (float)s, lo = (float)(s - hi), or, single, rounded once
// (dsp_tpu's float32 hi + lo is that hi).
// For each lane c, with any 2x2 A (the coupled
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
// thread writes the end state [C, 2] (K3: [2, C, 2]).
//
// The three forms are one template: T the sample type, R the type of the
// coefficients and of every product and sum, kPair the (hi, lo) state. In
// float32 every product and sum rounds on its own (__fmul_rn, __fadd_rn:
// nvcc contracts none into an FMA), in the order the plain version
// (ops/iir.py biquad_scan_f32_ref) takes, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return a * b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }

// a·b + c·d and a·b + c·d + e, left to right
template <typename R>
__device__ __forceinline__ R dot2(R a, R b, R c, R d) {
    return add(mul(a, b), mul(c, d));
}
template <typename R>
__device__ __forceinline__ R dot2(R a, R b, R c, R d, R e) {
    return add(dot2(a, b, c, d), e);
}

template <typename R>
struct Affine {
    R m00, m01, m10, m11, v0, v1;
};

template <typename R>
__device__ __forceinline__ Affine<R> identity() {
    return {R(1), R(0), R(0), R(1), R(0), R(0)};
}

// `second` after `first`: x -> M2 (M1 x + v1) + v2
template <typename R>
__device__ __forceinline__ Affine<R> compose(const Affine<R>& first, const Affine<R>& second) {
    Affine<R> r;
    r.m00 = dot2(second.m00, first.m00, second.m01, first.m10);
    r.m01 = dot2(second.m00, first.m01, second.m01, first.m11);
    r.m10 = dot2(second.m10, first.m00, second.m11, first.m10);
    r.m11 = dot2(second.m10, first.m01, second.m11, first.m11);
    r.v0 = dot2(second.m00, first.v0, second.m01, first.v1, second.v0);
    r.v1 = dot2(second.m10, first.v0, second.m11, first.v1, second.v1);
    return r;
}

template <typename R>
__device__ __forceinline__ Affine<R> shfl_up(const Affine<R>& a, int d) {
    const unsigned full = 0xffffffffu;
    return {__shfl_up_sync(full, a.m00, d), __shfl_up_sync(full, a.m01, d),
            __shfl_up_sync(full, a.m10, d), __shfl_up_sync(full, a.m11, d),
            __shfl_up_sync(full, a.v0, d),  __shfl_up_sync(full, a.v1, d)};
}

// the lane's incoming state: [C, 2] of T, or (kPair) the sum of the
// [2, C, 2] pair's hi and lo
template <typename T, typename R, bool kPair>
__device__ __forceinline__ R load_state(const T* st, int c, int C, int k) {
    if (kPair) return (R)st[c * 2 + k] + (R)st[(C + c) * 2 + k];
    return (R)st[c * 2 + k];
}

template <typename T, typename R, bool kPair>
__device__ __forceinline__ void store_state(T* st, int c, int C, int k, R s) {
    const T h = (T)s;
    st[c * 2 + k] = h;
    if (kPair) st[(C + c) * 2 + k] = (T)(s - (R)h);  // R = double here
}

template <typename T, typename R, bool kPair>
__global__ void biquad_scan_kernel(const R* __restrict__ A, const R* __restrict__ Bv,
                                   const R* __restrict__ c0, const T* __restrict__ state_in,
                                   T* __restrict__ state_out, const T* __restrict__ x,
                                   T* __restrict__ y, int B, int C) {
    __shared__ Affine<R> warp_prefix[32];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int T_ = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = T_ >> 5;
    const R a00 = A[c * 4 + 0], a01 = A[c * 4 + 1];
    const R a10 = A[c * 4 + 2], a11 = A[c * 4 + 3];
    const R b0 = Bv[c * 2 + 0], b1 = Bv[c * 2 + 1];
    const R g = c0[c];
    const int seg = (B + T_ - 1) / T_;
    const int t0 = min(B, tid * seg);
    const int t1 = min(B, t0 + seg);

    // 1. this segment's map
    Affine<R> f = identity<R>();
    for (int t = t0; t < t1; ++t) {
        const R xt = (R)x[(size_t)t * C + c];
        const R v0 = add(dot2(a00, f.v0, a01, f.v1), mul(b0, xt));
        const R v1 = add(dot2(a10, f.v0, a11, f.v1), mul(b1, xt));
        f = {dot2(a00, f.m00, a01, f.m10), dot2(a00, f.m01, a01, f.m11),
             dot2(a10, f.m00, a11, f.m10), dot2(a10, f.m01, a11, f.m11), v0, v1};
    }

    // 2. exclusive scan over the block's segments
    for (int d = 1; d < 32; d <<= 1) {
        const Affine<R> o = shfl_up(f, d);
        if (lane >= d) f = compose(o, f);
    }
    if (lane == 31) warp_prefix[warp] = f;
    Affine<R> excl = shfl_up(f, 1);
    if (lane == 0) excl = identity<R>();
    __syncthreads();
    if (tid == 0) {
        Affine<R> run = identity<R>();
        for (int w = 0; w < nwarps; ++w) {
            const Affine<R> total = warp_prefix[w];
            warp_prefix[w] = run;
            run = compose(run, total);
        }
    }
    __syncthreads();
    const Affine<R> pre = compose(warp_prefix[warp], excl);

    // 3. rerun the segment from its start state
    const R si0 = load_state<T, R, kPair>(state_in, c, C, 0);
    const R si1 = load_state<T, R, kPair>(state_in, c, C, 1);
    R u0 = dot2(pre.m00, si0, pre.m01, si1, pre.v0);
    R u1 = dot2(pre.m10, si0, pre.m11, si1, pre.v1);
    for (int t = t0; t < t1; ++t) {
        const R xt = (R)x[(size_t)t * C + c];
        y[(size_t)t * C + c] = (T)add(mul(g, xt), u0);
        const R n0 = add(dot2(a00, u0, a01, u1), mul(b0, xt));
        const R n1 = add(dot2(a10, u0, a11, u1), mul(b1, xt));
        u0 = n0;
        u1 = n1;
    }
    // the last thread's segment ends at B (or is empty, past B): its state
    // is the lane's end state
    if (tid == T_ - 1) {
        store_state<T, R, kPair>(state_out, c, C, 0, u0);
        store_state<T, R, kPair>(state_out, c, C, 1, u1);
    }
}

template <typename T, typename R, bool kPair>
int biquad_scan(const R* A, const R* Bv, const R* c0, const T* state_in, T* state_out,
                const T* x, T* y, int B, int C, void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    // about 16 samples a thread, 32..1024 threads a lane
    int T_ = ((B + 15) / 16 + 31) / 32 * 32;
    T_ = T_ < 32 ? 32 : (T_ > 1024 ? 1024 : T_);
    biquad_scan_kernel<T, R, kPair><<<C, T_, 0, static_cast<cudaStream_t>(stream)>>>(
        A, Bv, c0, state_in, state_out, x, y, B, C);
    return (int)cudaGetLastError();
}

}  // namespace

// Return cudaGetLastError() after the launch (0 on success). The caller
// checks shapes, dtypes and contiguity.
extern "C" int dsp_biquad_scan_f64(const double* A, const double* Bv, const double* c0,
                                   const double* state_in, double* state_out, const double* x,
                                   double* y, int B, int C, void* stream) {
    return biquad_scan<double, double, false>(A, Bv, c0, state_in, state_out, x, y, B, C,
                                              stream);
}

// K2 in float32: everything float32, state [C, 2].
extern "C" int dsp_biquad_scan_f32(const float* A, const float* Bv, const float* c0,
                                   const float* state_in, float* state_out, const float* x,
                                   float* y, int B, int C, void* stream) {
    return biquad_scan<float, float, false>(A, Bv, c0, state_in, state_out, x, y, B, C, stream);
}

// K3: float64 coefficients and registers, float32 samples, a float32
// (hi, lo) state [2, C, 2].
extern "C" int dsp_biquad_scan_df(const double* A, const double* Bv, const double* c0,
                                  const float* state_in, float* state_out, const float* x,
                                  float* y, int B, int C, void* stream) {
    return biquad_scan<float, double, true>(A, Bv, c0, state_in, state_out, x, y, B, C, stream);
}

// K3 with a single float32 state [C, 2]: float64 coefficients and
// registers, float32 samples, the end state rounded once.
extern "C" int dsp_biquad_scan_df1(const double* A, const double* Bv, const double* c0,
                                   const float* state_in, float* state_out, const float* x,
                                   float* y, int B, int C, void* stream) {
    return biquad_scan<float, double, false>(A, Bv, c0, state_in, state_out, x, y, B, C, stream);
}
