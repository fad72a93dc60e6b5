// K1: blocked state-space (LTI) filter, for Hopper (sm_90a), on float64 or
// float32 samples.
//
// Replaces dsp_tpu/ops/iir.py:566 `_lti_blocked_impl`, entered through
// `lti_blocked` (iir.py:550) and `lti_blocked_df` (iir.py:556): its float64
// branch (iir.py:634-650) and its float32 branch (iir.py:574-631), which
// composes two-float32 (hi, lo) pairs for the chunk products, the injection
// and a Kogge-Stone carry because the TPU has no usable float64. Tables come
// from `CascadeBlockedPlan._init_from_ss` (dsp_tpu_torch/ops/iir.py), all
// per channel c:
//   h  [C, L]     impulse response taps h[c, k] = C A^k B (k < L-1; the last
//                 entry is unused), so the chunk's Toeplitz matrix is
//                 W[c, i, j] = h[c, i-1-j] for j < i
//   V  [C, n, L]  injection: chunk k's input adds V·x_k to the carried state
//   P  [C, L, n]  readout: the carried state's contribution to each sample
//   AL [C, n, n]  A^L, the per-chunk state transition
//   c0 [C]        direct feed-through
// For chunk k of L samples: y_k = c0·x_k + W·x_k + P·s_k, and
// s_{k+1} = AL·s_k + V·x_k, with s_0 = state[0] + state[1].
//
// What bounds it on the card: at the main path's shapes (C = 2, n = 12,
// L = 128, B = 2048..65536) the whole call moves well under 2 MB and does
// under 10 MFLOP, so it is bound by launch latency and by the serial carry,
// not by bandwidth or FLOPs. The TPU version multiplied a dense [L, L]
// Toeplitz matrix per channel on the MXU; here W is never materialised:
// z = W·x is a causal FIR of L-1 taps inside the chunk, computed from h
// (1 KB) and the chunk's x in shared memory.
//
// Design: three launches on the caller's stream, no allocation.
//   1. lti_inject, grid (Nc, C): v_k = V·x_k, one warp per state row, warp
//      shuffle reduction over the chunk.
//   2. lti_carry, grid C, one warp per channel: the serial recurrence over
//      the Nc chunks (Nc·n² FMAs per channel; 512·144 at B = 65536). It
//      writes the state at the start of every chunk. The TPU version's
//      Kogge-Stone doubling over chunks is not needed to be exact here.
//   3. lti_output, grid (Nc, C): y = c0·x + z + P·s_start.
// x and y are [B, C] row-major (channel-interleaved, as the chain passes
// them) and are read and written strided by C; nothing is transposed.
//
// float32 samples (dsp_lti_blocked_f32): the same three launches read f32
// x and the f32 (hi, lo) state, carry everything in float64 registers and
// shared memory, and store f32: the state split as hi = (float)s,
// lo = (float)(s - hi), so hi + lo keeps s to ~48 bits across blocks, and y
// rounded once (or, with y_lo, split the same way: lti_blocked_df's (hi, lo)
// output). Hopper has float64 in hardware, so this computes the df
// branch's function at least as accurately as its two-float32 arithmetic,
// from the same float64 tables, with none of its hi/lo table splits. Its
// bytes are half the float64 form's for x and y; the work is the same.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// a state of T: float64 carries s in hi and 0 in lo; float32 splits s
// into a (hi, lo) pair whose sum is s to ~48 bits
__device__ __forceinline__ void store_split(double* hi, double* lo, double s) {
    *hi = s;
    *lo = 0.0;
}
__device__ __forceinline__ void store_split(float* hi, float* lo, double s) {
    const float h = (float)s;
    *hi = h;
    *lo = (float)(s - (double)h);
}

// one output sample: float64 stores it; float32 rounds it, or splits it
// into y and y_lo when y_lo is given
__device__ __forceinline__ void store_y(double* y, double*, size_t o, double v) { y[o] = v; }
__device__ __forceinline__ void store_y(float* y, float* y_lo, size_t o, double v) {
    const float h = (float)v;
    y[o] = h;
    if (y_lo != nullptr) y_lo[o] = (float)(v - (double)h);
}

template <typename T>
__global__ void lti_inject(const T* __restrict__ x, const double* __restrict__ V,
                           double* __restrict__ v, int C, int n, int L) {
    extern __shared__ double xs[];  // [L]
    const int k = blockIdx.x;
    const int c = blockIdx.y;
    const T* xk = x + (size_t)k * L * C + c;
    for (int j = threadIdx.x; j < L; j += blockDim.x) xs[j] = (double)xk[(size_t)j * C];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const double* Vc = V + (size_t)c * n * L;
    for (int r = warp; r < n; r += nwarps) {
        double acc = 0.0;
        for (int j = lane; j < L; j += 32) acc = fma(Vc[(size_t)r * L + j], xs[j], acc);
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) v[((size_t)k * C + c) * n + r] = acc;
    }
}

template <typename T>
__global__ void lti_carry(const double* __restrict__ AL, const double* __restrict__ v,
                          const T* __restrict__ state_in, double* __restrict__ s_start,
                          T* __restrict__ state_out, int C, int n, int Nc) {
    extern __shared__ double sh[];  // [2, n]: current and next state
    double* s = sh;
    double* s_next = sh + n;
    const int c = blockIdx.x;
    const int lane = threadIdx.x;
    const double* A = AL + (size_t)c * n * n;
    for (int r = lane; r < n; r += 32)
        s[r] = (double)state_in[(size_t)c * n + r] + (double)state_in[(size_t)(C + c) * n + r];
    __syncwarp();
    for (int k = 0; k < Nc; ++k) {
        const double* vk = v + ((size_t)k * C + c) * n;
        double* sk = s_start + ((size_t)k * C + c) * n;
        for (int r = lane; r < n; r += 32) {
            double acc = vk[r];
            for (int j = 0; j < n; ++j) acc = fma(A[(size_t)r * n + j], s[j], acc);
            sk[r] = s[r];
            s_next[r] = acc;
        }
        __syncwarp();
        double* t = s;
        s = s_next;
        s_next = t;
    }
    for (int r = lane; r < n; r += 32)
        store_split(state_out + (size_t)c * n + r, state_out + (size_t)(C + c) * n + r, s[r]);
}

template <typename T>
__global__ void lti_output(const T* __restrict__ x, const double* __restrict__ h,
                           const double* __restrict__ P, const double* __restrict__ c0,
                           const double* __restrict__ s_start, T* __restrict__ y,
                           T* __restrict__ y_lo, int C, int n, int L) {
    extern __shared__ double sh[];  // x chunk [L], taps [L], start state [n]
    double* xs = sh;
    double* hs = sh + L;
    double* ss = sh + 2 * L;
    const int k = blockIdx.x;
    const int c = blockIdx.y;
    const T* xk = x + (size_t)k * L * C + c;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        xs[j] = (double)xk[(size_t)j * C];
        hs[j] = h[(size_t)c * L + j];
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) ss[r] = s_start[((size_t)k * C + c) * n + r];
    __syncthreads();
    const double g = c0[c];
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        double z = 0.0;
        for (int j = 0; j < i; ++j) z = fma(hs[i - 1 - j], xs[j], z);
        const double* Pi = P + ((size_t)c * L + i) * n;
        double ps = 0.0;
        for (int r = 0; r < n; ++r) ps = fma(Pi[r], ss[r], ps);
        store_y(y, y_lo, ((size_t)k * L + i) * C + c, g * xs[i] + ps + z);
    }
}

template <typename T>
int lti_blocked(const T* x, T* y, T* y_lo, const T* state_in, T* state_out, const double* h,
                const double* V, const double* P, const double* AL, const double* c0,
                double* v_scratch, double* s_scratch, int B, int C, int n, int L,
                cudaStream_t st) {
    if (B <= 0 || C <= 0 || n <= 0 || L <= 0 || B % L != 0) return (int)cudaErrorInvalidValue;
    const size_t smem_out = (size_t)(2 * L + n) * sizeof(double);
    const size_t smem_carry = (size_t)2 * n * sizeof(double);
    if (smem_out > 48 * 1024 || smem_carry > 48 * 1024 || C > 65535)
        return (int)cudaErrorInvalidValue;
    const int Nc = B / L;
    const dim3 grid(Nc, C);
    lti_inject<T><<<grid, kThreads, (size_t)L * sizeof(double), st>>>(x, V, v_scratch, C, n, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lti_carry<T><<<C, 32, smem_carry, st>>>(AL, v_scratch, state_in, s_scratch, state_out, C, n,
                                            Nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lti_output<T><<<grid, kThreads, smem_out, st>>>(x, h, P, c0, s_scratch, y, y_lo, C, n, L);
    return (int)cudaGetLastError();
}

}  // namespace

// Return cudaGetLastError() after the launches (0 on success). The caller
// checks shapes, dtypes and contiguity; these only refuse what they cannot
// launch. The tables h, V, P, AL, c0 and the scratch are float64 in both.
extern "C" int dsp_lti_blocked_f64(const double* x, double* y, const double* state_in,
                                   double* state_out, const double* h, const double* V,
                                   const double* P, const double* AL, const double* c0,
                                   double* v_scratch, double* s_scratch, int B, int C, int n,
                                   int L, void* stream) {
    return lti_blocked<double>(x, y, nullptr, state_in, state_out, h, V, P, AL, c0, v_scratch,
                               s_scratch, B, C, n, L, static_cast<cudaStream_t>(stream));
}

// float32 samples and a float32 (hi, lo) state [2, C, n]; y_lo null rounds
// y once, else y and y_lo are the (hi, lo) split of each output sample.
extern "C" int dsp_lti_blocked_f32(const float* x, float* y, float* y_lo, const float* state_in,
                                   float* state_out, const double* h, const double* V,
                                   const double* P, const double* AL, const double* c0,
                                   double* v_scratch, double* s_scratch, int B, int C, int n,
                                   int L, void* stream) {
    return lti_blocked<float>(x, y, y_lo, state_in, state_out, h, V, P, AL, c0, v_scratch,
                              s_scratch, B, C, n, L, static_cast<cudaStream_t>(stream));
}
