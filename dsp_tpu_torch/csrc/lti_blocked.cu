// K1: blocked state-space (LTI) filter, float64, for Hopper (sm_90a).
//
// Replaces dsp_tpu/ops/iir.py:566 `_lti_blocked_impl` (its float64 branch,
// iir.py:634-650), entered through `lti_blocked` (iir.py:550). Tables come
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void lti_inject(const double* __restrict__ x, const double* __restrict__ V,
                           double* __restrict__ v, int C, int n, int L) {
    extern __shared__ double xs[];  // [L]
    const int k = blockIdx.x;
    const int c = blockIdx.y;
    const double* xk = x + (size_t)k * L * C + c;
    for (int j = threadIdx.x; j < L; j += blockDim.x) xs[j] = xk[(size_t)j * C];
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

__global__ void lti_carry(const double* __restrict__ AL, const double* __restrict__ v,
                          const double* __restrict__ state_in, double* __restrict__ s_start,
                          double* __restrict__ state_out, int C, int n, int Nc) {
    extern __shared__ double sh[];  // [2, n]: current and next state
    double* s = sh;
    double* s_next = sh + n;
    const int c = blockIdx.x;
    const int lane = threadIdx.x;
    const double* A = AL + (size_t)c * n * n;
    for (int r = lane; r < n; r += 32)
        s[r] = state_in[(size_t)c * n + r] + state_in[(size_t)(C + c) * n + r];
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
    for (int r = lane; r < n; r += 32) {
        state_out[(size_t)c * n + r] = s[r];
        state_out[(size_t)(C + c) * n + r] = 0.0;
    }
}

__global__ void lti_output(const double* __restrict__ x, const double* __restrict__ h,
                           const double* __restrict__ P, const double* __restrict__ c0,
                           const double* __restrict__ s_start, double* __restrict__ y, int C,
                           int n, int L) {
    extern __shared__ double sh[];  // x chunk [L], taps [L], start state [n]
    double* xs = sh;
    double* hs = sh + L;
    double* ss = sh + 2 * L;
    const int k = blockIdx.x;
    const int c = blockIdx.y;
    const double* xk = x + (size_t)k * L * C + c;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        xs[j] = xk[(size_t)j * C];
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
        y[((size_t)k * L + i) * C + c] = g * xs[i] + ps + z;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). The caller
// checks shapes, dtypes and contiguity; this only refuses what it cannot
// launch.
extern "C" int dsp_lti_blocked_f64(const double* x, double* y, const double* state_in,
                                   double* state_out, const double* h, const double* V,
                                   const double* P, const double* AL, const double* c0,
                                   double* v_scratch, double* s_scratch, int B, int C, int n,
                                   int L, void* stream) {
    if (B <= 0 || C <= 0 || n <= 0 || L <= 0 || B % L != 0) return (int)cudaErrorInvalidValue;
    const size_t smem_out = (size_t)(2 * L + n) * sizeof(double);
    const size_t smem_carry = (size_t)2 * n * sizeof(double);
    if (smem_out > 48 * 1024 || smem_carry > 48 * 1024 || C > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int Nc = B / L;
    const dim3 grid(Nc, C);
    lti_inject<<<grid, kThreads, (size_t)L * sizeof(double), st>>>(x, V, v_scratch, C, n, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lti_carry<<<C, 32, smem_carry, st>>>(AL, v_scratch, state_in, s_scratch, state_out, C, n,
                                         Nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lti_output<<<grid, kThreads, smem_out, st>>>(x, h, P, c0, s_scratch, y, C, n, L);
    return (int)cudaGetLastError();
}
