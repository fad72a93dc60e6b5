// K5-K7: the spectral multiply-accumulate of FFT convolution, complex128,
// for Hopper (sm_90a).
//
// Replaces the work between the transforms of three TPU functions of
// dsp_tpu/ops/fft_conv.py: `OlsConv.step` (:85, the product X*H at :99),
// `UpolsConv.step` (:137, the FDL shift and MAC at :146-151) and
// `NupolsConv.step` (:204, the tail's at :226-233); the transforms and
// copies around it are csrc/fft_conv.cu. For every bin f and channel c:
//   Y[f, c]       = X[f, c] H[0, f, c] + sum_{k=1..K-1} FDL_in[k-1, f, c] H[k, f, c]
//   FDL_out[0]    = X,   FDL_out[k] = FDL_in[k-1]   (k = 1..K-1)
// X, Y are [NB, C]; H, FDL_in, FDL_out are [K, NB, C] complex128, the FDL as
// dsp_tpu's (re, im) float64 pairs, which have the same layout. FDL_in and
// FDL_out may be null (K = 1, the overlap-save engine has no delay line).
// Writing the shifted FDL in the same pass keeps dsp_tpu's newest-first
// order with no ring index, at one write per slot read.
//
// What bounds it on the card: memory. A (bin, channel) moves about
// (3K + 1) * 16 bytes (X, K spectra of H, K-1 FDL slots in, K out, Y) for
// 8K flops, far below the f64 ridge. At the main path's shapes that is
// 6.4 MB (K = 32, NB = 2049, C = 2) to 94 MB (K = 15, NB = 65537, C = 2).
//
// Design: one thread per (bin, channel), a grid-stride loop, 16-byte loads
// and stores of each complex value (neighbouring threads on neighbouring
// addresses, so every access is coalesced), and f64 FMAs over k in
// registers. Streaming H through shared memory or splitting K across
// blocks is later work.

#include <cuda_runtime.h>

namespace {

// The FDL's slots as dsp_tpu stores them: float64 (re, im) pairs, or
// float32 pairs under float32 (read into float64, written rounded)
__device__ __forceinline__ double2 fdl_load(const double2& v) { return v; }
__device__ __forceinline__ double2 fdl_load(const float2& v) {
    return make_double2((double)v.x, (double)v.y);
}
__device__ __forceinline__ void fdl_store(double2& d, double2 v) { d = v; }
__device__ __forceinline__ void fdl_store(float2& d, double2 v) {
    d = make_float2((float)v.x, (float)v.y);
}

template <class F>
__global__ void fdl_mac_kernel(const double2* __restrict__ X, const double2* __restrict__ H,
                               const F* __restrict__ fdl_in, double2* __restrict__ Y,
                               F* __restrict__ fdl_out, long long n, int K) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const double2 x = X[i];
        const double2 h0 = H[i];
        double re = x.x * h0.x;
        double im = x.x * h0.y;
        re = fma(-x.y, h0.y, re);
        im = fma(x.y, h0.x, im);
        if (fdl_out != nullptr) fdl_store(fdl_out[i], x);
        for (int k = 1; k < K; ++k) {
            const F raw = fdl_in[(long long)(k - 1) * n + i];
            const double2 d = fdl_load(raw);
            const double2 h = H[(long long)k * n + i];
            re = fma(d.x, h.x, re);
            re = fma(-d.y, h.y, re);
            im = fma(d.x, h.y, im);
            im = fma(d.y, h.x, im);
            fdl_out[(long long)k * n + i] = raw;
        }
        Y[i] = make_double2(re, im);
    }
}

template <class F>
int launch(const void* X, const void* H, const void* fdl_in, void* Y, void* fdl_out,
           long long n, int K, void* stream) {
    if (n <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    if (K > 1 && (fdl_in == nullptr || fdl_out == nullptr)) return (int)cudaErrorInvalidValue;
    if ((fdl_in == nullptr) != (fdl_out == nullptr)) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then grid-stride
    fdl_mac_kernel<F><<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double2*>(X), static_cast<const double2*>(H),
        static_cast<const F*>(fdl_in), static_cast<double2*>(Y), static_cast<F*>(fdl_out), n,
        K);
    return (int)cudaGetLastError();
}

}  // namespace

// n = NB * C. Returns cudaGetLastError() after the launch (0 on success).
// The caller checks shapes, dtypes, contiguity and 16-byte alignment.
extern "C" int dsp_fdl_mac_c128(const void* X, const void* H, const void* fdl_in, void* Y,
                                void* fdl_out, long long n, int K, void* stream) {
    return launch<double2>(X, H, fdl_in, Y, fdl_out, n, K, stream);
}

// The same with the FDL as float32 (re, im) pairs (8-byte aligned): X, H
// and Y complex128, the slots read into float64 and X stored rounded as the
// newest slot.
extern "C" int dsp_fdl_mac_f32(const void* X, const void* H, const void* fdl_in, void* Y,
                               void* fdl_out, long long n, int K, void* stream) {
    return launch<float2>(X, H, fdl_in, Y, fdl_out, n, K, stream);
}
