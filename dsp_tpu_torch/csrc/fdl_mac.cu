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
// At NB = 2049 there are only 4,098 (bin, channel) pairs, so what sets the
// time is how many bytes each pair's thread keeps in flight, and on how
// many SMs; at NB = 65537 (more than the 50 MB L2) it is HBM.
//
// Design: each (bin, channel)'s sum is one thread's f64 FMAs over k in
// registers, in the order k = 0, 1, ..., K-1 (each pair's sum rounds as it
// always has; splitting a pair's slots across threads would not); 16-byte
// loads and stores of each complex value, neighbouring pairs on
// neighbouring addresses, so every access is coalesced. Three kernels:
// * fdl_mac_product, for K = 1 (the product X H[0], and X as the one
//   slot): a thread a pair, blocks of 128, no loop;
// * fdl_mac_kernel, at many pairs (NB = 65537: HBM-bound): a thread a
//   pair, a grid-stride loop over blocks of 64; the slots in groups of
//   kGroup, a group's loads of H and the FDL issued before its FMAs;
// * fdl_mac_staged, at few pairs (NB = 2049: 4,098 pairs, one warp's worth
//   for each SM), where a thread a pair keeps too few loads in flight: a
//   block of 256 threads loads the K - 1 slots of H and of the FDL for its
//   32 pairs into shared memory at once (every thread 2·ceil(31·32/256)
//   loads in flight, each FDL slot stored shifted straight from its
//   register), then its first warp runs the 32 sums from shared memory.
// K = 15, 16 and 32 (the main path's) are compiled with K known, their
// loops unrolled whole; another K takes fdl_mac_kernel's generic form.
//
// The stream axis (split and batched processing): X and Y [S, NB, C], the
// FDL [S, K, NB, C], against the one H [K, NB, C] of the filter. A pair i
// of the S·NB·C is pair r = i mod m (m = NB·C) of stream (i - r) / m: H's
// slot k at k·m + r, the FDL's at (i - r)·K + k·m + r. The S streams run in
// the one launch, each pair's sum in the order of a one-stream call.

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

// one slot's product into (re, im), in the order the sum has always taken
__device__ __forceinline__ void mac(double& re, double& im, double2 d, double2 h) {
    re = __fma_rn(d.x, h.x, re);
    re = __fma_rn(-d.y, h.y, re);
    im = __fma_rn(d.x, h.y, im);
    im = __fma_rn(d.y, h.x, im);
}

constexpr int kGroup = 8;

// pair i's place in its stream's slots: r (H's slot k at k·m + r) and the
// stream's first FDL element fb (its slot k at fb + k·m + r); one stream
// (m = n) needs no division
__device__ __forceinline__ void stream_of(long long i, long long n, long long m, int K,
                                          long long& r, long long& fb) {
    r = m == n ? i : i % m;
    fb = (i - r) * K;
}

// the product of slot 0, X H[0], as every sum starts
__device__ __forceinline__ double2 product(double2 x, double2 h0) {
    double re = __dmul_rn(x.x, h0.x);
    double im = __dmul_rn(x.x, h0.y);
    re = __fma_rn(-x.y, h0.y, re);
    im = __fma_rn(x.y, h0.x, im);
    return make_double2(re, im);
}

template <class F>
__global__ void fdl_mac_product(const double2* __restrict__ X, const double2* __restrict__ H,
                                double2* __restrict__ Y, F* __restrict__ fdl_out, long long n,
                                long long m) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long long r, fb;
    stream_of(i, n, m, 1, r, fb);
    const double2 x = X[i], h0 = H[r];
    if (fdl_out != nullptr) fdl_store(fdl_out[i], x);
    Y[i] = product(x, h0);
}

// KT > 0: K known at compile time (K_rt ignored); 0: K = K_rt
template <class F, int KT>
__global__ void fdl_mac_kernel(const double2* __restrict__ X, const double2* __restrict__ H,
                               const F* __restrict__ fdl_in, double2* __restrict__ Y,
                               F* __restrict__ fdl_out, long long n, long long m, int K_rt) {
    const int K = KT > 0 ? KT : K_rt;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        long long r, fb;
        stream_of(i, n, m, K, r, fb);
        const F* fin = fdl_in + fb + r;
        F* fout = fdl_out + fb + r;
        const double2* Hr = H + r;
        const double2 x = X[i];
        const double2 y0 = product(x, Hr[0]);
        double re = y0.x, im = y0.y;
        fdl_store(fout[0], x);
        int k = 1;
#pragma unroll
        for (; k + kGroup <= K; k += kGroup) {
            F raw[kGroup];
            double2 h[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                raw[j] = fin[(long long)(k + j - 1) * m];
                h[j] = Hr[(long long)(k + j) * m];
            }
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                fout[(long long)(k + j) * m] = raw[j];
                mac(re, im, fdl_load(raw[j]), h[j]);
            }
        }
#pragma unroll
        for (; k < K; ++k) {
            const F raw = fin[(long long)(k - 1) * m];
            const double2 h = Hr[(long long)k * m];
            fout[(long long)k * m] = raw;
            mac(re, im, fdl_load(raw), h);
        }
        Y[i] = make_double2(re, im);
    }
}

constexpr int kPairs = 32;          // pairs a block of fdl_mac_staged
constexpr int kStageThreads = 256;  // its threads

template <class F, int KT>
__global__ void __launch_bounds__(kStageThreads)
    fdl_mac_staged(const double2* __restrict__ X, const double2* __restrict__ H,
                   const F* __restrict__ fdl_in, double2* __restrict__ Y, F* __restrict__ fdl_out,
                   long long n, long long m) {
    constexpr int kRows = KT - 1;                 // slots 1..K-1 of H, 0..K-2 of the FDL
    constexpr int kItems = kRows * kPairs;        // of each
    constexpr int kPer = (kItems + kStageThreads - 1) / kStageThreads;
    __shared__ double2 hs[kRows][kPairs];
    __shared__ F fs[kRows][kPairs];
    const long long p0 = (long long)blockIdx.x * kPairs;
    const int t = threadIdx.x;
    const long long mine = p0 + t;  // the pair whose sum this thread runs (t < kPairs)
    double2 x = make_double2(0.0, 0.0), h0 = x;
    long long rm = 0, fbm = 0;  // `mine`'s place in its stream
    if (t < kPairs && mine < n) {
        stream_of(mine, n, m, KT, rm, fbm);
        x = X[mine];
        h0 = H[rm];
    }
    double2 hv[kPer];
    F fv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int item = t + j * kStageThreads, r = item / kPairs;
        const long long i = p0 + item % kPairs;
        if (item < kItems && i < n) {
            long long ri, fb;
            stream_of(i, n, m, KT, ri, fb);
            hv[j] = H[(long long)(r + 1) * m + ri];
            fv[j] = fdl_in[fb + (long long)r * m + ri];
        }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int item = t + j * kStageThreads, r = item / kPairs, p = item % kPairs;
        const long long i = p0 + p;
        if (item < kItems && i < n) {
            long long ri, fb;
            stream_of(i, n, m, KT, ri, fb);
            hs[r][p] = hv[j];
            fs[r][p] = fv[j];
            fdl_out[fb + (long long)(r + 1) * m + ri] = fv[j];
        }
    }
    __syncthreads();
    if (t >= kPairs || mine >= n) return;
    const double2 y0 = product(x, h0);
    double re = y0.x, im = y0.y;
    fdl_store(fdl_out[fbm + rm], x);
#pragma unroll
    for (int k = 1; k < KT; ++k) mac(re, im, fdl_load(fs[k - 1][t]), hs[k - 1][t]);
    Y[mine] = make_double2(re, im);
}

template <class F, int KT>
void launch_k(const void* X, const void* H, const void* fdl_in, void* Y, void* fdl_out,
              long long n, long long m, int K, int blocks, int threads, cudaStream_t stream) {
    fdl_mac_kernel<F, KT><<<blocks, threads, 0, stream>>>(
        static_cast<const double2*>(X), static_cast<const double2*>(H),
        static_cast<const F*>(fdl_in), static_cast<double2*>(Y), static_cast<F*>(fdl_out), n, m,
        K);
}

template <class F, int KT>
void launch_staged(const void* X, const void* H, const void* fdl_in, void* Y, void* fdl_out,
                   long long n, long long m, cudaStream_t stream) {
    fdl_mac_staged<F, KT><<<(unsigned)((n + kPairs - 1) / kPairs), kStageThreads, 0, stream>>>(
        static_cast<const double2*>(X), static_cast<const double2*>(H),
        static_cast<const F*>(fdl_in), static_cast<double2*>(Y), static_cast<F*>(fdl_out), n, m);
}

// n = S·m pairs, m = NB·C a stream's
template <class F>
int launch(const void* X, const void* H, const void* fdl_in, void* Y, void* fdl_out,
           long long n, int K, int S, void* stream) {
    if (n <= 0 || K <= 0 || S <= 0 || n % S) return (int)cudaErrorInvalidValue;
    const long long m = n / S;
    if (K > 1 && (fdl_in == nullptr || fdl_out == nullptr)) return (int)cudaErrorInvalidValue;
    if ((fdl_in == nullptr) != (fdl_out == nullptr)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (K == 1) {
        fdl_mac_product<F><<<(unsigned)((n + 127) / 128), 128, 0, s>>>(
            static_cast<const double2*>(X), static_cast<const double2*>(H),
            static_cast<double2*>(Y), static_cast<F*>(fdl_out), n, m);
        return (int)cudaGetLastError();
    }
    if (n <= 132 * 4 * kPairs && (K == 15 || K == 16 || K == 32)) {  // a few blocks an SM
        switch (K) {
            case 15: launch_staged<F, 15>(X, H, fdl_in, Y, fdl_out, n, m, s); break;
            case 16: launch_staged<F, 16>(X, H, fdl_in, Y, fdl_out, n, m, s); break;
            default: launch_staged<F, 32>(X, H, fdl_in, Y, fdl_out, n, m, s);
        }
        return (int)cudaGetLastError();
    }
    int threads = 64;
    long long blocks = (n + threads - 1) / threads;
    if (blocks < 132) {  // spread a small call over more SMs
        threads = 32;
        blocks = (n + threads - 1) / threads;
    }
    if (blocks > 132 * 32) blocks = 132 * 32;  // then grid-stride
    const int b = (int)blocks;
    switch (K) {
        case 15: launch_k<F, 15>(X, H, fdl_in, Y, fdl_out, n, m, K, b, threads, s); break;
        case 16: launch_k<F, 16>(X, H, fdl_in, Y, fdl_out, n, m, K, b, threads, s); break;
        case 32: launch_k<F, 32>(X, H, fdl_in, Y, fdl_out, n, m, K, b, threads, s); break;
        default: launch_k<F, 0>(X, H, fdl_in, Y, fdl_out, n, m, K, b, threads, s);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// n = S * NB * C: S streams (X, Y [S, NB, C], the FDL [S, K, NB, C]) against
// the one H [K, NB, C]. Returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, dtypes, contiguity and 16-byte
// alignment.
extern "C" int dsp_fdl_mac_c128(const void* X, const void* H, const void* fdl_in, void* Y,
                                void* fdl_out, long long n, int K, int S, void* stream) {
    return launch<double2>(X, H, fdl_in, Y, fdl_out, n, K, S, stream);
}

// The same with the FDL as float32 (re, im) pairs (8-byte aligned): X, H
// and Y complex128, the slots read into float64 and X stored rounded as the
// newest slot.
extern "C" int dsp_fdl_mac_f32(const void* X, const void* H, const void* fdl_in, void* Y,
                               void* fdl_out, long long n, int K, int S, void* stream) {
    return launch<float2>(X, H, fdl_in, Y, fdl_out, n, K, S, stream);
}
