// K5-K7: the transforms and copies around the spectral multiply-accumulate
// of FFT convolution, float64 / complex128, for Hopper (sm_90a).
//
// Together with fdl_mac.cu these replace every step of three TPU functions
// of dsp_tpu/ops/fft_conv.py: `OlsConv.step` (:85), `UpolsConv.step` (:137)
// and `NupolsConv.step` (:204). This file does the work on either side of
// the multiply-accumulate:
//
// * rfft_pack (:90-93, :142-143, :223-224): the spectrum, bins 0..N/2, of the
//   real signal [a | x | 0] of length N along axis 0 of [N, C]. The pack is
//   the first stage's load, so [a | x] is never built.
// * irfft_crop (:100-101, :152-153, :213-216, :234): rows [lo, lo + L) of
//   the real inverse transform at N of a half spectrum [N/2+1, C], times
//   1/N, plus an optional addend [L, C] (the Nupols tail's contribution).
//   The Hermitian extension is the first stage's load and the crop the last
//   stage's store.
// * splice (:102, :155, :217-219): out[n] = x[n - lo] for lo <= n < lo + Lx,
//   else a[n + shift], n in [0, L): the history kept by overlap-save, the
//   previous block of the partitioned engines and the Nupols stage write.
//   The engine's state is always its own copy, never the caller's block.
//
// The transform is a mixed-radix Stockham autosort FFT (no bit reversal):
// N is factored into radices 8, 4, 2, 3, 5, 7 and then any other prime, and
// each radix is one launch. With Ns the product of the radices before it
// and M = N / R, output d = (j / Ns) Ns R + j % Ns + q Ns of a stage is
//   out[d] = sum_{r<R} in[j + r M] W^(r e mod N),  e = (j % Ns) N/(Ns R) + q M,
// W = exp(-+2 pi i / N). One thread computes one output point of one
// channel by this direct sum (R complex FMAs and twiddles from sincospi),
// so a prime radix of any size works, at R operations a point. Layout is
// [N, C] with C fastest, so neighbouring threads read and write neighbouring
// addresses. A forward transform of N real values costs log_R N passes over
// N * C complex values; the real-input half-length trick and fused radix
// butterflies in shared memory are later work.
//
// What bounds it on the card: at the main path's sizes (N = 4,096 to
// 131,072, C = 2, 4-7 launches a transform) each launch is short, so launch
// latency and the host's enqueue bound it, not bandwidth or f64 rate.
//
// float32 samples: the resampler's float32 step (dsp_tpu's `_block_df`,
// resample_ops.py:191, whose transforms are the two-float32 Stockham and
// Bluestein DFTs of dfx_fft.py:30 `DfFft` and :123 `DfDft`) runs the same
// float64 transforms with a float32 load and a float32 store:
// * rfft_pack_f32: the pack reads float32 [a | x] into float64;
// * irfft_ola_f32: the inverse's last stage is the resampler's overlap-add.
//   Its columns are inner blocks times channels; output point d < N/2 of
//   column b·ch + c is (head of column b) + (tail of column b-1), the tail
//   of the block before the first one being the carried overlap, each
//   times 1/N and then the rate ratio, as the float64 step orders them.
//   A thread computes both points by the stage's direct sum from the
//   previous stage's buffer, rounds the tail to float32 (the overlap a
//   block carries, as dsp_tpu's float32 state holds it), adds in float64
//   and stores y rounded once; the tails of the last column become the
//   float32 overlap carried out. So the sums stay float64 from the
//   float32 input to the float32 output, which the two-float32 transforms
//   only approach, and the store takes no extra pass.
//
// float32 FFT convolution (dsp_tpu runs K5-K7 in complex64 under float32,
// fft_conv.py:97, :144, :220): the engines' steps take rfft_pack_f32 (the
// float32 [a | x] pack), irfft_crop_f32 (the crop, and the Nupols tail's
// float32 addend added in float64, stored rounded once) and splice_f32; the
// transforms between stay float64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks per SM, then grid-stride

enum LoadMode { kLoadComplex = 0, kLoadRealPack = 1, kLoadHermitian = 2, kLoadRealPackF32 = 3 };
enum StoreMode {
    kStoreComplex = 0, kStoreRealCrop = 1, kStoreOlaF32 = 2, kStoreRealCropF32 = 3
};

struct Load {
    int mode;
    const double2* c;   // kLoadComplex: [N, C]; kLoadHermitian: [NB, C]
    const double* a;    // kLoadRealPack: [La, C]
    long long La;
    const double* x;    // kLoadRealPack: [Lx, C]
    long long Lx;
    long long NB;       // kLoadHermitian: rows of the half spectrum
    const float* af;    // kLoadRealPackF32: [La, C]
    const float* xf;    // kLoadRealPackF32: [Lx, C]
};

struct Store {
    int mode;
    double2* c;         // kStoreComplex: rows [0, keep) of [N, C]
    long long keep;
    double* r;          // kStoreRealCrop: [L, C]
    long long lo, L;
    const double* add;  // kStoreRealCrop: [L, C] or null
    double scale;
    float* y;           // kStoreOlaF32: [C / ch, N / 2, ch]
    float* ov_out;      // kStoreOlaF32: [N / 2, ch]
    const float* ov_in; // kStoreOlaF32: [N / 2, ch]
    double ratio;       // kStoreOlaF32: applied after scale
    int ch;             // kStoreOlaF32: channels; C / ch inner blocks
    float* rf;          // kStoreRealCropF32: [L, C], with lo, L, scale
    const float* addf;  // kStoreRealCropF32: [L, C] or null
};

__device__ __forceinline__ double2 load_point(const Load& ld, long long n, int c, int C, int N) {
    switch (ld.mode) {
        case kLoadRealPack:
            if (n < ld.La) return make_double2(ld.a[n * C + c], 0.0);
            if (n < ld.La + ld.Lx) return make_double2(ld.x[(n - ld.La) * C + c], 0.0);
            return make_double2(0.0, 0.0);
        case kLoadRealPackF32:
            if (n < ld.La) return make_double2((double)ld.af[n * C + c], 0.0);
            if (n < ld.La + ld.Lx) return make_double2((double)ld.xf[(n - ld.La) * C + c], 0.0);
            return make_double2(0.0, 0.0);
        case kLoadHermitian:
            if (n < ld.NB) return ld.c[n * C + c];
            {
                const double2 v = ld.c[(N - n) * C + c];
                return make_double2(v.x, -v.y);
            }
        default:
            return ld.c[n * C + c];
    }
}

// Output point d of column c of a radix-R stage: the direct sum over the
// R inputs it reads. N * C < 2^31 (the host checks), so every index of a
// stage is an int.
__device__ __forceinline__ double2 stage_point(const Load& ld, int d, int c, int N, int C, int R,
                                               int Ns, double sign) {
    const int M = N / R;
    const int span = N / (Ns * R);
    const int k = d % Ns;
    const int q = (d / Ns) % R;
    const int j = (d / (Ns * R)) * Ns + k;
    const int e = k * span + q * M;  // < N
    double2 acc = load_point(ld, j, c, C, N);
    int idx = 0;
    for (int r = 1; r < R; ++r) {
        idx += e;
        if (idx >= N) idx -= N;
        double s, co;
        sincospi(2.0 * (double)idx / (double)N, &s, &co);
        s *= sign;  // forward: W = cos - i sin; inverse: cos + i sin
        const double2 v = load_point(ld, j + r * M, c, C, N);
        acc.x = fma(v.x, co, fma(v.y, s, acc.x));
        acc.y = fma(v.y, co, fma(-v.x, s, acc.y));
    }
    return acc;
}

__global__ void fft_stage_kernel(Load ld, Store st, int N, int C, int R, int Ns, double sign) {
    const int total = N * C;
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const int d = i / C;
        const int c = i % C;
        if (st.mode == kStoreComplex && d >= st.keep) continue;
        if (st.mode != kStoreComplex && (d < st.lo || d >= st.lo + st.L)) continue;
        const double2 acc = stage_point(ld, d, c, N, C, R, Ns, sign);
        if (st.mode == kStoreComplex) {
            st.c[i] = acc;
        } else if (st.mode == kStoreRealCrop) {
            const long long o = (d - st.lo) * C + c;
            double y = acc.x * st.scale;
            if (st.add != nullptr) y += st.add[o];
            st.r[o] = y;
        } else {
            const long long o = (d - st.lo) * C + c;
            double y = acc.x * st.scale;
            if (st.addf != nullptr) y += (double)st.addf[o];
            st.rf[o] = (float)y;
        }
    }
}

// The last stage of the resampler's inverse, with its overlap-add
// (kStoreOlaF32): over rows d < N/2 and columns col < C + ch, column
// col < C stores y at (col / ch, d, col % ch) = head + tail of column
// col - ch (the carried overlap for the first block), and column col >= C
// stores the overlap carried out, the tail of column col - ch.
__global__ void fft_ola_f32_kernel(Load ld, Store st, int N, int C, int R, int Ns, double sign) {
    const int half = N / 2;
    const int ch = st.ch;
    const int cols = C + ch;
    const long long total = (long long)half * cols;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const int d = (int)(i / cols);
        const int col = (int)(i % cols);
        double prev;
        if (col >= ch) {
            const double2 t = stage_point(ld, half + d, col - ch, N, C, R, Ns, sign);
            prev = (double)(float)((t.x * st.scale) * st.ratio);
        } else {
            prev = (double)st.ov_in[(long long)d * ch + col];
        }
        if (col < C) {
            const double2 h = stage_point(ld, d, col, N, C, R, Ns, sign);
            const long long o = ((long long)(col / ch) * half + d) * ch + col % ch;
            st.y[o] = (float)((h.x * st.scale) * st.ratio + prev);
        } else {
            st.ov_out[(long long)d * ch + (col - C)] = (float)prev;
        }
    }
}

template <class T>
__global__ void splice_kernel(const T* __restrict__ a, const T* __restrict__ x,
                              T* __restrict__ out, long long L, long long Lx, long long lo,
                              long long shift, int C) {
    const long long total = L * C;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const long long n = i / C;
        const int c = (int)(i % C);
        out[i] = (n >= lo && n < lo + Lx) ? x[(n - lo) * C + c] : a[(n + shift) * C + c];
    }
}

unsigned grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : (blocks < 1 ? 1 : blocks));
}

// Radices of N in launch order; returns their count (N = 1 is one radix-1 stage).
int factor(int N, int* radix) {
    static const int kSmall[] = {8, 4, 2, 3, 5, 7};
    int n = N, s = 0;
    for (int r : kSmall) {
        while (n % r == 0) {
            radix[s++] = r;
            n /= r;
        }
    }
    for (int p = 11; n > 1; p += 2) {
        while (n % p == 0) {
            radix[s++] = p;
            n /= p;
        }
    }
    if (s == 0) radix[s++] = 1;
    return s;
}

// All stages of one transform: the first loads through `first`, the last
// stores through `last`, the ones between ping-pong through work[2][N, C].
int run_fft(const Load& first, const Store& last, double2* work, int N, int C, double sign,
            cudaStream_t stream) {
    int radix[64];
    const int stages = factor(N, radix);
    const long long nc = (long long)N * C;
    int Ns = 1;
    for (int s = 0; s < stages; ++s) {
        Load ld = first;
        if (s > 0) {
            ld = Load{kLoadComplex, work + ((s - 1) % 2) * nc, nullptr, 0, nullptr, 0, 0};
        }
        Store st = last;
        if (s < stages - 1) {
            st = Store{kStoreComplex, work + (s % 2) * nc, N, nullptr, 0, 0, nullptr, 0.0};
        }
        if (st.mode == kStoreOlaF32) {
            fft_ola_f32_kernel<<<grid_for((long long)(N / 2) * (C + st.ch)), kThreads, 0, stream>>>(
                ld, st, N, C, radix[s], Ns, sign);
        } else {
            fft_stage_kernel<<<grid_for(nc), kThreads, 0, stream>>>(ld, st, N, C, radix[s], Ns,
                                                                   sign);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        Ns *= radix[s];
    }
    return 0;
}

}  // namespace

// X[N/2+1, C] = rfft([a | x | 0], n = N) along axis 0. a is [La, C] (may be
// empty), x is [Lx, C], La + Lx <= N; work holds 2 * N * C complex values.
// Returns a CUDA error code (0 on success). The caller checks shapes,
// dtypes and contiguity.
extern "C" int dsp_rfft_pack_c128(const void* a, long long La, const void* x, long long Lx,
                                  void* X, void* work, int N, int C, void* stream) {
    if (N <= 0 || C <= 0 || (long long)N * C >= (1LL << 31) || La < 0 || Lx < 0 || La + Lx > N) {
        return (int)cudaErrorInvalidValue;
    }
    const Load first{kLoadRealPack, nullptr, static_cast<const double*>(a), La,
                     static_cast<const double*>(x), Lx, 0};
    const Store last{kStoreComplex, static_cast<double2*>(X), N / 2 + 1, nullptr, 0, 0, nullptr,
                     0.0};
    return run_fft(first, last, static_cast<double2*>(work), N, C, 1.0,
                   static_cast<cudaStream_t>(stream));
}

// out[L, C] = irfft(Y, n = N)[lo : lo + L] (+ add[L, C] when add is not
// null) along axis 0; Y is [N/2+1, C], 0 <= lo, lo + L <= N; work holds
// 2 * N * C complex values.
extern "C" int dsp_irfft_crop_c128(const void* Y, void* work, void* out, long long lo,
                                   long long L, const void* add, int N, int C, void* stream) {
    if (N <= 0 || C <= 0 || (long long)N * C >= (1LL << 31) || L <= 0 || lo < 0 || lo + L > N) {
        return (int)cudaErrorInvalidValue;
    }
    const Load first{kLoadHermitian, static_cast<const double2*>(Y), nullptr, 0, nullptr, 0,
                     N / 2 + 1};
    const Store last{kStoreRealCrop, nullptr, 0, static_cast<double*>(out), lo, L,
                     static_cast<const double*>(add), 1.0 / N};
    return run_fft(first, last, static_cast<double2*>(work), N, C, -1.0,
                   static_cast<cudaStream_t>(stream));
}

// irfft_crop with a float32 out and add: the inverse in float64, each
// point rounded once on its store.
extern "C" int dsp_irfft_crop_f32(const void* Y, void* work, void* out, long long lo, long long L,
                                  const void* add, int N, int C, void* stream) {
    if (N <= 0 || C <= 0 || (long long)N * C >= (1LL << 31) || L <= 0 || lo < 0 || lo + L > N) {
        return (int)cudaErrorInvalidValue;
    }
    const Load first{kLoadHermitian, static_cast<const double2*>(Y), nullptr, 0, nullptr, 0,
                     N / 2 + 1};
    Store last{kStoreRealCropF32, nullptr, 0, nullptr, lo, L, nullptr, 1.0 / N};
    last.rf = static_cast<float*>(out);
    last.addf = static_cast<const float*>(add);
    return run_fft(first, last, static_cast<double2*>(work), N, C, -1.0,
                   static_cast<cudaStream_t>(stream));
}

// rfft_pack on float32 a and x: the spectrum is complex128.
extern "C" int dsp_rfft_pack_f32(const void* a, long long La, const void* x, long long Lx,
                                 void* X, void* work, int N, int C, void* stream) {
    if (N <= 0 || C <= 0 || (long long)N * C >= (1LL << 31) || La < 0 || Lx < 0 || La + Lx > N) {
        return (int)cudaErrorInvalidValue;
    }
    Load first{kLoadRealPackF32, nullptr, nullptr, La, nullptr, Lx, 0};
    first.af = static_cast<const float*>(a);
    first.xf = static_cast<const float*>(x);
    const Store last{kStoreComplex, static_cast<double2*>(X), N / 2 + 1, nullptr, 0, 0, nullptr,
                     0.0};
    return run_fft(first, last, static_cast<double2*>(work), N, C, 1.0,
                   static_cast<cudaStream_t>(stream));
}

// The resampler's inverse and overlap-add in float32 out: Y [N/2+1, C]
// half spectra, C = blocks * ch columns (block-major); y [blocks, N/2, ch],
// ov_out and ov_in [N/2, ch] float32; every value times 1/N, then ratio.
extern "C" int dsp_irfft_ola_f32(const void* Y, void* work, void* y, void* ov_out,
                                 const void* ov_in, double ratio, int N, int C, int ch,
                                 void* stream) {
    if (N <= 0 || N % 2 || C <= 0 || ch <= 0 || C % ch || (long long)N * C >= (1LL << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const Load first{kLoadHermitian, static_cast<const double2*>(Y), nullptr, 0, nullptr, 0,
                     N / 2 + 1};
    Store last{kStoreOlaF32, nullptr, 0, nullptr, 0, 0, nullptr, 1.0 / N};
    last.y = static_cast<float*>(y);
    last.ov_out = static_cast<float*>(ov_out);
    last.ov_in = static_cast<const float*>(ov_in);
    last.ratio = ratio;
    last.ch = ch;
    return run_fft(first, last, static_cast<double2*>(work), N, C, -1.0,
                   static_cast<cudaStream_t>(stream));
}

template <class T>
int splice(const void* a, const void* x, void* out, long long L, long long Lx, long long lo,
           long long shift, int C, void* stream) {
    if (L <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    splice_kernel<T><<<grid_for(L * C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(out), L, Lx, lo,
        shift, C);
    return (int)cudaGetLastError();
}

// out[n, c] = x[n - lo, c] for lo <= n < lo + Lx, else a[n + shift, c];
// n in [0, L). Every row read lies inside its tensor (the caller checks).
extern "C" int dsp_splice_f64(const void* a, const void* x, void* out, long long L, long long Lx,
                              long long lo, long long shift, int C, void* stream) {
    return splice<double>(a, x, out, L, Lx, lo, shift, C, stream);
}

// The same on float32.
extern "C" int dsp_splice_f32(const void* a, const void* x, void* out, long long L, long long Lx,
                              long long lo, long long shift, int C, void* stream) {
    return splice<float>(a, x, out, L, Lx, lo, shift, C, stream);
}
