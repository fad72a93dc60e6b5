// K8: the spectral fold of the rational resampler, complex128, for Hopper
// (sm_90a).
//
// Replaces the middle of dsp_tpu/ops/resample_ops.py:144
// `SpectralResampler.block` (:159-168): the gather of the input spectrum by
// the index walk's input bins, the two conj masks, the product with the
// prototype filter's spectrum and the segment sum into the out_len + 1
// output bins. The transforms on either side are fft_conv.cu's rfft_pack and
// irfft_crop; the inner blocks of a chain block are columns of one launch.
//
//   Y[l, c] = sum_{e in bin l} conj^c2( conj^c1( X[j_e, c] ) * s_e )
//
// The walk's output bin is not monotone (it bounces between bins 0 and
// out_len), so the host inverts it into a per-bin list (CSR) in table
// order: one thread per (bin, column) sums its entries in that order, with
// no atomics, so the result does not depend on the launch. The products
// and sums are written out with __dmul_rn / __dadd_rn / __dsub_rn, as
// (ac - bd) + (ad + bc)i: nvcc contracts nothing into an FMA, so each
// entry rounds as a plain complex product does.
//
// What bounds it on the card: it reads X (in_len + 1 rows) and the tables,
// and writes Y (out_len + 1 rows); at the main path's shapes (48 kHz: 589
// input and 641 output bins, 8 columns) a few hundred KB, so the launch,
// not bandwidth, bounds it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void resample_fold_kernel(const double2* __restrict__ X, double2* __restrict__ Y,
                                     const int* __restrict__ ptr, const int* __restrict__ j,
                                     const int* __restrict__ flags,
                                     const double2* __restrict__ s, int n_out, int ncol) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)n_out * ncol) return;
    const int l = (int)(i / ncol);
    const int c = (int)(i % ncol);
    double2 acc = make_double2(0.0, 0.0);
    for (int e = ptr[l]; e < ptr[l + 1]; ++e) {
        double2 x = X[(long long)j[e] * ncol + c];
        const int f = flags[e];
        if (f & 1) x.y = -x.y;
        const double2 w = s[e];
        double2 v = make_double2(__dsub_rn(__dmul_rn(x.x, w.x), __dmul_rn(x.y, w.y)),
                                 __dadd_rn(__dmul_rn(x.x, w.y), __dmul_rn(x.y, w.x)));
        if (f & 2) v.y = -v.y;
        acc.x = __dadd_rn(acc.x, v.x);
        acc.y = __dadd_rn(acc.y, v.y);
    }
    Y[i] = acc;
}

}  // namespace

// Y[n_out, ncol] from X[n_in, ncol] through the CSR tables ptr[n_out + 1],
// j, flags, s[ptr[n_out]]. Returns cudaGetLastError() after the launch (0
// on success). The caller (dsp_tpu_torch/ops/resample_ops.py) checks shapes,
// dtypes and contiguity.
extern "C" int dsp_resample_fold_c128(const void* X, void* Y, const int* ptr, const int* j,
                                      const int* flags, const void* s, int n_out, int ncol,
                                      void* stream) {
    if (n_out <= 0 || ncol <= 0) return (int)cudaErrorInvalidValue;
    const long long total = (long long)n_out * ncol;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    resample_fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double2*>(X), static_cast<double2*>(Y), ptr, j, flags,
        static_cast<const double2*>(s), n_out, ncol);
    return (int)cudaGetLastError();
}
