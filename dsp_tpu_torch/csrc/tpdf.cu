// K15 (TPDF dither) and K18-noise (TPDF noise), float64 and float32, for
// Hopper (sm_90a).
//
// Replaces dsp_tpu/effects/dither.py:107 `DitherEffect.step` and
// dsp_tpu/effects/noise.py:51 `NoiseEffect.step`. Both split the effect's
// threefry key in three (key', k1, k2) and draw two uniforms in
// [0, PM_RAND_MAX] for every (b, c) of the [B, C] block, from the counter
// b·C + c (threefry.cuh), so they add dsp_tpu's very numbers. The kernel
// splits the key itself and writes key' to the output state: nothing is
// read back on the host.
//   noise:  y = x + where(sel, (u1 - u2)·mult, 0)
//   dither: flat    y = q1·rint(q0·(x + (u1 - u2)·n_mult))
//           shaped  the 9-tap error-feedback quantizer, serial per channel:
//                   fb = Σ fir[t]·e[t];  p0 = x - fb;
//                   p1 = q1·rint(q0·(p0 + n));  e' = [p1 - p0, e[0..7]]
//           sloped2 the same, on the first difference of one uniform
//                   stream, carrying the block's last uniform (nprev).
//
// What bounds it on the card: the noise is 2 threefry2x32 calls (20 rounds
// of integer add, rotate, xor) per element, parallel over B·C, a few µs at
// B = 2048; the shaped dither is a dependent chain of B samples per channel
// (nine products and adds, a rint, a product and two subtractions a sample),
// one thread a channel, so its latency, not bytes or operations, bounds it.
// Design: noise runs on a grid over B·C. Dither is one block: all threads
// draw the block's noise into shared memory beside a copy of x (64 KB at
// B = 2048, C = 2; the noise goes to a scratch from the wrapper above
// 200 KB), then one thread a channel runs the feedback loop from there, so
// no global load sits in its chain.
//
// Rounding. rint rounds ties to even, as jnp.round does (CUDA's round goes
// away from zero). dsp_tpu's XLA fuses the flat dither's x + (u1 - u2)·n_mult
// and, with every channel selected, noise's x + (u1 - u2)·mult into one FMA,
// and rounds every other product and sum on its own; the kernel writes those
// two as __fma_rn and every other operation as __dmul_rn / __dadd_rn /
// __dsub_rn, so nvcc contracts nothing and a fed-back error never differs.
//
// float32 (dsp_tpdf_noise_f32, dsp_tpdf_dither_f32): the same kernels with
// T = float. The draws are jax's float32 uniform (threefry.cuh), whose
// numbers differ from the float64 one's, and every product and sum rounds
// to float32 where dsp_tpu float32 rounds, with the same two FMAs: noise
// and the flat dither equal dsp_tpu float32's bit for bit. The shaped
// dither's feedback sums its 9 taps in order, each product and sum rounded;
// dsp_tpu float32's XLA:CPU sums that dot in an order that changes with the
// block size (an FMA chain for lipshitz at B = 2048, in order at B = 1000),
// so a shaped float32 dither follows dsp_tpu float32 until one rounding
// flips a quantizer step, and the plain version exactly.

#include <cuda_runtime.h>

#include "rn.cuh"
#include "threefry.cuh"

namespace {

constexpr double PM_RAND_MAX = 2147483647.0;
constexpr int DITHER_FLAT = 0, DITHER_SHAPED = 1, DITHER_SLOPED2 = 2, TAPS = 9;
// the most dynamic shared memory the dither kernel asks for (kernels.py
// holds the same number)
constexpr int DITHER_SHARED_BYTES = 200 * 1024;

// key' and the two subkeys of split(key, 3), in shared memory
__device__ __forceinline__ void split3(const uint32_t* key, uint32_t (*k)[2]) {
    if (threadIdx.x < 3) dsp_threefry::split(key, threadIdx.x, k[threadIdx.x]);
    __syncthreads();
}

template <typename T>
__device__ __forceinline__ T draw(const uint32_t* k, long long i) {
    return dsp_threefry::uniform(k[0], k[1], (unsigned long long)i, (T)PM_RAND_MAX);
}

template <typename T>
__global__ void tpdf_noise_kernel(const uint32_t* __restrict__ key_in,
                                  uint32_t* __restrict__ key_out, const T* __restrict__ x,
                                  T* __restrict__ y, const bool* __restrict__ sel, T mult,
                                  long long N, int C) {
    __shared__ uint32_t k[3][2];
    split3(key_in, k);
    if (blockIdx.x == 0 && threadIdx.x < 2) key_out[threadIdx.x] = k[0][threadIdx.x];
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
         i += (long long)gridDim.x * blockDim.x) {
        const T d = sub_rn(draw<T>(k[1], i), draw<T>(k[2], i));
        if (sel == nullptr) {
            y[i] = fma_rn(d, mult, x[i]);
        } else {
            y[i] = add_rn(x[i], sel[i % C] ? mul_rn(d, mult) : (T)0);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(512) tpdf_dither_kernel(const uint32_t* __restrict__ key_in,
                                   uint32_t* __restrict__ key_out, const T* __restrict__ x,
                                   T* __restrict__ y, const T* __restrict__ ehist_in,
                                   T* __restrict__ ehist_out, const T* __restrict__ nprev_in,
                                   T* __restrict__ nprev_out, const T* __restrict__ n_mult,
                                   const T* __restrict__ q0, const T* __restrict__ q1,
                                   const bool* __restrict__ enabled,
                                   const T* __restrict__ fir, int mode, int B, int C,
                                   T* __restrict__ scratch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    __shared__ uint32_t k[3][2];
    split3(key_in, k);
    const int tid = threadIdx.x;
    if (tid < 2) key_out[tid] = k[0][tid];
    // the block's noise, and a copy of x for the serial loop, in shared
    // memory; or the noise in the scratch and x where it lies
    T* noise = scratch != nullptr ? scratch : smem;
    const long long N = (long long)B * C;
    const T* xl = scratch != nullptr ? x : smem + N;

    // 1. the block's noise (or, flat, the whole job), in parallel
    for (long long i = tid; i < N; i += blockDim.x) {
        const int c = (int)(i % C);
        const T u1 = draw<T>(k[1], i);
        if (mode == DITHER_SLOPED2) {
            const T prev = i < C ? nprev_in[c] : draw<T>(k[1], i - C);
            noise[i] = mul_rn(sub_rn(u1, prev), n_mult[c]);
            if (i >= N - C) nprev_out[c] = u1;
            if (scratch == nullptr) smem[N + i] = x[i];
            continue;
        }
        const T u2 = draw<T>(k[2], i);
        if (mode == DITHER_FLAT) {
            const T v = fma_rn(sub_rn(u1, u2), n_mult[c], x[i]);
            y[i] = enabled[c] ? mul_rn(q1[c], rint_rn(mul_rn(q0[c], v))) : x[i];
        } else {
            noise[i] = mul_rn(sub_rn(u1, u2), n_mult[c]);
        }
        if (scratch == nullptr && mode != DITHER_FLAT) smem[N + i] = x[i];
    }
    if (mode != DITHER_SLOPED2) {
        for (int c = tid; c < C; c += blockDim.x) nprev_out[c] = nprev_in[c];
    }
    if (mode == DITHER_FLAT) {
        for (int i = tid; i < TAPS * C; i += blockDim.x) ehist_out[i] = ehist_in[i];
        return;
    }
    __syncthreads();

    // 2. the error-feedback loop, one thread a channel, samples in order
    for (int c = tid; c < C; c += blockDim.x) {
        T e[TAPS], f[TAPS];
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
            e[t] = ehist_in[t * C + c];
            f[t] = fir[t];
        }
        const T qa = q0[c], qb = q1[c];
        const bool on = enabled[c];
        for (int b = 0; b < B; ++b) {
            const long long i = (long long)b * C + c;
            T fb = 0;
#pragma unroll
            for (int t = 0; t < TAPS; ++t) fb = add_rn(fb, mul_rn(f[t], e[t]));
            const T xn = xl[i];
            const T p0 = sub_rn(xn, fb);
            const T p1 = mul_rn(qb, rint_rn(mul_rn(qa, add_rn(p0, noise[i]))));
#pragma unroll
            for (int t = TAPS - 1; t > 0; --t) e[t] = e[t - 1];
            e[0] = sub_rn(p1, p0);
            y[i] = on ? p1 : xn;
        }
#pragma unroll
        for (int t = 0; t < TAPS; ++t) ehist_out[t * C + c] = e[t];
    }
}

template <typename T>
int launch_noise(const uint32_t* key_in, uint32_t* key_out, const T* x, T* y, const bool* sel,
                 double mult, int B, int C, void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    const long long N = (long long)B * C;
    const int T_ = 256;
    long long blocks = (N + T_ - 1) / T_;
    if (blocks > 1024) blocks = 1024;
    // mult in the sample type: dsp_tpu's jnp.asarray(mult, x.dtype)
    tpdf_noise_kernel<T><<<(int)blocks, T_, 0, static_cast<cudaStream_t>(stream)>>>(
        key_in, key_out, x, y, sel, (T)mult, N, C);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dither(const uint32_t* key_in, uint32_t* key_out, const T* x, T* y,
                  const T* ehist_in, T* ehist_out, const T* nprev_in, T* nprev_out,
                  const T* n_mult, const T* q0, const T* q1, const bool* enabled, const T* fir,
                  int mode, int B, int C, T* scratch, void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    const long long bytes = 2LL * B * C * (long long)sizeof(T);
    const size_t shmem = (mode == DITHER_FLAT || scratch != nullptr) ? 0 : (size_t)bytes;
    if (shmem > DITHER_SHARED_BYTES) return (int)cudaErrorInvalidValue;
    if (shmem > 48 * 1024) {
        // above 48 KB a block must opt in to its dynamic shared memory
        const cudaError_t err = cudaFuncSetAttribute(
            tpdf_dither_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            DITHER_SHARED_BYTES);
        if (err != cudaSuccess) return (int)err;
    }
    tpdf_dither_kernel<T><<<1, 512, shmem, static_cast<cudaStream_t>(stream)>>>(
        key_in, key_out, x, y, ehist_in, ehist_out, nprev_in, nprev_out, n_mult, q0, q1,
        enabled, fir, mode, B, C, scratch);
    return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success). The
// caller (dsp_tpu_torch/ops/time_domain.py) checks shapes, dtypes and
// contiguity. sel may be null: every channel, fused. mult is rounded to the
// sample type here.
extern "C" int dsp_tpdf_noise_f64(const uint32_t* key_in, uint32_t* key_out, const double* x,
                                  double* y, const bool* sel, double mult, int B, int C,
                                  void* stream) {
    return launch_noise<double>(key_in, key_out, x, y, sel, mult, B, C, stream);
}

extern "C" int dsp_tpdf_noise_f32(const uint32_t* key_in, uint32_t* key_out, const float* x,
                                  float* y, const bool* sel, double mult, int B, int C,
                                  void* stream) {
    return launch_noise<float>(key_in, key_out, x, y, sel, mult, B, C, stream);
}

// scratch: null when the block's noise and x fit the shared memory
// (2·B·C·sizeof(sample) <= DITHER_SHARED_BYTES) or mode is flat; else [B, C]
// of the sample type in device memory for the noise.
extern "C" int dsp_tpdf_dither_f64(const uint32_t* key_in, uint32_t* key_out, const double* x,
                                   double* y, const double* ehist_in, double* ehist_out,
                                   const double* nprev_in, double* nprev_out,
                                   const double* n_mult, const double* q0, const double* q1,
                                   const bool* enabled, const double* fir, int mode, int B,
                                   int C, double* scratch, void* stream) {
    return launch_dither<double>(key_in, key_out, x, y, ehist_in, ehist_out, nprev_in,
                                 nprev_out, n_mult, q0, q1, enabled, fir, mode, B, C, scratch,
                                 stream);
}

extern "C" int dsp_tpdf_dither_f32(const uint32_t* key_in, uint32_t* key_out, const float* x,
                                   float* y, const float* ehist_in, float* ehist_out,
                                   const float* nprev_in, float* nprev_out,
                                   const float* n_mult, const float* q0, const float* q1,
                                   const bool* enabled, const float* fir, int mode, int B,
                                   int C, float* scratch, void* stream) {
    return launch_dither<float>(key_in, key_out, x, y, ehist_in, ehist_out, nprev_in,
                                nprev_out, n_mult, q0, q1, enabled, fir, mode, B, C, scratch,
                                stream);
}
