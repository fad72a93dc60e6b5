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
// (a product and a sum a real tap, a rint, a product and two subtractions
// a sample), one thread a channel, so its latency, not bytes or operations,
// bounds it. Design: noise runs on a grid over B·C (~0.002 ms on the card at
// B = 2048, so a call's time is its launch and its wrapper's host path: one
// pass of checks, y and key' in one allocation, one ctypes call); the flat
// dither on one block. The shaped dither keeps only the chain serial: its loop is
// instantiated on the shape's real tap count (lipshitz 5 of the 9 slots,
// wan3 3, sloped and sloped2 1), so lipshitz's chain is 12 dependent
// operations a sample instead of 16, and the draws run beside it: in a
// block of up to 8 channels, four warps draw the noise and copy the input
// chunk by chunk into a ring in shared memory, up to four chunks ahead,
// while lanes of warp 0 run the chains, each loading 8 samples' inputs
// ahead of its chain.
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
// dither's feedback sums its taps in order, each product and sum rounded;
// dsp_tpu float32's XLA:CPU sums that dot in an order that changes with the
// block size (an FMA chain for lipshitz at B = 2048, in order at B = 1000),
// so a shaped float32 dither follows dsp_tpu float32 until one rounding
// flips a quantizer step, and the plain version exactly.
//
// The stream axis (batched processing): S independent streams in one
// launch, x and y [S, B, C], the key [S, 2], ehist [S, 9, C] and nprev
// [S, C] (n_mult, q0, q1, enabled, sel and fir are the effect's, one for
// all streams). Each stream has its own blocks, and its threads, counters
// (b·C + c, from key[s]) and order of operations are those of a
// one-stream launch: the same bits.

#include <cuda_runtime.h>

#include "rn.cuh"
#include "threefry.cuh"

namespace {

constexpr double PM_RAND_MAX = 2147483647.0;
constexpr int DITHER_FLAT = 0, DITHER_SHAPED = 1, DITHER_SLOPED2 = 2, TAPS = 9;

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
    const int s = blockIdx.y;  // the stream
    key_in += 2 * s;
    key_out += 2 * s;
    x += s * N;
    y += s * N;
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

// flat: one block draws and quantizes the whole [B, C] block in parallel
template <typename T>
__global__ void __launch_bounds__(512) tpdf_flat_kernel(const uint32_t* __restrict__ key_in,
                                   uint32_t* __restrict__ key_out, const T* __restrict__ x,
                                   T* __restrict__ y, const T* __restrict__ ehist_in,
                                   T* __restrict__ ehist_out, const T* __restrict__ nprev_in,
                                   T* __restrict__ nprev_out, const T* __restrict__ n_mult,
                                   const T* __restrict__ q0, const T* __restrict__ q1,
                                   const bool* __restrict__ enabled, int B, int C) {
    __shared__ uint32_t k[3][2];
    const int s = blockIdx.x;  // a block a stream
    const long long N = (long long)B * C;
    key_in += 2 * s;
    key_out += 2 * s;
    x += s * N;
    y += s * N;
    ehist_in += (size_t)s * TAPS * C;
    ehist_out += (size_t)s * TAPS * C;
    nprev_in += (size_t)s * C;
    nprev_out += (size_t)s * C;
    split3(key_in, k);
    const int tid = threadIdx.x;
    if (tid < 2) key_out[tid] = k[0][tid];
    for (long long i = tid; i < N; i += blockDim.x) {
        const int c = (int)(i % C);
        const T v = fma_rn(sub_rn(draw<T>(k[1], i), draw<T>(k[2], i)), n_mult[c], x[i]);
        y[i] = enabled[c] ? mul_rn(q1[c], rint_rn(mul_rn(q0[c], v))) : x[i];
    }
    for (int c = tid; c < C; c += blockDim.x) nprev_out[c] = nprev_in[c];
    for (int i = tid; i < TAPS * C; i += blockDim.x) ehist_out[i] = ehist_in[i];
}

// shaped and sloped2: a block of kChainCh channels, in two roles that meet
// at named barriers over a ring of kRing chunks of kChunk samples in shared
// memory. Warps 1-4 draw a chunk's noise and copy its input into the ring,
// up to kRing chunks ahead; lanes of warp 0 (one a channel) run the error
// feedback from the ring, 8 samples' inputs loaded ahead of the chain.
constexpr int kChainCh = 8;
constexpr int kChunk = 64;
constexpr int kRing = 4;
constexpr int kDrawWarps = 4;
constexpr int kShapedThreads = 32 * (1 + kDrawWarps);
constexpr int kAhead = 8;

__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kShapedThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
    __threadfence_block();
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kShapedThreads) : "memory");
}
// barrier ids: a ring slot is full (1 + slot) or free again (1 + kRing + slot)
__device__ __forceinline__ int full_bar(int slot) { return 1 + slot; }
__device__ __forceinline__ int free_bar(int slot) { return 1 + kRing + slot; }

// One sample of the feedback on NT taps: fb sums the taps in order, each
// product and sum rounded. NT is the shape's real tap count (1 sloped and
// sloped2, 3 wan3, 5 lipshitz, 9 wan9; taps past it are zero): leaving those
// zero taps out is exact for finite inputs, because fb starts at +0, a sum
// that starts at +0 is never -0, and fb + (±0) == fb. e keeps all 9 slots
// (the state's layout).
template <typename T, int NT>
__device__ __forceinline__ void feedback_step(T xn, T nn, const T (&f)[TAPS], T (&e)[TAPS], T qa,
                                              T qb, bool on, T* __restrict__ yp) {
    T fb = 0;
#pragma unroll
    for (int t = 0; t < NT; ++t) fb = add_rn(fb, mul_rn(f[t], e[t]));
    const T p0 = sub_rn(xn, fb);
    const T p1 = mul_rn(qb, rint_rn(mul_rn(qa, add_rn(p0, nn))));
#pragma unroll
    for (int t = TAPS - 1; t > 0; --t) e[t] = e[t - 1];
    e[0] = sub_rn(p1, p0);
    *yp = on ? p1 : xn;
}

// The feedback of one channel over one chunk of nb samples from the ring
// (xr, nr: the channel's column, kChainCh apart): whole groups of kAhead
// samples, each group's inputs loaded while the group before it runs, then
// the rest one by one.
template <typename T, int NT>
__device__ __forceinline__ void feedback_chunk(const T* __restrict__ xr, const T* __restrict__ nr,
                                               int nb, const T (&f)[TAPS], T (&e)[TAPS], T qa,
                                               T qb, bool on, T* __restrict__ yc, int C) {
    const int whole = nb - nb % kAhead;
    T xv[kAhead], nv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
        xv[u] = xr[u * kChainCh];
        nv[u] = nr[u * kChainCh];
    }
    for (int b0 = 0; b0 < whole; b0 += kAhead) {
        T xn_[kAhead], nn_[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            xn_[u] = xr[(b0 + kAhead + u) * kChainCh];
            nn_[u] = nr[(b0 + kAhead + u) * kChainCh];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
            feedback_step<T, NT>(xv[u], nv[u], f, e, qa, qb, on, yc + (size_t)(b0 + u) * C);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            xv[u] = xn_[u];
            nv[u] = nn_[u];
        }
    }
    for (int b = whole; b < nb; ++b)
        feedback_step<T, NT>(xr[b * kChainCh], nr[b * kChainCh], f, e, qa, qb, on,
                             yc + (size_t)b * C);
}

template <typename T>
__global__ void __launch_bounds__(kShapedThreads) tpdf_shaped_kernel(
    const uint32_t* __restrict__ key_in, uint32_t* __restrict__ key_out, const T* __restrict__ x,
    T* __restrict__ y, const T* __restrict__ ehist_in, T* __restrict__ ehist_out,
    const T* __restrict__ nprev_in, T* __restrict__ nprev_out, const T* __restrict__ n_mult,
    const T* __restrict__ q0, const T* __restrict__ q1, const bool* __restrict__ enabled,
    const T* __restrict__ fir, int mode, int B, int C) {
    // the ring: [kRing][kChunk + kAhead][kChainCh] inputs, then noise (the
    // kAhead rows past a chunk are read ahead and never used)
    constexpr int kSlot = (kChunk + kAhead) * kChainCh;
    __shared__ T ring_x[kRing * kSlot];
    __shared__ T ring_n[kRing * kSlot];
    __shared__ uint32_t k[3][2];
    {   // the stream: the grid's y index
        const int s = blockIdx.y;
        const size_t n = (size_t)B * C;
        key_in += 2 * s;
        key_out += 2 * s;
        x += s * n;
        y += s * n;
        ehist_in += (size_t)s * TAPS * C;
        ehist_out += (size_t)s * TAPS * C;
        nprev_in += (size_t)s * C;
        nprev_out += (size_t)s * C;
    }
    split3(key_in, k);
    const int c0 = blockIdx.x * kChainCh, cb = min(kChainCh, C - c0);
    if (blockIdx.x == 0 && threadIdx.x < 2) key_out[threadIdx.x] = k[0][threadIdx.x];
    const int nch = (B + kChunk - 1) / kChunk;
    if (threadIdx.x >= 32) {
        // the draws: chunk q into slot q % kRing, once the chain freed it
        const int t = threadIdx.x - 32, nt = kShapedThreads - 32;
        if (mode != DITHER_SLOPED2 && t < cb) nprev_out[c0 + t] = nprev_in[c0 + t];
        for (int q = 0; q < nch; ++q) {
            const int slot = q % kRing, nb = min(kChunk, B - q * kChunk);
            if (q >= kRing) bar_sync(free_bar(slot));
            T* xs = ring_x + slot * kSlot;
            T* ns = ring_n + slot * kSlot;
            for (int e = t; e < nb * cb; e += nt) {
                const int bl = e / cb, cl = e % cb, c = c0 + cl, b = q * kChunk + bl;
                const long long i = (long long)b * C + c;
                const T u1 = draw<T>(k[1], i);
                T v;
                if (mode == DITHER_SLOPED2) {
                    const T prev = b == 0 ? nprev_in[c] : draw<T>(k[1], i - C);
                    v = mul_rn(sub_rn(u1, prev), n_mult[c]);
                    if (b == B - 1) nprev_out[c] = u1;
                } else {
                    v = mul_rn(sub_rn(u1, draw<T>(k[2], i)), n_mult[c]);
                }
                ns[bl * kChainCh + cl] = v;
                xs[bl * kChainCh + cl] = x[i];
            }
            bar_arrive(full_bar(slot));
        }
        return;
    }
    // the chain: lane cl of warp 0 runs channel c0 + cl
    const int cl = threadIdx.x;
    const bool act = cl < cb;
    const int c = c0 + (act ? cl : 0);
    T e[TAPS], f[TAPS];
    int last = 0;  // the last nonzero tap + 1
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
        e[t] = act ? ehist_in[t * C + c] : (T)0;
        f[t] = fir[t];
        if (f[t] != 0) last = t + 1;
    }
    const int ntaps = last <= 1 ? 1 : last <= 3 ? 3 : last <= 5 ? 5 : 9;
    const T qa = q0[c], qb = q1[c];
    const bool on = enabled[c];
    for (int q = 0; q < nch; ++q) {
        const int slot = q % kRing, nb = min(kChunk, B - q * kChunk);
        bar_sync(full_bar(slot));
        if (act) {
            const T* xr = ring_x + slot * kSlot + cl;
            const T* nr = ring_n + slot * kSlot + cl;
            T* yc = y + (size_t)q * kChunk * C + c;
            if (ntaps == 1) {
                feedback_chunk<T, 1>(xr, nr, nb, f, e, qa, qb, on, yc, C);
            } else if (ntaps == 3) {
                feedback_chunk<T, 3>(xr, nr, nb, f, e, qa, qb, on, yc, C);
            } else if (ntaps == 5) {
                feedback_chunk<T, 5>(xr, nr, nb, f, e, qa, qb, on, yc, C);
            } else {
                feedback_chunk<T, 9>(xr, nr, nb, f, e, qa, qb, on, yc, C);
            }
        }
        __syncwarp();
        if (q + kRing < nch) bar_arrive(free_bar(slot));
    }
    if (act) {
#pragma unroll
        for (int t = 0; t < TAPS; ++t) ehist_out[t * C + c] = e[t];
    }
}

// The noise and dither kernels launched in this process (host side).
unsigned long long noise_launches = 0;
unsigned long long dither_launches = 0;

template <typename T>
int launch_noise(const uint32_t* key_in, uint32_t* key_out, const T* x, T* y, const bool* sel,
                 double mult, int B, int C, int S, void* stream) {
    if (B <= 0 || C <= 0 || S <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
    const long long N = (long long)B * C;
    const int T_ = 256;
    long long blocks = (N + T_ - 1) / T_;  // a stream's
    if (blocks > 1024) blocks = 1024;
    // mult in the sample type: dsp_tpu's jnp.asarray(mult, x.dtype)
    tpdf_noise_kernel<T><<<dim3((unsigned)blocks, S), T_, 0, static_cast<cudaStream_t>(stream)>>>(
        key_in, key_out, x, y, sel, (T)mult, N, C);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++noise_launches;
    return (int)err;
}

template <typename T>
int launch_dither(const uint32_t* key_in, uint32_t* key_out, const T* x, T* y,
                  const T* ehist_in, T* ehist_out, const T* nprev_in, T* nprev_out,
                  const T* n_mult, const T* q0, const T* q1, const bool* enabled, const T* fir,
                  int mode, int B, int C, int S, void* stream) {
    if (B <= 0 || C <= 0 || S <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mode == DITHER_FLAT) {
        tpdf_flat_kernel<T><<<S, 512, 0, st>>>(key_in, key_out, x, y, ehist_in, ehist_out,
                                                nprev_in, nprev_out, n_mult, q0, q1, enabled, B,
                                                C);
    } else if (mode == DITHER_SHAPED || mode == DITHER_SLOPED2) {
        tpdf_shaped_kernel<T><<<dim3((C + kChainCh - 1) / kChainCh, S), kShapedThreads, 0, st>>>(
            key_in, key_out, x, y, ehist_in, ehist_out, nprev_in, nprev_out, n_mult, q0, q1,
            enabled, fir, mode, B, C);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++dither_launches;
    return (int)err;
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success). The
// caller (dsp_tpu_torch/ops/time_domain.py) checks shapes, dtypes and
// contiguity. sel may be null: every channel, fused. mult is rounded to the
// sample type here. S streams: x and y [S, B, C], the keys [S, 2].
extern "C" int dsp_tpdf_noise_f64(const uint32_t* key_in, uint32_t* key_out, const double* x,
                                  double* y, const bool* sel, double mult, int B, int C,
                                  int S, void* stream) {
    return launch_noise<double>(key_in, key_out, x, y, sel, mult, B, C, S, stream);
}

extern "C" int dsp_tpdf_noise_f32(const uint32_t* key_in, uint32_t* key_out, const float* x,
                                  float* y, const bool* sel, double mult, int B, int C,
                                  int S, void* stream) {
    return launch_noise<float>(key_in, key_out, x, y, sel, mult, B, C, S, stream);
}

// The noise kernels dsp_tpdf_noise_f64 and _f32 have launched in this process.
extern "C" unsigned long long dsp_noise_launches() { return noise_launches; }

// The kernels dsp_tpdf_dither_f64 and _f32 have launched in this process.
extern "C" unsigned long long dsp_dither_launches() { return dither_launches; }

// S streams: x and y [S, B, C], the keys [S, 2], ehist [S, 9, C], nprev
// [S, C]; n_mult, q0, q1, enabled [C] and fir [9] one for all streams.

extern "C" int dsp_tpdf_dither_f64(const uint32_t* key_in, uint32_t* key_out, const double* x,
                                   double* y, const double* ehist_in, double* ehist_out,
                                   const double* nprev_in, double* nprev_out,
                                   const double* n_mult, const double* q0, const double* q1,
                                   const bool* enabled, const double* fir, int mode, int B,
                                   int C, int S, void* stream) {
    return launch_dither<double>(key_in, key_out, x, y, ehist_in, ehist_out, nprev_in,
                                 nprev_out, n_mult, q0, q1, enabled, fir, mode, B, C, S, stream);
}

extern "C" int dsp_tpdf_dither_f32(const uint32_t* key_in, uint32_t* key_out, const float* x,
                                   float* y, const float* ehist_in, float* ehist_out,
                                   const float* nprev_in, float* nprev_out,
                                   const float* n_mult, const float* q0, const float* q1,
                                   const bool* enabled, const float* fir, int mode, int B,
                                   int C, int S, void* stream) {
    return launch_dither<float>(key_in, key_out, x, y, ehist_in, ehist_out, nprev_in,
                                nprev_out, n_mult, q0, q1, enabled, fir, mode, B, C, S, stream);
}
