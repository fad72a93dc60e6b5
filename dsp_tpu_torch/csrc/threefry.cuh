// jax's threefry2x32 and its float64 and float32 uniforms, as device
// functions shared by the noise, dither and modulated-delay kernels
// (tpdf.cu, mod_delay.cu).
//
// dsp_tpu draws its noise with jax.random.split and jax.random.uniform
// under partitionable threefry counters, and both come down to one
// threefry2x32(key, counter) per element, the counter being the flat
// element index as (hi, lo) words:
//   split(key, n)[i]                = threefry2x32(key, (0, i));
//   uniform(key, shape, f64)[i]     = the top 52 bits of (x0 << 32) | x1 as
//                                     the mantissa of a float in [1, 2),
//                                     minus 1, times maxval;
//   uniform(key, shape, f32)[i]     = the top 23 bits of x0 ^ x1 as the
//                                     mantissa of a float32 in [1, 2),
//                                     minus 1, times float32(maxval), in
//                                     float32.
// The two dtypes draw different numbers from one key.
// Each thread computes its own elements' bits from the key and the index,
// with no state shared between threads. dsp_tpu_torch/core/prng.py is the
// plain version.

#pragma once

#include <cstdint>

namespace dsp_threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
    return (v << r) | (v >> (32 - r));
}

#define DSP_TF_ROUND(r)         \
    x0 += x1;                   \
    x1 = rotl(x1, r) ^ x0;

// threefry2x32 of (x0, x1) under key (k0, k1), in place: 20 rounds in 5
// groups of 4, key injections k0, k1, k2 = k0 ^ k1 ^ 0x1BD11BDA with
// + (i + 1) on the second word after group i.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
    DSP_TF_ROUND(13) DSP_TF_ROUND(15) DSP_TF_ROUND(26) DSP_TF_ROUND(6)
    x0 += k1;
    x1 += k2 + 1u;
    DSP_TF_ROUND(17) DSP_TF_ROUND(29) DSP_TF_ROUND(16) DSP_TF_ROUND(24)
    x0 += k2;
    x1 += k0 + 2u;
    DSP_TF_ROUND(13) DSP_TF_ROUND(15) DSP_TF_ROUND(26) DSP_TF_ROUND(6)
    x0 += k0;
    x1 += k1 + 3u;
    DSP_TF_ROUND(17) DSP_TF_ROUND(29) DSP_TF_ROUND(16) DSP_TF_ROUND(24)
    x0 += k1;
    x1 += k2 + 4u;
    DSP_TF_ROUND(13) DSP_TF_ROUND(15) DSP_TF_ROUND(26) DSP_TF_ROUND(6)
    x0 += k2;
    x1 += k0 + 5u;
}

#undef DSP_TF_ROUND

// jax.random.split(key, n)[i]
__device__ __forceinline__ void split(const uint32_t* key, uint32_t i, uint32_t* out) {
    uint32_t x0 = 0u, x1 = i;
    threefry2x32(key[0], key[1], x0, x1);
    out[0] = x0;
    out[1] = x1;
}

// element i of jax.random.uniform(key, shape, float64, 0, maxval): the
// mantissa (x0 << 20) | (x1 >> 12) is below 2^52, so (double)mant * 2^-52
// is exact and only the product with maxval rounds, as in jax
__device__ __forceinline__ double uniform_f64(uint32_t k0, uint32_t k1, unsigned long long i,
                                              double maxval) {
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    const unsigned long long mant = ((unsigned long long)x0 << 20) | (x1 >> 12);
    return __dmul_rn(__dmul_rn((double)mant, 0x1p-52), maxval);
}

// element i of jax.random.uniform(key, shape, float32, 0, maxval): 1.m - 1
// is exact, the product with maxval (a float32) rounds once, as in jax
__device__ __forceinline__ float uniform_f32(uint32_t k0, uint32_t k1, unsigned long long i,
                                             float maxval) {
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    const float one_m = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u);
    return __fmul_rn(__fsub_rn(one_m, 1.0f), maxval);
}

// the sample type's uniform: float64 draws for a float64 chain, float32
// draws for a float32 one
__device__ __forceinline__ double uniform(uint32_t k0, uint32_t k1, unsigned long long i,
                                          double maxval) {
    return uniform_f64(k0, k1, i, maxval);
}
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1, unsigned long long i,
                                         float maxval) {
    return uniform_f32(k0, k1, i, maxval);
}

}  // namespace dsp_threefry
