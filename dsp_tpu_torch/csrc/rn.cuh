// Correctly rounded arithmetic in the sample type, one overload each for
// float64 and float32, for the kernels whose float32 forms must round where
// dsp_tpu float32 rounds (tpdf.cu, stats.cu, mod_delay.cu). The intrinsics
// are never contracted by nvcc: an FMA appears only where fma_rn is written. A
// kernel that takes a type T writes add_rn(a, b) for T's a + b.

#pragma once

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
// a·b + c rounded once
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
// ties to even, as jnp.round
__device__ __forceinline__ double rint_rn(double a) { return ::rint(a); }
__device__ __forceinline__ float rint_rn(float a) { return ::rintf(a); }

// fmin, fmax and fabs of the sample type
__device__ __forceinline__ double fmin_t(double a, double b) { return ::fmin(a, b); }
__device__ __forceinline__ float fmin_t(float a, float b) { return ::fminf(a, b); }
__device__ __forceinline__ double fmax_t(double a, double b) { return ::fmax(a, b); }
__device__ __forceinline__ float fmax_t(float a, float b) { return ::fmaxf(a, b); }
__device__ __forceinline__ double fabs_t(double a) { return ::fabs(a); }
__device__ __forceinline__ float fabs_t(float a) { return ::fabsf(a); }
