// float32 (hi, lo) pairs: the float32 mode's state leaves, read into float64
// registers and stored back split (dsp_tpu_torch/ops/iir.py's design: read
// float32, carry float64, store float32).
//
// A value v leaves a kernel as hi = float32(v), lo = float32(v - hi), so
// hi + lo holds v to about 48 bits and crosses to dsp_tpu's two-float32
// state unchanged. A float64 leaf is the same call with lo null.

#pragma once

template <class T>
__device__ __forceinline__ double pair_load(const T* hi, const T* lo, size_t i) {
    return lo == nullptr ? (double)hi[i] : (double)hi[i] + (double)lo[i];
}

template <class T>
__device__ __forceinline__ void pair_store(T* hi, T* lo, size_t i, double v) {
    const T h = (T)v;
    hi[i] = h;
    if (lo != nullptr) lo[i] = (T)(v - (double)h);
}
