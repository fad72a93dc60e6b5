// K12 + K13: matrix4_mb's audio path, float64 or float32, for Hopper (sm_90a).
//
// Replaces dsp_tpu/effects/matrix4_mb.py:569 `_audio` (to the inverse
// fshape, which runs on K2) with its time-varying allpass `_ap1_lanes`
// (:778), and the interpolation of the control values to audio rate
// (:546-551). For each sample t of a block and band k:
//   vals[k, q] = (c2·u + c1)·u + c0 of set (t+1)/D of [interp_c | ics],
//                u = ((t+1) % D)/D   ([B, 13, 12] is never stored)
//   (s0, s1)   = band k delayed by len (the carried fb_buf, then the block)
//   l = s0·v0 + s1·v1,  r = s0·v2 + s1·v3,  ls = s0·v4 + s1·v5,
//   rs = s0·v6 + s1·v7
// then, with the phase flip, on each of the 26 surround lanes (ls of every
// band, then rs) the first-order allpass (allpass.h:46-56) with the
// time-varying coefficient v8 (ls) or v9 (rs), on the signal + 1e-15:
//   r = i0 + c0·(x - o0),  i0' = x,  o0' = r   (o0' = -c0·o0 + (i0 + c0·x))
// and - 1e-15 after it; last the band sums from band 0 up: l, r, ls, rs
// (times the ambience pan v10 with direct_path, which adds the direct pair
// ls·v11 and -(rs·v11) of the unflipped surrounds), each surround sum
// + 1e-15/324. The inverse fshape and the output columns follow on K2.
//
// What bounds it on the card: per sample it interpolates 13 x 12 values
// (reading 3 coefficient sets) and does about 10 operations a band; the
// allpasses are 26 chains of B samples. Latency for the chains, operations
// for the rest. Design: two launches.
//   1. m4mb_allpass, a warp a surround lane (26 blocks of 32): each lane
//      composes its segment of B/32 samples into one affine map of o0, a
//      shuffle scan gives each segment its start, and the lane reruns the
//      segment and writes the allpass output to the scratch row [26, B].
//      The input x is recomputed where it is needed (the sample before a
//      segment included), so nothing else is stored.
//   2. m4mb_sum, a thread a sample: the band sums and the offsets.
//
// float32 (`dsp_m4mb_audio_f32`, dsp_tpu's float32 _audio): the bands (the
// hi half of the bank's float32 (hi, lo) output), the line, the
// coefficient sets and the allpass states are float32, read into float64;
// the same float64 arithmetic runs, and the 4 or 6 signals and the states
// are stored rounded once to float32. Both kernels are templates on that
// storage type; the scratch rows stay float64.

#include <cuda_runtime.h>

struct MbAudioCfg {
    int len, D, phase_flip, direct;
};

namespace {

constexpr int kBands = 13;
constexpr int kSig = 12;
constexpr int kRow = kBands * kSig;

struct Map {
    double a, b;  // m -> a·m + b
};

__device__ Map exclusive_scan(Map f) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
        const double ao = __shfl_up_sync(full, f.a, d), bo = __shfl_up_sync(full, f.b, d);
        if (lane >= d) {
            f.b = f.a * bo + f.b;
            f.a = f.a * ao;
        }
    }
    Map pre = {__shfl_up_sync(full, f.a, 1), __shfl_up_sync(full, f.b, 1)};
    if (lane == 0) pre = {1.0, 0.0};
    return pre;
}

// value q of band k at sample t
template <class T>
__device__ __forceinline__ double interp_val(const T* __restrict__ interp_c,
                                             const T* __restrict__ ics, int t, int k, int q,
                                             int D) {
    const int set = (t + 1) / D;
    const double u = (double)((t + 1) % D) / (double)D;
    const T* c = (set == 0 ? interp_c : ics + (size_t)(set - 1) * 3 * kRow) + k * kSig + q;
    return ((double)c[2 * kRow] * u + (double)c[kRow]) * u + (double)c[0];
}

// band k's delayed pair at sample t
template <class T>
__device__ __forceinline__ void delayed(const T* __restrict__ bands, const T* __restrict__ fb_buf,
                                        int len, int t, int k, double& s0, double& s1) {
    const T* row = t < len ? fb_buf + ((size_t)t * kBands + k) * 2
                           : bands + ((size_t)(t - len) * kBands + k) * 2;
    s0 = (double)row[0];
    s1 = (double)row[1];
}

// surround lane j (ls of band j for j < 13, else rs of band j - 13) at t:
// the allpass input (the matrix output + 1e-15) and its coefficient
template <class T>
__device__ __forceinline__ void lane_input(const T* bands, const T* fb_buf, const T* interp_c,
                                           const T* ics, const MbAudioCfg& cfg, int j, int t,
                                           double& x, double& c0) {
    const int k = j < kBands ? j : j - kBands;
    const int q = j < kBands ? 4 : 6;
    double s0, s1;
    delayed(bands, fb_buf, cfg.len, t, k, s0, s1);
    x = (s0 * interp_val(interp_c, ics, t, k, q, cfg.D) +
         s1 * interp_val(interp_c, ics, t, k, q + 1, cfg.D)) + 1e-15;
    c0 = interp_val(interp_c, ics, t, k, j < kBands ? 8 : 9, cfg.D);
}

template <class T>
__global__ void m4mb_allpass(const T* __restrict__ bands, const T* __restrict__ fb_buf,
                             const T* __restrict__ interp_c, const T* __restrict__ ics,
                             const T* __restrict__ pf_in, T* __restrict__ pf_out,
                             double* __restrict__ scratch, MbAudioCfg cfg, int B) {
    const int j = blockIdx.x;  // the surround lane
    const int lane = threadIdx.x;
    // pf [13, 2, 2]: (band, ls or rs, (i0, o0))
    const int st = (j < kBands ? j * 2 : (j - kBands) * 2 + 1) * 2;
    const int seg = B / 32;  // B % 32 == 0 (the host checks)
    const int t0 = lane * seg, t1 = t0 + seg;
    double x_prev, c0;
    if (t0 == 0) {
        x_prev = (double)pf_in[st];
    } else {
        lane_input(bands, fb_buf, interp_c, ics, cfg, j, t0 - 1, x_prev, c0);
    }
    // 1. this segment's map of o0
    Map f = {1.0, 0.0};
    double i0 = x_prev;
    for (int t = t0; t < t1; ++t) {
        double x;
        lane_input(bands, fb_buf, interp_c, ics, cfg, j, t, x, c0);
        f.b = -c0 * f.b + (i0 + c0 * x);
        f.a = -c0 * f.a;
        i0 = x;
    }
    // 2. the start of each segment, 3. the rerun
    const Map pre = exclusive_scan(f);
    double o0 = pre.a * (double)pf_in[st + 1] + pre.b;
    i0 = x_prev;
    double* y = scratch + (size_t)j * B;
    for (int t = t0; t < t1; ++t) {
        double x;
        lane_input(bands, fb_buf, interp_c, ics, cfg, j, t, x, c0);
        const double r = i0 + c0 * (x - o0);
        y[t] = r - 1e-15;
        o0 = r;
        i0 = x;
    }
    if (lane == 31) {
        pf_out[st] = (T)i0;
        pf_out[st + 1] = (T)o0;
    }
}

template <class T>
__global__ void m4mb_sum(const T* __restrict__ bands, const T* __restrict__ fb_buf,
                         const T* __restrict__ interp_c, const T* __restrict__ ics,
                         const double* __restrict__ scratch, T* __restrict__ sig, MbAudioCfg cfg,
                         int B) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    double out_l = 0.0, out_r = 0.0, out_ls = 0.0, out_rs = 0.0, dir_ls = 0.0, dir_rs = 0.0;
    for (int k = 0; k < kBands; ++k) {
        double s0, s1;
        delayed(bands, fb_buf, cfg.len, t, k, s0, s1);
        double v[kSig];
        for (int q = 0; q < kSig; ++q) v[q] = interp_val(interp_c, ics, t, k, q, cfg.D);
        const double b_l = s0 * v[0] + s1 * v[1];
        const double b_r = s0 * v[2] + s1 * v[3];
        const double b_ls = s0 * v[4] + s1 * v[5];
        const double b_rs = s0 * v[6] + s1 * v[7];
        const double ls_pf = cfg.phase_flip ? scratch[(size_t)k * B + t] : b_ls;
        const double rs_pf = cfg.phase_flip ? scratch[(size_t)(kBands + k) * B + t] : b_rs;
        const double ls = cfg.direct ? ls_pf * v[10] : ls_pf;
        const double rs = cfg.direct ? rs_pf * v[10] : rs_pf;
        out_l = k == 0 ? b_l : out_l + b_l;
        out_r = k == 0 ? b_r : out_r + b_r;
        out_ls = k == 0 ? ls : out_ls + ls;
        out_rs = k == 0 ? rs : out_rs + rs;
        if (cfg.direct) {
            dir_ls = k == 0 ? b_ls * v[11] : dir_ls + b_ls * v[11];
            dir_rs = k == 0 ? b_rs * v[11] : dir_rs + b_rs * v[11];
        }
    }
    constexpr double eps = 1e-15 / 324;
    const int n = cfg.direct ? 6 : 4;
    T* row = sig + (size_t)t * n;
    row[0] = (T)out_l;
    row[1] = (T)out_r;
    row[2] = (T)(out_ls + eps);
    row[3] = (T)(out_rs + eps);
    if (cfg.direct) {
        row[4] = (T)(dir_ls + eps);
        row[5] = (T)(-dir_rs + eps);
    }
}

template <class T>
__global__ void copy_state(const T* __restrict__ in, T* __restrict__ out, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
}

template <class T>
int launch(const T* bands, const T* fb_buf, const T* interp_c, const T* ics, const T* pf_in,
           T* sig, T* pf_out, double* scratch, const MbAudioCfg* cfg, int B, void* stream) {
    if (B <= 0 || B % 32 || cfg->D <= 0 || B % cfg->D || cfg->len < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cfg->phase_flip) {
        m4mb_allpass<T><<<2 * kBands, 32, 0, st>>>(bands, fb_buf, interp_c, ics, pf_in, pf_out,
                                                    scratch, *cfg, B);
    } else {
        copy_state<T><<<1, 64, 0, st>>>(pf_in, pf_out, kBands * 4);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    m4mb_sum<T><<<(B + 127) / 128, 128, 0, st>>>(bands, fb_buf, interp_c, ics, scratch, sig,
                                                  *cfg, B);
    return (int)cudaGetLastError();
}

}  // namespace

// bands [B, 13, 2], fb_buf [len, 13, 2], interp_c [3, 13, 12], ics
// [B/D, 3, 13, 12], pf [13, 2, 2] in and out, sig [B, 4 or 6], scratch
// [26, B]. Returns cudaGetLastError() after the launches (0 on success). The
// caller (dsp_tpu_torch/ops/m4_engine.py) checks shapes, dtypes and
// contiguity.
extern "C" int dsp_m4mb_audio_f64(const double* bands, const double* fb_buf,
                                  const double* interp_c, const double* ics, const double* pf_in,
                                  double* sig, double* pf_out, double* scratch,
                                  const MbAudioCfg* cfg, int B, void* stream) {
    return launch<double>(bands, fb_buf, interp_c, ics, pf_in, sig, pf_out, scratch, cfg, B,
                          stream);
}

// The same with the bands, the line, the coefficient sets, the states and
// the signals float32 (scratch float64).
extern "C" int dsp_m4mb_audio_f32(const float* bands, const float* fb_buf, const float* interp_c,
                                  const float* ics, const float* pf_in, float* sig, float* pf_out,
                                  double* scratch, const MbAudioCfg* cfg, int B, void* stream) {
    return launch<float>(bands, fb_buf, interp_c, ics, pf_in, sig, pf_out, scratch, cfg, B,
                         stream);
}
