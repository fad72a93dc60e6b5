// K12 + K13: matrix4's audio path, float64 or float32, for Hopper (sm_90a).
//
// Replaces dsp_tpu/effects/matrix4.py:597 `_audio` with its time-varying
// scans `_dyn_shelf_block` (:673) and `_ap1_block` (:699), and the
// interpolation of the control values to audio rate (:576-581). For each
// sample t of a block:
//   vals[k]  = (c2[k]·u + c1[k])·u + c0[k], set (t+1)/D of [interp_c | ics],
//              u = ((t+1) % D)/D
//   (s0, s1) = the selected pair delayed by len (the carried line, then the
//              block)
//   l = s0·v0 + s1·v1,  r = s0·v2 + s1·v3,  ls = s0·v4 + s1·v5 + 1e-15,
//   rs = s0·v6 + s1·v7 + 1e-15
// then on each of l, r, ls, rs the dynamic shelf and the dynamic lowpass
// (each skipped when its mult is 1), first-order recurrences with a
// constant pole and time-varying input terms
//   r = c0s + m,  m' = -c2·m + (c1s - c2·c0s)
// and on ls and rs the phase-flip allpass (ap1, allpass.h:46-56) with a
// time-varying coefficient c0:
//   r = i0 + c0·(x - o0),  i0' = x,  o0' = r   (o0' = -c0·o0 + (i0 + c0·x))
// and last the output columns: the pass-through channels, l and r at the
// pair's columns, and the surround pair (times the ambience and direct pans
// with direct_path).
//
// What bounds it on the card: each of the four signals is a chain of B
// samples through up to three recurrences; the block reads 16·B bytes of
// input and writes 32·B or 48·B. Latency, not bytes. Design: one block of
// four warps, a warp a signal, as in levels.cu: for each recurrence each
// lane composes its segment of B/32 samples into one affine map, a shuffle
// scan gives each segment its start state, and the lane reruns its segment.
// Between the recurrences a signal lives in a scratch row [4, B] (the lane
// that wrote a sample reads it back; the allpass also reads the sample
// before its segment, after a warp barrier).
//
// float32 (`dsp_m4_audio_f32`, dsp_tpu's float32 _audio): x, the line, the
// coefficient sets and the filter states are float32, read into float64;
// the same float64 arithmetic runs, and y and the states are stored
// rounded once to float32. The kernel is a template on that storage type.

#include <cuda_runtime.h>

struct AudioCfg {
    double shelf_sin, shelf_cos1, shelf_norm, shelf_c2;
    double lp_sin, lp_cos1, lp_norm, lp_c2;
    int c0, c1, n_in, n_out, len, D, shelf_on, lp_on, phase_flip, direct;
};

namespace {

constexpr int kInterp = 16;

struct Map {
    double a, b;  // m -> a·m + b
};

// an inclusive scan of the lanes' maps, shifted to exclusive: the map from
// the warp's start to this lane's segment start
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

template <class T>
__device__ __forceinline__ double interp_val(const T* interp_c, const T* ics, int t, int k,
                                             int D) {
    const int set = (t + 1) / D;
    const double u = (double)((t + 1) % D) / (double)D;
    const T* c = set == 0 ? interp_c : ics + (size_t)(set - 1) * 3 * kInterp;
    return ((double)c[2 * kInterp + k] * u + (double)c[kInterp + k]) * u + (double)c[k];
}

// one dynamic shelf (or lowpass) over the warp's signal in `sig`, in place
template <class T>
__device__ void dyn_shelf(double* sig, const T* interp_c, const T* ics, int gk, double sin_w0,
                          double cos1, double norm, double c2, double m0, T* m_out, int t0,
                          int t1, int D) {
    const double a = -c2;
    Map f = {1.0, 0.0};
    for (int t = t0; t < t1; ++t) {
        const double g = interp_val(interp_c, ics, t, gk, D);
        const double sn = sig[t] * norm;
        const double gcp1 = g * cos1;
        const double c0s = (sin_w0 + gcp1) * sn;
        const double c1s = (sin_w0 - gcp1) * sn;
        f.b = a * f.b + (c1s - c2 * c0s);
        f.a = a * f.a;
    }
    const Map pre = exclusive_scan(f);
    double m = pre.a * m0 + pre.b;
    for (int t = t0; t < t1; ++t) {
        const double g = interp_val(interp_c, ics, t, gk, D);
        const double sn = sig[t] * norm;
        const double gcp1 = g * cos1;
        const double c0s = (sin_w0 + gcp1) * sn;
        const double c1s = (sin_w0 - gcp1) * sn;
        sig[t] = c0s + m;
        m = a * m + (c1s - c2 * c0s);
    }
    if ((threadIdx.x & 31) == 31) *m_out = (T)m;
}

template <class T>
__global__ void m4_audio_kernel(const T* __restrict__ x, const T* __restrict__ buf,
                                const T* __restrict__ interp_c, const T* __restrict__ ics,
                                const T* __restrict__ shelf_in, const T* __restrict__ lp_in,
                                const T* __restrict__ pf_in, T* __restrict__ y,
                                T* __restrict__ shelf_out, T* __restrict__ lp_out,
                                T* __restrict__ pf_out, double* __restrict__ scratch,
                                AudioCfg cfg, int B) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int seg = B / 32;  // B % 32 == 0 (the host checks)
    const int t0 = lane * seg, t1 = t0 + seg;
    const int D = cfg.D;
    double* sig = scratch + (size_t)w * B;
    // the matrix: signal w from the delayed pair
    const int ka = 2 * w, kb = 2 * w + 1;
    const double eps = w >= 2 ? 1e-15 : 0.0;
    for (int t = t0; t < t1; ++t) {
        double s0, s1;
        if (t < cfg.len) {
            s0 = (double)buf[2 * t];
            s1 = (double)buf[2 * t + 1];
        } else {
            const T* row = x + (size_t)(t - cfg.len) * cfg.n_in;
            s0 = (double)row[cfg.c0];
            s1 = (double)row[cfg.c1];
        }
        const double v = s0 * interp_val(interp_c, ics, t, ka, D) + s1 * interp_val(interp_c, ics, t, kb, D);
        sig[t] = w >= 2 ? v + eps : v;
    }
    if (cfg.shelf_on) {
        dyn_shelf(sig, interp_c, ics, w < 2 ? 10 : 8, cfg.shelf_sin, cfg.shelf_cos1,
                  cfg.shelf_norm, cfg.shelf_c2, (double)shelf_in[w], shelf_out + w, t0, t1, D);
    } else if (lane == 31) {
        shelf_out[w] = shelf_in[w];
    }
    if (cfg.lp_on) {
        dyn_shelf(sig, interp_c, ics, w < 2 ? 11 : 9, cfg.lp_sin, cfg.lp_cos1, cfg.lp_norm,
                  cfg.lp_c2, (double)lp_in[w], lp_out + w, t0, t1, D);
    } else if (lane == 31) {
        lp_out[w] = lp_in[w];
    }
    if (w < 2) {
        const int col = w == 0 ? cfg.c0 : cfg.c1;
        for (int t = t0; t < t1; ++t) y[(size_t)t * cfg.n_out + col] = (T)sig[t];
    } else {
        const int k = w - 2;  // 0: ls, 1: rs
        __syncwarp();
        double o0 = 0.0;
        if (cfg.phase_flip) {
            // the o0 chain: o0' = -c0·o0 + (i0 + c0·x), i0 the sample before
            const int ck = 12 + k;
            Map f = {1.0, 0.0};
            for (int t = t0; t < t1; ++t) {
                const double c0 = interp_val(interp_c, ics, t, ck, D);
                const double i0 = t == 0 ? (double)pf_in[2 * k] : sig[t - 1];
                f.b = -c0 * f.b + (i0 + c0 * sig[t]);
                f.a = -c0 * f.a;
            }
            const Map pre = exclusive_scan(f);
            o0 = pre.a * (double)pf_in[2 * k + 1] + pre.b;
        }
        for (int t = t0; t < t1; ++t) {
            const double s = sig[t];
            double pf = s;
            if (cfg.phase_flip) {
                const double c0 = interp_val(interp_c, ics, t, 12 + k, D);
                const double i0 = t == 0 ? (double)pf_in[2 * k] : sig[t - 1];
                pf = i0 + c0 * (s - o0);
                o0 = pf;
            }
            T* row = y + (size_t)t * cfg.n_out + cfg.n_in;
            if (cfg.direct) {
                const double amb = interp_val(interp_c, ics, t, 14, D);
                const double dire = interp_val(interp_c, ics, t, 15, D);
                row[k] = (T)((pf - 1e-15) * amb);
                row[2 + k] = (T)(k == 0 ? (s - 1e-15) * dire : -(s - 1e-15) * dire);
            } else {
                row[k] = (T)(pf - 1e-15);
            }
        }
        if (lane == 31) {
            pf_out[2 * k] = cfg.phase_flip ? (T)sig[B - 1] : pf_in[2 * k];
            pf_out[2 * k + 1] = cfg.phase_flip ? (T)o0 : pf_in[2 * k + 1];
        }
    }
    // the pass-through channels
    for (int i = threadIdx.x; i < B * cfg.n_in; i += blockDim.x) {
        const int t = i / cfg.n_in, c = i % cfg.n_in;
        if (c != cfg.c0 && c != cfg.c1) y[(size_t)t * cfg.n_out + c] = x[i];
    }
}

template <class T>
int launch(const T* x, const T* buf, const T* interp_c, const T* ics, const T* shelf_in,
           const T* lp_in, const T* pf_in, T* y, T* shelf_out, T* lp_out, T* pf_out,
           double* scratch, const AudioCfg* cfg, int B, void* stream) {
    if (B <= 0 || B % 32 || cfg->D <= 0 || B % cfg->D || cfg->n_in < 2) {
        return (int)cudaErrorInvalidValue;
    }
    m4_audio_kernel<T><<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        x, buf, interp_c, ics, shelf_in, lp_in, pf_in, y, shelf_out, lp_out, pf_out, scratch,
        *cfg, B);
    return (int)cudaGetLastError();
}

}  // namespace

// x [B, n_in], buf [len, 2], interp_c [3, 16], ics [B/D, 3, 16], the states
// shelf, lp [4] and pf [2, 2] in and out, y [B, n_out], scratch [4, B].
// Returns cudaGetLastError() after the launch (0 on success). The caller
// (dsp_tpu_torch/ops/m4_engine.py) checks shapes, dtypes and contiguity.
extern "C" int dsp_m4_audio_f64(const double* x, const double* buf, const double* interp_c,
                                const double* ics, const double* shelf_in, const double* lp_in,
                                const double* pf_in, double* y, double* shelf_out, double* lp_out,
                                double* pf_out, double* scratch, const AudioCfg* cfg, int B,
                                void* stream) {
    return launch<double>(x, buf, interp_c, ics, shelf_in, lp_in, pf_in, y, shelf_out, lp_out,
                          pf_out, scratch, cfg, B, stream);
}

// The same with every input, output and state float32 (scratch float64).
extern "C" int dsp_m4_audio_f32(const float* x, const float* buf, const float* interp_c,
                                const float* ics, const float* shelf_in, const float* lp_in,
                                const float* pf_in, float* y, float* shelf_out, float* lp_out,
                                float* pf_out, double* scratch, const AudioCfg* cfg, int B,
                                void* stream) {
    return launch<float>(x, buf, interp_c, ics, shelf_in, lp_in, pf_in, y, shelf_out, lp_out,
                         pf_out, scratch, cfg, B, stream);
}
