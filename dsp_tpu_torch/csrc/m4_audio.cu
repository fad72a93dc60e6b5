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
// input and writes 32·B or 48·B. Latency, not bytes.
//
// Design: one block of 1,024 threads, 256 a signal (warps 8s..8s+7 run
// signal s), over tiles of TILE = 2,048 samples in time; a thread owns a
// segment of SEG = 8 samples of each tile. A tile's signals live in shared
// memory (sig, beside a second row aux a signal: 130 KB), loaded with
// coalesced reads of the line and x, and its rows of y are written from
// there in one coalesced pass with the pass-through channels. For each
// recurrence a thread folds its segment into one affine map, computing each
// sample's interpolated value and input term once (the rerun reads them
// from aux); a shuffle scan inside each warp gives the maps from the
// warp's start; one thread a signal carries the recurrence's value across
// the signal's warps in order, m <- A·m + b (eight steps a tile), and
// from tile to tile; each thread reruns its segment from its start value.
// So the grouping of the rounding is set by the segments and the warps of
// 32 segments alone: the tiling and the thread count do not move a bit
// (tests/test_torch_m4_audio_partition.py models it). The interpolation
// takes u from a 32-entry table of ((t+1) % D)/D (the same division) and
// the set from a shift (the host checks D = 32), from the tile's 65
// coefficient sets staged in shared memory as float64. A tile sits in
// shared memory by position in the segment (`at`), so that neither the
// segment walks nor the coalesced passes conflict on banks. A block of
// 65,536 is 32 tiles of the same work on the one block.
//
// The stream axis (batched processing): S independent streams in one
// launch, a block each (block s: stream s's x, line, coefficient sets,
// states and y), each running a one-stream launch's tiles: the same bits.
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
constexpr int kD = 32;            // the control decimation (ops/m4_engine.py)
constexpr int kThreads = 1024;    // the block
constexpr int kSigThreads = 256;  // a signal's threads
constexpr int kWarps = kSigThreads / 32;
constexpr int kSeg = 8;           // a thread's samples in a tile
constexpr int kTile = kSigThreads * kSeg;
// a tile's signal sits in shared memory by position in the segment first:
// sample r at (r % SEG)·kStride + r / SEG, so that a warp walking its
// segments touches consecutive words, and one reading consecutive samples
// touches 16 distinct ones (the padding of 4)
constexpr int kStride = kSigThreads + 4;
constexpr int kRow = kSeg * kStride;

__device__ __forceinline__ int at(int r) { return (r & (kSeg - 1)) * kStride + (r >> 3); }
// the tile's coefficient sets, in float64, one row each (48 values and a
// pad: rows an odd number of words apart)
constexpr int kSets = kTile / kD + 1;
constexpr int kSetStride = 3 * kInterp + 1;

struct Map {
    double a, b;  // m -> a·m + b
};

// the shared memory of a block: a tile's signals, their aux rows, its
// coefficient sets, the u table, the warps' totals and start values, and
// the carried values
struct Smem {
    double sig[4][kRow];
    double aux[4][kRow];
    double sets[kSets][kSetStride];
    double u[kD];
    Map total[4][kWarps];
    double start[4][kWarps];
    double carry[4][4];  // shelf m, lowpass m, allpass o0, allpass i0
};

// the inclusive scan of the lanes' maps (f on return), and the exclusive
// one returned: the map from the warp's start to this lane's segment start
__device__ __forceinline__ Map warp_scan(Map& f) {
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

// the start value of every segment, from each thread's segment map f (of
// signal sg, on when `on`): returns this thread's start value and carries
// the signal's value in sm.carry[sg][slot] across the tile. Every thread
// of the block calls it (two barriers).
__device__ __forceinline__ double segment_start(Smem& sm, Map f, int sg, int slot, bool on) {
    const int j = threadIdx.x & (kSigThreads - 1), wl = j >> 5;
    const Map pre = warp_scan(f);
    if ((threadIdx.x & 31) == 31) sm.total[sg][wl] = f;
    __syncthreads();
    if (j == 0 && on) {
        double v = sm.carry[sg][slot];
        for (int w = 0; w < kWarps; ++w) {
            sm.start[sg][w] = v;
            v = sm.total[sg][w].a * v + sm.total[sg][w].b;
        }
        sm.carry[sg][slot] = v;
    }
    __syncthreads();
    return pre.a * sm.start[sg][wl] + pre.b;
}

// the interpolated value k of sample t of the tile at t0: set (t+1)/D of
// [interp_c | ics], staged in sm.sets from set t0/D on
__device__ __forceinline__ double interp_val(const Smem& sm, int t0, int t, int k) {
    const double u = sm.u[(t + 1) & (kD - 1)];
    const double* c = sm.sets[((t + 1) >> 5) - (t0 >> 5)];
    return (c[2 * kInterp + k] * u + c[kInterp + k]) * u + c[k];
}

// one dynamic shelf (or lowpass) over the tile's four signals, in place:
// r = c0s + m, m' = -c2·m + (c1s - c2·c0s)
__device__ void dyn_shelf(Smem& sm, int gk_front, int gk_surr,
                          double sin_w0, double cos1, double norm, double c2, int slot, int t0,
                          int n) {
    const int sg = threadIdx.x / kSigThreads, j = threadIdx.x & (kSigThreads - 1);
    const int i0 = j * kSeg;
    const bool full = i0 < n;  // n is a multiple of 32: a segment is full or empty
    const int gk = sg < 2 ? gk_front : gk_surr;
    double* x = sm.sig[sg];
    double* b = sm.aux[sg];
    const double a = -c2;
    Map f = {1.0, 0.0};
    if (full) {
#pragma unroll
        for (int i = i0; i < i0 + kSeg; ++i) {
            const double g = interp_val(sm, t0, t0 + i, gk);
            const double sn = x[at(i)] * norm;
            const double gcp1 = g * cos1;
            const double c0s = (sin_w0 + gcp1) * sn;
            const double c1s = (sin_w0 - gcp1) * sn;
            const double bi = c1s - c2 * c0s;
            x[at(i)] = c0s;
            b[at(i)] = bi;
            f.b = a * f.b + bi;
            f.a = a * f.a;
        }
    }
    double m = segment_start(sm, f, sg, slot, true);
    if (full) {
#pragma unroll
        for (int i = i0; i < i0 + kSeg; ++i) {
            x[at(i)] = x[at(i)] + m;
            m = a * m + b[at(i)];
        }
    }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
m4_audio_kernel(const T* __restrict__ x, const T* __restrict__ buf, const T* __restrict__ interp_c,
                const T* __restrict__ ics, const T* __restrict__ shelf_in,
                const T* __restrict__ lp_in, const T* __restrict__ pf_in, T* __restrict__ y,
                T* __restrict__ shelf_out, T* __restrict__ lp_out, T* __restrict__ pf_out,
                AudioCfg cfg, int B) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int tid = threadIdx.x;
    const int sg = tid / kSigThreads, j = tid & (kSigThreads - 1);
    {   // stream blockIdx.x's tensors
        const size_t s = blockIdx.x;
        x += s * B * cfg.n_in;
        buf += s * cfg.len * 2;
        interp_c += s * 3 * kInterp;
        ics += s * (B / kD) * 3 * kInterp;
        shelf_in += s * 4;
        lp_in += s * 4;
        pf_in += s * 4;
        y += s * B * cfg.n_out;
        shelf_out += s * 4;
        lp_out += s * 4;
        pf_out += s * 4;
    }
    if (tid < kD) sm.u[tid] = (double)tid / (double)kD;
    if (tid < 4) {
        sm.carry[tid][0] = (double)shelf_in[tid];
        sm.carry[tid][1] = (double)lp_in[tid];
        sm.carry[tid][2] = tid >= 2 ? (double)pf_in[2 * (tid - 2) + 1] : 0.0;
        sm.carry[tid][3] = tid >= 2 ? (double)pf_in[2 * (tid - 2)] : 0.0;
    }
    __syncthreads();
    const int n_in = cfg.n_in, n_out = cfg.n_out;
    for (int t0 = 0; t0 < B; t0 += kTile) {
        const int n = min(kTile, B - t0);
        // the tile's coefficient sets t0/D .. (t0 + n)/D
        const int set0 = t0 >> 5, nsets = (n >> 5) + 1;
        for (int idx = tid; idx < nsets * 3 * kInterp; idx += kThreads) {
            const int k = idx / (3 * kInterp), gs = set0 + k;
            const T* c = gs == 0 ? interp_c : ics + (size_t)(gs - 1) * 3 * kInterp;
            sm.sets[k][idx - k * 3 * kInterp] = (double)c[idx - k * 3 * kInterp];
        }
        __syncthreads();
        // the matrix: the four signals from the delayed pair, a thread a
        // sample (coalesced)
        for (int i = tid; i < n; i += kThreads) {
            const int t = t0 + i;
            double s0, s1;
            if (t < cfg.len) {
                s0 = (double)buf[2 * t];
                s1 = (double)buf[2 * t + 1];
            } else {
                const T* row = x + (size_t)(t - cfg.len) * n_in;
                s0 = (double)row[cfg.c0];
                s1 = (double)row[cfg.c1];
            }
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                const double v = s0 * interp_val(sm, t0, t, 2 * w)
                                 + s1 * interp_val(sm, t0, t, 2 * w + 1);
                sm.sig[w][at(i)] = w >= 2 ? v + 1e-15 : v;
            }
        }
        __syncthreads();
        if (cfg.shelf_on) {
            dyn_shelf(sm, 10, 8, cfg.shelf_sin, cfg.shelf_cos1, cfg.shelf_norm,
                      cfg.shelf_c2, 0, t0, n);
            __syncthreads();
        }
        if (cfg.lp_on) {
            dyn_shelf(sm, 11, 9, cfg.lp_sin, cfg.lp_cos1, cfg.lp_norm, cfg.lp_c2, 1,
                      t0, n);
            __syncthreads();
        }
        const int i0 = j * kSeg;
        const bool full = i0 < n;
        if (cfg.phase_flip) {
            // the allpass on ls and rs: o0' = -c0·o0 + (i0 + c0·x), i0 the
            // sample before (the carried one before the tile); aux keeps
            // c0, then the output
            const bool on = sg >= 2;
            double* xs = sm.sig[sg];
            double* c0s = sm.aux[sg];
            const int ck = 12 + (sg & 1);
            Map f = {1.0, 0.0};
            if (on && full) {
                double in0 = i0 == 0 ? sm.carry[sg][3] : xs[at(i0 - 1)];
#pragma unroll
                for (int i = i0; i < i0 + kSeg; ++i) {
                    const double c0 = interp_val(sm, t0, t0 + i, ck);
                    const double xi = xs[at(i)];
                    c0s[at(i)] = c0;
                    f.b = -c0 * f.b + (in0 + c0 * xi);
                    f.a = -c0 * f.a;
                    in0 = xi;
                }
            }
            double o0 = segment_start(sm, f, sg, 2, on);
            if (on && full) {
                double in0 = i0 == 0 ? sm.carry[sg][3] : xs[at(i0 - 1)];
#pragma unroll
                for (int i = i0; i < i0 + kSeg; ++i) {
                    const double s = xs[at(i)];
                    const double pf = in0 + c0s[at(i)] * (s - o0);
                    o0 = pf;
                    in0 = s;
                    c0s[at(i)] = pf;
                }
            }
        }
        if (cfg.direct && sg < 2 && full) {
            // the ambience (aux row 0) and direct (aux row 1) pans
#pragma unroll
            for (int i = i0; i < i0 + kSeg; ++i) {
                sm.aux[sg][at(i)] = interp_val(sm, t0, t0 + i, 14 + sg);
            }
        }
        __syncthreads();
        // the tile's rows of y, coalesced, with the pass-through channels
        const double* pf0 = cfg.phase_flip ? sm.aux[2] : sm.sig[2];
        const double* pf1 = cfg.phase_flip ? sm.aux[3] : sm.sig[3];
        T* yt = y + (size_t)t0 * n_out;
        for (int idx = tid; idx < n * n_out; idx += kThreads) {
            const int r = idx / n_out, c = idx - r * n_out, q = at(r);
            T v;
            if (c < n_in) {
                v = c == cfg.c0 ? (T)sm.sig[0][q]
                    : c == cfg.c1 ? (T)sm.sig[1][q] : x[(size_t)(t0 + r) * n_in + c];
            } else {
                const int k = c - n_in;
                const double pf = (k & 1) ? pf1[q] : pf0[q];
                if (!cfg.direct) {
                    v = (T)(pf - 1e-15);
                } else if (k < 2) {
                    v = (T)((pf - 1e-15) * sm.aux[0][q]);
                } else {
                    const double s = sm.sig[k][q] - 1e-15;
                    v = (T)(k == 2 ? s * sm.aux[1][q] : -s * sm.aux[1][q]);
                }
            }
            yt[idx] = v;
        }
        if (j == 0 && sg >= 2) sm.carry[sg][3] = sm.sig[sg][at(n - 1)];
        __syncthreads();
    }
    if (tid < 4) {
        shelf_out[tid] = cfg.shelf_on ? (T)sm.carry[tid][0] : shelf_in[tid];
        lp_out[tid] = cfg.lp_on ? (T)sm.carry[tid][1] : lp_in[tid];
        if (tid >= 2) {
            const int k = tid - 2;
            pf_out[2 * k] = cfg.phase_flip ? (T)sm.carry[tid][3] : pf_in[2 * k];
            pf_out[2 * k + 1] = cfg.phase_flip ? (T)sm.carry[tid][2] : pf_in[2 * k + 1];
        }
    }
}

// The kernels launch has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long audio_launches = 0;

template <class T>
int launch(const T* x, const T* buf, const T* interp_c, const T* ics, const T* shelf_in,
           const T* lp_in, const T* pf_in, T* y, T* shelf_out, T* lp_out, T* pf_out,
           const AudioCfg* cfg, int B, int S, void* stream) {
    if (B <= 0 || B % kD || S <= 0 || cfg->D != kD || cfg->n_in < 2 || cfg->len < 0
        || cfg->n_out != cfg->n_in + (cfg->direct ? 4 : 2)) {
        return (int)cudaErrorInvalidValue;
    }
    static bool sized = false;  // the attribute is the function's, set once
    if (!sized) {
        const cudaError_t err = cudaFuncSetAttribute(
            m4_audio_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
        if (err != cudaSuccess) return (int)err;
        sized = true;
    }
    m4_audio_kernel<T><<<S, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
        x, buf, interp_c, ics, shelf_in, lp_in, pf_in, y, shelf_out, lp_out, pf_out, *cfg, B);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++audio_launches;
    return (int)err;
}

}  // namespace

extern "C" unsigned long long dsp_m4_audio_launches() { return audio_launches; }

// x [B, n_in], buf [len, 2], interp_c [3, 16], ics [B/D, 3, 16], the states
// shelf, lp [4] and pf [2, 2] in and out, y [B, n_out]; S streams: each of
// them with a leading S. Returns
// cudaGetLastError() after the launch (0 on success). The caller
// (dsp_tpu_torch/ops/m4_engine.py) checks shapes, dtypes and contiguity.
extern "C" int dsp_m4_audio_f64(const double* x, const double* buf, const double* interp_c,
                                const double* ics, const double* shelf_in, const double* lp_in,
                                const double* pf_in, double* y, double* shelf_out, double* lp_out,
                                double* pf_out, const AudioCfg* cfg, int B, int S,
                                void* stream) {
    return launch<double>(x, buf, interp_c, ics, shelf_in, lp_in, pf_in, y, shelf_out, lp_out,
                          pf_out, cfg, B, S, stream);
}

// The same with every input, output and state float32.
extern "C" int dsp_m4_audio_f32(const float* x, const float* buf, const float* interp_c,
                                const float* ics, const float* shelf_in, const float* lp_in,
                                const float* pf_in, float* y, float* shelf_out, float* lp_out,
                                float* pf_out, const AudioCfg* cfg, int B, int S,
                                void* stream) {
    return launch<float>(x, buf, interp_c, ics, shelf_in, lp_in, pf_in, y, shelf_out, lp_out,
                         pf_out, cfg, B, S, stream);
}
