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
// and does about 10 operations a band; the allpasses are 26 chains of B
// samples. Latency for the chains, operations for the rest; a block of
// 2048 moves about 0.5 MB.
//
// Design: one launch, a block a tile of 256 samples of all 26 lanes, tiles
// over the card in ticket order (csrc/lookback.cuh):
//   1. the tile's 9 coefficient sets and its delayed band pairs (from
//      fb_buf where t < len, then from the bands) are staged in shared
//      memory as float64, with coalesced loads;
//   2. warp w runs surround lane w, a thread a segment of 8 samples (so a
//      warp is 32 segments, the tile): each thread computes its samples'
//      allpass inputs and coefficients once, into registers, and folds its
//      segment into one affine map of o0; a shuffle scan gives each
//      segment its map from the tile's start, and the warp's total is the
//      tile's map of the lane;
//   3. the tile publishes its 26 maps, and the look-back's general affine
//      form applies every earlier tile's maps to the carried o0 of each
//      lane, one after another in tile order (a value is carried, never a
//      composed map);
//   4. each thread reruns its segment from its start value on the values
//      it kept, the allpass outputs stay in shared memory;
//   5. after a barrier, a thread a sample and pair of outputs makes the
//      band sums from band 0 up (l and r; ls and rs; the direct pair),
//      with the offsets, and writes sig; the last tile writes pf_m'.
// So the grouping of the rounding is set by the segments of 8 and the
// warps of 32 segments alone: the number of tiles, the tile count of the
// card and the thread count move no bit, and every run gives the same bits
// (tests/test_torch_m4mb_audio_partition.py models it). A block of B % 256
// samples takes the same grouping: its empty segments are identity maps.
// Without the phase flip the same launch copies the states, and no tile
// takes a ticket or waits. The interpolation takes u from a 32-entry table
// of ((t+1) % D)/D and the set from a shift (the host checks D = 32). A
// tile sits in shared memory by position in the segment (`at`), so that
// neither the segment walks nor the sums conflict on banks.
//
// The stream axis (batched processing): S independent streams in one
// launch, ntiles·S blocks; ticket q (or, without the flip, block q) takes
// tile q / S of stream q % S, so a tile only waits on tiles with earlier
// tickets. A stream runs a one-stream launch's tiles and its own slots of
// the look-back scratch (stream s's tile t at s·ntiles + t): the same bits.
//
// float32 (`dsp_m4mb_audio_f32`, dsp_tpu's float32 _audio): the bands (the
// hi half of the bank's float32 (hi, lo) output), the line, the
// coefficient sets and the allpass states are float32, read into float64;
// the same float64 arithmetic runs, and the 4 or 6 signals and the states
// are stored rounded once to float32. The kernel is a template on that
// storage type.

#include <cuda_runtime.h>

#include "lookback.cuh"

struct MbAudioCfg {
    int len, D, phase_flip, direct;
};

namespace {

constexpr int kBands = 13;
constexpr int kSig = 12;
constexpr int kRow = kBands * kSig;
constexpr int kLanes = 2 * kBands;      // the surround lanes: ls of every band, then rs
constexpr int kD = 32;                  // the control decimation (ops/m4_engine.py)
constexpr int kSeg = 8;                 // a thread's samples
constexpr int kTile = 32 * kSeg;        // a warp of segments: a tile
constexpr int kThreads = 32 * kLanes;   // a warp a lane
constexpr int kSets = kTile / kD + 1;   // the coefficient sets a tile reads
constexpr int kSetStride = 3 * kRow + 1;
constexpr int kStage = 8;               // loads a thread has in flight while staging
// a tile's signal sits in shared memory by position in the segment first:
// sample r at (r % 8)·kStride + r / 8. A warp walking its segments reads
// consecutive words; one reading consecutive samples reads 16 distinct
// 8-byte banks a half-warp (kStride = 2 mod 16)
constexpr int kStride = 34;
constexpr int kPlane = kSeg * kStride;

__device__ __forceinline__ int at(int r) { return (r & (kSeg - 1)) * kStride + (r >> 3); }

struct Map {
    double a, b;  // m -> a·m + b
};

struct Smem {
    double pair[kBands][2][kPlane];  // the tile's delayed (s0, s1) of each band
    double y[kLanes][kPlane];        // each lane's allpass output - 1e-15 (or its
                                     // unflipped signal); the look-back's maps first
    double dir[kLanes][kPlane];      // with the flip and direct_path: the unflipped lanes
    double sets[kSets][kSetStride];  // the tile's coefficient sets
    double u[kD];
    double agg[2 * kLanes];          // this tile's maps: a of each lane, then b
    double v[kLanes];                // the carried o0 at the tile's start
};

static_assert(lookback::kAffineLook * 2 * kLanes <= kLanes * kPlane,
              "the look-back's maps are staged in y");

// the inclusive scan of the lanes' maps (f on return), and the exclusive
// one returned: the map from the warp's start to this lane's segment start
__device__ __forceinline__ Map warp_scan(Map& f) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
        const double ao = __shfl_up_sync(full, f.a, d), bo = __shfl_up_sync(full, f.b, d);
        if (lane >= d) {
            f.b = __fma_rn(f.a, bo, f.b);
            f.a = __dmul_rn(f.a, ao);
        }
    }
    Map pre = {__shfl_up_sync(full, f.a, 1), __shfl_up_sync(full, f.b, 1)};
    if (lane == 0) pre = {1.0, 0.0};
    return pre;
}

// value q of band k from a coefficient set c at u
__device__ __forceinline__ double interp(const double* c, int k, int q, double u) {
    const int i = k * kSig + q;
    return __fma_rn(__fma_rn(c[2 * kRow + i], u, c[kRow + i]), u, c[i]);
}

// s0·va + s1·vb
__device__ __forceinline__ double mix(double s0, double s1, double va, double vb) {
    return __fma_rn(s1, vb, __dmul_rn(s0, va));
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
m4mb_audio_kernel(const T* __restrict__ bands, const T* __restrict__ fb_buf,
                  const T* __restrict__ interp_c, const T* __restrict__ ics,
                  const T* __restrict__ pf_in, T* __restrict__ sig, T* __restrict__ pf_out,
                  MbAudioCfg cfg, int B, int ntiles, int S, lookback::Scratch lb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    __shared__ unsigned tk[2];
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const bool flip = cfg.phase_flip != 0, direct = cfg.direct != 0;
    unsigned ticket = blockIdx.x, tag = 0;
    if (flip) {
        lookback::begin(lb, tk);
        ticket = tk[0];
        tag = tk[1];
    }
    const int t = (int)(ticket / S), strm = (int)(ticket % S);  // tile t of stream strm
    const long long slot0 = (long long)strm * ntiles;
    {   // this stream's tensors
        const size_t s = strm;
        bands += s * B * kLanes;
        fb_buf += s * cfg.len * kLanes;
        interp_c += s * 3 * kRow;
        ics += s * (B / kD) * 3 * kRow;
        pf_in += s * 4 * kBands;
        sig += s * B * (direct ? 6 : 4);
        pf_out += s * 4 * kBands;
    }
    const int t0 = t * kTile, n = min(kTile, B - t0);
    const int set0 = t0 / kD;

    // 1. the u table, the tile's coefficient sets t0/D .. (t0 + n)/D and
    // its delayed pairs, coalesced, kStage loads a thread in flight
    if (tid < kD) sm.u[tid] = (double)tid / (double)kD;
    const int nsets = n / kD + 1;
    for (int idx = tid; idx < nsets * 3 * kRow; idx += kThreads) {
        const int g = idx / (3 * kRow), e = idx - g * 3 * kRow, gs = set0 + g;
        const T* c = gs == 0 ? interp_c : ics + (size_t)(gs - 1) * 3 * kRow;
        sm.sets[g][e] = (double)c[e];
    }
    const int count = n * kLanes;  // the tile's rows of 13 pairs
    for (int q0 = tid; q0 < count; q0 += kStage * kThreads) {
        double vals[kStage];
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
            const int q = q0 + s * kThreads;
            if (q < count) {
                const int r = q / kLanes, e = q - r * kLanes, tt = t0 + r;
                vals[s] = (double)(tt < cfg.len ? fb_buf[(size_t)tt * kLanes + e]
                                                : bands[(size_t)(tt - cfg.len) * kLanes + e]);
            }
        }
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
            const int q = q0 + s * kThreads;
            if (q < count) {
                const int r = q / kLanes, e = q - r * kLanes;
                sm.pair[e >> 1][e & 1][at(r)] = vals[s];
            }
        }
    }
    __syncthreads();

    // 2. lane w: ls of band w (w < 13) or rs of band w - 13; this thread's
    // segment of 8 samples. n is a multiple of 32: a segment is full or
    // empty, and an empty one is the identity map.
    const int k = w < kBands ? w : w - kBands;
    const int qa = w < kBands ? 4 : 6, qc = w < kBands ? 8 : 9;
    const int i0 = lane * kSeg;
    const bool full = i0 < n;
    double xs[kSeg], cs[kSeg];
    Map f = {1.0, 0.0};
    if (full) {
#pragma unroll
        for (int s = 0; s < kSeg; ++s) {
            const int r = i0 + s, tt = t0 + r;
            const double u = sm.u[(tt + 1) & (kD - 1)];
            const double* c = sm.sets[((tt + 1) >> 5) - set0];
            const double b = mix(sm.pair[k][0][at(r)], sm.pair[k][1][at(r)], interp(c, k, qa, u),
                                 interp(c, k, qa + 1, u));
            if (!flip) {
                sm.y[w][at(r)] = b;
                continue;
            }
            if (direct) sm.dir[w][at(r)] = b;
            xs[s] = b + 1e-15;
            cs[s] = interp(c, k, qc, u);
        }
    }
    const int st = (w < kBands ? w * 2 : k * 2 + 1) * 2;  // pf [13, 2, 2]: (band, ls|rs, (i0, o0))
    if (flip) {
        // the allpass input before the segment: the neighbour's last, or
        // before the tile the last sample of the tile before (the same
        // formula on the same set), or the carried i0
        double in0 = __shfl_up_sync(0xffffffffu, xs[kSeg - 1], 1);
        if (lane == 0) {
            if (t0 == 0) {
                in0 = (double)pf_in[st];
            } else {
                const int tt = t0 - 1;
                const T* row = tt < cfg.len ? fb_buf + (size_t)tt * kLanes
                                            : bands + (size_t)(tt - cfg.len) * kLanes;
                const double* c = sm.sets[0];  // set (tt + 1)/D = t0/D, u = 0
                in0 = mix((double)row[2 * k], (double)row[2 * k + 1], interp(c, k, qa, sm.u[0]),
                          interp(c, k, qa + 1, sm.u[0])) + 1e-15;
            }
        }
        if (full) {
            double p = in0;
#pragma unroll
            for (int s = 0; s < kSeg; ++s) {
                const double c0 = cs[s];
                f.b = __fma_rn(-c0, f.b, __fma_rn(c0, xs[s], p));
                f.a = __dmul_rn(-c0, f.a);
                p = xs[s];
            }
        }
        const Map pre = warp_scan(f);
        if (lane == 31) {
            sm.agg[w] = f.a;
            sm.agg[kLanes + w] = f.b;
        }
        if (tid < kLanes) {
            const int sj = (tid < kBands ? tid * 2 : (tid - kBands) * 2 + 1) * 2;
            sm.v[tid] = (double)pf_in[sj + 1];
        }
        // 3. publish this tile's maps (a tile with tiles after it), then
        // carry o0 over every earlier tile's, in order
        if (t < ntiles - 1) lookback::publish(lb, slot0 + t, tag, sm.agg, 2 * kLanes);
        __syncthreads();
        lookback::carry_affine(lb, slot0, t, tag, kLanes, sm.v, &sm.y[0][0]);
        // 4. the rerun from the segment's start value
        const double v0 = sm.v[w];
        if (full) {
            double o0 = __fma_rn(pre.a, v0, pre.b), p = in0;
#pragma unroll
            for (int s = 0; s < kSeg; ++s) {
                const double r = __fma_rn(cs[s], xs[s] - o0, p);
                sm.y[w][at(i0 + s)] = r - 1e-15;
                o0 = r;
                p = xs[s];
            }
            if (t == ntiles - 1 && i0 + kSeg == n) pf_out[st] = (T)xs[kSeg - 1];
        }
        if (t == ntiles - 1 && lane == 31) pf_out[st + 1] = (T)__fma_rn(f.a, v0, f.b);
    } else if (t == 0 && tid < 4 * kBands) {
        pf_out[tid] = pf_in[tid];
    }
    __syncthreads();

    // 5. the band sums from band 0 up, a thread a sample and pair of
    // outputs: (l, r), (ls, rs), the direct pair
    const int g = tid / kTile, r = tid - g * kTile;
    if (r < n && (g < 2 || (g == 2 && direct))) {
        const int tt = t0 + r;
        const double u = sm.u[(tt + 1) & (kD - 1)];
        const double* c = sm.sets[((tt + 1) >> 5) - set0];
        const double (*lanes)[kPlane] = g == 1 || !flip ? sm.y : sm.dir;
        double o0 = 0.0, o1 = 0.0;
        for (int b = 0; b < kBands; ++b) {
            double a0, a1;
            if (g == 0) {
                const double s0 = sm.pair[b][0][at(r)], s1 = sm.pair[b][1][at(r)];
                a0 = mix(s0, s1, interp(c, b, 0, u), interp(c, b, 1, u));
                a1 = mix(s0, s1, interp(c, b, 2, u), interp(c, b, 3, u));
            } else {
                a0 = lanes[b][at(r)];
                a1 = lanes[kBands + b][at(r)];
                if (g == 2 || direct) {
                    const double m = interp(c, b, g == 2 ? 11 : 10, u);
                    a0 = __dmul_rn(a0, m);
                    a1 = __dmul_rn(a1, m);
                }
            }
            o0 = b == 0 ? a0 : o0 + a0;
            o1 = b == 0 ? a1 : o1 + a1;
        }
        constexpr double eps = 1e-15 / 324;
        T* row = sig + (size_t)tt * (direct ? 6 : 4) + 2 * g;
        if (g == 0) {
            row[0] = (T)o0;
            row[1] = (T)o1;
        } else {
            row[0] = (T)(o0 + eps);
            row[1] = (T)((g == 2 ? -o1 : o1) + eps);
        }
    }
    if (flip) lookback::end(lb);
}

// The kernels launch has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long audio_launches = 0;

template <class T>
int launch(const T* bands, const T* fb_buf, const T* interp_c, const T* ics, const T* pf_in,
           T* sig, T* pf_out, const MbAudioCfg* cfg, int B, int S, unsigned* flags,
           long long flag_slots, double* agg, long long agg_doubles, void* stream) {
    const int ntiles = (B + kTile - 1) / kTile;
    if (B <= 0 || B % 32 || S <= 0 || cfg->D != kD || cfg->len < 0 ||
        (cfg->phase_flip && (flags == nullptr || agg == nullptr ||
                             (long long)ntiles * S > flag_slots ||
                             (long long)ntiles * S * 2 * kLanes > agg_doubles)))
        return (int)cudaErrorInvalidValue;
    static bool sized = false;  // the attribute is the function's, set once
    if (!sized) {
        const cudaError_t err = cudaFuncSetAttribute(
            m4mb_audio_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
        if (err != cudaSuccess) return (int)err;
        sized = true;
    }
    m4mb_audio_kernel<T><<<ntiles * S, kThreads, sizeof(Smem),
                           static_cast<cudaStream_t>(stream)>>>(
        bands, fb_buf, interp_c, ics, pf_in, sig, pf_out, *cfg, B, ntiles, S,
        lookback::carve(flags, agg));
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++audio_launches;
    return (int)err;
}

}  // namespace

// bands [B, 13, 2], fb_buf [len, 13, 2], interp_c [3, 13, 12], ics
// [B/D, 3, 13, 12], pf [13, 2, 2] in and out, sig [B, 4 or 6], each with a
// leading S for S streams; flags
// (flag_slots slots after its head) and agg (agg_doubles long) the
// look-back scratch of csrc/lookback.cuh, read only with the phase flip.
// Returns cudaGetLastError() after the launch (0 on success). The caller
// (dsp_tpu_torch/ops/m4_engine.py) checks shapes, dtypes and contiguity.
extern "C" int dsp_m4mb_audio_f64(const double* bands, const double* fb_buf,
                                  const double* interp_c, const double* ics, const double* pf_in,
                                  double* sig, double* pf_out, const MbAudioCfg* cfg, int B,
                                  int S, unsigned* flags, long long flag_slots, double* agg,
                                  long long agg_doubles, void* stream) {
    return launch<double>(bands, fb_buf, interp_c, ics, pf_in, sig, pf_out, cfg, B, S, flags,
                          flag_slots, agg, agg_doubles, stream);
}

// The same with the bands, the line, the coefficient sets, the states and
// the signals float32.
extern "C" int dsp_m4mb_audio_f32(const float* bands, const float* fb_buf, const float* interp_c,
                                  const float* ics, const float* pf_in, float* sig, float* pf_out,
                                  const MbAudioCfg* cfg, int B, int S, unsigned* flags,
                                  long long flag_slots, double* agg, long long agg_doubles,
                                  void* stream) {
    return launch<float>(bands, fb_buf, interp_c, ics, pf_in, sig, pf_out, cfg, B, S, flags,
                         flag_slots, agg, agg_doubles, stream);
}

extern "C" unsigned long long dsp_m4mb_audio_launches() { return audio_launches; }
