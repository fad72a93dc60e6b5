// K9 + K10: matrix4's event engine and matrix coefficients, float64 or
// float32, for Hopper (sm_90a).
//
// Replaces dsp_tpu/ops/m4_engine.py:395 `event_step` (with `smf_asym_run`,
// :192), as effects/matrix4.py:482-503 scans it over the Nc = B/32 control
// ticks of a block, and the per-tick work after the scan
// (effects/matrix4.py:512-574): the fade, the contour gains,
// `calc_matrix_coefs_v4` / `_v1` (m4_engine.py:784, :730), the phase flip
// and the direct pan (:887-910), and the parabolic interpolator's
// coefficient sets.
//
// The engine is a serial state machine: each tick reads the state the last
// one wrote (about sixty values, and six ring buffers of buf_len entries),
// compares thresholds and branches. What bounds it on the card is the
// latency of that dependent chain, not bytes or operations: each tick
// carries eleven float64 divisions (the two notch filters' gains, the
// ord_factor decay, the two mask normalisations, ds_diff, norm_axes twice,
// the ordering weight) and some two hundred dependent adds, multiplies and
// selects, and the lookback replay when an event starts: about 3,100
// cycles a tick on an H100 (PERF.md §6), about 1.6 µs. Design,
// for one block a lane (S = 1 for matrix4; the 13 bands of matrix4_mb in
// one block), four warps in roles that overlap over chunks of ticks
// (event_geometry in ops/m4_engine.py sizes the chunk and the shared
// memory; every role meets the others at one named barrier a chunk, on
// double-buffered tables; the whole block runs the first chunk's pre-phase,
// before the chain has work, and the last chunk's epilogue, after it):
//
//  * warp 1, the pre-phase: the values of a tick that no decision touches
//    (m4_engine.py:411-463): ord_lr / ord_cs (a division and an atan each),
//    their lowpass, the accom EWMAs, the adapted powers and diff_lr /
//    diff_cs (a division, a sqrt and an atan each), the crossfed powers,
//    the fast norms n2 / n3 and the masks. The divisions, sqrt and atan run
//    in parallel over (tick, band); the three recurrences (lowpass, accom,
//    fast norm) by one lane a band. For matrix4_mb it also spreads the 169
//    cross-band similarity terms of each tick over the warp's lanes (they
//    depend only on the previous tick's diff_lr / diff_cs). All of it goes
//    into a table in shared memory, chunk k+1 while the chain runs chunk k.
//  * warp 0, the chain: lane 0 (matrix4) or lanes 0-12 (matrix4_mb, one a
//    band, in lockstep) run the decision-dependent rest of each tick from
//    the table, with the state in registers and the rings in shared memory
//    at fixed offsets (in a device scratch, L2-resident, where they would
//    not fit: matrix4_mb from 461.9 kHz), and write the tick's engine
//    outputs to shared memory.
//    The lookback walk runs only when a fresh event starts (its result is
//    read nowhere else). matrix4_mb's threshold modulation is a ballot of the
//    bands' candidacy and each band's sum of its 13 table terms.
//  * warps 2-3, the epilogue: chunk k-1's background weight (smf_asym_run,
//    matrix4), then K10 over its ticks (and bands), then its interpolator
//    insert.
//
// The kernel's time is then about the chain alone, plus one chunk of the
// pre-phase before it and one chunk of epilogue after it, each on the
// whole block.
//
// matrix4_mb (`dsp_m4mb_event_f64`, replacing effects/matrix4_mb.py:445-551)
// runs 13 of these engines, one a band, coupled every tick: each band's
// event threshold is an EWMA toward a target built from every band's
// previous-tick `last`, `slope_last` and `diff_last` (:460-480). Where
// dsp_tpu's XLA:CPU contracts a product into a sum (`1 - max(d)·16/π`, the
// target's last product and sum, and the threshold's EWMA) the kernel writes
// fma(), and nowhere else; `fact` is summed from band 0 up. A lane that
// replays its lookback while the others do not makes the warp diverge for
// those steps: correct, only slower.
//
// The arithmetic is dsp_tpu's, operation for operation, in the order the
// plain version (ops/m4_engine.py) writes it; the roles only move operations
// between threads. This file is compiled with -fmad=false (kernels.py): no
// product is fused into a sum, so each operation rounds as torch's does, and
// atan, tan, sin, cos, exp, pow and sqrt are the CUDA math library's, as
// torch's CUDA ops call them. The decisions (booleans, counters, tick stamps)
// are exact comparisons of those values.
//
// The stream axis (batched processing): S independent streams in one
// launch, a block each. matrix4's streams are the lanes of m4_event (block
// s: lane s); matrix4_mb's take a block each (block s: stream s's 13
// coupled engines, state lanes 13s .. 13s + 12, its rings in shared memory
// or its own part of the device scratch). A block runs a one-stream
// launch's geometry, roles and order: the same bits.
//
// float32 (`dsp_m4_event_f32`, `dsp_m4mb_event_f32`): dsp_tpu runs the whole
// control path of both upmixes in two-float32 under float32
// (`event_step` over dfx.DF with cast_params(df=True), m4_engine.py:225,
// and dfx's add, multiply, divide, sqrt, sin, cos, tan, exp and atan_pos,
// dfx.py:113-520). These entries run the same float64 code: every float
// leaf of the event state comes in as its float32 (hi, lo) pair (`ev`,
// `ev_lo`; the background weight's `bg_cs`, `bg_cs_lo`; the thresholds'
// `ev_thresh`, `ev_thresh_lo`), is read into float64 registers and goes out
// split again (f32_pair.cuh). The per-tick values are rounded to float32
// where dsp_tpu collapses its pairs, before the interpolator insert; the
// insert runs in float64 on those values and stores the coefficient sets,
// the window and the display values in float32, so the coefficient set a
// block carries equals the one computed inside the next, whatever the
// block size. The kernels are templates on the state's pointers and the
// output's storage type.

#include <cuda_runtime.h>

#include "f32_pair.cuh"

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kPi4 = kPi / 4.0;
constexpr double kPi2 = kPi / 2.0;
constexpr double kDblMin = 1.1754943508222875e-38;  // float32's smallest normal, as dsp_tpu
constexpr double kEventEndThresh = 0.2;
constexpr double kNormCrossfeed = 0.1;
constexpr double kOrdSensErr = 2.0;
constexpr double kOrdSensWeight = 3.0;
constexpr double kOrdWeightThresh = 0.3;
constexpr double kDiffSensWeight = 2.0;
constexpr double kDiffWeightScale = 2.5;
constexpr double kOrdDpwrSensErr = 8.0;
constexpr double kPwrcmpRiseFall = 100.0 / 15.0;  // PWRCMP_RISE_TIME / PWRCMP_FALL_TIME
constexpr int kInterp = 16;

enum { B_SAMPLE, B_HOLD, B_F1_L, B_F1_R, B_F1_USE_ORD, B_F1_FUSE, B_F0_L, B_F0_R, B_F0_USE_ORD,
       B_F0_FUSE, B_F0_END, NB };
enum { F_ACCOM, F_NORM, F_SLOW, F_SMOOTH, F_AVG, F_DRIFT, F_DRIFT_DPWR, F_DRIFT_SCALE, F_PWRCMP,
       F_ONS, F_ORD_LP_M, F_SVF_M, F_DIR_LR, F_DIR_CS, F_ORD_BUF, F_ORD_LP_BUF, F_DIFF_BUF,
       F_SLOPE_BUF, F_DS_ORD_BUF, F_MAX_BUF, F_LAST, F_SLOPE_LAST, F_DIFF_LAST, F_MAX1, F_MAX0,
       F_ORD_FACTOR, F_ADJ, F_DS_DIFF, NF };
enum { I_T, I_T_SAMPLE, I_T_HOLD, I_BUF_P, I_ORD_COUNT, I_DIFF_COUNT, I_EARLY_COUNT,
       I_IGNORE_COUNT, NI };

}  // namespace

// The event state's device pointers, in ops/m4_engine.py's EV_LEAVES order;
// every leaf is [S, ...] contiguous.
struct EvPtrs {
    unsigned char* b[NB];
    double* f[NF];
    long long* i[NI];
};

// The same under float32: each float leaf as its (hi, lo) pair.
struct EvPtrsF32 {
    unsigned char* b[NB];
    float* f[NF];
    float* lo[NF];
    long long* i[NI];
};

// make_event_params, as Python floats and ints (ops/m4_engine.M4Control).
struct EvParams {
    double g_accom, g_norm, g_norm_fast, g_slow, g_smooth, g_avg, g_drift_slow, g_drift_fast,
        g_dpwr_slow, g_dpwr_fast, g_ds0, g_ds1, g_pwrcmp, g_ord_notch_scale, base_ord_ns;
    double ord_lp_c[5];
    double svf1_a0, svf1_alpha, svf1_beta, svf2_a0, svf2_alpha, svf2_beta;
    double clip_thresh, pcf_sens, ord_factor_c, diff_lim, rear_ev_mask, accom_mask_fall,
        norm_accom_factor;
    double thresh, bg_g0, bg_c0, bg_c1;
    int buf_len, sample_frames, max_hold_frames, min_hold_frames;
};

// matrix4_mb's constants: the bands' threshold bounds, contour and the
// event parameters that differ by band, then the epilogue's.
struct MbParams {
    double etmax[13], etmin[13], contour[13], base_ord_ns[13], clip_thresh[13], pcf_sens[13];
    double g_evt, surr_mult0, surr_mult1, contour_pwrcmp, matrix_param, pf_c0, pf_c1;
    int matrix_v4, dpwr_decouple, fade_frames, D;
};

// The per-tick epilogue's constants (matrix4's config).
struct K10Params {
    double surr_mult0, surr_mult1, contour_pwrcmp, shelf_mult, lowpass_mult, matrix_param, pf_c0,
        pf_c1;
    int matrix_v4, dpwr_decouple, fade_frames, D;
};

namespace {

// jnp.minimum / jnp.maximum and torch.clamp for the values here (no NaN
// reaches a comparison that matters)
__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }
__device__ __forceinline__ double dmax(double a, double b) { return b > a ? b : a; }
__device__ __forceinline__ double sq(double a) { return a * a; }

__device__ __forceinline__ double smoothstep(double x) {
    x = dmin(dmax(x, 0.0), 1.0);
    return x * x * (3.0 - 2.0 * x);
}
__device__ __forceinline__ double ewma(double m, double s, double g) { return m + g * (s - m); }
__device__ __forceinline__ double ewma_scale(double m, double s, double g, double sf) {
    const double gs = dmin(g * sf, 0.39);
    return m + gs * (s - m);
}
__device__ __forceinline__ double ewma_set_max(double m, double s, double g) {
    return s >= m ? ewma(m, s, g) : s;
}
__device__ __forceinline__ double ewma_scale_asym(double m, double s, double g, double rise,
                                                  double fall) {
    return ewma_scale(m, s, g, s >= m ? rise : fall);
}
__device__ __forceinline__ double calc_lr(double n, double d, double expr) {
    const double angle = (n < kDblMin && d < kDblMin) ? kPi4 : (d < kDblMin ? kPi2 : atan(expr));
    return angle - kPi4;
}
__device__ __forceinline__ void norm_axes(double& lr, double& cs) {
    const double abs_sum = fabs(lr) + fabs(cs);
    const double norm = abs_sum > kPi4 ? kPi4 / dmax(abs_sum, kDblMin) : 1.0;
    lr = lr * norm;
    cs = cs * norm;
}
__device__ __forceinline__ double drift_err_scale(double lr0, double cs0, double lr1, double cs1,
                                                  double sens) {
    const double lr_err = fabs(lr1 - lr0) * (2.0 / kPi);
    const double cs_err = fabs(cs1 - cs0) * (2.0 / kPi);
    return 1.0 + (lr_err + cs_err) * sens;
}
__device__ __forceinline__ double ord_notch_scale(double lr, double cs) {
    const double z = dmax((fabs(lr) + fabs(cs)) * (2.0 / kPi4) - 1.0, 0.0);
    return 1.0 - z * z * 0.99;
}
// svf_pk_run: (m0, m1) in and out, returns y
__device__ __forceinline__ double svf_pk_run(double a0, double alpha, double beta, double& m0,
                                             double& m1, double s, double scale) {
    const double a = (a0 - 1.0) * scale + 1.0;
    const double k0 = a * alpha;
    const double k1 = a * beta;
    const double g0 = 1.0 / (alpha + a);
    const double g1 = a / (k1 - alpha);
    const double c1 = 2.0 * g0 * (alpha - k1);
    const double c2 = g1 * beta;
    const double d0 = g0 * a * (k0 + 1.0);
    const double d1 = g1 * (beta - k0);
    const double x = s - m0 - m1;
    const double y = d0 * x + d1 * m0 + m1;
    m1 = m1 + c2 * m0;
    m0 = m0 + c1 * x;
    return y;
}
// v mod L for v in [-L, 2L): the ring indices here stay in that range, so
// no integer division is needed
__device__ __forceinline__ int wrap(int v, int L) { return v < 0 ? v + L : (v >= L ? v - L : v); }

constexpr int kBands = 13;
constexpr int kSim = kBands * kBands;  // matrix4_mb's similarity terms a tick
constexpr int kSigMb = 12;
constexpr int kMaxChunk = 32;
// the launch's threads: warp 0 the chain, warp 1 the pre-phase, the rest
// (at least one warp) the epilogue
constexpr int kMinThreads = 96;
constexpr int kMaxThreads = 256;
// the dynamic shared memory a launch may ask for on Hopper (227 KB)
constexpr size_t kMaxSmem = 227 * 1024;

// The decision-free table: the values of one (tick, band), a slot each.
// The pre-phase stages the powers and the adapted powers in slots it
// overwrites later (T_PW_*, T_ADAPT_L / _R).
enum { T_ORD_LR, T_ORD_CS, T_LP_LR, T_LP_CS, T_DIFF_LR, T_DIFF_CS, T_XF_L, T_XF_R, T_N2, T_N3,
       T_MASK_L, T_MASK_R, T_ADAPT_SUM, T_ADAPT_DIFF, NT };
enum { T_PW_L = T_N2, T_PW_R = T_N3, T_PW_SUM = T_MASK_L, T_PW_DIFF = T_MASK_R,
       T_ADAPT_L = T_DIFF_LR, T_ADAPT_R = T_DIFF_CS };
// a tick's engine outputs: ax_lr, ax_cs, ax_ev_lr, ax_ev_cs, ax_dpwr_lr,
// ax_dpwr_cs, pwrcmp_factor, then the background weight w1 (matrix4)
constexpr int NEO = 8;
// a band's rings in shared memory, at these multiples of buf_len: ord_buf,
// ord_lp_buf, diff_buf and slope_buf (two values an entry), ds_ord_buf and
// max_buf (one)
enum { R_ORD = 0, R_ORD_LP = 2, R_DIFF = 4, R_SLOPE = 6, R_DS_ORD = 8, R_MAX = 9, R_ALL = 10 };

// The shared memory of one launch, in doubles: nb bands' rings (unless
// they sit in a device scratch: ring_dev), then two tables and two
// engine-output buffers of a chunk of C ticks, and for matrix4_mb two
// buffers of similarity terms and the diffs before a chunk.
// ops/m4_engine.py's event_geometry computes the same size, and moves the
// rings to the device scratch where they would not fit beside a chunk of
// one tick (matrix4_mb from 461.9 kHz); there they stay in the L2.
__host__ __device__ inline size_t smem_doubles(int nb, int L, int C, bool ring_dev) {
    const size_t mb = nb == kBands ? 2 * (size_t)C * kSim + 2 * kBands : 0;
    return (ring_dev ? 0 : (size_t)nb * R_ALL * L) + 2 * (size_t)C * nb * (NT + NEO) + mb;
}

struct Smem {
    double* ring;
    double* tab[2];
    double* eo[2];
    double* sim[2];
    double* dprev;  // matrix4_mb: diff_lr of the 13 bands, then diff_cs
};

__device__ inline Smem carve(double* base, int nb, int L, int C, double* ring_dev) {
    Smem s;
    s.ring = ring_dev != nullptr ? ring_dev : base;
    base += ring_dev != nullptr ? 0 : (size_t)nb * R_ALL * L;
    for (int k = 0; k < 2; ++k) {
        s.tab[k] = base;
        base += (size_t)C * nb * NT;
    }
    for (int k = 0; k < 2; ++k) {
        s.eo[k] = base;
        base += (size_t)C * nb * NEO;
    }
    for (int k = 0; k < 2; ++k) {
        s.sim[k] = base;
        base += nb == kBands ? (size_t)C * kSim : 0;
    }
    s.dprev = base;
    return s;
}

__device__ __forceinline__ void named_barrier(int id, int n) {
    __syncwarp();
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// the barrier every role meets once a chunk, and the epilogue warps' own
constexpr int kChunkBarrier = 1;
constexpr int kEpilogueBarrier = 2;

// The chain's state while its ticks run (its rings in shared memory). The
// pre-phase owns accom and ord_lp_m (Pre); the chain writes the fast norms
// norm[2:4] from the table.
struct Ev {
    bool b[NB];
    double norm[4], slow[2], smooth[2], avg[4], drift[4], dpwr[4], dscale[2], pwrcmp, ons,
        svf_m[8], dir_lr, dir_cs, last[2], slope_last[2], diff_last[2], max1, max0, ord_factor,
        adj, ds_diff;
    long long i[NI];
};

// The pre-phase's recurrences of one band: the ordering's lowpass, the
// accom EWMAs and the fast norms.
struct Pre {
    double lp[4], ac[6], n2, n3;
};

// element k of float leaf `idx`, read into and written from float64
__device__ __forceinline__ double leaf_get(const EvPtrs& P, int idx, size_t k) {
    return P.f[idx][k];
}
__device__ __forceinline__ double leaf_get(const EvPtrsF32& P, int idx, size_t k) {
    return pair_load(P.f[idx], P.lo[idx], k);
}
__device__ __forceinline__ void leaf_put(const EvPtrs& P, int idx, size_t k, double v) {
    P.f[idx][k] = v;
}
__device__ __forceinline__ void leaf_put(const EvPtrsF32& P, int idx, size_t k, double v) {
    pair_store(P.f[idx], P.lo[idx], k, v);
}

template <class P>
__device__ void load_vals(double* dst, const P& in, int idx, size_t off, int n) {
    for (int k = 0; k < n; ++k) dst[k] = leaf_get(in, idx, off + k);
}
template <class P>
__device__ void store_vals(const P& out, int idx, size_t off, const double* src, int n) {
    for (int k = 0; k < n; ++k) leaf_put(out, idx, off + k, src[k]);
}

// The chain's float leaves held in registers: (Ev member, leaf, values a lane).
#define EV_REG_LEAVES(X)                                                                    \
    X(norm, F_NORM, 4) X(slow, F_SLOW, 2) X(smooth, F_SMOOTH, 2) X(avg, F_AVG, 4)           \
    X(drift, F_DRIFT, 4) X(dpwr, F_DRIFT_DPWR, 4) X(dscale, F_DRIFT_SCALE, 2)               \
    X(svf_m, F_SVF_M, 8) X(last, F_LAST, 2) X(slope_last, F_SLOPE_LAST, 2)                  \
    X(diff_last, F_DIFF_LAST, 2)
#define EV_SCALAR_LEAVES(X)                                                                 \
    X(pwrcmp, F_PWRCMP) X(ons, F_ONS) X(dir_lr, F_DIR_LR) X(dir_cs, F_DIR_CS) X(max1, F_MAX1) \
    X(max0, F_MAX0) X(ord_factor, F_ORD_FACTOR) X(adj, F_ADJ) X(ds_diff, F_DS_DIFF)

template <class P>
__device__ void load_ev(Ev& e, const P& in, int s) {
    for (int k = 0; k < NB; ++k) e.b[k] = in.b[k][s] != 0;
    for (int k = 0; k < NI; ++k) e.i[k] = in.i[k][s];
#define LOAD_REG(MEM, IDX, N) load_vals(e.MEM, in, IDX, (size_t)s * (N), N);
    EV_REG_LEAVES(LOAD_REG)
#undef LOAD_REG
#define LOAD_SCALAR(MEM, IDX) e.MEM = leaf_get(in, IDX, s);
    EV_SCALAR_LEAVES(LOAD_SCALAR)
#undef LOAD_SCALAR
}

template <class P>
__device__ void store_ev(const Ev& e, const P& out, int s) {
    for (int k = 0; k < NB; ++k) out.b[k][s] = e.b[k] ? 1 : 0;
    for (int k = 0; k < NI; ++k) out.i[k][s] = e.i[k];
#define STORE_REG(MEM, IDX, N) store_vals(out, IDX, (size_t)s * (N), e.MEM, N);
    EV_REG_LEAVES(STORE_REG)
#undef STORE_REG
#define STORE_SCALAR(MEM, IDX) leaf_put(out, IDX, s, e.MEM);
    EV_SCALAR_LEAVES(STORE_SCALAR)
#undef STORE_SCALAR
}

template <class P>
__device__ void load_pre(Pre& q, const P& in, int s) {
    load_vals(q.lp, in, F_ORD_LP_M, (size_t)s * 4, 4);
    load_vals(q.ac, in, F_ACCOM, (size_t)s * 6, 6);
    q.n2 = leaf_get(in, F_NORM, (size_t)s * 4 + 2);
    q.n3 = leaf_get(in, F_NORM, (size_t)s * 4 + 3);
}

template <class P>
__device__ void store_pre(const Pre& q, const P& out, int s) {
    store_vals(out, F_ORD_LP_M, (size_t)s * 4, q.lp, 4);
    store_vals(out, F_ACCOM, (size_t)s * 6, q.ac, 6);
}

// The rings of lanes s0 .. s0 + nb - 1 between the state and shared memory,
// by every thread of the block: ring[b · R_ALL·L + r] is entry r of band b's
// rings in R_* order (the leaves F_ORD_BUF .. F_MAX_BUF). ring_at gives
// shared element q's leaf and element in it.
struct RingAt {
    int idx;
    size_t k;
};
__device__ __forceinline__ RingAt ring_at(int q, int s0, int L) {
    const int per = R_ALL * L, b = q / per;
    int r = q % per;
    if (r < R_DS_ORD * L) return {F_ORD_BUF + r / (2 * L), (size_t)(s0 + b) * 2 * L + r % (2 * L)};
    r -= R_DS_ORD * L;
    return {F_DS_ORD_BUF + r / L, (size_t)(s0 + b) * L + r % L};
}
template <class P>
__device__ void rings_in(double* ring, const P& in, int s0, int nb, int L) {
#pragma unroll 4
    for (int q = threadIdx.x; q < nb * R_ALL * L; q += blockDim.x) {
        const RingAt a = ring_at(q, s0, L);
        ring[q] = leaf_get(in, a.idx, a.k);
    }
}
template <class P>
__device__ void rings_out(const P& out, const double* ring, int s0, int nb, int L) {
#pragma unroll 4
    for (int q = threadIdx.x; q < nb * R_ALL * L; q += blockDim.x) {
        const RingAt a = ring_at(q, s0, L);
        leaf_put(out, a.idx, a.k, ring[q]);
    }
}

// The threads that run a pre-phase: warp 1 alone (Warp), or the whole block
// for the first chunk, before any other role has work (Block).
struct Warp {
    static __device__ __forceinline__ void sync() { __syncwarp(); }
};
struct Block {
    static __device__ __forceinline__ void sync() { __syncthreads(); }
};

// The pre-phase of one chunk, n ticks of NB_ bands, by thread t of nt in
// group G: the decision-free part of event_step (m4_engine.py:411-463), in
// the plain version's operations, into the table tb (slot, tick, band:
// tb[(slot·C + i)·NB_ + b]). env: the chunk's first tick's envelopes, band
// 0 (l, r, sum, diff, then their powers); ts: a tick's stride, a band's is
// 8. q: the recurrences of band `rec` (-1 on a thread that holds none: warp
// 1's lanes 0 .. NB_ - 1 hold them). For matrix4_mb also the similarity
// terms of each tick into sb [n, 13, 13], from the bands' diffs before the
// tick (dprev before the chunk's first, which it then moves on to the
// chunk's last).
template <int NB_, class G>
__device__ void pre_phase(const EvParams& p, Pre& q, int t, int nt, int rec, const double* env,
                          size_t ts, int n, int C, double* tb, double* sb, double* dprev) {
#define TB(slot, i, b) tb[((slot) * C + (i)) * NB_ + (b)]
    // the ordering's divisions and atan, the crossfed powers; the powers
    // staged for the recurrences
    for (int x = t; x < n * NB_; x += nt) {
        const int i = x / NB_, b = x % NB_;
        const double* e8 = env + i * ts + b * 8;
        const double env_l = e8[0], env_r = e8[1], env_sum = e8[2], env_diff = e8[3];
        const double pw_l = e8[4], pw_r = e8[5], pw_sum = e8[6], pw_diff = e8[7];
        TB(T_ORD_LR, i, b) = calc_lr(env_l, env_r, env_l / env_r);
        TB(T_ORD_CS, i, b) = calc_lr(env_sum, env_diff, env_sum / env_diff);
        TB(T_XF_L, i, b) = pw_l * (1.0 - kNormCrossfeed) + pw_r * kNormCrossfeed;
        TB(T_XF_R, i, b) = pw_r * (1.0 - kNormCrossfeed) + pw_l * kNormCrossfeed;
        TB(T_PW_L, i, b) = pw_l;
        TB(T_PW_R, i, b) = pw_r;
        TB(T_PW_SUM, i, b) = pw_sum;
        TB(T_PW_DIFF, i, b) = pw_diff;
    }
    G::sync();
    // the three recurrences, a thread a band, tick by tick: adds, multiplies
    // and selects
    if (rec >= 0) {
        const int b = rec;
        const double* c = p.ord_lp_c;
        for (int i = 0; i < n; ++i) {
            const double ord_lr = TB(T_ORD_LR, i, b), ord_cs = TB(T_ORD_CS, i, b);
            const double pw_l = TB(T_PW_L, i, b), pw_r = TB(T_PW_R, i, b);
            const double pw_sum = TB(T_PW_SUM, i, b), pw_diff = TB(T_PW_DIFF, i, b);
            const double ord_lp_lr = c[0] * ord_lr + q.lp[0];
            const double ord_lp_cs = c[0] * ord_cs + q.lp[2];
            const double m0a = q.lp[1] + c[1] * ord_lr - c[3] * ord_lp_lr;
            const double m1a = c[2] * ord_lr - c[4] * ord_lp_lr;
            const double m0b = q.lp[3] + c[1] * ord_cs - c[3] * ord_lp_cs;
            const double m1b = c[2] * ord_cs - c[4] * ord_lp_cs;
            q.lp[0] = m0a;
            q.lp[1] = m1a;
            q.lp[2] = m0b;
            q.lp[3] = m1b;
            const double ac0 = ewma_set_max(q.ac[0], pw_l, p.g_accom);
            const double ac1 = ewma_set_max(q.ac[1], pw_r, p.g_accom);
            const double ac2 = ewma_set_max(q.ac[2], pw_sum, p.g_accom);
            const double ac3 = ewma_set_max(q.ac[3], pw_diff, p.g_accom);
            q.n2 = ewma(q.n2, TB(T_XF_L, i, b), p.g_norm_fast);
            q.n3 = ewma(q.n3, TB(T_XF_R, i, b), p.g_norm_fast);
            const double ac4 = ewma_scale_asym(q.ac[4], pw_l, p.g_accom, 1.0, p.accom_mask_fall);
            const double ac5 = ewma_scale_asym(q.ac[5], pw_r, p.g_accom, 1.0, p.accom_mask_fall);
            q.ac[0] = ac0;
            q.ac[1] = ac1;
            q.ac[2] = ac2;
            q.ac[3] = ac3;
            q.ac[4] = ac4;
            q.ac[5] = ac5;
            TB(T_LP_LR, i, b) = ord_lp_lr;
            TB(T_LP_CS, i, b) = ord_lp_cs;
            TB(T_ADAPT_L, i, b) = pw_l - ac0;
            TB(T_ADAPT_R, i, b) = pw_r - ac1;
            TB(T_ADAPT_SUM, i, b) = pw_sum - ac2;
            TB(T_ADAPT_DIFF, i, b) = pw_diff - ac3;
            TB(T_N2, i, b) = q.n2;
            TB(T_N3, i, b) = q.n3;
            TB(T_MASK_L, i, b) = dmax(pw_l - ac4, 0.0);
            TB(T_MASK_R, i, b) = dmax(pw_r - ac5, 0.0);
        }
    }
    G::sync();
    // the adapted powers' divisions, sqrt and atan
    for (int x = t; x < n * NB_; x += nt) {
        const int i = x / NB_, b = x % NB_;
        const double adapt_l = TB(T_ADAPT_L, i, b), adapt_r = TB(T_ADAPT_R, i, b);
        const double adapt_sum = TB(T_ADAPT_SUM, i, b), adapt_diff = TB(T_ADAPT_DIFF, i, b);
        TB(T_DIFF_LR, i, b) = calc_lr(adapt_l, adapt_r, sqrt(fabs(adapt_l / adapt_r)));
        TB(T_DIFF_CS, i, b) = calc_lr(adapt_sum, adapt_diff, sqrt(fabs(adapt_sum / adapt_diff)));
    }
    if constexpr (NB_ == kBands) {
        // the cross-band similarity of each tick (matrix4_mb.py:467-476),
        // term (b, j) from the two bands' diffs of the tick before, over the
        // group's threads
        G::sync();
        for (int x = t; x < n * kSim; x += nt) {
            const int i = x / kSim, b = (x % kSim) / kBands, j = x % kBands;
            const double lb = i > 0 ? TB(T_DIFF_LR, i - 1, b) : dprev[b];
            const double lj = i > 0 ? TB(T_DIFF_LR, i - 1, j) : dprev[j];
            const double cb = i > 0 ? TB(T_DIFF_CS, i - 1, b) : dprev[kBands + b];
            const double cj = i > 0 ? TB(T_DIFF_CS, i - 1, j) : dprev[kBands + j];
            const double d_lr = fabs(lb - lj);
            const double d_cs = fabs(cb - cj);
            sb[x] = smoothstep(fma(-dmax(d_lr, d_cs), 16.0 / kPi, 1.0));
        }
        G::sync();
        if (rec >= 0) {
            dprev[rec] = TB(T_DIFF_LR, n - 1, rec);
            dprev[kBands + rec] = TB(T_DIFF_CS, n - 1, rec);
        }
    }
    G::sync();
#undef TB
}

// One control tick's decision-dependent rest (event_step, m4_engine.py:
// 395-686, less what the pre-phase put in the table). f: the tick's table
// slots, fs apart; rb: the lane's rings (R_* offsets); thresh: the event
// threshold; base_ord_ns, clip_thresh, pcf_sens: the lane's (matrix4_mb's
// bands differ in them). out: ax_lr, ax_cs, ax_ev_lr, ax_ev_cs, ax_dpwr_lr,
// ax_dpwr_cs (the axes normalized), pwrcmp_factor.
__device__ __forceinline__ void event_chain(const EvParams& p, double base_ord_ns,
                                            double clip_thresh, double pcf_sens, Ev& e, double* rb,
                                            const double* f, int fs, double thresh, double* out) {
    const int L = p.buf_len;
    const long long t = e.i[I_T];
    const int bp = (int)e.i[I_BUF_P];
    double* ord_buf = rb + R_ORD * L;
    double* ord_lp_buf = rb + R_ORD_LP * L;
    double* diff_buf = rb + R_DIFF * L;
    double* slope_buf = rb + R_SLOPE * L;
    double* ds_ord_buf = rb + R_DS_ORD * L;
    double* max_buf = rb + R_MAX * L;
    const double ord_lr = f[T_ORD_LR * fs], ord_cs = f[T_ORD_CS * fs];
    const double ord_lp_lr = f[T_LP_LR * fs], ord_lp_cs = f[T_LP_CS * fs];
    const double diff_lr = f[T_DIFF_LR * fs], diff_cs = f[T_DIFF_CS * fs];
    const double l_pwr_xf = f[T_XF_L * fs], r_pwr_xf = f[T_XF_R * fs];
    const double n2_new = f[T_N2 * fs], n3_new = f[T_N3 * fs];
    const double l_mask = f[T_MASK_L * fs], r_mask = f[T_MASK_R * fs];

    const double lpd0 = ord_lp_buf[2 * bp], lpd1 = ord_lp_buf[2 * bp + 1];  // delayed
    const double ord_ns = e.ons * base_ord_ns;
    double* m = e.svf_m;  // [4][2]
    const double y0 = svf_pk_run(p.svf1_a0, p.svf1_alpha, p.svf1_beta, m[0], m[1], lpd0, ord_ns);
    const double notched_lr = svf_pk_run(p.svf2_a0, p.svf2_alpha, p.svf2_beta, m[4], m[5], y0, ord_ns);
    const double y1 = svf_pk_run(p.svf1_a0, p.svf1_alpha, p.svf1_beta, m[2], m[3], lpd1, ord_ns);
    const double notched_cs = svf_pk_run(p.svf2_a0, p.svf2_alpha, p.svf2_beta, m[6], m[7], y1, ord_ns);

    ord_buf[2 * bp] = ord_lr;
    ord_buf[2 * bp + 1] = ord_cs;
    ord_lp_buf[2 * bp] = ord_lp_lr;
    ord_lp_buf[2 * bp + 1] = ord_lp_cs;
    diff_buf[2 * bp] = diff_lr;
    diff_buf[2 * bp + 1] = diff_cs;

    const double adj = dmax(1.0 - e.ord_factor / 20.0, 0.5);
    e.adj = adj;
    double ord_factor = e.ord_factor * p.ord_factor_c;

    double* nrm = e.norm;
    const double n0_new = ewma(nrm[0], fabs(l_pwr_xf - n2_new * p.norm_accom_factor * adj), p.g_norm);
    const double n1_new = ewma(nrm[1], fabs(r_pwr_xf - n3_new * p.norm_accom_factor * adj), p.g_norm);
    nrm[0] = n0_new;
    nrm[1] = n1_new;
    nrm[2] = n2_new;
    nrm[3] = n3_new;
    const double l_mask_norm =
        n0_new >= kDblMin ? l_mask / n0_new : (l_mask < kDblMin ? 0.0 : clip_thresh);
    const double r_mask_norm =
        n1_new >= kDblMin ? r_mask / n1_new : (r_mask < kDblMin ? 0.0 : clip_thresh);
    const double sm0 = ewma(e.smooth[0], dmin(l_mask_norm, clip_thresh), p.g_smooth);
    const double sm1 = ewma(e.smooth[1], dmin(r_mask_norm, clip_thresh), p.g_smooth);
    e.smooth[0] = sm0;
    e.smooth[1] = sm1;
    const double sl0 = ewma(e.slow[0], sm0, p.g_slow);
    const double sl1 = ewma(e.slow[1], sm1, p.g_slow);
    e.slow[0] = sl0;
    e.slow[1] = sl1;
    const double l_event = (sm0 - sl0) * adj;
    const double r_event = (sm1 - sl1) * adj;
    const double l_slope = l_event - e.last[0];
    const double r_slope = r_event - e.last[1];
    e.last[0] = l_event;
    e.last[1] = r_event;
    e.slope_last[0] = l_slope;
    e.slope_last[1] = r_slope;
    e.diff_last[0] = diff_lr;
    e.diff_last[1] = diff_cs;
    slope_buf[2 * bp] = l_slope;
    slope_buf[2 * bp + 1] = r_slope;
    const double max_d = max_buf[bp];
    max_buf[bp] = dmax(l_event, r_event);
    e.pwrcmp = ewma_scale_asym(e.pwrcmp, 1.0 - smoothstep(max_d * pcf_sens), p.g_pwrcmp, 1.0,
                               kPwrcmpRiseFall);

    // --- event sampling trigger (matrix4_common.c:567-609) ---
    bool* b = e.b;
    const bool trigger = !b[B_SAMPLE] && ((l_slope > 0.0 && l_event > thresh) ||
                                          (r_slope > 0.0 && r_event > thresh));
    const bool new_f1_l = l_event >= r_event;
    const bool new_f1_r = r_event >= l_event;
    const bool fresh = (t - e.i[I_T_HOLD]) > 1;
    const bool tr_fresh = trigger && fresh;
    const bool tr_fuse = trigger && !fresh;

    // averaging seed, and where a fresh event starts the lookback (how far
    // back the slope keeps increasing, bounded by L) and the C-ordered
    // masked EWMA replay over it: nothing else reads them
    double seeded[4] = {ord_lr, ord_cs, diff_lr, diff_cs};
    int steps = 0;
    if (tr_fresh) {
        const int pick = (new_f1_l && !new_f1_r) ? 0 : ((new_f1_r && !new_f1_l) ? 1 : 2);
        const double* sb = slope_buf;
#define SEL_SLOPE(i) (pick == 2 ? sb[2 * (i)] + sb[2 * (i) + 1] : sb[2 * (i) + pick])
        for (int j = 1; j < L; ++j) {
            const int i_pos = wrap(bp - j, L);
            const int k_pos = wrap(bp - j + 1, L);
            if (!(SEL_SLOPE(i_pos) > SEL_SLOPE(k_pos))) break;
            ++steps;
        }
#undef SEL_SLOPE
        const int lb_start = wrap(bp - steps, L);
        for (int j = 0; j < steps; ++j) {
            const int idx = wrap(lb_start + j, L);
            seeded[0] = ewma(seeded[0], ord_buf[2 * idx], p.g_avg);
            seeded[1] = ewma(seeded[1], ord_buf[2 * idx + 1], p.g_avg);
            seeded[2] = ewma(seeded[2], diff_buf[2 * idx], p.g_avg);
            seeded[3] = ewma(seeded[3], diff_buf[2 * idx + 1], p.g_avg);
        }
    }

    bool s_sample = trigger ? true : b[B_SAMPLE];
    const bool s_f1_l = trigger ? new_f1_l : b[B_F1_L];
    const bool s_f1_r = trigger ? new_f1_r : b[B_F1_R];
    const bool s_f1_use_ord = trigger ? false : b[B_F1_USE_ORD];
    const bool s_f1_fuse = trigger ? tr_fuse : b[B_F1_FUSE];
    const long long s_t_sample =
        tr_fresh ? t - steps : (tr_fuse ? t - p.sample_frames / 2 : e.i[I_T_SAMPLE]);
    double s_max1 = tr_fresh ? 0.0 : e.max1;
    double av[4];
    for (int k = 0; k < 4; ++k) av[k] = tr_fresh ? seeded[k] : e.avg[k];

    // --- sampling phase (matrix4_common.c:611-657) ---
    const bool in_sample = s_sample;
    if (in_sample) {
        av[0] = ewma(av[0], ord_lr, p.g_avg);
        av[1] = ewma(av[1], ord_cs, p.g_avg);
        av[2] = ewma(av[2], diff_lr, p.g_avg);
        av[3] = ewma(av[3], diff_cs, p.g_avg);
        s_max1 = dmax(s_max1, dmax(l_event, r_event));
    }
    for (int k = 0; k < 4; ++k) e.avg[k] = av[k];
    const bool sample_done = in_sample && (t - s_t_sample) >= p.sample_frames;
    const bool use_ord = (fabs(av[2]) + fabs(av[3])) > p.diff_lim;
    const bool f1_use_ord = sample_done ? (s_f1_use_ord || use_ord) : s_f1_use_ord;
    const bool ignore1 = sample_done && s_f1_fuse && f1_use_ord && !b[B_F0_USE_ORD];
    const bool ignore2 = sample_done && !ignore1 && p.rear_ev_mask > 0.0 && av[3] < -kPi4 / 12 &&
                         ((s_f1_l && l_event < thresh * p.rear_ev_mask) ||
                          (s_f1_r && r_event < thresh * p.rear_ev_mask));
    const bool accept = sample_done && !ignore1 && !ignore2;
    s_sample = sample_done ? false : s_sample;
    if (ignore1 || ignore2) e.i[I_IGNORE_COUNT] += 1;
    const bool s_hold = accept ? true : b[B_HOLD];
    const long long s_t_hold = accept ? t : e.i[I_T_HOLD];
    if (accept) {
        e.dir_lr = f1_use_ord ? av[0] : av[2];
        e.dir_cs = f1_use_ord ? av[1] : av[3];
    }
    ord_factor = ord_factor + ((accept && f1_use_ord) ? 1.0 : 0.0);
    if (accept && f1_use_ord && !s_f1_fuse) e.i[I_ORD_COUNT] += 1;
    if (accept && !f1_use_ord && !s_f1_fuse) e.i[I_DIFF_COUNT] += 1;
    const bool f0_l = accept ? s_f1_l : b[B_F0_L];
    const bool f0_r = accept ? s_f1_r : b[B_F0_R];
    const bool f0_use_ord = accept ? f1_use_ord : b[B_F0_USE_ORD];
    const bool f0_fuse = accept ? s_f1_fuse : b[B_F0_FUSE];
    const bool f0_end_s = accept ? false : b[B_F0_END];
    if (accept) e.max0 = s_max1;
    e.max1 = s_max1;
    const double ds_diff_new =
        1.0 + smoothstep((s_max1 - thresh) / (thresh * kDiffWeightScale)) * kDiffSensWeight;
    if (accept) e.ds_diff = ds_diff_new;
    const double ds1 = accept ? ds_diff_new * 0.25 : e.dscale[1];

    // --- hold / drift phase (matrix4_common.c:658-698) ---
    const bool hold = s_hold;
    const double* dr = e.drift;
    const double* dp = e.dpwr;
    const double ds_diff_run = ewma_scale(ds1, e.ds_diff, p.g_ds1, e.ds_diff);
    const double dr2_h = ewma_scale(dr[2], e.dir_lr, p.g_drift_fast, ds_diff_run);
    const double dr3_h = ewma_scale(dr[3], e.dir_cs, p.g_drift_fast, ds_diff_run);
    const bool end_trig = (f0_l && sm0 <= kEventEndThresh) || (f0_r && sm1 <= kEventEndThresh);
    const bool f0_end = f0_end_s || (hold && end_trig);
    const long long held_frames = t - s_t_hold;
    const bool release = hold && ((held_frames >= p.min_hold_frames && f0_end) ||
                                  held_frames >= p.max_hold_frames);
    if (release && held_frames < p.max_hold_frames) e.i[I_EARLY_COUNT] += 1;
    const double dp2_h = ewma_scale(dp[2], e.dir_lr, p.g_dpwr_fast, ds_diff_run);
    const double dp3_h = ewma_scale(dp[3], e.dir_cs, p.g_dpwr_fast, ds_diff_run);

    // non-hold path
    const double ds_ord_prev = ds_ord_buf[bp];
    const double ds_ord_in =
        drift_err_scale(dr[0], dr[1], notched_lr, notched_cs, kOrdSensErr) * ds_ord_prev;
    const double ds_ord = ewma_set_max(e.dscale[0], ds_ord_in, p.g_ds0);
    const double ds0_new = ds_ord;
    const double dr0_nh = ewma_scale(dr[0], notched_lr, p.g_drift_slow, ds_ord);
    const double dr1_nh = ewma_scale(dr[1], notched_cs, p.g_drift_slow, ds_ord);
    const double ds_dpwr = drift_err_scale(dp[0], dp[1], ord_lp_lr, ord_lp_cs, kOrdDpwrSensErr);
    const double dp0_nh = ewma_scale(dp[0], ord_lp_lr, p.g_dpwr_slow, ds_dpwr);
    const double dp1_nh = ewma_scale(dp[1], ord_lp_cs, p.g_dpwr_slow, ds_dpwr);

    double ax_lr = hold ? dr2_h : dr0_nh;
    double ax_cs = hold ? dr3_h : dr1_nh;
    const double ax_ev_lr = hold ? dr2_h : 0.0;
    const double ax_ev_cs = hold ? dr3_h : 0.0;
    double ax_dpwr_lr = hold ? dp2_h : dp0_nh;
    double ax_dpwr_cs = hold ? dp3_h : dp1_nh;

    // on release: seed slow drift from the current axes
    const double drift0 = release ? ax_lr : (hold ? dr[0] : dr0_nh);
    const double drift1 = release ? ax_cs : (hold ? dr[1] : dr1_nh);
    const double drift2 = hold ? dr2_h : ax_lr;
    const double drift3 = hold ? dr3_h : ax_cs;
    e.drift[0] = drift0;
    e.drift[1] = drift1;
    e.drift[2] = drift2;
    e.drift[3] = drift3;
    e.dpwr[0] = e.dpwr[2] = ax_dpwr_lr;
    e.dpwr[1] = e.dpwr[3] = ax_dpwr_cs;
    const double dscale0 = release ? 1.0 : (hold ? e.dscale[0] : ds0_new);
    e.dscale[0] = dscale0;
    e.dscale[1] = hold ? ds_diff_run : ds1;

    norm_axes(ax_lr, ax_cs);
    norm_axes(ax_dpwr_lr, ax_dpwr_cs);
    e.ons = ewma_set_max(e.ons, ord_notch_scale(ax_lr, ax_cs), p.g_ord_notch_scale);
    const double ds_ord_thresh = thresh * kOrdWeightThresh;
    const double x_w = (dmax(sm0, sm1) - ds_ord_thresh) / (thresh * 1.5 - ds_ord_thresh);
    ds_ord_buf[bp] = (sm0 > ds_ord_thresh || sm1 > ds_ord_thresh)
                         ? smoothstep(x_w) * kOrdSensWeight + 1.0
                         : 1.0;
    e.ord_factor = ord_factor;

    b[B_SAMPLE] = s_sample;
    b[B_HOLD] = release ? false : hold;
    b[B_F1_L] = s_f1_l;
    b[B_F1_R] = s_f1_r;
    b[B_F1_USE_ORD] = f1_use_ord;
    b[B_F1_FUSE] = s_f1_fuse;
    b[B_F0_L] = f0_l;
    b[B_F0_R] = f0_r;
    b[B_F0_USE_ORD] = f0_use_ord;
    b[B_F0_FUSE] = f0_fuse;
    b[B_F0_END] = f0_end;
    e.i[I_T_SAMPLE] = s_t_sample;
    e.i[I_T_HOLD] = s_t_hold;
    e.i[I_T] = t + 1;
    e.i[I_BUF_P] = wrap(bp + 1, L);

    out[0] = ax_lr;
    out[1] = ax_cs;
    out[2] = ax_ev_lr;
    out[3] = ax_ev_cs;
    out[4] = ax_dpwr_lr;
    out[5] = ax_dpwr_cs;
    out[6] = e.pwrcmp;
}

// --- K10: matrix coefficients (matrix4_common.c:715-978) ---

struct Phasors {
    double l_real, l_imag, r_real, r_imag;
};

__device__ Phasors input_phasors(double ph_lr, double ph_cs) {
    const double sin_lr = sin(ph_lr + kPi4);
    const double cos_lr = cos(ph_lr + kPi4);
    const bool inside = (fabs(ph_lr) + fabs(ph_cs)) < kPi4;
    const double ratio = sin(2.0 * ph_cs) / (inside ? cos(2.0 * ph_lr) : 1.0);
    const double alpha = sqrt(dmax(1.0 - ratio * ratio, 0.0));
    const double beta = sqrt(1.0 + alpha);
    const double gamma = sqrt(dmax(1.0 - alpha, 0.0));
    const bool neg = ph_cs < 0.0;
    const double sin_theta_in = neg ? 0.5 * (beta + gamma) : 0.5 * (beta - gamma);
    const double cos_theta_in = neg ? 0.5 * (beta - gamma) : 0.5 * (beta + gamma);
    const double sin_theta = inside ? sin_theta_in : (neg ? 1.0 : 0.0);
    const double cos_theta = inside ? cos_theta_in : (neg ? 0.0 : 1.0);
    return {sin_lr * cos_theta, sin_lr * sin_theta, cos_lr * cos_theta, cos_lr * -sin_theta};
}

__device__ __forceinline__ double pwr_sum(double a, double b) { return sqrt(a * a + b * b); }

// m: ll lr rl rr lsl lsr rsl rsr; rets: (front, surr) for the two shelf args
__device__ void calc_matrix_coefs_v1(double lr, double cs, double dp_lr, double dp_cs,
                                     double surr_mult, const double* shelf_args, double* m,
                                     double* rets) {
    const double abs_lr = fabs(lr);
    const double gl = 1.0 + tan(abs_lr - kPi4);
    const double gc_2 = cs > 0.0 ? 0.5 + 0.5 * tan(cs - kPi4) : 0.0;
    double lsl = 1.0 - gc_2;
    double lsr = -gc_2;
    double rsl = lsr;
    double rsr = lsl;
    const double cs_gl = cs > -kPi4 / 2 ? 3.0 * cs : cs - kPi4;
    const double fa = cs >= 0.0 ? 1.0 : 1.0 + sin(cs_gl);
    const double fb = cs >= 0.0 ? 1.0 : cos(cs_gl);
    if (lr > 0.0) {
        lsl = lsl - gl * gl * fa;
        lsr = lsr - gl * fb;
    }
    if (lr < 0.0) {
        rsl = rsl - gl * fb;
        rsr = rsr - gl * gl * fa;
    }
    const double pu_sl = pwr_sum(lsl, lsr);
    lsl = lsl / pu_sl;
    lsr = lsr / pu_sl;
    const double pu_sr = pwr_sum(rsl, rsr);
    rsl = rsl / pu_sr;
    rsr = rsr / pu_sr;

    const Phasors ph = input_phasors(dp_lr, dp_cs);
    const double gd_sl2 = sq(lsl * ph.l_real + lsr * ph.r_real) + sq(lsl * ph.l_imag + lsr * ph.r_imag);
    const double gd_sr2 = sq(rsl * ph.l_real + rsr * ph.r_real) + sq(rsl * ph.l_imag + rsr * ph.r_imag);
    const double pd_s = gd_sl2 + gd_sr2;

    const double surr_mult2 = surr_mult * surr_mult;
    const double adj_norm_mult2 = 1.0 / (1.0 + surr_mult2);
    const double surr_pwr = surr_mult2 * adj_norm_mult2;
    const double pdc_f = sqrt(1.0 - surr_pwr * dmin(pd_s, 1.0));
    const double pdc_s = sqrt(surr_pwr);
    for (int k = 0; k < 2; ++k) {
        const double arg = shelf_args[k];
        const double hf2 = arg * arg;
        const double anm = 1.0 / (1.0 + hf2);
        const double spw = hf2 * anm;
        rets[2 * k] = sqrt(1.0 - spw * dmin(pd_s, 1.0)) / pdc_f;
        rets[2 * k + 1] = sqrt(spw) / dmax(pdc_s, kDblMin);
    }
    m[0] = pdc_f;
    m[1] = 0.0;
    m[2] = 0.0;
    m[3] = pdc_f;
    m[4] = lsl * pdc_s;
    m[5] = lsr * pdc_s;
    m[6] = rsl * pdc_s;
    m[7] = rsr * pdc_s;
}

__device__ void calc_matrix_coefs_v4(double lr, double cs, double dp_lr, double dp_cs,
                                     double surr_mult, double surr_mult_rear, double param,
                                     const double* shelf_args, double* m, double* rets) {
    const double abs_lr = fabs(lr);
    const double abs_cs = fabs(cs);
    double lsl = 1.0, rsr = 1.0, lsr = 0.0, rsl = 0.0;
    const double gl = 1.0 + tan(abs_lr - kPi4);
    if (lr > 0.0) {
        lsl = lsl - gl * gl;
        lsr = lsr - gl;
    }
    if (lr < 0.0) {
        rsl = rsl - gl;
        rsr = rsr - gl * gl;
    }
    const double gc_2_pos = 0.5 + 0.5 * tan(abs_cs - kPi4);
    const double cs_gc = cs > -kPi4 / 2 ? abs_cs : kPi4 + cs;
    const double gc_2_neg = 0.5 + 0.5 * tan(cs_gc - kPi4);
    if (cs > 0.0) {
        lsl = lsl - gc_2_pos;
        lsr = lsr - gc_2_pos;
        rsl = rsl - gc_2_pos;
        rsr = rsr - gc_2_pos;
    } else if (cs < 0.0) {
        lsl = lsl - gc_2_neg;
        lsr = lsr + gc_2_neg;
        rsl = rsl + gc_2_neg;
        rsr = rsr - gc_2_neg;
    }
    const double pu_sl = pwr_sum(lsl, lsr);
    lsl = lsl / pu_sl;
    lsr = lsr / pu_sl;
    const double pu_sr = pwr_sum(rsl, rsr);
    rsl = rsl / pu_sr;
    rsr = rsr / pu_sr;

    // front elements
    const double front_gc_2 = 0.5 + 0.5 * tan(abs_cs - kPi4);
    const double front_cs = cs > -kPi4 / 2 ? 4.0 * abs_cs : kPi2;
    const double front_lr_mult = (abs_lr <= kPi4 / 2 ? 1.0 : 1.0 + cos(4.0 * abs_lr)) * param;
    double ll_n = -front_gc_2, rr_n = -front_gc_2, lr_n = front_gc_2, rl_n = front_gc_2;
    if (lr > 0.0) {
        ll_n = ll_n - gl * gl * sin(front_cs) * front_lr_mult;
        lr_n = lr_n + gl * (1.0 - cos(front_cs)) * front_lr_mult;
    }
    if (lr < 0.0) {
        rl_n = rl_n + gl * (1.0 - cos(front_cs)) * front_lr_mult;
        rr_n = rr_n - gl * gl * sin(front_cs) * front_lr_mult;
    }
    const double cf_sm2 = sq(dmin(surr_mult_rear, 1.0));
    const double cf = 1.0 - sqrt((1.0 - cf_sm2) / (1.0 + cf_sm2));
    ll_n = 1.0 + ll_n * cf;
    lr_n = lr_n * cf;
    rl_n = rl_n * cf;
    rr_n = 1.0 + rr_n * cf;
    const double pu_fl = pwr_sum(ll_n, lr_n);
    const double pu_fr = pwr_sum(rl_n, rr_n);
    const bool cs_nn = cs >= 0.0;
    const double ll = cs_nn ? 1.0 : ll_n / pu_fl;
    const double lrm = cs_nn ? 0.0 : lr_n / pu_fl;
    const double rl = cs_nn ? 0.0 : rl_n / pu_fr;
    const double rr = cs_nn ? 1.0 : rr_n / pu_fr;

    const Phasors ph = input_phasors(dp_lr, dp_cs);
    const double gd_fl2 = sq(ll * ph.l_real + lrm * ph.r_real) + sq(ll * ph.l_imag + lrm * ph.r_imag);
    const double gd_fr2 = sq(rl * ph.l_real + rr * ph.r_real) + sq(rl * ph.l_imag + rr * ph.r_imag);
    const double gd_sl2 = sq(lsl * ph.l_real + lsr * ph.r_real) + sq(lsl * ph.l_imag + lsr * ph.r_imag);
    const double gd_sr2 = sq(rsl * ph.l_real + rsr * ph.r_real) + sq(rsl * ph.l_imag + rsr * ph.r_imag);
    const double pd_f = gd_fl2 + gd_fr2;
    const double pd_s = gd_sl2 + gd_sr2;

    // weighted directional power
    const double abs_dp_lr = fabs(dp_lr);
    const double abs_dp_cs = fabs(dp_cs);
    const double lr2 = dp_lr * dp_lr;
    const double cs2 = dp_cs * dp_cs;
    const double wf_in = lr2 + cs2 > kDblMin ? sq((lr2 - cs2) / dmax(lr2 + cs2, kDblMin)) : 0.0;
    const bool case_a = dp_cs < 0.0 && abs_dp_cs < abs_dp_lr;
    const bool case_b = dp_cs < 0.0 && !case_a;
    const double pd_f_wf = case_a ? (pd_f - 1.0) * wf_in + 1.0 : (case_b ? 1.0 : pd_f);
    const double pd_s_wf = case_a ? (pd_s - 1.0) * wf_in + 1.0 : (case_b ? 1.0 : pd_s);
    const double pd_f_ws = case_a ? (pd_f - 1.0) * (1.0 - wf_in) + 1.0 : (case_b ? pd_f : 1.0);
    const double pd_s_ws = case_a ? (pd_s - 1.0) * (1.0 - wf_in) + 1.0 : (case_b ? pd_s : 1.0);

    const double surr_mult2 = surr_mult * surr_mult;
    const double adj_norm_mult2 = 1.0 / (1.0 + surr_mult2);
    const double pdc_fi2 = (1.0 - surr_mult2 * adj_norm_mult2 * pd_s_wf) / pd_f_wf;
    const double pdc_si2 = (1.0 - adj_norm_mult2 * pd_f_ws) / pd_s_ws;
    const double pdc_all2 = 1.0 / (pd_f * pdc_fi2 + pd_s * pdc_si2);
    const double pdc_f = sqrt(dmax(pdc_fi2, 0.0) * pdc_all2);
    const double pdc_s = sqrt(dmax(pdc_si2, 0.0) * pdc_all2);
    for (int k = 0; k < 2; ++k) {
        const double arg = shelf_args[k];
        const double hf2 = arg * arg;
        const double anm = 1.0 / (1.0 + hf2);
        const double fi2 = (1.0 - hf2 * anm * pd_s_wf) / pd_f_wf;
        const double si2 = (1.0 - anm * pd_f_ws) / pd_s_ws;
        const double all2 = 1.0 / (pd_f * fi2 + pd_s * si2);
        rets[2 * k] = sqrt(dmax(fi2, 0.0) * all2) / pdc_f;
        rets[2 * k + 1] = sqrt(dmax(si2, 0.0) * all2) / dmax(pdc_s, kDblMin);
    }
    m[0] = ll * pdc_f;
    m[1] = lrm * pdc_f;
    m[2] = rl * pdc_f;
    m[3] = rr * pdc_f;
    m[4] = lsl * pdc_s;
    m[5] = lsr * pdc_s;
    m[6] = rsl * pdc_s;
    m[7] = rsr * pdc_s;
}

// The 16 matrix values of one tick (matrix4.py:516-550). eo: the engine's
// outputs and w1.
__device__ void tick_vals(const K10Params& k, const double* eo, double fade, double* v) {
    const double ax_lr = eo[0], ax_cs = eo[1], pwrcmp = eo[6], w1 = eo[7];
    const double w = w1 - 1.0;
    const double surr_mult = (w * k.surr_mult1 + (1.0 - w) * k.surr_mult0) * fade;
    const double ct_pcf = k.contour_pwrcmp * pwrcmp;
    const double shelf_ct0 = w + (1.0 - w) * k.shelf_mult;
    const double shelf_ct1 = (shelf_ct0 - 1.0) * ct_pcf + 1.0;
    const double lp_ct0 = w + (1.0 - w) * k.lowpass_mult;
    const double pw = pow(dmax(ct_pcf, kDblMin), 1.0 / k.shelf_mult);
    const double lp_ct1 = (lp_ct0 - 1.0) * pw + 1.0;
    const double dp_lr = k.dpwr_decouple ? eo[4] : ax_lr;
    const double dp_cs = k.dpwr_decouple ? eo[5] : ax_cs;
    const double shelf_args[2] = {surr_mult * shelf_ct1, surr_mult * shelf_ct1 * lp_ct1};
    double rets[4];
    if (k.matrix_v4) {
        calc_matrix_coefs_v4(ax_lr, ax_cs, dp_lr, dp_cs, surr_mult, k.surr_mult1 * fade,
                             k.matrix_param, shelf_args, v, rets);
    } else {
        calc_matrix_coefs_v1(ax_lr, ax_cs, dp_lr, dp_cs, surr_mult, shelf_args, v, rets);
    }
    v[8] = shelf_ct0 / shelf_ct1 * rets[1];
    v[9] = lp_ct0 / lp_ct1 * rets[3] / dmax(rets[1], kDblMin);
    v[10] = rets[0];
    v[11] = rets[2] / rets[0];
    // phase flip (phase_flip_pos_rs, phase_flip_ap1_c0) and direct pan
    double x = ax_cs * (-2.0 / kPi4);
    x = x * x * 0.5 + 0.5;
    const double pf_pos = ax_cs >= 0.0 ? 0.5 : dmin(x, 1.0);
    const double dc = k.pf_c1 - k.pf_c0;
    v[12] = exp((1.0 - pf_pos) * dc + k.pf_c0) - 1.0;
    v[13] = exp(pf_pos * dc + k.pf_c0) - 1.0;
    const double ax = fabs(ax_lr);
    const double y0 = ax_cs + (kPi4 / 2);
    const double y = ax_cs > -kPi4 / 2 ? y0 * 2.0 : y0;
    const double z = dmin(dmax(ax - y, 0.0) * 6.0, kPi2);
    v[14] = ax_cs >= 0.0 ? 1.0 : cos(z);
    v[15] = ax_cs >= 0.0 ? 0.0 : sin(z);
}

// the fade multiplier at tick i (fade_mult, matrix4_common.h:265-280)
__device__ __forceinline__ double fade_at(int i, int D, long long fade_p, int fade_frames,
                                          int disable) {
    const long long tick = (long long)i * D + (D - 1);
    const long long at = fade_p - tick > 0 ? fade_p - tick : 0;
    const double posf = (double)at / (double)fade_frames;
    const double fade_lin = disable ? posf : 1.0 - posf;
    const double fade_sm = (1.0 - cos(fade_lin * kPi)) * 0.5;
    return at > 0 ? fade_sm : (disable ? 0.0 : 1.0);
}

// The 12 matrix values of one tick and band (matrix4_mb.py:505-526).
__device__ void tick_vals_mb(const MbParams& k, const double* eo, double fade, double contour,
                             double* v) {
    const double ax_lr = eo[0], ax_cs = eo[1], pwrcmp = eo[6];
    const double w = smoothstep(ax_cs * (-2.0 / kPi4));
    const double surr_mult = (w * k.surr_mult1 + (1.0 - w) * k.surr_mult0) * fade;
    const double ct_pcf = k.contour_pwrcmp * pwrcmp;
    const double ct0 = w + (1.0 - w) * contour;
    const double ct1 = (ct0 - 1.0) * ct_pcf + 1.0;
    const double ct2 = ct0 / ct1;
    const double dp_lr = k.dpwr_decouple ? eo[4] : ax_lr;
    const double dp_cs = k.dpwr_decouple ? eo[5] : ax_cs;
    const double no_shelf[2] = {1.0, 1.0};  // matrix4_mb asks for no shelf gains
    double m[8], rets[4];
    if (k.matrix_v4) {
        calc_matrix_coefs_v4(ax_lr, ax_cs, dp_lr, dp_cs, surr_mult * ct1, k.surr_mult1 * fade,
                             k.matrix_param, no_shelf, m, rets);
    } else {
        calc_matrix_coefs_v1(ax_lr, ax_cs, dp_lr, dp_cs, surr_mult * ct1, no_shelf, m, rets);
    }
    for (int j = 0; j < 4; ++j) v[j] = m[j];
    for (int j = 4; j < 8; ++j) v[j] = m[j] * ct2;
    double x = ax_cs * (-2.0 / kPi4);
    x = x * x * 0.5 + 0.5;
    const double pf_pos = ax_cs >= 0.0 ? 0.5 : dmin(x, 1.0);
    const double dc = k.pf_c1 - k.pf_c0;
    v[8] = exp((1.0 - pf_pos) * dc + k.pf_c0) - 1.0;
    v[9] = exp(pf_pos * dc + k.pf_c0) - 1.0;
    const double ax = fabs(ax_lr);
    const double y0 = ax_cs + (kPi4 / 2);
    const double y = ax_cs > -kPi4 / 2 ? y0 * 2.0 : y0;
    const double z = dmin(dmax(ax - y, 0.0) * 6.0, kPi2);
    v[10] = ax_cs >= 0.0 ? 1.0 : cos(z);
    v[11] = ax_cs >= 0.0 ? 0.0 : sin(z);
}

// The interpolator insert (matrix4_common.h:358-367) of ticks [i0, i0 + n)
// by the epilogue's threads (et of ne): row i of the coefficient sets from
// rows i .. i + 3 of [interp_y[1:] | vals], `row` values a row.
template <class T>
__device__ void insert_rows(const T* iy, const double* vt, T* ics, int i0, int n, int row, int et,
                            int ne) {
#define EXT(r, c) ((r) < 3 ? (double)iy[((r) + 1) * row + (c)] : vt[((r) - 3) * row + (c)])
    for (int j = et; j < n * row; j += ne) {
        const int i = i0 + j / row, c = j % row;
        const double iy0 = EXT(i, c), iy1 = EXT(i + 1, c), iy2 = EXT(i + 2, c), iy3 = EXT(i + 3, c);
        const double ia = iy2 - iy0;
        T* o = ics + (size_t)i * 3 * row + c;
        o[0] = (T)(0.5 * iy1 + 0.25 * (iy0 + iy2));
        o[row] = (T)(0.5 * ia);
        o[2 * row] = (T)(0.25 * (iy3 - iy1 - ia));
    }
#undef EXT
}

// the window the next block starts from: rows Nc - 1 .. Nc + 2 of
// [interp_y[1:] | vals]
template <class T>
__device__ void window_out(const T* iy, const double* vt, T* iy_out, int Nc, int row) {
    for (int j = threadIdx.x; j < 4 * row; j += blockDim.x) {
        const int r = Nc - 1 + j / row, c = j % row;
        iy_out[j] = (T)(r < 3 ? (double)iy[(r + 1) * row + c] : vt[(r - 3) * row + c]);
    }
}

// The background weight (smf_asym_run on smoothstep(ax_cs·(-2/(π/4))) + 1)
// over n ticks of a chunk's engine outputs ob, tick by tick, into slot 7.
__device__ void bg_weight(const EvParams& p, double* ob, int C, int n, double& m0, double& m1) {
    for (int i = 0; i < n; ++i) {
        const double sv = smoothstep(ob[1 * C + i] * (-2.0 / kPi4)) + 1.0;
        const double cc = sv > m1 ? p.bg_c0 : p.bg_c1;
        const double g = dmin(p.bg_g0 + cc * fabs(m0 - m1), 0.39);
        m0 = m0 + g * (sv - m0);
        m1 = m1 + g * (m0 - m1);
        ob[7 * C + i] = m1;
    }
}

// matrix4's K10 for ticks [i0, i0 + n), chunk-relative 0 .. n - 1 in ob:
// the fade and the 16 matrix values into vt_s (rounded to T), the display
// values into aux_s; thread t of nt.
template <class T>
__device__ void k10_rows(const K10Params& k, const double* ob, int C, int i0, int n,
                         double* vt_s, T* aux_s, long long fade_p, int disable, int t, int nt) {
    for (int i = t; i < n; i += nt) {
        double o[NEO];
        for (int q = 0; q < NEO; ++q) o[q] = ob[q * C + i];
        double* v = vt_s + (size_t)(i0 + i) * kInterp;
        tick_vals(k, o, fade_at(i0 + i, k.D, fade_p, k.fade_frames, disable), v);
        for (int q = 0; q < kInterp; ++q) v[q] = (double)(T)v[q];  // float32: rounded here
        T* a = aux_s + (size_t)(i0 + i) * 4;
        for (int q = 0; q < 4; ++q) a[q] = (T)o[q];
    }
}

// matrix4_mb's K10 for ticks [i0, i0 + n) and every band, as k10_rows.
template <class T>
__device__ void k10_rows_mb(const MbParams& k, const double* ob, int C, int i0, int n, double* vt,
                            T* aux, long long fade_p, int disable, int t, int nt) {
    for (int x = t; x < n * kBands; x += nt) {
        const int i = x / kBands, bb = x % kBands;
        double o[NEO];
        for (int q = 0; q < NEO; ++q) o[q] = ob[(q * C + i) * kBands + bb];
        const size_t idx = (size_t)(i0 + i) * kBands + bb;
        double* v = vt + idx * kSigMb;
        tick_vals_mb(k, o, fade_at(i0 + i, k.D, fade_p, k.fade_frames, disable), k.contour[bb], v);
        for (int q = 0; q < kSigMb; ++q) v[q] = (double)(T)v[q];  // float32: rounded here
        aux[idx * 2] = (T)o[0];
        aux[idx * 2 + 1] = (T)o[1];
    }
}

// the state's pointers P (EvPtrs or EvPtrsF32) and the storage type T of
// the background weight's pair, the window, the coefficient sets and aux.
// One block a lane, C ticks a chunk. The whole block runs chunk 0's
// pre-phase; then, in iteration c, warp 1 runs chunk c + 1's pre-phase,
// warp 0 chunk c's chain and the other warps chunk c - 1's epilogue, and
// every role meets the chunk barrier once an iteration; last, the whole
// block runs the last chunk's epilogue.
template <class P, class T>
__global__ void __launch_bounds__(kMaxThreads)
    m4_event_kernel(P in, P out, const T* __restrict__ bg_in, const T* __restrict__ bg_in_lo,
                    T* __restrict__ bg_out, T* __restrict__ bg_out_lo,
                    const double* __restrict__ env_ds, double* __restrict__ vt,
                    const T* __restrict__ iy_in, T* __restrict__ ics, T* __restrict__ iy_out,
                    T* __restrict__ aux, double* ring_dev, EvParams p, K10Params k, int Nc,
                    int C, long long fade_p, int disable) {
    extern __shared__ double smem[];
    const int s = blockIdx.x;
    const int L = p.buf_len;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nch = (Nc + C - 1) / C;
    const Smem sm =
        carve(smem, 1, L, C, ring_dev != nullptr ? ring_dev + (size_t)s * R_ALL * L : nullptr);
    const double* env = env_ds + (size_t)s * Nc * 8;
    const int rec = warp == 1 && lane == 0 ? 0 : -1;  // the recurrences' thread
    Pre q;
    if (rec >= 0) load_pre(q, in, s);
    rings_in(sm.ring, in, s, 1, L);
    __syncthreads();
    pre_phase<1, Block>(p, q, threadIdx.x, blockDim.x, rec, env, 8, min(C, Nc), C, sm.tab[0],
                        nullptr, nullptr);
    if (warp == 0) {
        Ev e;
        if (lane == 0) load_ev(e, in, s);
        for (int c = 0; c < nch; ++c) {
            if (lane == 0) {
                const int n = min(C, Nc - c * C);
                const double* tb = sm.tab[c & 1];
                double* ob = sm.eo[c & 1];
                for (int i = 0; i < n; ++i) {
                    double o[7];
                    event_chain(p, p.base_ord_ns, p.clip_thresh, p.pcf_sens, e, sm.ring, tb + i, C,
                                p.thresh, o);
                    for (int j = 0; j < 7; ++j) ob[j * C + i] = o[j];
                }
            }
            __syncwarp();
            named_barrier(kChunkBarrier, blockDim.x);
        }
        if (lane == 0) store_ev(e, out, s);
    } else if (warp == 1) {
        for (int c = 0; c < nch; ++c) {
            if (c + 1 < nch) {
                pre_phase<1, Warp>(p, q, lane, 32, rec, env + (size_t)(c + 1) * C * 8, 8,
                                   min(C, Nc - (c + 1) * C), C, sm.tab[(c + 1) & 1], nullptr,
                                   nullptr);
            }
            named_barrier(kChunkBarrier, blockDim.x);
        }
        if (rec >= 0) store_pre(q, out, s);
    } else {
        // the epilogue of the full chunk before: thread et of ne
        const int et = threadIdx.x - 64, ne = blockDim.x - 64;
        double* vt_s = vt + (size_t)s * Nc * kInterp;
        const T* iy_s = iy_in + (size_t)s * 4 * kInterp;
        T* ics_s = ics + (size_t)s * Nc * 3 * kInterp;
        T* aux_s = aux + (size_t)s * Nc * 4;
        double m0 = 0.0, m1 = 0.0;
        if (et == 0) {
            m0 = pair_load(bg_in, bg_in_lo, 2 * s);
            m1 = pair_load(bg_in, bg_in_lo, 2 * s + 1);
        }
        for (int c = 0; c < nch; ++c) {
            if (c > 0) {
                const int i0 = (c - 1) * C;
                double* ob = sm.eo[(c - 1) & 1];
                if (et == 0) bg_weight(p, ob, C, C, m0, m1);
                named_barrier(kEpilogueBarrier, ne);
                k10_rows(k, ob, C, i0, C, vt_s, aux_s, fade_p, disable, et, ne);
                named_barrier(kEpilogueBarrier, ne);
                insert_rows(iy_s, vt_s, ics_s, i0, C, kInterp, et, ne);
            }
            named_barrier(kChunkBarrier, blockDim.x);
        }
        if (et == 0) {
            bg_weight(p, sm.eo[(nch - 1) & 1], C, Nc - (nch - 1) * C, m0, m1);
            pair_store(bg_out, bg_out_lo, 2 * s, m0);
            pair_store(bg_out, bg_out_lo, 2 * s + 1, m1);
        }
    }
    // the last chunk's epilogue, by the whole block (the lane's pointers
    // are computed again here: held across the chain's branch, they cost
    // the chain registers)
    __syncthreads();
    const int i0 = (nch - 1) * C;
    double* vt_s = vt + (size_t)s * Nc * kInterp;
    const T* iy_s = iy_in + (size_t)s * 4 * kInterp;
    T* ics_s = ics + (size_t)s * Nc * 3 * kInterp;
    T* aux_s = aux + (size_t)s * Nc * 4;
    k10_rows(k, sm.eo[(nch - 1) & 1], C, i0, Nc - i0, vt_s, aux_s, fade_p, disable, threadIdx.x,
             blockDim.x);
    rings_out(out, sm.ring, s, 1, L);
    __syncthreads();
    insert_rows(iy_s, vt_s, ics_s, i0, Nc - i0, kInterp, threadIdx.x, blockDim.x);
    window_out(iy_s, vt_s, iy_out + (size_t)s * 4 * kInterp, Nc, kInterp);
}

// P and T as m4_event_kernel's; the thresholds are a (hi, lo) pair under
// float32. One block a stream of 13 bands, C ticks a chunk, the roles as
// m4_event_kernel's.
template <class P, class T>
__global__ void __launch_bounds__(kMaxThreads)
    m4mb_event_kernel(P in, P out, const T* __restrict__ evt_in, const T* __restrict__ evt_in_lo,
                      T* __restrict__ evt_out, T* __restrict__ evt_out_lo,
                      const double* __restrict__ env_ds, double* __restrict__ vt,
                      const T* __restrict__ iy_in, T* __restrict__ ics, T* __restrict__ iy_out,
                      T* __restrict__ aux, double* ring_dev, EvParams base, MbParams k, int Nc,
                      int C, long long fade_p, int disable) {
    extern __shared__ double smem[];
    const int L = base.buf_len;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nch = (Nc + C - 1) / C;
    const int b0 = blockIdx.x * kBands;  // the stream's first lane of the state
    const Smem sm = carve(smem, kBands, L, C,
                          ring_dev != nullptr ? ring_dev + (size_t)b0 * R_ALL * L : nullptr);
    constexpr int kRow = kBands * kSigMb;
    const size_t ts = kBands * 8;  // a tick's envelopes
    env_ds += (size_t)blockIdx.x * Nc * ts;
    const int rec = warp == 1 && lane < kBands ? lane : -1;  // band rec's recurrences
    Pre q;
    if (rec >= 0) {
        load_pre(q, in, b0 + rec);
        sm.dprev[rec] = leaf_get(in, F_DIFF_LAST, (size_t)(b0 + rec) * 2);
        sm.dprev[kBands + rec] = leaf_get(in, F_DIFF_LAST, (size_t)(b0 + rec) * 2 + 1);
    }
    rings_in(sm.ring, in, b0, kBands, L);
    __syncthreads();
    pre_phase<kBands, Block>(base, q, threadIdx.x, blockDim.x, rec, env_ds, ts, min(C, Nc), C,
                             sm.tab[0], sm.sim[0], sm.dprev);
    if (warp == 0) {
        // lane b runs band b's engine; the bands meet every tick in the
        // ballot of their candidacy
        const int b = lane;
        Ev e;
        double evt = 0.0, etmax = 0.0, etmin = 0.0;
        if (b < kBands) {
            load_ev(e, in, b0 + b);
            evt = pair_load(evt_in, evt_in_lo, b0 + b);
            etmax = k.etmax[b];
            etmin = k.etmin[b];
        }
        for (int c = 0; c < nch; ++c) {
            if (b < kBands) {
                const int n = min(C, Nc - c * C);
                const double* tb = sm.tab[c & 1];
                const double* sb = sm.sim[c & 1];
                double* ob = sm.eo[c & 1];
                for (int i = 0; i < n; ++i) {
                    // the cross-band threshold modulation (matrix4_mb.py:
                    // 467-480): the bands rising past their minimum
                    // threshold, and this band's similarity terms from the
                    // table, summed from band 0 up
                    const bool cand = (e.slope_last[0] > 0.0 && e.last[0] > etmin) ||
                                      (e.slope_last[1] > 0.0 && e.last[1] > etmin);
                    const unsigned cands = __ballot_sync((1u << kBands) - 1u, cand);
                    const double* sr = sb + (i * kBands + b) * kBands;
                    double fact = 0.0;
                    for (int j = 0; j < kBands; ++j) {
                        const double term = sr[j] * (((cands >> j) & 1u) ? 1.0 : 0.0);
                        fact = j == 0 ? term : fact + term;
                    }
                    fact = cand ? fact - 1.0 : 0.0;
                    const double target = fma(-((etmax - etmin) * fact), 1.0 / (kBands - 1), etmax);
                    const double up = fma(k.g_evt, target - evt, evt);
                    evt = target >= evt ? up : target;
                    double o[7];
                    event_chain(base, k.base_ord_ns[b], k.clip_thresh[b], k.pcf_sens[b], e,
                                sm.ring + (size_t)b * R_ALL * L, tb + i * kBands + b, C * kBands,
                                1.8 * (evt * (1.0 / 1.8)),  // EVENT_THRESH * thresh_scale
                                o);
                    for (int j = 0; j < 7; ++j) ob[(j * C + i) * kBands + b] = o[j];
                }
            }
            __syncwarp();
            named_barrier(kChunkBarrier, blockDim.x);
        }
        if (b < kBands) {
            store_ev(e, out, b0 + b);
            pair_store(evt_out, evt_out_lo, b0 + b, evt);
        }
    } else if (warp == 1) {
        for (int c = 0; c < nch; ++c) {
            if (c + 1 < nch) {
                pre_phase<kBands, Warp>(base, q, lane, 32, rec, env_ds + (size_t)(c + 1) * C * ts,
                                        ts, min(C, Nc - (c + 1) * C), C, sm.tab[(c + 1) & 1],
                                        sm.sim[(c + 1) & 1], sm.dprev);
            }
            named_barrier(kChunkBarrier, blockDim.x);
        }
        if (rec >= 0) store_pre(q, out, b0 + rec);
    } else {
        // the stream's scratch, window, coefficient sets and display values
        const size_t s = blockIdx.x;
        double* vt_s = vt + s * Nc * kRow;
        const T* iy_s = iy_in + s * 4 * kRow;
        T* ics_s = ics + s * Nc * 3 * kRow;
        T* aux_s = aux + s * Nc * kBands * 2;
        const int et = threadIdx.x - 64, ne = blockDim.x - 64;
        for (int c = 0; c < nch; ++c) {
            if (c > 0) {
                const int i0 = (c - 1) * C;
                k10_rows_mb(k, sm.eo[(c - 1) & 1], C, i0, C, vt_s, aux_s, fade_p, disable, et,
                            ne);
                named_barrier(kEpilogueBarrier, ne);
                insert_rows(iy_s, vt_s, ics_s, i0, C, kRow, et, ne);
            }
            named_barrier(kChunkBarrier, blockDim.x);
        }
    }
    // the last chunk's epilogue, by the whole block (the stream's pointers
    // computed again, as m4_event_kernel's)
    __syncthreads();
    const size_t s = blockIdx.x;
    double* vt_s = vt + s * Nc * kRow;
    const T* iy_s = iy_in + s * 4 * kRow;
    const int i0 = (nch - 1) * C;
    k10_rows_mb(k, sm.eo[(nch - 1) & 1], C, i0, Nc - i0, vt_s, aux + s * Nc * kBands * 2, fade_p,
                disable, threadIdx.x, blockDim.x);
    rings_out(out, sm.ring, b0, kBands, L);
    __syncthreads();
    insert_rows(iy_s, vt_s, ics + s * Nc * 3 * kRow, i0, Nc - i0, kRow, threadIdx.x, blockDim.x);
    window_out(iy_s, vt_s, iy_out + s * 4 * kRow, Nc, kRow);
}

// What a launch's geometry must hold: the roles' threads, a chunk of 1 to
// kMaxChunk ticks, and the shared memory its layout needs (no more than
// Hopper gives a block).
__host__ inline bool geometry_ok(int nb, int L, int threads, int C, size_t smem, bool ring_dev) {
    return threads >= kMinThreads && threads <= kMaxThreads && threads % 32 == 0 && C >= 1 &&
           C <= kMaxChunk && smem >= sizeof(double) * smem_doubles(nb, L, C, ring_dev) &&
           smem <= kMaxSmem;
}

// The kernels launch_m4 and launch_m4mb have launched in this process (host
// side): how a caller checks that a call is one launch.
unsigned long long event_launches = 0;

int counted(cudaError_t err) {
    if (err == cudaSuccess) ++event_launches;
    return (int)err;
}

template <class K>
int set_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
}

template <class P, class T>
int launch_m4(const P* in, const P* out, const T* bg_in, const T* bg_in_lo, T* bg_out,
              T* bg_out_lo, const double* env_ds, double* vt, const T* iy_in, T* ics, T* iy_out,
              T* aux, double* ring_dev, const EvParams* p, const K10Params* k, int S, int Nc,
              int threads, int C, size_t smem, long long fade_p, int disable, void* stream) {
    if (S <= 0 || Nc <= 0 || p->buf_len <= 0 || k->fade_frames <= 0 ||
        !geometry_ok(1, p->buf_len, threads, C, smem, ring_dev != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const int err = set_smem(m4_event_kernel<P, T>, smem);
    if (err != 0) return err;
    m4_event_kernel<P, T><<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        *in, *out, bg_in, bg_in_lo, bg_out, bg_out_lo, env_ds, vt, iy_in, ics, iy_out, aux,
        ring_dev, *p, *k, Nc, C, fade_p, disable);
    return counted(cudaGetLastError());
}

template <class P, class T>
int launch_m4mb(const P* in, const P* out, const T* evt_in, const T* evt_in_lo, T* evt_out,
                T* evt_out_lo, const double* env_ds, double* vt, const T* iy_in, T* ics,
                T* iy_out, T* aux, double* ring_dev, const EvParams* p, const MbParams* k, int S,
                int Nc, int threads, int C, size_t smem, long long fade_p, int disable,
                void* stream) {
    if (S <= 0 || Nc <= 0 || p->buf_len <= 0 || k->fade_frames <= 0 ||
        !geometry_ok(kBands, p->buf_len, threads, C, smem, ring_dev != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const int err = set_smem(m4mb_event_kernel<P, T>, smem);
    if (err != 0) return err;
    m4mb_event_kernel<P, T><<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        *in, *out, evt_in, evt_in_lo, evt_out, evt_out_lo, env_ds, vt, iy_in, ics, iy_out, aux,
        ring_dev, *p, *k, Nc, C, fade_p, disable);
    return counted(cudaGetLastError());
}

}  // namespace

extern "C" unsigned long long dsp_m4_event_launches() { return event_launches; }

// S lanes of Nc ticks: the event state in and out (EvPtrs), bg [S, 2],
// env_ds [S, Nc, 8], the scratch vt [S, Nc, 16], interp_y [S, 4, 16] in and
// out, ics [S, Nc, 3, 16], aux [S, Nc, 4], ring: null (the rings in shared
// memory) or the rings' device scratch [S, 10 · buf_len]; the launch's
// threads, chunk and dynamic shared memory from ops/m4_engine.py's
// event_geometry. Returns cudaErrorInvalidValue for a geometry the kernel
// cannot hold, else cudaGetLastError() after the launch (0 on success). The
// caller checks shapes, dtypes and contiguity.
extern "C" int dsp_m4_event_f64(const EvPtrs* in, const EvPtrs* out, const double* bg_in,
                                double* bg_out, const double* env_ds, double* vt,
                                const double* iy_in, double* ics, double* iy_out, double* aux,
                                double* ring, const EvParams* p, const K10Params* k, int S,
                                int Nc, int threads, int chunk, long long smem, long long fade_p,
                                int disable, void* stream) {
    return launch_m4<EvPtrs, double>(in, out, bg_in, nullptr, bg_out, nullptr, env_ds, vt, iy_in,
                                     ics, iy_out, aux, ring, p, k, S, Nc, threads, chunk,
                                     (size_t)smem, fade_p, disable, stream);
}

// The same under float32: the state as (hi, lo) pairs (EvPtrsF32), bg as
// the pair (bg_in, bg_in_lo) in and (bg_out, bg_out_lo) out; env_ds, the
// scratch and the rings float64; interp_y, ics and aux float32.
extern "C" int dsp_m4_event_f32(const EvPtrsF32* in, const EvPtrsF32* out, const float* bg_in,
                                const float* bg_in_lo, float* bg_out, float* bg_out_lo,
                                const double* env_ds, double* vt, const float* iy_in, float* ics,
                                float* iy_out, float* aux, double* ring, const EvParams* p,
                                const K10Params* k, int S, int Nc, int threads, int chunk,
                                long long smem, long long fade_p, int disable, void* stream) {
    return launch_m4<EvPtrsF32, float>(in, out, bg_in, bg_in_lo, bg_out, bg_out_lo, env_ds, vt,
                                       iy_in, ics, iy_out, aux, ring, p, k, S, Nc, threads, chunk,
                                       (size_t)smem, fade_p, disable, stream);
}

// matrix4_mb's 13 coupled band engines over Nc ticks, for S streams: the
// event state in and out (EvPtrs, every leaf [S, 13, ...]), the thresholds
// evt [S, 13], env_ds [S, Nc, 13, 8], the scratch vt [S, Nc, 13, 12],
// interp_y [S, 4, 13, 12] in and out, ics [S, Nc, 3, 13, 12], aux
// [S, Nc, 13, 2], ring null or [S · 13 · 10 · buf_len];
// threads, chunk and shared memory as dsp_m4_event_f64's. `p` holds band
// 0's event parameters; MbParams the ones that differ by band. Returns as
// dsp_m4_event_f64.
extern "C" int dsp_m4mb_event_f64(const EvPtrs* in, const EvPtrs* out, const double* evt_in,
                                  double* evt_out, const double* env_ds, double* vt,
                                  const double* iy_in, double* ics, double* iy_out, double* aux,
                                  double* ring, const EvParams* p, const MbParams* k, int S,
                                  int Nc, int threads, int chunk, long long smem,
                                  long long fade_p, int disable, void* stream) {
    return launch_m4mb<EvPtrs, double>(in, out, evt_in, nullptr, evt_out, nullptr, env_ds, vt,
                                       iy_in, ics, iy_out, aux, ring, p, k, S, Nc, threads, chunk,
                                       (size_t)smem, fade_p, disable, stream);
}

// The same under float32: the state (EvPtrsF32) and the thresholds as
// (hi, lo) pairs; env_ds, the scratch and the rings float64; interp_y, ics
// and aux float32.
extern "C" int dsp_m4mb_event_f32(const EvPtrsF32* in, const EvPtrsF32* out, const float* evt_in,
                                  const float* evt_in_lo, float* evt_out, float* evt_out_lo,
                                  const double* env_ds, double* vt, const float* iy_in, float* ics,
                                  float* iy_out, float* aux, double* ring, const EvParams* p,
                                  const MbParams* k, int S, int Nc, int threads, int chunk,
                                  long long smem, long long fade_p, int disable, void* stream) {
    return launch_m4mb<EvPtrsF32, float>(in, out, evt_in, evt_in_lo, evt_out, evt_out_lo, env_ds,
                                         vt, iy_in, ics, iy_out, aux, ring, p, k, S, Nc, threads,
                                         chunk, (size_t)smem, fade_p, disable, stream);
}
