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
// one wrote (about seventy values, and six ring buffers of buf_len entries),
// compares thresholds and branches. What bounds it on the card is the
// latency of that chain: some three hundred dependent float64 operations a
// tick, a few of them atan/sqrt/divisions, and the lookback replay (up to
// buf_len masked EWMAs) when an event starts. Design: one block a lane
// (S = 1 for matrix4; streams x bands later); thread 0 runs the ticks with
// the state in registers and the rings in shared memory, and writes each
// tick's engine outputs. Then every thread of the block takes ticks of the
// epilogue, which has no carried state, and then of the interpolator insert.
//
// matrix4_mb (`dsp_m4mb_event_f64`, replacing effects/matrix4_mb.py:445-551)
// runs 13 of these engines, one a band, coupled every tick: each band's
// event threshold is an EWMA toward a target built from every band's
// previous-tick `last`, `slope_last` and `diff_last` (:460-480). So the 13
// engines run in lockstep in one warp of one block: lanes 0-12 each hold a
// band's state in registers and its rings in shared memory, publish the three
// pairs to shared memory at the start of each tick, and after a __syncwarp
// each computes every band's candidacy, its own row of the similarity
// matrix, the sum `fact` from band 0 up and its threshold; then it runs
// event_step with that threshold. Where dsp_tpu's XLA:CPU contracts a
// product into a sum (`1 - max(d)·16/π`, the target's last product and
// sum, and the threshold's EWMA) the kernel writes fma(), and nowhere else. After the ticks every thread takes
// (tick, band) pairs of matrix4_mb's epilogue, then of the interpolator
// insert. A lane that replays its lookback while the others do not makes the
// warp diverge for those steps: correct, only slower.
//
// The arithmetic is dsp_tpu's, operation for operation, in the order the
// plain version (ops/m4_engine.py) writes it. This file is compiled with
// -fmad=false (kernels.py): no product is fused into a sum, so each
// operation rounds as torch's does, and atan, tan, sin, cos, exp, pow and
// sqrt are the CUDA math library's, as torch's CUDA ops call them. The
// decisions (booleans, counters, tick stamps) are exact comparisons of those
// values.
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

// One lane's state while its ticks run (rings in shared memory).
struct Ev {
    bool b[NB];
    double accom[6], norm[4], slow[2], smooth[2], avg[4], drift[4], dpwr[4], dscale[2], pwrcmp,
        ons, lp_m[4], svf_m[8], dir_lr, dir_cs, last[2], slope_last[2], diff_last[2], max1, max0,
        ord_factor, adj, ds_diff;
    long long i[NI];
    double *ord_buf, *ord_lp_buf, *diff_buf, *slope_buf, *ds_ord_buf, *max_buf;
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

// The float leaves held in registers: (Ev member, leaf, values a lane).
#define EV_REG_LEAVES(X)                                                              \
    X(accom, F_ACCOM, 6) X(norm, F_NORM, 4) X(slow, F_SLOW, 2) X(smooth, F_SMOOTH, 2) \
    X(avg, F_AVG, 4) X(drift, F_DRIFT, 4) X(dpwr, F_DRIFT_DPWR, 4)                    \
    X(dscale, F_DRIFT_SCALE, 2) X(lp_m, F_ORD_LP_M, 4) X(svf_m, F_SVF_M, 8)           \
    X(last, F_LAST, 2) X(slope_last, F_SLOPE_LAST, 2) X(diff_last, F_DIFF_LAST, 2)
#define EV_SCALAR_LEAVES(X)                                                                 \
    X(pwrcmp, F_PWRCMP) X(ons, F_ONS) X(dir_lr, F_DIR_LR) X(dir_cs, F_DIR_CS) X(max1, F_MAX1) \
    X(max0, F_MAX0) X(ord_factor, F_ORD_FACTOR) X(adj, F_ADJ) X(ds_diff, F_DS_DIFF)
// the rings: (Ev member, leaf, values an entry)
#define EV_RINGS(X)                                                                        \
    X(ord_buf, F_ORD_BUF, 2) X(ord_lp_buf, F_ORD_LP_BUF, 2) X(diff_buf, F_DIFF_BUF, 2)     \
    X(slope_buf, F_SLOPE_BUF, 2) X(ds_ord_buf, F_DS_ORD_BUF, 1) X(max_buf, F_MAX_BUF, 1)

template <class P>
__device__ void load_ev(Ev& e, const P& in, int s, int L, double* ring) {
    for (int k = 0; k < NB; ++k) e.b[k] = in.b[k][s] != 0;
    for (int k = 0; k < NI; ++k) e.i[k] = in.i[k][s];
#define LOAD_REG(MEM, IDX, N) load_vals(e.MEM, in, IDX, (size_t)s * (N), N);
    EV_REG_LEAVES(LOAD_REG)
#undef LOAD_REG
#define LOAD_SCALAR(MEM, IDX) e.MEM = leaf_get(in, IDX, s);
    EV_SCALAR_LEAVES(LOAD_SCALAR)
#undef LOAD_SCALAR
#define LOAD_RING(MEM, IDX, N)                                   \
    e.MEM = ring;                                                \
    load_vals(ring, in, IDX, (size_t)s * (N) * L, (N) * L);      \
    ring += (N) * L;
    EV_RINGS(LOAD_RING)
#undef LOAD_RING
}

template <class P>
__device__ void store_ev(const Ev& e, const P& out, int s, int L) {
    for (int k = 0; k < NB; ++k) out.b[k][s] = e.b[k] ? 1 : 0;
    for (int k = 0; k < NI; ++k) out.i[k][s] = e.i[k];
#define STORE_REG(MEM, IDX, N) store_vals(out, IDX, (size_t)s * (N), e.MEM, N);
    EV_REG_LEAVES(STORE_REG)
#undef STORE_REG
#define STORE_SCALAR(MEM, IDX) leaf_put(out, IDX, s, e.MEM);
    EV_SCALAR_LEAVES(STORE_SCALAR)
#undef STORE_SCALAR
#define STORE_RING(MEM, IDX, N) store_vals(out, IDX, (size_t)s * (N) * L, e.MEM, (N) * L);
    EV_RINGS(STORE_RING)
#undef STORE_RING
}

// One control tick (event_step, m4_engine.py:395-686). e8: the envelopes
// l, r, sum, diff, then their powers. out: ax_lr, ax_cs, ax_ev_lr,
// ax_ev_cs, ax_dpwr_lr, ax_dpwr_cs (the axes normalized), pwrcmp_factor.
__device__ void event_step(const EvParams& p, Ev& e, const double* e8, double* out) {
    const int L = p.buf_len;
    const long long t = e.i[I_T];
    const int bp = (int)e.i[I_BUF_P];
    const double env_l = e8[0], env_r = e8[1], env_sum = e8[2], env_diff = e8[3];
    const double pw_l = e8[4], pw_r = e8[5], pw_sum = e8[6], pw_diff = e8[7];

    const double ord_lr = calc_lr(env_l, env_r, env_l / env_r);
    const double ord_cs = calc_lr(env_sum, env_diff, env_sum / env_diff);
    const double* c = p.ord_lp_c;
    const double ord_lp_lr = c[0] * ord_lr + e.lp_m[0];
    const double ord_lp_cs = c[0] * ord_cs + e.lp_m[2];
    {
        const double m0a = e.lp_m[1] + c[1] * ord_lr - c[3] * ord_lp_lr;
        const double m1a = c[2] * ord_lr - c[4] * ord_lp_lr;
        const double m0b = e.lp_m[3] + c[1] * ord_cs - c[3] * ord_lp_cs;
        const double m1b = c[2] * ord_cs - c[4] * ord_lp_cs;
        e.lp_m[0] = m0a;
        e.lp_m[1] = m1a;
        e.lp_m[2] = m0b;
        e.lp_m[3] = m1b;
    }
    const double lpd0 = e.ord_lp_buf[2 * bp], lpd1 = e.ord_lp_buf[2 * bp + 1];  // delayed
    const double ord_ns = e.ons * p.base_ord_ns;
    double* m = e.svf_m;  // [4][2]
    const double y0 = svf_pk_run(p.svf1_a0, p.svf1_alpha, p.svf1_beta, m[0], m[1], lpd0, ord_ns);
    const double notched_lr = svf_pk_run(p.svf2_a0, p.svf2_alpha, p.svf2_beta, m[4], m[5], y0, ord_ns);
    const double y1 = svf_pk_run(p.svf1_a0, p.svf1_alpha, p.svf1_beta, m[2], m[3], lpd1, ord_ns);
    const double notched_cs = svf_pk_run(p.svf2_a0, p.svf2_alpha, p.svf2_beta, m[6], m[7], y1, ord_ns);

    double* ac = e.accom;
    const double ac0 = ewma_set_max(ac[0], pw_l, p.g_accom);
    const double ac1 = ewma_set_max(ac[1], pw_r, p.g_accom);
    const double ac2 = ewma_set_max(ac[2], pw_sum, p.g_accom);
    const double ac3 = ewma_set_max(ac[3], pw_diff, p.g_accom);
    const double adapt_l = pw_l - ac0, adapt_r = pw_r - ac1;
    const double adapt_sum = pw_sum - ac2, adapt_diff = pw_diff - ac3;
    const double diff_lr = calc_lr(adapt_l, adapt_r, sqrt(fabs(adapt_l / adapt_r)));
    const double diff_cs = calc_lr(adapt_sum, adapt_diff, sqrt(fabs(adapt_sum / adapt_diff)));

    e.ord_buf[2 * bp] = ord_lr;
    e.ord_buf[2 * bp + 1] = ord_cs;
    e.ord_lp_buf[2 * bp] = ord_lp_lr;
    e.ord_lp_buf[2 * bp + 1] = ord_lp_cs;
    e.diff_buf[2 * bp] = diff_lr;
    e.diff_buf[2 * bp + 1] = diff_cs;

    const double adj = dmax(1.0 - e.ord_factor / 20.0, 0.5);
    e.adj = adj;
    double ord_factor = e.ord_factor * p.ord_factor_c;

    const double thresh = p.thresh;
    const double l_pwr_xf = pw_l * (1.0 - kNormCrossfeed) + pw_r * kNormCrossfeed;
    const double r_pwr_xf = pw_r * (1.0 - kNormCrossfeed) + pw_l * kNormCrossfeed;
    double* nrm = e.norm;
    const double n2_new = ewma(nrm[2], l_pwr_xf, p.g_norm_fast);
    const double n3_new = ewma(nrm[3], r_pwr_xf, p.g_norm_fast);
    const double n0_new = ewma(nrm[0], fabs(l_pwr_xf - n2_new * p.norm_accom_factor * adj), p.g_norm);
    const double n1_new = ewma(nrm[1], fabs(r_pwr_xf - n3_new * p.norm_accom_factor * adj), p.g_norm);
    nrm[0] = n0_new;
    nrm[1] = n1_new;
    nrm[2] = n2_new;
    nrm[3] = n3_new;
    const double ac4 = ewma_scale_asym(ac[4], pw_l, p.g_accom, 1.0, p.accom_mask_fall);
    const double ac5 = ewma_scale_asym(ac[5], pw_r, p.g_accom, 1.0, p.accom_mask_fall);
    ac[0] = ac0;
    ac[1] = ac1;
    ac[2] = ac2;
    ac[3] = ac3;
    ac[4] = ac4;
    ac[5] = ac5;
    const double l_mask = dmax(pw_l - ac4, 0.0);
    const double r_mask = dmax(pw_r - ac5, 0.0);
    const double l_mask_norm =
        n0_new >= kDblMin ? l_mask / n0_new : (l_mask < kDblMin ? 0.0 : p.clip_thresh);
    const double r_mask_norm =
        n1_new >= kDblMin ? r_mask / n1_new : (r_mask < kDblMin ? 0.0 : p.clip_thresh);
    const double sm0 = ewma(e.smooth[0], dmin(l_mask_norm, p.clip_thresh), p.g_smooth);
    const double sm1 = ewma(e.smooth[1], dmin(r_mask_norm, p.clip_thresh), p.g_smooth);
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
    e.slope_buf[2 * bp] = l_slope;
    e.slope_buf[2 * bp + 1] = r_slope;
    const double max_d = e.max_buf[bp];
    e.max_buf[bp] = dmax(l_event, r_event);
    e.pwrcmp = ewma_scale_asym(e.pwrcmp, 1.0 - smoothstep(max_d * p.pcf_sens), p.g_pwrcmp, 1.0,
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

    // lookback: how far back the slope keeps increasing (bounded by L)
    const int pick = (new_f1_l && !new_f1_r) ? 0 : ((new_f1_r && !new_f1_l) ? 1 : 2);
    const double* sb = e.slope_buf;
#define SEL_SLOPE(i) (pick == 2 ? sb[2 * (i)] + sb[2 * (i) + 1] : sb[2 * (i) + pick])
    int steps = 0;
    for (int j = 1; j < L; ++j) {
        const int i_pos = wrap(bp - j, L);
        const int k_pos = wrap(bp - j + 1, L);
        if (!(SEL_SLOPE(i_pos) > SEL_SLOPE(k_pos))) break;
        ++steps;
    }
#undef SEL_SLOPE
    const int lb_start = wrap(bp - steps, L);
    // averaging seed + the C-ordered masked EWMA replay (used only when a
    // fresh event starts)
    double seeded[4] = {ord_lr, ord_cs, diff_lr, diff_cs};
    if (tr_fresh) {
        for (int j = 0; j < steps; ++j) {
            const int idx = wrap(lb_start + j, L);
            seeded[0] = ewma(seeded[0], e.ord_buf[2 * idx], p.g_avg);
            seeded[1] = ewma(seeded[1], e.ord_buf[2 * idx + 1], p.g_avg);
            seeded[2] = ewma(seeded[2], e.diff_buf[2 * idx], p.g_avg);
            seeded[3] = ewma(seeded[3], e.diff_buf[2 * idx + 1], p.g_avg);
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
    const double ds_ord_prev = e.ds_ord_buf[bp];
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
    e.ds_ord_buf[bp] = (sm0 > ds_ord_thresh || sm1 > ds_ord_thresh)
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

// the state's pointers P (EvPtrs or EvPtrsF32) and the storage type T of
// the background weight's pair, the window, the coefficient sets and aux
template <class P, class T>
__global__ void m4_event_kernel(P in, P out, const T* __restrict__ bg_in,
                                const T* __restrict__ bg_in_lo, T* __restrict__ bg_out,
                                T* __restrict__ bg_out_lo, const double* __restrict__ env_ds,
                                double* __restrict__ eo, double* __restrict__ vt,
                                const T* __restrict__ iy_in, T* __restrict__ ics,
                                T* __restrict__ iy_out, T* __restrict__ aux, EvParams p,
                                K10Params k, int Nc, long long fade_p, int disable) {
    extern __shared__ double ring[];
    const int s = blockIdx.x;
    const int L = p.buf_len;
    double* eo_s = eo + (size_t)s * Nc * 8;
    if (threadIdx.x == 0) {
        Ev e;
        load_ev(e, in, s, L, ring);
        double m0 = pair_load(bg_in, bg_in_lo, 2 * s), m1 = pair_load(bg_in, bg_in_lo, 2 * s + 1);
        const double* env = env_ds + (size_t)s * Nc * 8;
        double cur[8], nxt[8];
        for (int k = 0; k < 8; ++k) cur[k] = env[k];
        for (int i = 0; i < Nc; ++i) {
            // the next tick's envelopes load while this tick runs
            if (i + 1 < Nc) {
                for (int k = 0; k < 8; ++k) nxt[k] = env[(size_t)(i + 1) * 8 + k];
            }
            double* o = eo_s + (size_t)i * 8;
            event_step(p, e, cur, o);
            // the background weight: smf_asym_run on smoothstep(ax_cs·(-2/(π/4))) + 1
            const double sv = smoothstep(o[1] * (-2.0 / kPi4)) + 1.0;
            const double cc = sv > m1 ? p.bg_c0 : p.bg_c1;
            const double g = dmin(p.bg_g0 + cc * fabs(m0 - m1), 0.39);
            m0 = m0 + g * (sv - m0);
            m1 = m1 + g * (m0 - m1);
            o[7] = m1;
            for (int k = 0; k < 8; ++k) cur[k] = nxt[k];
        }
        store_ev(e, out, s, L);
        pair_store(bg_out, bg_out_lo, 2 * s, m0);
        pair_store(bg_out, bg_out_lo, 2 * s + 1, m1);
    }
    __syncthreads();
    // K10 for every tick: the fade (fade_mult, matrix4_common.h:265-280)
    // and the matrix values
    double* vt_s = vt + (size_t)s * Nc * kInterp;
    for (int i = threadIdx.x; i < Nc; i += blockDim.x) {
        const long long tick = (long long)i * k.D + (k.D - 1);
        const long long at = fade_p - tick > 0 ? fade_p - tick : 0;
        const double posf = (double)at / (double)k.fade_frames;
        const double fade_lin = disable ? posf : 1.0 - posf;
        const double fade_sm = (1.0 - cos(fade_lin * kPi)) * 0.5;
        const double fade = at > 0 ? fade_sm : (disable ? 0.0 : 1.0);
        const double* o = eo_s + (size_t)i * 8;
        double* v = vt_s + (size_t)i * kInterp;
        tick_vals(k, o, fade, v);
        for (int q = 0; q < kInterp; ++q) v[q] = (double)(T)v[q];  // float32: rounded here
        T* a = aux + ((size_t)s * Nc + i) * 4;
        for (int q = 0; q < 4; ++q) a[q] = (T)o[q];
    }
    __syncthreads();
    // the interpolator insert (matrix4_common.h:358-367): row r of
    // [interp_y[1:] | vals]
    const T* iy_s = iy_in + (size_t)s * 4 * kInterp;
#define EXT(r, c)                                                                     \
    ((r) < 3 ? (double)iy_s[((r) + 1) * kInterp + (c)] : vt_s[((r) - 3) * kInterp + (c)])
    for (int j = threadIdx.x; j < Nc * kInterp; j += blockDim.x) {
        const int i = j / kInterp, c = j % kInterp;
        const double iy0 = EXT(i, c), iy1 = EXT(i + 1, c), iy2 = EXT(i + 2, c), iy3 = EXT(i + 3, c);
        const double ia = iy2 - iy0;
        T* o = ics + (((size_t)s * Nc + i) * 3) * kInterp + c;
        o[0] = (T)(0.5 * iy1 + 0.25 * (iy0 + iy2));
        o[kInterp] = (T)(0.5 * ia);
        o[2 * kInterp] = (T)(0.25 * (iy3 - iy1 - ia));
    }
    for (int j = threadIdx.x; j < 4 * kInterp; j += blockDim.x) {
        const int r = j / kInterp, c = j % kInterp;
        iy_out[(size_t)s * 4 * kInterp + j] = (T)EXT(Nc - 1 + r, c);
    }
#undef EXT
}

// --- matrix4_mb ---

constexpr int kBands = 13;
constexpr int kSigMb = 12;

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

// P and T as m4_event_kernel's; the thresholds are a (hi, lo) pair under
// float32
template <class P, class T>
__global__ void m4mb_event_kernel(P in, P out, const T* __restrict__ evt_in,
                                  const T* __restrict__ evt_in_lo, T* __restrict__ evt_out,
                                  T* __restrict__ evt_out_lo, const double* __restrict__ env_ds,
                                  double* __restrict__ eo, double* __restrict__ vt,
                                  const T* __restrict__ iy_in, T* __restrict__ ics,
                                  T* __restrict__ iy_out, T* __restrict__ aux, EvParams base,
                                  MbParams k, int Nc, long long fade_p, int disable) {
    extern __shared__ double ring[];
    __shared__ double pub[kBands][6];  // a band's last, slope_last and diff_last pairs
    const int L = base.buf_len;
    const int b = threadIdx.x;
    if (b < kBands) {
        const unsigned lanes = (1u << kBands) - 1u;
        EvParams p = base;
        p.base_ord_ns = k.base_ord_ns[b];
        p.clip_thresh = k.clip_thresh[b];
        p.pcf_sens = k.pcf_sens[b];
        Ev e;
        load_ev(e, in, b, L, ring + (size_t)b * 10 * L);
        double evt = pair_load(evt_in, evt_in_lo, b);
        const double etmax = k.etmax[b], etmin = k.etmin[b];
        double* eo_b = eo + (size_t)b * Nc * 8;
        for (int i = 0; i < Nc; ++i) {
            pub[b][0] = e.last[0];
            pub[b][1] = e.last[1];
            pub[b][2] = e.slope_last[0];
            pub[b][3] = e.slope_last[1];
            pub[b][4] = e.diff_last[0];
            pub[b][5] = e.diff_last[1];
            __syncwarp(lanes);
            // the cross-band threshold modulation (matrix4_mb.py:467-480)
            double fact = 0.0;
            bool cand = false;
            for (int j = 0; j < kBands; ++j) {
                const bool cj = (pub[j][2] > 0.0 && pub[j][0] > k.etmin[j]) ||
                                (pub[j][3] > 0.0 && pub[j][1] > k.etmin[j]);
                const double d_lr = fabs(pub[b][4] - pub[j][4]);
                const double d_cs = fabs(pub[b][5] - pub[j][5]);
                const double term =
                    smoothstep(fma(-dmax(d_lr, d_cs), 16.0 / kPi, 1.0)) * (cj ? 1.0 : 0.0);
                fact = j == 0 ? term : fact + term;
                if (j == b) cand = cj;
            }
            __syncwarp(lanes);
            fact = cand ? fact - 1.0 : 0.0;
            const double target = fma(-((etmax - etmin) * fact), 1.0 / (kBands - 1), etmax);
            const double up = fma(k.g_evt, target - evt, evt);
            evt = target >= evt ? up : target;
            p.thresh = 1.8 * (evt * (1.0 / 1.8));  // EVENT_THRESH * thresh_scale
            const double* e8 = env_ds + ((size_t)i * kBands + b) * 8;
            event_step(p, e, e8, eo_b + (size_t)i * 8);
        }
        store_ev(e, out, b, L);
        pair_store(evt_out, evt_out_lo, b, evt);
    }
    __syncthreads();
    // the epilogue for every tick and band
    for (int idx = threadIdx.x; idx < Nc * kBands; idx += blockDim.x) {
        const int i = idx / kBands, bb = idx % kBands;
        const double* o = eo + ((size_t)bb * Nc + i) * 8;
        double* v = vt + (size_t)idx * kSigMb;
        tick_vals_mb(k, o, fade_at(i, k.D, fade_p, k.fade_frames, disable), k.contour[bb], v);
        for (int q = 0; q < kSigMb; ++q) v[q] = (double)(T)v[q];  // float32: rounded here
        aux[(size_t)idx * 2] = (T)o[0];
        aux[(size_t)idx * 2 + 1] = (T)o[1];
    }
    __syncthreads();
    // the interpolator insert: row r of [interp_y[1:] | vals], [.., 13, 12] each
    constexpr int kRow = kBands * kSigMb;
#define EXT(r, c) ((r) < 3 ? (double)iy_in[((r) + 1) * kRow + (c)] : vt[((r) - 3) * kRow + (c)])
    for (int j = threadIdx.x; j < Nc * kRow; j += blockDim.x) {
        const int i = j / kRow, c = j % kRow;
        const double iy0 = EXT(i, c), iy1 = EXT(i + 1, c), iy2 = EXT(i + 2, c), iy3 = EXT(i + 3, c);
        const double ia = iy2 - iy0;
        T* o = ics + (size_t)i * 3 * kRow + c;
        o[0] = (T)(0.5 * iy1 + 0.25 * (iy0 + iy2));
        o[kRow] = (T)(0.5 * ia);
        o[2 * kRow] = (T)(0.25 * (iy3 - iy1 - ia));
    }
    for (int j = threadIdx.x; j < 4 * kRow; j += blockDim.x) {
        const int r = j / kRow, c = j % kRow;
        iy_out[j] = (T)EXT(Nc - 1 + r, c);
    }
#undef EXT
}

// the dynamic shared memory a launch may ask for on Hopper (227 KB)
constexpr size_t kMaxSmem = 227 * 1024;

template <class P, class T>
int launch_m4(const P* in, const P* out, const T* bg_in, const T* bg_in_lo, T* bg_out,
              T* bg_out_lo, const double* env_ds, double* eo, double* vt, const T* iy_in, T* ics,
              T* iy_out, T* aux, const EvParams* p, const K10Params* k, int S, int Nc,
              long long fade_p, int disable, void* stream) {
    if (S <= 0 || Nc <= 0 || p->buf_len <= 0 || k->fade_frames <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = sizeof(double) * 10 * (size_t)p->buf_len;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            m4_event_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    m4_event_kernel<P, T><<<S, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        *in, *out, bg_in, bg_in_lo, bg_out, bg_out_lo, env_ds, eo, vt, iy_in, ics, iy_out, aux,
        *p, *k, Nc, fade_p, disable);
    return (int)cudaGetLastError();
}

template <class P, class T>
int launch_m4mb(const P* in, const P* out, const T* evt_in, const T* evt_in_lo, T* evt_out,
                T* evt_out_lo, const double* env_ds, double* eo, double* vt, const T* iy_in,
                T* ics, T* iy_out, T* aux, const EvParams* p, const MbParams* k, int Nc,
                long long fade_p, int disable, void* stream) {
    if (Nc <= 0 || p->buf_len <= 0 || k->fade_frames <= 0) return (int)cudaErrorInvalidValue;
    // the 13 bands' rings: 21.8 KB at 44.1 kHz, 93.6 KB at 192 kHz
    const size_t smem = sizeof(double) * 10 * (size_t)p->buf_len * kBands;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            m4mb_event_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    m4mb_event_kernel<P, T><<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        *in, *out, evt_in, evt_in_lo, evt_out, evt_out_lo, env_ds, eo, vt, iy_in, ics, iy_out,
        aux, *p, *k, Nc, fade_p, disable);
    return (int)cudaGetLastError();
}

}  // namespace

// S lanes of Nc ticks: the event state in and out (EvPtrs), bg [S, 2],
// env_ds [S, Nc, 8], the scratch eo [S, Nc, 8] and vt [S, Nc, 16],
// interp_y [S, 4, 16] in and out, ics [S, Nc, 3, 16], aux [S, Nc, 4].
// Returns cudaGetLastError() after the launch (0 on success). The caller
// (dsp_tpu_torch/ops/m4_engine.py) checks shapes, dtypes and contiguity.
extern "C" int dsp_m4_event_f64(const EvPtrs* in, const EvPtrs* out, const double* bg_in,
                                double* bg_out, const double* env_ds, double* eo, double* vt,
                                const double* iy_in, double* ics, double* iy_out, double* aux,
                                const EvParams* p, const K10Params* k, int S, int Nc,
                                long long fade_p, int disable, void* stream) {
    return launch_m4<EvPtrs, double>(in, out, bg_in, nullptr, bg_out, nullptr, env_ds, eo, vt,
                                     iy_in, ics, iy_out, aux, p, k, S, Nc, fade_p, disable,
                                     stream);
}

// The same under float32: the state as (hi, lo) pairs (EvPtrsF32), bg as
// the pair (bg_in, bg_in_lo) in and (bg_out, bg_out_lo) out; env_ds and
// the scratch float64; interp_y, ics and aux float32.
extern "C" int dsp_m4_event_f32(const EvPtrsF32* in, const EvPtrsF32* out, const float* bg_in,
                                const float* bg_in_lo, float* bg_out, float* bg_out_lo,
                                const double* env_ds, double* eo, double* vt, const float* iy_in,
                                float* ics, float* iy_out, float* aux, const EvParams* p,
                                const K10Params* k, int S, int Nc, long long fade_p, int disable,
                                void* stream) {
    return launch_m4<EvPtrsF32, float>(in, out, bg_in, bg_in_lo, bg_out, bg_out_lo, env_ds, eo,
                                       vt, iy_in, ics, iy_out, aux, p, k, S, Nc, fade_p, disable,
                                       stream);
}

// matrix4_mb's 13 coupled band engines over Nc ticks: the event state in and
// out (EvPtrs, every leaf [13, ...]), the thresholds evt [13], env_ds
// [Nc, 13, 8], the scratch eo [13, Nc, 8] and vt [Nc, 13, 12], interp_y
// [4, 13, 12] in and out, ics [Nc, 3, 13, 12], aux [Nc, 13, 2]. `p` holds
// band 0's event parameters; MbParams the ones that differ by band. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dsp_m4mb_event_f64(const EvPtrs* in, const EvPtrs* out, const double* evt_in,
                                  double* evt_out, const double* env_ds, double* eo, double* vt,
                                  const double* iy_in, double* ics, double* iy_out, double* aux,
                                  const EvParams* p, const MbParams* k, int Nc, long long fade_p,
                                  int disable, void* stream) {
    return launch_m4mb<EvPtrs, double>(in, out, evt_in, nullptr, evt_out, nullptr, env_ds, eo, vt,
                                       iy_in, ics, iy_out, aux, p, k, Nc, fade_p, disable, stream);
}

// The same under float32: the state (EvPtrsF32) and the thresholds as
// (hi, lo) pairs; env_ds and the scratch float64; interp_y, ics and aux
// float32.
extern "C" int dsp_m4mb_event_f32(const EvPtrsF32* in, const EvPtrsF32* out, const float* evt_in,
                                  const float* evt_in_lo, float* evt_out, float* evt_out_lo,
                                  const double* env_ds, double* eo, double* vt,
                                  const float* iy_in, float* ics, float* iy_out, float* aux,
                                  const EvParams* p, const MbParams* k, int Nc, long long fade_p,
                                  int disable, void* stream) {
    return launch_m4mb<EvPtrsF32, float>(in, out, evt_in, evt_in_lo, evt_out, evt_out_lo, env_ds,
                                         eo, vt, iy_in, ics, iy_out, aux, p, k, Nc, fade_p,
                                         disable, stream);
}
