// K2 and K3: per-sample biquad scan over lanes, for Hopper (sm_90a).
//
// K2 replaces dsp_tpu/ops/iir.py:77 `_biquad_scan_impl` (entered through
// `biquad_scan`, iir.py:61), in float64 (dsp_biquad_scan_f64) and in
// float32 (dsp_biquad_scan_f32: samples, coefficients, state and every
// product and sum in float32, as the TPU runs it under dsp_tpu's float32
// for crossfeed, crossfeed.py:42-48, and the Thiran delay, delay.py:172).
// K3 replaces iir.py:89 `biquad_scan_df` (dsp_biquad_scan_df): float32
// samples and a [2, C, 2] float32 (hi, lo) state, with float64
// coefficients; dsp_biquad_scan_df1 takes a single [C, 2] float32 state,
// as `biquad_scan_auto` (iir.py:129) hands it in and out. dsp_tpu composes
// its affine maps in two-float32 arithmetic there, because the TPU has no
// usable float64 and a plain float32 scan of a near-DC pole loses ~60 dB;
// here the same kernel runs with float64 registers, reads x and the state
// (hi + lo) into float64, and stores y rounded once and the end state
// split hi = (float)s, lo = (float)(s - hi), or, single, rounded once
// (dsp_tpu's float32 hi + lo is that hi).
// For each lane c, with any 2x2 A (the coupled
// form from BiquadEffect or the companion form from crossfeed; the kernel
// assumes neither):
//   y[t] = c0·x[t] + s[t-1][0],   s[t] = A·s[t-1] + Bv·x[t]
// The TPU version ran a log-depth associative scan of the affine maps
// (A, Bv·x[t]) over all B samples at once.
//
// What bounds it on the card: the recurrence is serial per lane, and the
// main path has few lanes (crossfeed: 4). At B = 65536 a lane is 512 KB of
// input, so the work is latency-bound, not bandwidth- or FLOP-bound.
//
// Design: one block per lane, T threads (T a multiple of 32, at most 1024),
// each thread owning a contiguous segment of about B/T samples.
//   1. Each thread composes its segment's affine map (M = A^len, v).
//   2. A block-wide exclusive scan of the maps: warp shuffles inside each
//      warp, then one thread scans the per-warp totals in shared memory.
//      That gives each segment its start state from the incoming state.
//   3. Each thread reruns its segment from its start state and writes y.
// x and y are [B, C] row-major and are accessed strided by C; the last
// thread writes the end state [C, 2] (K3: [2, C, 2]).
//
// The three forms are one template: T the sample type, R the type of the
// coefficients and of every product and sum, kPair the (hi, lo) state (also
// with float64 storage, dsp_biquad_scan_f64_pair: BiquadEffect's per-sample
// path hands its [2, C, 2] state in and out without three torch ops). Every
// operation is written out as an intrinsic, so that nvcc contracts nothing
// of its own: in float32 every product and sum rounds on its own
// (__fmul_rn, __fadd_rn), in the order the plain version (ops/iir.py
// biquad_scan_f32_ref) takes, so the two agree bit for bit; in float64
// each a·b + c whose sum takes the product directly is one __fma_rn, every
// other product and sum rounds on its own, and which product of a·b + c·d
// is fused follows the grouping K2 has always had (compose_start). The
// kernels that share scan_stage therefore round alike, whatever code
// surrounds the stage, and as K2 did.
//
// Further entries take the launches the chain made around K2 and K3 into
// one; they run the same segments through the same stage (scan_stage), so
// each lane's output and end state are the bits of the launch they replace:
// * dsp_crossfeed_step_f64/_f32 replace dsp_tpu/effects/crossfeed.py:40-55
//   `CrossfeedEffect.step` (K2 on four lanes and the mix), which the port
//   ran as 15 launches (a stack, K2, a clone, six multiplies, four adds
//   and two copies). Two blocks, one an output column; each thread runs
//   the column's two lanes over its segment (two maps a thread in the
//   scan), reads them straight from x's columns and mixes in registers,
//   rounded as torch's separate elementwise kernels round;
// * dsp_biquad_scan_run runs a run of n stages (1..kMaxStages) in series
//   in one launch, in all four forms of the template (K3 with a (hi, lo) or
//   a single float32 state, K2 float64 with a single or a (hi, lo) state):
//   the chain's runs of adjacent per-sample biquads (dsp_tpu/effects/
//   biquad.py:329, a launch each), matrix4_mb's fshape and its inverse
//   (dsp_tpu/effects/matrix4_mb.py:338-349, :616-622: two launches each)
//   and, as its n = 2 case, matrix4's band-limit pair
//   (dsp_biquad_scan_series_f64, dsp_tpu/effects/matrix4.py:431-432). Stage
//   s + 1 runs after a block barrier on stage s's output, which each thread
//   left for its own segment, rounded to the sample type as the separate
//   launch stored it. Up to B of about 25,000 (float64) the lane's column
//   sits in shared memory for the whole run, staged in and out once, so a
//   stage's serial walks over its segment read shared memory, not a global
//   load a sample. The n states are read and written where their owners
//   keep them (RunStates: a pointer a stage, a lane stride and the lo
//   part's offset), so no caller stacks, splits or transposes them.
// What bounds them is what bounds K2: the launch and the chain of a
// segment, not bytes; a run pays one launch for n.
//
// The stream axis (split and batched processing): K2, K3, crossfeed's step
// and the run take x and y as [S, B, C] and each state with a leading S, S
// independent streams in one launch: S times the blocks (block s·C + c runs
// channel c of stream s; crossfeed's block 2s + b output column b of
// stream s), each stream's coefficients those of its channel, so a stream
// runs the segments, scan and rounding of a one-stream call: the same
// bits.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
// a·b + c: float32 rounds the product and the sum, float64 once (an FMA)
__device__ __forceinline__ float madd(float a, float b, float c) { return add(mul(a, b), c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return __fma_rn(a, b, c); }

// a·b + c·d and a·b + c·d + e, left to right
template <typename R>
__device__ __forceinline__ R dot2(R a, R b, R c, R d) {
    return madd(a, b, mul(c, d));
}
template <typename R>
__device__ __forceinline__ R dot2(R a, R b, R c, R d, R e) {
    return add(dot2(a, b, c, d), e);
}

template <typename R>
struct Affine {
    R m00, m01, m10, m11, v0, v1;
};

template <typename R>
__device__ __forceinline__ Affine<R> identity() {
    return {R(1), R(0), R(0), R(1), R(0), R(0)};
}

// `second` after `first`: x -> M2 (M1 x + v1) + v2
template <typename R>
__device__ __forceinline__ Affine<R> compose(const Affine<R>& first, const Affine<R>& second) {
    Affine<R> r;
    r.m00 = dot2(second.m00, first.m00, second.m01, first.m10);
    r.m01 = dot2(second.m00, first.m01, second.m01, first.m11);
    r.m10 = dot2(second.m10, first.m00, second.m11, first.m10);
    r.m11 = dot2(second.m10, first.m01, second.m11, first.m11);
    r.v0 = dot2(second.m00, first.v0, second.m01, first.v1, second.v0);
    r.v1 = dot2(second.m10, first.v0, second.m11, first.v1, second.v1);
    return r;
}

// compose for a segment's start map: as compose, but m11 fuses
// second.m11·first.m11 and rounds second.m10·first.m01 (the other terms
// fuse their first product). K2's float64 forms have always grouped this
// one term so; keeping it keeps their outputs' bits.
template <typename R>
__device__ __forceinline__ Affine<R> compose_start(const Affine<R>& first,
                                                   const Affine<R>& second) {
    Affine<R> r = compose(first, second);
    r.m11 = madd(second.m11, first.m11, mul(second.m10, first.m01));
    return r;
}

template <typename R>
__device__ __forceinline__ Affine<R> shfl_up(const Affine<R>& a, int d) {
    const unsigned full = 0xffffffffu;
    return {__shfl_up_sync(full, a.m00, d), __shfl_up_sync(full, a.m01, d),
            __shfl_up_sync(full, a.m10, d), __shfl_up_sync(full, a.m11, d),
            __shfl_up_sync(full, a.v0, d),  __shfl_up_sync(full, a.v1, d)};
}

// a lane's incoming state value k from st, the lane's first value: st[k],
// or (kPair) the sum of its hi st[k] and its lo st[lo + k] ([2, C, 2]: lo
// = 2C)
template <typename T, typename R, bool kPair>
__device__ __forceinline__ R load_state(const T* st, int lo, int k) {
    if (kPair) return (R)st[k] + (R)st[lo + k];
    return (R)st[k];
}

// a lane's end state value k: st[k], or (kPair) its hi and lo; with double
// storage the whole state is hi and lo is 0
template <typename T, typename R, bool kPair>
__device__ __forceinline__ void store_state(T* st, int lo, int k, R s) {
    const T h = (T)s;
    st[k] = h;
    if (kPair) st[lo + k] = std::is_same<T, R>::value ? T(0) : (T)(s - (R)h);
}

// one lane's coefficients
template <typename R>
struct Coef {
    R a00, a01, a10, a11, b0, b1, g;
};

template <typename R>
__device__ __forceinline__ Coef<R> coef(const R* A, const R* Bv, const R* c0, int l) {
    return {A[l * 4 + 0], A[l * 4 + 1], A[l * 4 + 2], A[l * 4 + 3],
            Bv[l * 2 + 0], Bv[l * 2 + 1], c0[l]};
}

// one sample into a segment's map: f -> (A·M, A·v + Bv·x)
template <typename R>
__device__ __forceinline__ void absorb(Affine<R>& f, const Coef<R>& k, R xt) {
    const R v0 = madd(k.b0, xt, dot2(k.a00, f.v0, k.a01, f.v1));
    const R v1 = madd(k.b1, xt, dot2(k.a10, f.v0, k.a11, f.v1));
    f = {dot2(k.a00, f.m00, k.a01, f.m10), dot2(k.a00, f.m01, k.a01, f.m11),
         dot2(k.a10, f.m00, k.a11, f.m10), dot2(k.a10, f.m01, k.a11, f.m11), v0, v1};
}

// one sample of the rerun: y = c0·x + s[0], then s <- A·s + Bv·x
template <typename R>
__device__ __forceinline__ R advance(R& u0, R& u1, const Coef<R>& k, R xt) {
    const R y = madd(k.g, xt, u0);
    const R n0 = madd(k.b0, xt, dot2(k.a00, u0, k.a01, u1));
    const R n1 = madd(k.b1, xt, dot2(k.a10, u0, k.a11, u1));
    u0 = n0;
    u1 = n1;
    return y;
}

// The block-wide exclusive scan of NL maps a thread (one a lane the block
// runs): on entry f[j] is this thread's segment map of lane j, on return
// the map from the lane's start to the segment's start. Warp shuffles,
// then one thread scans the warps' totals in shared memory (prefix[j][w]).
template <typename R, int NL>
__device__ __forceinline__ void block_exclusive_scan(Affine<R> (&f)[NL], Affine<R> (*prefix)[32]) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            const Affine<R> o = shfl_up(f[j], d);
            if (lane >= d) f[j] = compose(o, f[j]);
        }
    }
    Affine<R> excl[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        if (lane == 31) prefix[j][warp] = f[j];
        excl[j] = shfl_up(f[j], 1);
        if (lane == 0) excl[j] = identity<R>();
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            Affine<R> run = identity<R>();
            for (int w = 0; w < nwarps; ++w) {
                const Affine<R> total = prefix[j][w];
                prefix[j][w] = run;
                run = compose(run, total);
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NL; ++j) f[j] = compose_start(prefix[j][warp], excl[j]);
}

// the segment [t0, t1) of B samples that thread tid of T owns: about B/T
__device__ __forceinline__ void segment(int B, int& t0, int& t1) {
    const int seg = (B + blockDim.x - 1) / blockDim.x;
    t0 = min(B, (int)threadIdx.x * seg);
    t1 = min(B, t0 + seg);
}

// one stage of NL lanes over a block of B samples: x_j(t) reads lane j's
// input, out(t, y) takes the NL outputs of sample t; s[j] holds lane j's
// incoming state and, in the block's last thread, returns its end state
// (that thread's segment ends at B, or is empty, past B).
template <typename R, int NL, class In, class Out>
__device__ __forceinline__ void scan_stage(const Coef<R> (&k)[NL], R (&s)[NL][2], int B, In x_j,
                                           Out out, Affine<R> (*prefix)[32]) {
    int t0, t1;
    segment(B, t0, t1);
    // 1. this segment's maps
    Affine<R> f[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) f[j] = identity<R>();
    for (int t = t0; t < t1; ++t) {
#pragma unroll
        for (int j = 0; j < NL; ++j) absorb(f[j], k[j], x_j(j, t));
    }
    // 2. exclusive scan over the block's segments
    block_exclusive_scan<R, NL>(f, prefix);
    // 3. rerun the segment from its start state
    R u0[NL], u1[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        u0[j] = dot2(f[j].m00, s[j][0], f[j].m01, s[j][1], f[j].v0);
        u1[j] = dot2(f[j].m10, s[j][0], f[j].m11, s[j][1], f[j].v1);
    }
    for (int t = t0; t < t1; ++t) {
        R y[NL];
#pragma unroll
        for (int j = 0; j < NL; ++j) y[j] = advance(u0[j], u1[j], k[j], x_j(j, t));
        out(t, y);
    }
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        s[j][0] = u0[j];
        s[j][1] = u1[j];
    }
}

// K2 and K3: one block a lane c of C of stream s (block s·C + c), x and y
// [S, B, C], the state [S, C, 2] or, kPair, [S, 2, C, 2]
template <typename T, typename R, bool kPair>
__global__ void biquad_scan_kernel(const R* __restrict__ A, const R* __restrict__ Bv,
                                   const R* __restrict__ c0, const T* __restrict__ state_in,
                                   T* __restrict__ state_out, const T* __restrict__ x,
                                   T* __restrict__ y, int B, int C) {
    __shared__ Affine<R> prefix[1][32];
    const int s_ = blockIdx.x / C, c = blockIdx.x - s_ * C;
    const size_t xs0 = (size_t)s_ * B * C, st0 = (size_t)s_ * (kPair ? 4 : 2) * C;
    x += xs0;
    y += xs0;
    state_in += st0;
    state_out += st0;
    const Coef<R> k[1] = {coef(A, Bv, c0, c)};
    R s[1][2] = {{load_state<T, R, kPair>(state_in + c * 2, 2 * C, 0),
                  load_state<T, R, kPair>(state_in + c * 2, 2 * C, 1)}};
    scan_stage<R, 1>(
        k, s, B, [&](int, int t) { return (R)x[(size_t)t * C + c]; },
        [&](int t, const R (&yt)[1]) { y[(size_t)t * C + c] = (T)yt[0]; }, prefix);
    if (threadIdx.x == blockDim.x - 1) {
        store_state<T, R, kPair>(state_out + c * 2, 2 * C, 0, s[0][0]);
        store_state<T, R, kPair>(state_out + c * 2, 2 * C, 1, s[0][1]);
    }
}

// the mix of crossfeed's output column, rounded as torch's separate
// elementwise kernels round it: (s·direct + y_lp·cross) + y_hp·cross
__device__ __forceinline__ double mix(double s, double ylp, double yhp, double gd, double gc) {
    return __dadd_rn(__dadd_rn(__dmul_rn(s, gd), __dmul_rn(ylp, gc)), __dmul_rn(yhp, gc));
}
__device__ __forceinline__ float mix(float s, float ylp, float yhp, float gd, float gc) {
    return __fadd_rn(__fadd_rn(__fmul_rn(s, gd), __fmul_rn(ylp, gc)), __fmul_rn(yhp, gc));
}

// crossfeed's whole step: block b writes output column cb (b = 0: c0,
// 1: c1) from lanes b (the lowpass of the other column) and 2 + b (the
// highpass of its own), both run by every thread over its segment; the
// blocks copy the pass-through columns between them. Stream s (x and out
// [S, B, C], the state [S, 4, 2]) takes blocks 2s and 2s + 1.
template <typename R>
__global__ void __launch_bounds__(1024) crossfeed_kernel(const R* __restrict__ A, const R* __restrict__ Bv,
                                 const R* __restrict__ c0, const R* __restrict__ state_in,
                                 R* __restrict__ state_out, const R* __restrict__ x,
                                 R* __restrict__ out, int B, int C, int col0, int col1, R gd,
                                 R gc) {
    __shared__ Affine<R> prefix[2][32];
    const int b = blockIdx.x & 1;
    {   // this stream's columns and lanes
        const size_t xs0 = (size_t)(blockIdx.x >> 1) * B * C, st0 = (size_t)(blockIdx.x >> 1) * 8;
        x += xs0;
        out += xs0;
        state_in += st0;
        state_out += st0;
    }
    const int own = b == 0 ? col0 : col1, other = b == 0 ? col1 : col0;
    const int lanes[2] = {b, 2 + b};
    const Coef<R> k[2] = {coef(A, Bv, c0, lanes[0]), coef(A, Bv, c0, lanes[1])};
    R s[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        s[j][0] = state_in[lanes[j] * 2 + 0];
        s[j][1] = state_in[lanes[j] * 2 + 1];
    }
    scan_stage<R, 2>(
        k, s, B, [&](int j, int t) { return x[(size_t)t * C + (j == 0 ? other : own)]; },
        [&](int t, const R (&yt)[2]) {
            out[(size_t)t * C + own] = mix(x[(size_t)t * C + own], yt[0], yt[1], gd, gc);
        },
        prefix);
    if (threadIdx.x == blockDim.x - 1) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            state_out[lanes[j] * 2 + 0] = s[j][0];
            state_out[lanes[j] * 2 + 1] = s[j][1];
        }
    }
    if (C > 2) {
        for (int t = b * blockDim.x + threadIdx.x; t < B; t += 2 * blockDim.x) {
            for (int c = 0; c < C; ++c) {
                if (c != col0 && c != col1) out[(size_t)t * C + c] = x[(size_t)t * C + c];
            }
        }
    }
}

}  // namespace

// The states of a run of stages, where their owners keep them: in[s] and
// out[s] point at stage s's state, lane 0's first value; lane c's values
// sit `lane` elements further on and, in the (hi, lo) forms, each lo `lo`
// elements after its hi (a biquad's own [2, C, 2]: lane 2, lo 2C;
// matrix4_mb's fshape_m [4, 2]: stage s at 4s, lane 2; its inv_fshape_m
// [n_sig, 2, 2]: stage s at 2s, lane 4); with a stream axis, each stream's
// states `stream` elements after the one before's (a biquad's [S, 2, C, 2]:
// 4C). Passed to the kernel by value.
constexpr int kMaxStages = 16;
struct RunStates {
    const void* in[kMaxStages];
    void* out[kMaxStages];
    int lane;
    int lo;
    long long stream;
};

namespace {

// n stages in series over C lanes of S streams, one block a lane (block
// s·C + c: channel c of stream s, x and y [S, B, C]): coefficient row
// stage * C + c is the stage's on channel c. kStaged: the lane's B samples sit in
// shared memory for the whole run (sample j of thread i's segment at
// col[j * threads + i], so a warp's reads and writes hit consecutive
// words), staged in from x once and out to y once; each stage reads its
// input there and overwrites it with its output, rounded to T, each thread
// its own segment. Otherwise (a column too large to stage) stage 0 reads x
// and writes y, and every later stage reads y and overwrites it.
template <typename T, typename R, bool kPair, bool kStaged>
__global__ void __launch_bounds__(1024) run_kernel(const R* __restrict__ A, const R* __restrict__ Bv,
                              const R* __restrict__ c0, const RunStates st,
                              const T* __restrict__ x, T* y, int B, int C, int n) {
    __shared__ Affine<R> prefix[1][32];
    extern __shared__ __align__(16) unsigned char run_smem[];
    T* col = reinterpret_cast<T*>(run_smem);
    const int s_ = blockIdx.x / C, c = blockIdx.x - s_ * C, tid = threadIdx.x, nt = blockDim.x;
    const size_t lane0 = (size_t)c * st.lane + (size_t)s_ * st.stream;  // this lane's state
    x += (size_t)s_ * B * C;
    y += (size_t)s_ * B * C;
    const int seg = (B + nt - 1) / nt, t0 = min(B, tid * seg);  // as segment() cuts
    if (kStaged) {
        for (int t = tid; t < B; t += nt) col[(t % seg) * nt + t / seg] = x[(size_t)t * C + c];
        __syncthreads();
    }
    for (int stage = 0; stage < n; ++stage) {
        const T* in = stage == 0 ? x : y;
        const T* s_in = static_cast<const T*>(st.in[stage]) + lane0;
        const Coef<R> k[1] = {coef(A, Bv, c0, stage * C + c)};
        R s[1][2] = {{load_state<T, R, kPair>(s_in, st.lo, 0),
                      load_state<T, R, kPair>(s_in, st.lo, 1)}};
        if (kStaged) {
            scan_stage<R, 1>(
                k, s, B, [&](int, int t) { return (R)col[(t - t0) * nt + tid]; },
                [&](int t, const R (&yt)[1]) { col[(t - t0) * nt + tid] = (T)yt[0]; }, prefix);
        } else {
            scan_stage<R, 1>(
                k, s, B, [&](int, int t) { return (R)in[(size_t)t * C + c]; },
                [&](int t, const R (&yt)[1]) { y[(size_t)t * C + c] = (T)yt[0]; }, prefix);
        }
        if (tid == nt - 1) {
            T* s_out = static_cast<T*>(st.out[stage]) + lane0;
            store_state<T, R, kPair>(s_out, st.lo, 0, s[0][0]);
            store_state<T, R, kPair>(s_out, st.lo, 1, s[0][1]);
        }
        __syncthreads();  // the next stage reuses prefix (and, staged, the last stage's col)
    }
    if (kStaged) {
        for (int t = tid; t < B; t += nt) y[(size_t)t * C + c] = col[(t % seg) * nt + t / seg];
    }
}

// about 16 samples a thread, 32..1024 threads a lane (the crossfeed and
// run kernels are bounded to 1,024 threads' registers, so that they run
// K2's segments at every B)
int threads_for(int B) {
    int T_ = ((B + 15) / 16 + 31) / 32 * 32;
    return T_ < 32 ? 32 : (T_ > 1024 ? 1024 : T_);
}

template <typename T, typename R, bool kPair>
int biquad_scan(const R* A, const R* Bv, const R* c0, const T* state_in, T* state_out,
                const T* x, T* y, int B, int C, int S, void* stream) {
    if (B <= 0 || C <= 0 || S <= 0 || (long long)S * C > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    biquad_scan_kernel<T, R, kPair><<<S * C, threads_for(B), 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        A, Bv, c0, state_in, state_out, x, y, B, C);
    return (int)cudaGetLastError();
}

template <typename R>
int crossfeed(const R* A, const R* Bv, const R* c0, const R* state_in, R* state_out, const R* x,
              R* out, int B, int C, int S, int col0, int col1, R gd, R gc, void* stream) {
    if (B <= 0 || C < 2 || S <= 0 || S > (1 << 30) || col0 < 0 || col1 < 0 || col0 >= C ||
        col1 >= C || col0 == col1) {
        return (int)cudaErrorInvalidValue;
    }
    crossfeed_kernel<R><<<2 * S, threads_for(B), 0, static_cast<cudaStream_t>(stream)>>>(
        A, Bv, c0, state_in, state_out, x, out, B, C, col0, col1, gd, gc);
    return (int)cudaGetLastError();
}

// The launches run_kernel has made in this process (host side), every form
// and the band-limit pair's together: how a caller checks that a run is
// one launch.
unsigned long long run_launches = 0;

// the largest column run_kernel stages in shared memory (B = 16384 in
// float64 takes 128 KB; beside prefix, under the 227 KB a block may use)
constexpr int kRunSmem = 200 * 1024;

template <typename T, bool kPair>
int biquad_run(const double* A, const double* Bv, const double* c0, const RunStates& st,
               const void* x, void* y, int B, int C, int n, int S, void* stream) {
    if (B <= 0 || C <= 0 || S <= 0 || (long long)S * C > 0x7fffffffLL || n < 1 ||
        n > kMaxStages)
        return (int)cudaErrorInvalidValue;
    for (int s = 0; s < n; ++s) {
        if (st.in[s] == nullptr || st.out[s] == nullptr) return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const int threads = threads_for(B);
    const size_t smem = (size_t)((B + threads - 1) / threads) * threads * sizeof(T);
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (smem <= (size_t)kRunSmem) {
        static bool allowed = false;
        if (!allowed) {
            const cudaError_t e = cudaFuncSetAttribute(run_kernel<T, double, kPair, true>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       kRunSmem);
            if (e != cudaSuccess) return (int)e;
            allowed = true;
        }
        run_kernel<T, double, kPair, true><<<S * C, threads, smem, strm>>>(A, Bv, c0, st, xt, yt,
                                                                           B, C, n);
    } else {
        run_kernel<T, double, kPair, false><<<S * C, threads, 0, strm>>>(A, Bv, c0, st, xt, yt, B,
                                                                          C, n);
    }
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++run_launches;
    return (int)err;
}

}  // namespace

// Return cudaGetLastError() after the launch (0 on success). The caller
// checks shapes, dtypes and contiguity.
extern "C" int dsp_biquad_scan_f64(const double* A, const double* Bv, const double* c0,
                                   const double* state_in, double* state_out, const double* x,
                                   double* y, int B, int C, int S, void* stream) {
    return biquad_scan<double, double, false>(A, Bv, c0, state_in, state_out, x, y, B, C, S,
                                              stream);
}

// K2 in float32: everything float32, state [C, 2].
extern "C" int dsp_biquad_scan_f32(const float* A, const float* Bv, const float* c0,
                                   const float* state_in, float* state_out, const float* x,
                                   float* y, int B, int C, int S, void* stream) {
    return biquad_scan<float, float, false>(A, Bv, c0, state_in, state_out, x, y, B, C, S,
                                            stream);
}

// K3: float64 coefficients and registers, float32 samples, a float32
// (hi, lo) state [2, C, 2].
extern "C" int dsp_biquad_scan_df(const double* A, const double* Bv, const double* c0,
                                  const float* state_in, float* state_out, const float* x,
                                  float* y, int B, int C, int S, void* stream) {
    return biquad_scan<float, double, true>(A, Bv, c0, state_in, state_out, x, y, B, C, S,
                                            stream);
}

// K3 with a single float32 state [C, 2]: float64 coefficients and
// registers, float32 samples, the end state rounded once.
extern "C" int dsp_biquad_scan_df1(const double* A, const double* Bv, const double* c0,
                                   const float* state_in, float* state_out, const float* x,
                                   float* y, int B, int C, int S, void* stream) {
    return biquad_scan<float, double, false>(A, Bv, c0, state_in, state_out, x, y, B, C, S,
                                             stream);
}

// K2 with a float64 (hi, lo) state [2, C, 2]: the state read as hi + lo,
// the end state written as (s, 0) (BiquadEffect's per-sample path).
extern "C" int dsp_biquad_scan_f64_pair(const double* A, const double* Bv, const double* c0,
                                        const double* state_in, double* state_out,
                                        const double* x, double* y, int B, int C, int S,
                                        void* stream) {
    return biquad_scan<double, double, true>(A, Bv, c0, state_in, state_out, x, y, B, C, S,
                                             stream);
}

// crossfeed's step: x and out [B, C], the four lanes' A [4, 2, 2], Bv
// [4, 2], c0 [4] and state [4, 2] (lanes lp(s1), lp(s0), hp(s0), hp(s1)),
// the gains of the mix; every column of out is written.
extern "C" int dsp_crossfeed_step_f64(const double* A, const double* Bv, const double* c0,
                                      const double* state_in, double* state_out, const double* x,
                                      double* out, int B, int C, int S, int col0, int col1,
                                      double direct, double cross, void* stream) {
    return crossfeed<double>(A, Bv, c0, state_in, state_out, x, out, B, C, S, col0, col1, direct,
                             cross, stream);
}

// The same in float32, with the gains as torch's float32 scalar multiply
// takes them (rounded to float32).
extern "C" int dsp_crossfeed_step_f32(const float* A, const float* Bv, const float* c0,
                                      const float* state_in, float* state_out, const float* x,
                                      float* out, int B, int C, int S, int col0, int col1,
                                      float direct, float cross, void* stream) {
    return crossfeed<float>(A, Bv, c0, state_in, state_out, x, out, B, C, S, col0, col1, direct,
                            cross, stream);
}

// Two float64 stages in series on x [B, C] (matrix4's band-limit: the
// highpass, then the lowpass): A [2C, 2, 2], Bv [2C, 2], c0 [2C] and the
// state [2C, 2], rows [0, C) the first stage; y [B, C] the second's output;
// S streams: x and y [S, B, C], the state [S, 2C, 2] (S·C lanes, as the
// run's). The n = 2 case of dsp_biquad_scan_run.
extern "C" int dsp_biquad_scan_series_f64(const double* A, const double* Bv, const double* c0,
                                          const double* state_in, double* state_out,
                                          const double* x, double* y, int B, int C, int S,
                                          void* stream) {
    RunStates st{};
    for (int s = 0; s < 2; ++s) {
        st.in[s] = state_in + (size_t)s * 2 * C;
        st.out[s] = state_out + (size_t)s * 2 * C;
    }
    st.lane = 2;
    st.stream = 4LL * C;
    return biquad_run<double, false>(A, Bv, c0, st, x, y, B, C, 2, S, stream);
}

// A run of n stages in series on x [B, C] in one launch: A [n, C, 2, 2],
// Bv [n, C, 2] and c0 [n, C] float64 (row s * C + c stage s's lane c), the
// states where *st says; y [B, C] the last stage's output; S streams: x and
// y [S, B, C]. f32: float32 x, y and states (K3), else float64 (K2); pair:
// the (hi, lo) states, else single ones. Returns cudaGetLastError() after
// the launch (0 on success); the caller checks shapes, dtypes, layouts and
// contiguity.
extern "C" int dsp_biquad_scan_run(const double* A, const double* Bv, const double* c0,
                                   const RunStates* st, const void* x, void* y, int B, int C,
                                   int n, int S, int f32, int pair, void* stream) {
    if (st == nullptr) return (int)cudaErrorInvalidValue;
    if (f32) {
        return pair ? biquad_run<float, true>(A, Bv, c0, *st, x, y, B, C, n, S, stream)
                    : biquad_run<float, false>(A, Bv, c0, *st, x, y, B, C, n, S, stream);
    }
    return pair ? biquad_run<double, true>(A, Bv, c0, *st, x, y, B, C, n, S, stream)
                : biquad_run<double, false>(A, Bv, c0, *st, x, y, B, C, n, S, stream);
}

extern "C" unsigned long long dsp_biquad_run_launches() { return run_launches; }
