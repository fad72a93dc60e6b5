// K1: blocked state-space (LTI) filter, for Hopper (sm_90a), on float64 or
// float32 samples.
//
// Replaces dsp_tpu/ops/iir.py:566 `_lti_blocked_impl`, entered through
// `lti_blocked` (iir.py:550) and `lti_blocked_df` (iir.py:556): its float64
// branch (iir.py:634-650) and its float32 branch (iir.py:574-631), which
// composes two-float32 (hi, lo) pairs for the chunk products, the injection
// and a Kogge-Stone carry because the TPU has no usable float64. For chunk
// k of L samples of channel c:
//   y_k = c0·x_k + W·x_k + P·s_k,   s_{k+1} = AL·s_k + V·x_k,
// with s_0 = state[0] + state[1], W the chunk's causal Toeplitz matrix of
// the impulse response h. Tables (float64, built on the host by
// dsp_tpu_torch/ops/iir.py `lti_kernel_tables`):
//   h  [C, L]         h[c, k] = C A^k B (k < L-1; the last entry unused)
//   V  [C, n, L]      injection: chunk k adds V·x_k to the carried state
//   P  [C, L, n]      readout: the carried state's share of each sample
//   Qc [C, T+1, n, n] AL^i, i = 0..T: powers of the chunk transition AL = A^L
//   Qt [C, M, n, n]   AL^(T·m), m = 0..M-1: the tile powers
//   At [C, n, n]      A^tail for a last chunk of tail < L samples, or null
//   c0 [C]            direct feed-through
// (the chunk powers and At in extended precision on the host, rounded
// once; the tile powers, whose rounding moves no output, float64 products).
// For an L = 1 plan (matrix4_mb's bank and matrix4's float32 band-limit at
// blocks off the 128 grid) the host builds these tables at L = 32 from the
// same system, so that the card does not walk the samples one by one; the
// last chunk may then be short (tail samples: its injection is V's last
// tail columns, its transition A^tail).
//
// What bounds it on the card: at the main path's shapes (flagship C = 2,
// n = 12, L = 128, B = 2048..65536; the bank C = 26, n = 40) a call moves
// under 2 MB and does under 20 MFLOP, so it is bound by latency: the
// launch, the global round trips and the serial carry over the chunks.
//
// Design: one launch, grid tiles × C (1-D, in ticket order), 256 threads,
// a block a tile of T chunks of one channel, everything in shared memory:
//   1. the tile's x (T·L samples), h, and where they fit the chunk powers,
//      V, P and the tile powers the block needs are staged in shared memory
//      (the tables by asynchronous copies, all in flight together; rows at
//      odd strides so that a warp's rows fall on distinct banks);
//   2. v_i = V·x_i for its chunks, 8 lanes (or a warp) on 4 state rows,
//      shuffle reduction;
//   3. the carry from the tile's start, u_i = sum over i' <= i of
//      AL^(i-i')·v_i', by a Kogge-Stone scan over the chunks (log2 T
//      rounds of products, all rows at once); u_{T-1} is published as the
//      tile's aggregate;
//   4. the look-back (csrc/lookback.cuh): the tile's start state
//      s_in = Qt[t]·s_0 + sum over earlier tiles j of Qt[t-1-j]·u_{T-1}(j),
//      in tile order, so the result does not depend on the tiles' timing;
//   5. each chunk's start state s_i = AL^i·s_in + u_{i-1}, all at once, and
//      the last tile the end state AL·s_last + v_last;
//   6. y = c0·x + z + P·s_i: z the causal FIR of up to L - 1 taps inside
//      the chunk, from x and h in shared memory; a lane computes 8
//      neighbouring outputs at once, sliding a window of 8 taps (one load
//      of h and one of x for 8 FMAs), a unit takes blocks b and L/8-1-b of
//      8 outputs (the same taps for every unit), split over up to 32 lanes
//      where the tile has few chunks, whose shares a reduce-scatter sums.
// Nothing crosses global memory between phases but the aggregates, n
// doubles a tile; the wrapper allocates only the outputs. x and y are
// [B, C] row-major (channel-interleaved, as the chain passes them) and are
// read and written strided by C; nothing is transposed.
//
// The stream axis (split and batched processing): x and y [S, B, C], the
// state [S, 2, C, n]. The grid is tiles × S·C in the same ticket order
// (tile index major), lane l = s·C + c; every stream takes channel c's
// tables (one copy, indexed by c, not tiled into S), the partition of one
// stream (T from C, not S·C), and slots of its own in the look-back
// scratch (lane l's tile t at l·ntiles + t), so stream s's tiles combine
// exactly as a one-stream call's do: the same bits.
//
// float32 samples (dsp_lti_blocked_f32): the same launch reads f32 x and
// the f32 (hi, lo) state, carries everything in float64 registers and
// shared memory, and stores f32: the state split as hi = (float)s,
// lo = (float)(s - hi), so hi + lo keeps s to ~48 bits across blocks, and y
// rounded once (or, with y_lo, split the same way: lti_blocked_df's (hi, lo)
// output). Hopper has float64 in hardware, so this computes the df
// branch's function at least as accurately as its two-float32 arithmetic,
// from the same float64 tables, with none of its hi/lo table splits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLook = 32;                 // earlier tiles combined at a time
constexpr int kStage = 16;                // loads of x a thread has in flight
constexpr int kOut = 8;                   // outputs a lane computes at once
constexpr size_t kMaxShared = 232448;     // a block's shared memory on the H100
constexpr size_t kStageDoubles = 28672;   // what the staging may fill (224 KB)

struct Tables {
    const double* h;
    const double* V;
    const double* P;
    const double* Qc;
    const double* Qt;
    const double* At;
    const double* c0;
};

struct Shape {
    int C, n, L, T, M, Nc, ntiles, tail, stage_c, stage_vp, stage_q, S, B;
};

// a state of T: float64 carries s in hi and 0 in lo; float32 splits s
// into a (hi, lo) pair whose sum is s to ~48 bits
__device__ __forceinline__ void store_split(double* hi, double* lo, double s) {
    *hi = s;
    *lo = 0.0;
}
__device__ __forceinline__ void store_split(float* hi, float* lo, double s) {
    const float h = (float)s;
    *hi = h;
    *lo = (float)(s - (double)h);
}

// one output sample: float64 stores it; float32 rounds it, or splits it
// into y and y_lo when y_lo is given
__device__ __forceinline__ void store_y(double* y, double*, size_t o, double v) { y[o] = v; }
__device__ __forceinline__ void store_y(float* y, float* y_lo, size_t o, double v) {
    const float h = (float)v;
    y[o] = h;
    if (y_lo != nullptr) y_lo[o] = (float)(v - (double)h);
}

// out[i·n + r] = M_i[r]·v_i for i < cnt, r < n, the block's threads on the
// cnt·n rows: M_i = M + i·mstride (n rows ldm apart, shared or global
// memory), v_i = v + i·vstride (shared).
__device__ void matvecs(const double* M, long long mstride, int ldm, const double* v,
                        int vstride, double* out, int cnt, int n) {
    for (int q = threadIdx.x; q < cnt * n; q += blockDim.x) {
        const int i = q / n, r = q - i * n;
        const double* Mr = M + i * mstride + (long long)r * ldm;
        const double* vi = v + i * vstride;
        double acc = 0.0;
        for (int j = 0; j < n; ++j) acc = fma(Mr[j], vi[j], acc);
        out[q] = acc;
    }
}

// Copy rows × cols doubles from contiguous global memory into shared
// memory rows dstride apart (a stride that keeps a warp's rows on distinct
// banks), as asynchronous copies (cp.async): the block's threads issue
// every copy of the staging before any waits, so its latency is paid once.
__device__ void copy_async(double* dst, int dstride, const double* src, int rows, int cols) {
    const float inv = 1.0f / (float)cols;  // row = q / cols, exact for these sizes
    for (int q = threadIdx.x; q < rows * cols; q += blockDim.x) {
        const int row = __float2int_rz(((float)q + 0.5f) * inv);
        __pipeline_memcpy_async(dst + row * dstride + (q - row * cols), src + q, sizeof(double));
    }
}

// One reduce-scatter step over lanes `o` apart: of the 2·H values z holds,
// a lane with bit o of `part` set keeps the upper H (summed with its
// partner's), the other the lower H; returns how far the kept values moved
// (H or 0).
template <int H>
__device__ __forceinline__ int halve(double* z, int o, int part) {
    const bool up = (part & o) != 0;
#pragma unroll
    for (int m = 0; m < H; ++m) {
        const double send = up ? z[m] : z[m + H];
        const double got = __shfl_xor_sync(0xffffffffu, send, o);
        z[m] = (up ? z[m + H] : z[m]) + got;
    }
    return up ? H : 0;
}

__host__ __device__ inline int odd(int k) { return k | 1; }

__host__ __device__ inline size_t base_doubles(int T, int L, int n) {
    return (size_t)T * L + L + kOut + (size_t)n * (3 * T + 2) + 2 * (size_t)kLook * n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lti_tiles(const T* __restrict__ x, T* __restrict__ y, T* __restrict__ y_lo,
              const T* __restrict__ state_in, T* __restrict__ state_out, Tables tb, Shape sh,
              lookback::Scratch lb) {
    extern __shared__ double smem[];
    __shared__ unsigned tk[2];
    const int n = sh.n, L = sh.L, Tc = sh.T, C = sh.C;
    lookback::begin(lb, tk);
    const unsigned lanes = (unsigned)C * (unsigned)sh.S;
    const int t = (int)(tk[0] / lanes), lane = (int)(tk[0] % lanes);
    const int s = lane / C, c = lane - s * C;  // stream s, channel c
    {   // this stream's samples and state
        const size_t xs0 = (size_t)s * sh.B * C, st0 = (size_t)s * 2 * C * n;
        x += xs0;
        y += xs0;
        if (y_lo != nullptr) y_lo += xs0;
        state_in += st0;
        state_out += st0;
    }
    const unsigned tag = tk[1];
    const int k0 = t * Tc;
    const int nch = min(Tc, sh.Nc - k0);
    const bool last = t == sh.ntiles - 1;
    const bool partial = last && sh.tail < L;
    const int ns = (nch - 1) * L + (partial ? sh.tail : L);
    const long long slot0 = (long long)lane * sh.ntiles;  // this lane's tile 0
    const int nn = n * n, sa = odd(n);

    double* xs = smem;                  // [T·L] the tile's samples
    double* hs = xs + Tc * L + kOut;    // [L] taps, after kOut zeros
    double* v = hs + L;                 // [T·n] injections
    double* u = v + Tc * n;             // [T·n] the carry from the tile's start, inclusive
    double* ss = u + Tc * n;            // [T·n] chunk start states
    double* s0 = ss + Tc * n;           // [n] the state handed in
    double* sin = s0 + n;               // [n] the tile's start state
    double* lv = sin + n;               // [kLook·n] earlier tiles' aggregates
    double* tmp = lv + kLook * n;       // [kLook·n] products
    double* extra = tmp + kLook * n;    // Qc, V, P, then Qt[0..t], where staged

    // 1. the tile and its tables, every copy in flight at once
    const double* Q1 = tb.Qc + (size_t)c * (Tc + 1) * nn + nn;  // AL^1; AL^i is i - 1 on
    const double* Vc = tb.V + (size_t)c * n * L;
    const double* Pc = tb.P + (size_t)c * L * n;
    const double* Qt = tb.Qt + (size_t)c * sh.M * nn;
    int sc = n, sv = L, sp = n, sq = n;  // row strides of Qc, V, P and Qt
    copy_async(hs, L, tb.h + (size_t)c * L, 1, L);
    if (sh.stage_c) {
        sc = sa;
        copy_async(extra, sc, Q1, Tc * n, n);
        Q1 = extra;
        extra += Tc * n * sc;
    }
    if (sh.stage_vp) {
        sv = L + 1;
        sp = sa;
        copy_async(extra, sv, Vc, n, L);
        Vc = extra;
        extra += n * sv;
        copy_async(extra, sp, Pc, L, n);
        Pc = extra;
        extra += L * sp;
    }
    if (sh.stage_q && t > 0) {
        sq = sa;
        copy_async(extra, sq, Qt, (t + 1) * n, n);
        Qt = extra;
    }
    __pipeline_commit();
    const long long qc = (long long)n * sc;  // one chunk power
    const size_t xoff = (size_t)k0 * L;
    for (int j0 = threadIdx.x; j0 < Tc * L; j0 += kStage * blockDim.x) {
        double r[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
            const int j = j0 + u * blockDim.x;
            r[u] = j < ns ? (double)x[(xoff + j) * C + c] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
            const int j = j0 + u * blockDim.x;
            if (j < Tc * L) xs[j] = r[u];
        }
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x)
        s0[r] = (double)state_in[(size_t)c * n + r] + (double)state_in[(size_t)(C + c) * n + r];
    if (threadIdx.x < kOut) hs[(int)threadIdx.x - kOut] = 0.0;
    __pipeline_wait_prior(0);
    __syncthreads();

    // 2. injections, 8 lanes a (chunk, 4 rows) on interleaved samples (a
    // warp where the tile has few chunks): one load of x for 4 FMAs; a
    // short last chunk takes V's last `tail` columns
    const int rg = (n + 3) / 4;
    const int lpt = nch * rg * 32 <= (int)blockDim.x ? 32 : 8;
    const int part8 = threadIdx.x % lpt, groups = blockDim.x / lpt;
    for (int task0 = 0; task0 < nch * rg; task0 += groups) {
        const int task = task0 + threadIdx.x / lpt;
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
        const int i = task / rg, r0 = 4 * (task - i * rg);
        if (task < nch * rg) {
            const int len = (partial && i == nch - 1) ? sh.tail : L;
            const double* Vr = Vc + (size_t)r0 * sv + (L - len);
            const double* xi = xs + i * L;
            const int nr = min(4, n - r0);
            for (int j = part8; j < len; j += lpt) {
                const double xj = xi[j];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (k < nr) acc[k] = fma(Vr[k * sv + j], xj, acc[k]);
            }
        }
        for (int o = 1; o < lpt; o <<= 1)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
        if (task < nch * rg && part8 == 0)
            for (int k = 0; k < 4 && r0 + k < n; ++k) v[i * n + r0 + k] = acc[k];
    }
    __syncthreads();

    // 3. the carry from the tile's start over its whole chunks, u_i = sum
    // over i' <= i of AL^(i-i')·v_i', by a Kogge-Stone scan over the chunks
    // (rounds d = 1, 2, 4, ...: u_i += AL^d·u_{i-d}); u_{T-1} is the tile's
    // aggregate
    const int nfull = partial ? nch - 1 : nch;
    for (int q = threadIdx.x; q < nch * n; q += blockDim.x) u[q] = v[q];
    __syncthreads();
    for (int d = 1; d < nfull; d <<= 1) {
        matvecs(Q1 + (d - 1) * qc, 0, sc, u, n, tmp, nfull - d, n);
        __syncthreads();
        for (int q = d * n + threadIdx.x; q < nfull * n; q += blockDim.x) u[q] += tmp[q - d * n];
        __syncthreads();
    }
    if (!last) lookback::publish(lb, slot0 + t, tag, u + (Tc - 1) * n, n);

    // 4. the look-back: sin = Qt[t]·s0 + sum over j < t of Qt[t-1-j]·agg_j
    if (t == 0) {
        for (int r = threadIdx.x; r < n; r += blockDim.x) sin[r] = s0[r];
        __syncthreads();
    } else {
        const long long qm = (long long)n * sq;  // one tile power
        for (int j = threadIdx.x; j < t; j += blockDim.x) lookback::wait(lb, slot0 + j, tag);
        matvecs(Qt + t * qm, 0, sq, s0, 0, sin, 1, n);
        __syncthreads();
        for (int j0 = 0; j0 < t; j0 += kLook) {
            const int cnt = min(kLook, t - j0);
            for (int q = threadIdx.x; q < cnt * n; q += blockDim.x)
                lv[q] = __ldcg(lb.agg + (slot0 + j0) * n + q);
            __syncthreads();
            matvecs(Qt + (t - 1 - j0) * qm, -qm, sq, lv, n, tmp, cnt, n);
            __syncthreads();
            for (int r = threadIdx.x; r < n; r += blockDim.x) {
                double acc = sin[r];
                for (int i = 0; i < cnt; ++i) acc += tmp[i * n + r];
                sin[r] = acc;
            }
            __syncthreads();
        }
    }

    // 5. each chunk's start state s_i = AL^i·sin + u_{i-1}, and (last tile)
    // the end state AL·s_last + v_last (A^tail for a short last chunk)
    matvecs(Q1, qc, sc, sin, 0, tmp, nch - 1, n);
    __syncthreads();
    for (int q = threadIdx.x; q < nch * n; q += blockDim.x)
        ss[q] = q < n ? sin[q] : tmp[q - n] + u[q - n];
    __syncthreads();
    if (last) {
        if (partial)  // A^tail from global memory: one product a call
            matvecs(tb.At + (size_t)c * nn, 0, n, ss + (nch - 1) * n, 0, lv, 1, n);
        else
            matvecs(Q1, 0, sc, ss + (nch - 1) * n, 0, lv, 1, n);
        __syncthreads();
        for (int r = threadIdx.x; r < n; r += blockDim.x)
            store_split(state_out + (size_t)c * n + r, state_out + (size_t)(C + c) * n + r,
                        lv[r] + v[(nch - 1) * n + r]);
    }

    // 6. the outputs, in blocks of kOut: a unit is blocks b and L/kOut-1-b
    // of a chunk (L + 2·kOut - 2 taps in all), R lanes a unit each on a
    // contiguous share of the taps and of the readout; a lane slides a
    // window of kOut taps over its samples, one load of h and one of x for
    // kOut FMAs
    const double g = tb.c0[c];
    const int nb = L / kOut, upc = (nb + 1) / 2;
    const int units = nch * upc;
    int R = 1;
    while (R < 32 && units * R * 2 <= (int)blockDim.x) R *= 2;
    for (int q0 = 0; q0 < units * R; q0 += blockDim.x) {
        const int q = q0 + threadIdx.x;
        const int u = q / R, part = q - u * R;
        const bool on = u < units;
        const int i = on ? u / upc : 0, ub = on ? u - i * upc : 0;
        const double* xi = xs + i * L;
        const double* si = ss + i * n;
        double z[2][kOut];
        int pb[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int b = e == 0 ? ub : nb - 1 - ub;
            pb[e] = (on && (e == 0 || b != ub)) ? kOut * b : -1;
#pragma unroll
            for (int k = 0; k < kOut; ++k) z[e][k] = 0.0;
            if (pb[e] < 0) continue;
            const int p0 = pb[e];
            // output p0 + k takes h[p0 + k - 1 - j]·x[j] for j < p0 + k (h is
            // zero below index 0); hw[k] = h[p0 + k - 1 - j]
            const int span = p0 + kOut - 1, per = (span + R - 1) / R;
            const int j0 = part * per, j1 = min(span, j0 + per);
            double hw[kOut];
#pragma unroll
            for (int k = 0; k < kOut; ++k) hw[k] = hs[p0 + k - 1 - j0];
#pragma unroll 2
            for (int j = j0; j < j1; ++j) {
                const double xj = xi[j];
#pragma unroll
                for (int k = 0; k < kOut; ++k) z[e][k] = fma(hw[k], xj, z[e][k]);
#pragma unroll
                for (int k = kOut - 1; k > 0; --k) hw[k] = hw[k - 1];
                hw[0] = hs[p0 - 2 - j];
            }
            const double* Pp = Pc + (size_t)p0 * sp;
            for (int r = part; r < n; r += R) {
                const double sr = si[r];
#pragma unroll
                for (int k = 0; k < kOut; ++k) z[e][k] = fma(Pp[k * sp + r], sr, z[e][k]);
            }
        }
        // sum the R lanes' shares, halving the values a lane holds at each
        // step (a reduce-scatter: 2·kOut - 1 shuffles a lane at most)
        double zf[2 * kOut];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int k = 0; k < kOut; ++k) zf[e * kOut + k] = z[e][k];
        int base = 0, count = 2 * kOut, o = R >> 1;
        if (o >= 1) base += halve<kOut>(zf, o, part), count >>= 1, o >>= 1;
        if (o >= 1) base += halve<kOut / 2>(zf, o, part), count >>= 1, o >>= 1;
        if (o >= 1) base += halve<kOut / 4>(zf, o, part), count >>= 1, o >>= 1;
        if (o >= 1) base += halve<kOut / 8>(zf, o, part), count >>= 1, o >>= 1;
        const bool keeper = (part & (o > 0 ? 2 * o - 1 : 0)) == 0;
        for (; o >= 1; o >>= 1) zf[0] += __shfl_xor_sync(0xffffffffu, zf[0], o);
        if (keeper) {
            const int len = (partial && i == nch - 1) ? sh.tail : L;
#pragma unroll
            for (int m = 0; m < 2 * kOut; ++m) {
                if (m >= count) break;
                const int at = base + m, p0 = at < kOut ? pb[0] : pb[1], p = p0 + at % kOut;
                if (p0 >= 0 && p < len)
                    store_y(y, y_lo, (xoff + (size_t)i * L + p) * C + c, g * xi[p] + zf[m]);
            }
        }
    }
    lookback::end(lb);
}

// The kernels lti_blocked has launched in this process (host side): how a
// caller checks that a call is one launch.
unsigned long long lti_launches = 0;

template <typename T>
int lti_blocked(const T* x, T* y, T* y_lo, const T* state_in, T* state_out, const Tables& tb,
                unsigned* flags, long long flag_slots, double* agg, long long agg_doubles, int B,
                int C, int n, int L, int Tc, int M, int S, cudaStream_t st) {
    if (B <= 0 || C <= 0 || n <= 0 || L <= 0 || Tc <= 0 || S <= 0 || flags == nullptr ||
        agg == nullptr)
        return (int)cudaErrorInvalidValue;
    Shape sh;
    sh.S = S;
    sh.B = B;
    sh.C = C;
    sh.n = n;
    sh.L = L;
    sh.T = Tc;
    sh.M = M;
    sh.Nc = (B + L - 1) / L;
    sh.ntiles = (sh.Nc + Tc - 1) / Tc;
    sh.tail = B - (sh.Nc - 1) * L;
    const long long blocks = (long long)sh.ntiles * C * S;
    size_t doubles = base_doubles(Tc, L, n);
    const size_t qcs = (size_t)Tc * n * odd(n);
    sh.stage_c = doubles + qcs <= kStageDoubles;
    if (sh.stage_c) doubles += qcs;
    const size_t vp = (size_t)n * (L + 1) + (size_t)L * odd(n);
    sh.stage_vp = doubles + vp <= kStageDoubles;
    if (sh.stage_vp) doubles += vp;
    sh.stage_q = doubles + (size_t)sh.ntiles * n * odd(n) <= kStageDoubles;
    if (sh.stage_q) doubles += (size_t)sh.ntiles * n * odd(n);
    const size_t smem = doubles * sizeof(double);
    if (M < sh.ntiles || L % kOut || (sh.tail < L && tb.At == nullptr) || blocks > 0x7fffffffLL ||
        blocks > flag_slots || blocks * n > agg_doubles || smem > kMaxShared)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lti_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    lti_tiles<T><<<(unsigned)blocks, kThreads, smem, st>>>(x, y, y_lo, state_in, state_out, tb,
                                                           sh, lookback::carve(flags, agg));
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++lti_launches;
    return (int)err;
}

Tables tables(const double* h, const double* V, const double* P, const double* Qc,
              const double* Qt, const double* At, const double* c0) {
    Tables tb;
    tb.h = h;
    tb.V = V;
    tb.P = P;
    tb.Qc = Qc;
    tb.Qt = Qt;
    tb.At = At;
    tb.c0 = c0;
    return tb;
}

}  // namespace

// Return cudaGetLastError() after the launch (0 on success). The caller
// checks shapes, dtypes and contiguity; these only refuse what they cannot
// launch. The tables are float64 in both; L is the chunk length the tables
// were built for, T the chunks a tile, M the tile powers in Qt; flags
// (flag_slots slots after its head) and agg (agg_doubles long) are the
// look-back scratch of csrc/lookback.cuh; S streams: x and y [S, B, C], the
// states [S, 2, C, n].
extern "C" int dsp_lti_blocked_f64(const double* x, double* y, const double* state_in,
                                   double* state_out, const double* h, const double* V,
                                   const double* P, const double* Qc, const double* Qt,
                                   const double* At, const double* c0, unsigned* flags,
                                   long long flag_slots, double* agg, long long agg_doubles, int B,
                                   int C, int n, int L, int T, int M, int S, void* stream) {
    return lti_blocked<double>(x, y, nullptr, state_in, state_out,
                               tables(h, V, P, Qc, Qt, At, c0), flags, flag_slots, agg,
                               agg_doubles, B, C, n, L, T, M, S,
                               static_cast<cudaStream_t>(stream));
}

// float32 samples and a float32 (hi, lo) state [2, C, n] ([S, 2, C, n]);
// y_lo null rounds y once, else y and y_lo are the (hi, lo) split of each
// output sample.
extern "C" int dsp_lti_blocked_f32(const float* x, float* y, float* y_lo, const float* state_in,
                                   float* state_out, const double* h, const double* V,
                                   const double* P, const double* Qc, const double* Qt,
                                   const double* At, const double* c0, unsigned* flags,
                                   long long flag_slots, double* agg, long long agg_doubles, int B,
                                   int C, int n, int L, int T, int M, int S, void* stream) {
    return lti_blocked<float>(x, y, y_lo, state_in, state_out, tables(h, V, P, Qc, Qt, At, c0),
                              flags, flag_slots, agg, agg_doubles, B, C, n, L, T, M, S,
                              static_cast<cudaStream_t>(stream));
}

extern "C" unsigned long long dsp_lti_launches() { return lti_launches; }
