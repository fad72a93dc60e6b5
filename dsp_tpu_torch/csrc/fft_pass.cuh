// The passes of csrc/fft_conv.cu's mixed-radix FFT as device functions, for
// the kernels that run a transform inside a launch of their own: the plan's
// int array and its parse (Pass, Plan, parse_plan), the first pass's loads
// and the last pass's stores (Load, Store), a thread block's tile of
// sub-transforms in shared memory (Tile, pad, lane_points), its
// digit-reversed load (load_tile), the butterfly and direct stages
// (run_stages) and its store (store_tile), and the twiddle reads of the
// table ops/fft_conv.py `fft_tables` builds. fft_conv.cu (rfft_pack,
// irfft_crop, irfft_ola) and resample.cu (the resampler's step in one
// launch) include it; csrc/fft_conv.cu's header comment describes the
// transform.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // the copy and the global pass
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks per SM, then grid-stride
constexpr int kMaxThreads = 512;             // a block pass's threads
constexpr int kBlockPoints = 8192;           // points a block pass holds (T P)
constexpr int kHeld = 16;                    // points a thread holds across a direct stage
constexpr int kMaxPasses = 8;
constexpr int kMaxRadices = 16;
constexpr int kSmemLimit = 232448;           // dynamic shared memory a block can use
constexpr int kGlobalPass = 1;               // plan: a pass of one radix in device memory

enum LoadMode { kLoadRealPack = 1, kLoadHermitian = 2, kLoadRealPackF32 = 3 };
enum StoreMode {
    kStoreComplex = 0, kStoreRealCrop = 1, kStoreOlaF32 = 2, kStoreRealCropF32 = 3,
    kStoreOlaF64 = 4
};

// The first load's and the last store's tensors hold their columns in
// groups of ch (inner blocks, or streams): column g·ch + c is column c of
// group g's rows, [G, rows, ch] (grouped); one group of all C columns is
// the plain [rows, C].
struct Load {
    int mode;
    const double2* c;   // kLoadHermitian: [G, NB, ch]
    long long NB;       // kLoadHermitian: rows of the half spectrum
    const void* a;      // real pack: [G, La, ch], double or float by mode
    long long La;
    const void* x;      // real pack: [G, Lx, ch]
    long long Lx;
    int ch;             // the columns of a group
    void* kept;         // real pack: the last `keep` rows of [a | x], [G, keep, ch]
    long long keep;
};

struct Store {
    int mode;
    double2* c;         // kStoreComplex: rows [0, rows) of [N, C], grouped [G, rows, ch]
    long long rows;
    double* r;          // kStoreRealCrop: [G, L, ch]
    long long lo, L;
    const double* add;  // kStoreRealCrop: [G, L, ch] or null
    double scale;
    void* y;            // kStoreOla*: [C / ch, N / 2, ch], float or double by mode
    void* ov_out;       // kStoreOla*: [S, N / 2, ch]
    const void* ov_in;  // kStoreOla*: [S, N / 2, ch]
    double ratio;       // kStoreOla*: applied after scale
    int ch;             // the columns of a group (kStoreOla*: channels, C / ch inner blocks)
    float* rf;          // kStoreRealCropF32: [G, L, ch], with lo, L, scale
    const float* addf;  // kStoreRealCropF32: [G, L, ch] or null
    int nb;             // kStoreOla*: inner blocks a stream (S = C / (nb ch) streams)
};

// One pass of the plan, as the kernels take it.
struct Pass {
    int P;              // points of a sub-transform (block pass) or the radix (global pass)
    int nsa;            // product of the earlier passes' radices
    int T;              // sub-transforms a thread block (block pass)
    int nrad;
    int radix[kMaxRadices];
    int first, last;
    const double2* in;  // the previous pass's output [N, C] (not first)
    double2* out;       // this pass's output [N, C] (not last)
    const int* perm;    // block pass: each input point's digit-reversed position
};

template <class T>
__device__ __forceinline__ double real_at(const void* p, long long i) {
    return (double)static_cast<const T*>(p)[i];
}

// Row n of column c of a grouped tensor [G, rows, ch]: column c is column
// c % ch of group c / ch.
__device__ __forceinline__ long long grouped(long long n, int c, int ch, long long rows) {
    const int g = c / ch;
    return ((long long)g * rows + n) * ch + (c - g * ch);
}

template <class T>
__device__ __forceinline__ void keep_row(const Load& ld, long long n, int c, int) {
    const long long k0 = ld.La + ld.Lx - ld.keep;
    if (n >= k0 && n < ld.La + ld.Lx) {
        const T v = n < ld.La ? static_cast<const T*>(ld.a)[grouped(n, c, ld.ch, ld.La)]
                              : static_cast<const T*>(ld.x)[grouped(n - ld.La, c, ld.ch, ld.Lx)];
        static_cast<T*>(ld.kept)[grouped(n - k0, c, ld.ch, ld.keep)] = v;
    }
}

// Point n of column c of the first pass's input.
__device__ __forceinline__ double2 load_point(const Load& ld, long long n, int c, int, int N) {
    if (ld.mode == kLoadHermitian) {
        if (n < ld.NB) return ld.c[grouped(n, c, ld.ch, ld.NB)];
        const double2 v = ld.c[grouped(N - n, c, ld.ch, ld.NB)];
        return make_double2(v.x, -v.y);
    }
    double v = 0.0;
    const bool f32 = ld.mode == kLoadRealPackF32;
    if (n < ld.La) {
        const long long i = grouped(n, c, ld.ch, ld.La);
        v = f32 ? real_at<float>(ld.a, i) : real_at<double>(ld.a, i);
    } else if (n < ld.La + ld.Lx) {
        const long long i = grouped(n - ld.La, c, ld.ch, ld.Lx);
        v = f32 ? real_at<float>(ld.x, i) : real_at<double>(ld.x, i);
    }
    return make_double2(v, 0.0);
}

// load_point, storing the point as a kept row too where it is one.
__device__ __forceinline__ double2 load_first(const Load& ld, long long n, int c, int C, int N) {
    if (ld.keep > 0) {
        if (ld.mode == kLoadRealPackF32) keep_row<float>(ld, n, c, C);
        else keep_row<double>(ld, n, c, C);
    }
    return load_point(ld, n, c, C, N);
}

// Whether the last pass's store keeps output point d.
__device__ __forceinline__ bool stored(const Store& st, long long d) {
    return st.mode == kStoreComplex ? d < st.rows : (d >= st.lo && d < st.lo + st.L);
}

__device__ __forceinline__ void store_point(const Store& st, long long d, int c, int,
                                            double2 v) {
    if (!stored(st, d)) return;
    if (st.mode == kStoreComplex) {
        st.c[grouped(d, c, st.ch, st.rows)] = v;
        return;
    }
    const long long o = grouped(d - st.lo, c, st.ch, st.L);
    double y = v.x * st.scale;
    if (st.mode == kStoreRealCrop) {
        if (st.add != nullptr) y += st.add[o];
        st.r[o] = y;
    } else {
        if (st.addf != nullptr) y += (double)st.addf[o];
        st.rf[o] = (float)y;
    }
}

// The resampler's overlap-add (dsp_tpu/ops/resample_ops.py:144, `block`)
// on a point v of an inner block's inverse: its tail is v times 1/N
// (scale), then the rate ratio, each product rounded, in the sample type
// (the carried overlap's); the output adds the next block's head, scaled
// alike, to that tail. In float64 each product and the sum round on their
// own, as the torch ops of the step's plain version do (no FMA); in float32
// the head stays float64 up to the one rounding of the output, as
// irfft_ola_f32 has always written it.
template <class T>
__device__ __forceinline__ T ola_tail(double v, double scale, double ratio) {
    return (T)__dmul_rn(__dmul_rn(v, scale), ratio);
}
__device__ __forceinline__ double ola_out(double v, double scale, double ratio, double prev) {
    return __dadd_rn(__dmul_rn(__dmul_rn(v, scale), ratio), prev);
}
__device__ __forceinline__ float ola_out(double v, double scale, double ratio, float prev) {
    return (float)((v * scale) * ratio + (double)prev);
}

// W^idx of the table exp(-2 pi i idx / N); sign -1 conjugates it (the inverse).
__device__ __forceinline__ double2 twiddle(const double2* __restrict__ tw, int idx, double sign) {
    const double2 w = __ldg(tw + idx);
    return make_double2(w.x, sign * w.y);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
// z times W4 = -i sign
__device__ __forceinline__ double2 rot4(double2 z, double sign) { return make_double2(sign * z.y, -sign * z.x); }

__device__ __forceinline__ void dft4(const double2& u0, const double2& u1, const double2& u2,
                                     const double2& u3, double2* v, double sign) {
    const double2 a0 = cadd(u0, u2), a1 = csub(u0, u2);
    const double2 b0 = cadd(u1, u3), b1 = rot4(csub(u1, u3), sign);
    v[0] = cadd(a0, b0);
    v[2] = csub(a0, b0);
    v[1] = cadd(a1, b1);
    v[3] = csub(a1, b1);
}

// v[q] = sum_r u[r] W_R^(r q), W_R = exp(-+2 pi i / R) = W^(N / R).
template <int R>
__device__ __forceinline__ void dft(const double2* u, double2* v, const double2* __restrict__ tw,
                                    int N, double sign) {
    if constexpr (R == 2) {
        v[0] = cadd(u[0], u[1]);
        v[1] = csub(u[0], u[1]);
    } else if constexpr (R == 4) {
        dft4(u[0], u[1], u[2], u[3], v, sign);
    } else if constexpr (R == 8) {
        constexpr double h = 0.70710678118654752440;  // sqrt(1/2)
        double2 e[4], o[4];
        dft4(u[0], u[2], u[4], u[6], e, sign);
        dft4(u[1], u[3], u[5], u[7], o, sign);
        // o[q] times W8^q: W8 = h (1 - i sign), W8^2 = -i sign, W8^3 = h (-1 - i sign)
        o[1] = make_double2(h * (o[1].x + sign * o[1].y), h * (o[1].y - sign * o[1].x));
        o[2] = rot4(o[2], sign);
        o[3] = make_double2(h * (sign * o[3].y - o[3].x), -h * (o[3].y + sign * o[3].x));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            v[q] = cadd(e[q], o[q]);
            v[q + 4] = csub(e[q], o[q]);
        }
    } else {
        const int step = N / R;
        v[0] = u[0];
#pragma unroll
        for (int r = 1; r < R; ++r) v[0] = cadd(v[0], u[r]);
#pragma unroll
        for (int q = 1; q < R; ++q) {
            double2 acc = u[0];
#pragma unroll
            for (int r = 1; r < R; ++r) {
                acc = cadd(acc, cmul(u[r], twiddle(tw, ((r * q) % R) * step, sign)));
            }
            v[q] = acc;
        }
    }
}

// What a thread block of a block pass works on: lanes [l0, l0 + T) of the
// pass's (N / P) * C sub-transforms (lane l: sub-transform l / C of column
// l % C). Point i of lane t sits at buf[t * stride + pad(i)]: a gap of one
// point after every 8 and one more after every 512 (pad), so that the 8
// threads of a 128-byte phase that touch points 8 apart (a stage's first
// butterflies) or a power of 8 apart (the digit-reversed load) hit
// distinct banks.
struct Tile {
    double2* buf;
    int P, stride, nsa, T, l0, C, N;
    double sign;
    const double2* tw;
};

__host__ __device__ constexpr int pad(int i) { return i + (i >> 3) + (i >> 9); }
// A lane's span in shared memory, in points (ops/fft_conv.py `lane_points`).
__host__ __device__ constexpr int lane_points(int P) { return pad(P - 1) + 1; }

// A butterfly stage of radix R at ns (the product of the radices before it
// in this pass): butterfly (g, k) reads points g ns R + k + q ns, q < R, of
// its lane, times W_(ns R)^(q k), and writes its R-point DFT back to the
// same points. Butterflies share no point, so a thread holds one at a time.
// Of the twiddles it loads W_(ns R)^k and takes its powers by products (a
// power q off by about q rounding errors), one load where there were R - 1.
template <int R>
__device__ __forceinline__ void bfly_stage(const Tile& tl, int ns) {
    const int per_lane = tl.P / R;
    const int stride = tl.N / (ns * R);  // W_(ns R) = W^stride
    for (int b = threadIdx.x; b < tl.T * per_lane; b += blockDim.x) {
        const int t = tl.T == 1 ? 0 : b / per_lane, j = b - t * per_lane;
        const int g = j / ns, k = j - g * ns;
        double2* lane = tl.buf + t * tl.stride;
        const int base = g * ns * R + k;
        double2 u[R], v[R];
        const double2 w1 = twiddle(tl.tw, k * stride, tl.sign);
        double2 w = w1;
        u[0] = lane[pad(base)];
#pragma unroll
        for (int q = 1; q < R; ++q) {
            u[q] = cmul(lane[pad(base + q * ns)], w);
            if (q + 1 < R) w = cmul(w, w1);
        }
        dft<R>(u, v, tl.tw, tl.N, tl.sign);
#pragma unroll
        for (int q = 0; q < R; ++q) lane[pad(base + q * ns)] = v[q];
    }
    __syncthreads();
}

// A stage of any other radix (a prime above 7): each output point by its
// R-term sum, W^(q e) with e = k N / (ns R) + q' N / R for output q' of
// butterfly (g, k); a thread holds at most kHeld points across the
// barrier (the plan gives T P <= kHeld * threads).
__device__ __forceinline__ void direct_stage(const Tile& tl, int R, int ns) {
    const int n = tl.T * tl.P, L = ns * R;
    double2 v[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
        const int p = threadIdx.x + i * blockDim.x;
        if (p < n) {
            const int t = p / tl.P, pos = p - t * tl.P;
            const int g = pos / L, k = pos % ns, q = (pos - g * L) / ns;
            const double2* lane = tl.buf + t * tl.stride;
            const int first = g * L + k;
            const int e = k * (tl.N / L) + q * (tl.N / R);  // < N
            double2 acc = lane[pad(first)];
            int idx = 0;
            for (int r = 1; r < R; ++r) {
                idx += e;
                if (idx >= tl.N) idx -= tl.N;
                acc = cadd(acc, cmul(lane[pad(first + r * ns)], twiddle(tl.tw, idx, tl.sign)));
            }
            v[i] = acc;
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
        const int p = threadIdx.x + i * blockDim.x;
        if (p < n) {
            const int t = p / tl.P;
            tl.buf[t * tl.stride + pad(p - t * tl.P)] = v[i];
        }
    }
    __syncthreads();
}

// Every stage of the pass, in the plan's order (innermost first), on the
// tile's lanes in place: from the digit-reversed input to the DFT_P in
// natural order.
__device__ __forceinline__ void run_stages(const Tile& tl, const Pass& ps) {
    int ns = 1;
    for (int s = 0; s < ps.nrad; ++s) {
        const int R = ps.radix[s];
        switch (R) {
            case 2: bfly_stage<2>(tl, ns); break;
            case 3: bfly_stage<3>(tl, ns); break;
            case 4: bfly_stage<4>(tl, ns); break;
            case 5: bfly_stage<5>(tl, ns); break;
            case 7: bfly_stage<7>(tl, ns); break;
            case 8: bfly_stage<8>(tl, ns); break;
            default: direct_stage(tl, R, ns); break;
        }
        ns *= R;
    }
}

// Load the tile's lanes: input point r of lane t is point s + r N / P of
// the previous pass's layout (of the input, for the first pass), s = l / C,
// times W^(r kappa N / (nsa P)), kappa = s % nsa (the four-step twiddle;
// none in the first pass), and goes to its digit-reversed position
// perm[r] (the plan's table). Neighbouring threads take neighbouring
// points of one lane (T = 1) or one point of neighbouring lanes, which lie
// side by side, so the loads coalesce; a thread issues kLoads loads before
// it stores any, so that their latencies overlap.
__device__ __forceinline__ void load_tile(const Tile& tl, const Pass& ps, const Load& ld) {
    constexpr int kLoads = 8;
    const int span = tl.N / tl.P, n = tl.T * tl.P;
    const int tw_step = tl.N / (tl.nsa * tl.P);
    const bool one = tl.T == 1;
    const int s1 = tl.l0 / tl.C, c1 = tl.l0 - s1 * tl.C;  // the lane, for T = 1
    for (int i0 = threadIdx.x; i0 < n; i0 += kLoads * blockDim.x) {
        double2 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i < n) {
                const int r = one ? i : i / tl.T, t = i - r * tl.T;
                int s = s1, c = c1;
                if (!one) {
                    s = (tl.l0 + t) / tl.C;
                    c = tl.l0 + t - s * tl.C;
                }
                const long long g = s + (long long)r * span;
                if (ps.first) {
                    v[u] = load_first(ld, g, c, tl.C, tl.N);
                } else {
                    const int kap = s % tl.nsa;
                    v[u] = ps.in[g * tl.C + c];
                    if (kap) {
                        v[u] = cmul(v[u], twiddle(tl.tw, (int)((long long)r * kap * tw_step), tl.sign));
                    }
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i < n) {
                const int r = one ? i : i / tl.T, t = i - r * tl.T;
                tl.buf[t * tl.stride + pad(__ldg(ps.perm + r))] = v[u];
            }
        }
    }
    __syncthreads();
}

// Store the tile: point r of lane t is point
// s / nsa * nsa P + s % nsa + r nsa of this pass's layout (the transform's
// output index, for the last pass).
__device__ __forceinline__ void store_tile(const Tile& tl, const Pass& ps, const Store& st) {
    if (tl.T == 1) {  // one lane: its place in the layout once
        const int s = tl.l0 / tl.C, c = tl.l0 - s * tl.C;
        const long long g0 = (long long)(s / tl.nsa) * tl.nsa * tl.P + s % tl.nsa;
        for (int r = threadIdx.x; r < tl.P; r += blockDim.x) {
            const long long g = g0 + (long long)r * tl.nsa;
            const double2 v = tl.buf[pad(r)];
            if (ps.last) store_point(st, g, c, tl.C, v);
            else ps.out[g * tl.C + c] = v;
        }
        return;
    }
    for (int i = threadIdx.x; i < tl.T * tl.P; i += blockDim.x) {
        const int r = i / tl.T, t = i - r * tl.T;
        const int l = tl.l0 + t, s = l / tl.C, c = l - s * tl.C;
        const long long g = (long long)(s / tl.nsa) * tl.nsa * tl.P + s % tl.nsa + (long long)r * tl.nsa;
        const double2 v = tl.buf[t * tl.stride + pad(r)];
        if (ps.last) store_point(st, g, c, tl.C, v);
        else ps.out[g * tl.C + c] = v;
    }
}

// Raise a kernel's dynamic shared memory limit once per device.
template <class K>
cudaError_t allow_smem(K kernel, unsigned* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 32 && (*done >> dev) & 1u) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess && dev < 32) *done |= 1u << dev;
    return err;
}

// The plan handed over from Python (ops/fft_conv.py FftPlan.c_plan):
// [passes, then per pass: kind, P, T, threads, smem bytes, nrad, radices...].
struct Plan {
    int n;
    Pass pass[kMaxPasses];
    int kind[kMaxPasses], threads[kMaxPasses], smem[kMaxPasses];
};

// Parse and check a plan for N; false if it does not describe N or does
// not fit the kernels' bounds.
bool parse_plan(const int* p, int N, Plan* out) {
    if (p == nullptr || p[0] < 1 || p[0] > kMaxPasses) return false;
    out->n = p[0];
    long long prod = 1;
    int at = 1;
    for (int i = 0; i < out->n; ++i) {
        const int kind = p[at], P = p[at + 1], T = p[at + 2], threads = p[at + 3];
        const int smem = p[at + 4], nrad = p[at + 5];
        if (nrad < 0 || nrad > kMaxRadices || P < 1) return false;
        Pass& ps = out->pass[i];
        ps.P = P;
        ps.nsa = (int)prod;
        ps.T = T;
        ps.nrad = nrad;
        long long pp = 1;
        for (int r = 0; r < nrad; ++r) {
            ps.radix[r] = p[at + 6 + r];
            if (ps.radix[r] < 2) return false;
            pp *= ps.radix[r];
        }
        if (pp != P) return false;
        if (kind == kGlobalPass) {
            if (nrad != 1) return false;
        } else if (kind != 0 || T < 1 || (long long)T * P > kBlockPoints || threads < 32 ||
                   threads > kMaxThreads || (long long)threads * kHeld < (long long)T * P ||
                   smem < T * lane_points(P) * 16 || smem > kSmemLimit) {
            return false;
        }
        out->kind[i] = kind;
        out->threads[i] = threads;
        out->smem[i] = smem;
        prod *= P;
        at += 6 + nrad;
    }
    return prod == N;
}

}  // namespace
