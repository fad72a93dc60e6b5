// K5-K7: the transforms and copies around the spectral multiply-accumulate
// of FFT convolution, float64 / complex128, for Hopper (sm_90a).
//
// Together with fdl_mac.cu these replace every step of three TPU functions
// of dsp_tpu/ops/fft_conv.py: `OlsConv.step` (:85), `UpolsConv.step` (:137)
// and `NupolsConv.step` (:204). This file does the work on either side of
// the multiply-accumulate:
//
// * rfft_pack (:90-93, :142-143, :223-224): the spectrum, bins 0..N/2, of the
//   real signal [a | x | 0] of length N along axis 0 of [N, C]. The pack is
//   the first pass's load, so [a | x] is never built. The same load can
//   store the last `keep` rows of [a | x] as a second output: the history of
//   overlap-save and the previous block of the partitioned engines (:102,
//   :155), which then need no copy of their own.
// * irfft_crop (:100-101, :152-153, :213-216, :234): rows [lo, lo + L) of
//   the real inverse transform at N of a half spectrum [N/2+1, C], times
//   1/N, plus an optional addend [L, C] (the Nupols tail's contribution).
//   The Hermitian extension is the first pass's load and the crop the last
//   pass's store.
// * splice (:217-219, and the lookahead lines of delay, matrix4 and
//   matrix4_mb): out[n] = x[n - lo] for lo <= n < lo + Lx, else a[n + shift],
//   n in [0, L): at most three contiguous row ranges of a and x, copied 16
//   bytes a thread where their alignment allows.
//
// The transform is a mixed-radix FFT whose radices (8, 4, 2, 3, 5, 7 and
// larger primes) the plan (ops/fft_conv.py `fft_plan`, computed in Python
// and handed over as an int array) groups into passes, one launch each:
//
// * a block pass of P points (the product of its radices) runs N / P
//   independent sub-transforms a column: sub-transform s reads points
//   s + r N / P, r < P, multiplies point r by W^(r kappa N / (Ns_a P)),
//   kappa = s % Ns_a (Ns_a: the product of the earlier passes' radices), takes
//   their P-point DFT and writes output t to s / Ns_a * Ns_a P + s % Ns_a
//   + t Ns_a. So a plan of one pass is the whole transform of a column and
//   a plan of two the four-step split N = N1 N2 (pass 1: N2 transforms of
//   N1 points; pass 2: the twiddle, then N1 transforms of N2 points), the
//   passes meeting in work[N, C] complex128 slots (none for one pass). One
//   thread block loads T sub-transforms (T P <= 8192 points, 16 bytes
//   each with a gap after every 8: up to 147 KB of dynamic shared memory)
//   once, each point to its digit-reversed place (the plan's table), runs
//   the P-point DFT in place in shared memory
//   as decimation-in-time stages (a butterfly reads and writes the same R
//   points, so a thread holds one butterfly at a time and a stage needs one
//   barrier), and stores once in natural order. Radices 2, 3, 4, 5, 7 and
//   8 are butterflies in registers; a larger prime is a direct R-term sum
//   per output point, each thread holding at most 16 points across the
//   stage's barrier.
// * a global pass is one stage of a prime radix too large for a block
//   (R > 8192): one thread per output point, a direct R-term sum over the
//   previous pass's buffer in device memory (the stage's Stockham form:
//   butterfly j = u Ns + k reads in[j + r N / R] times W^(r k N / (Ns R))
//   and writes output q to u Ns R + k + q Ns).
//
// The first pass's load is the pack, the inner-block read or the Hermitian
// extension; the last pass's store is the half spectrum, the crop with the
// addend, or the float32 crop. Twiddles come from one complex128 table
// W^i = exp(-2 pi i i / N), i < N, per transform size (read through the
// read-only cache, conjugated for the inverse), in place of a sincospi a
// term; a butterfly loads one and takes the others as its powers.
//
// What bounds it on the card: at the main path's sizes (N = 1,176 to 8,192
// in one pass; 131,072 in two, 128 blocks each) a transform moves 0.1-4 MB
// and does 0.1-10 MFLOP of float64, microseconds of work, so one launch, its
// host-side enqueue and the blocks' latency through the stages bound it.
// The design therefore spends launches, not bytes: one launch a transform
// up to N = 8192 (was one per radix, 4-6), two for the four-step sizes, and
// no separate copy for the engines' carried input. A one-pass transform of
// a stereo block runs on one block a column, so only a few SMs work, and
// loading the column and the stages' latency (shared memory, the twiddles'
// loads, a barrier each) set its device time; the real-input half-length
// trick or a thread-block cluster a column is later work.
//
// float32 samples: the resampler's float32 step (dsp_tpu's `_block_df`,
// resample_ops.py:191, whose transforms are the two-float32 Stockham and
// Bluestein DFTs of dfx_fft.py:30 `DfFft` and :123 `DfDft`) runs the same
// float64 transforms with a float32 load and a float32 store:
// * rfft_pack_f32: the pack reads float32 [a | x], or the inner blocks of x
//   in place (column b·ch + c is rows [b Lx, (b+1) Lx) of channel c), into
//   float64;
// * irfft_ola_f32: the inverse with the resampler's overlap-add as its
//   store. Its columns are inner blocks times channels; output point
//   d < N/2 of column b·ch + c is (head of column b) + (tail of column b-1),
//   the tail of the block before the first one being the carried overlap,
//   each times 1/N and then the rate ratio, as the float64 step orders them.
//   With a one-pass plan one thread block per output column transforms
//   column b-1, keeps its tail rounded to float32 (the overlap a block
//   carries, as dsp_tpu's float32 state holds it) in shared memory, then
//   transforms column b and stores y rounded once; the blocks past the
//   last column store the float32 overlap carried out. With more passes the
//   last pass stores the scaled inverse into a work slot and a second
//   kernel does the same overlap-add. So the sums stay float64 from the
//   float32 input to the float32 output, which the two-float32 transforms
//   only approach.
//
// float32 FFT convolution (dsp_tpu runs K5-K7 in complex64 under float32,
// fft_conv.py:97, :144, :220): the engines' steps take rfft_pack_f32 (the
// float32 [a | x] pack and float32 kept rows), irfft_crop_f32 (the crop, and
// the Nupols tail's float32 addend added in float64, stored rounded once)
// and splice_f32; the transforms between stay float64.

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
    kStoreComplex = 0, kStoreRealCrop = 1, kStoreOlaF32 = 2, kStoreRealCropF32 = 3
};

struct Load {
    int mode;
    const double2* c;   // kLoadHermitian: [NB, C]
    long long NB;       // kLoadHermitian: rows of the half spectrum
    const void* a;      // real pack: [La, C], double or float by mode
    long long La;
    const void* x;      // real pack: [blocks * Lx, ch]
    long long Lx;
    int ch;             // real pack: channels; column b * ch + c reads inner block b
    void* kept;         // real pack: the last `keep` rows of [a | x], [keep, C]
    long long keep;
};

struct Store {
    int mode;
    double2* c;         // kStoreComplex: rows [0, rows) of [N, C]
    long long rows;
    double* r;          // kStoreRealCrop: [L, C]
    long long lo, L;
    const double* add;  // kStoreRealCrop: [L, C] or null
    double scale;
    float* y;           // kStoreOlaF32: [C / ch, N / 2, ch]
    float* ov_out;      // kStoreOlaF32: [N / 2, ch]
    const float* ov_in; // kStoreOlaF32: [N / 2, ch]
    double ratio;       // kStoreOlaF32: applied after scale
    int ch;             // kStoreOlaF32: channels; C / ch inner blocks
    float* rf;          // kStoreRealCropF32: [L, C], with lo, L, scale
    const float* addf;  // kStoreRealCropF32: [L, C] or null
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

template <class T>
__device__ __forceinline__ void keep_row(const Load& ld, long long n, int c, int C) {
    const long long k0 = ld.La + ld.Lx - ld.keep;
    if (n >= k0 && n < ld.La + ld.Lx) {
        const T v = n < ld.La ? static_cast<const T*>(ld.a)[n * C + c]
                              : static_cast<const T*>(ld.x)[(n - ld.La) * C + c];
        static_cast<T*>(ld.kept)[(n - k0) * C + c] = v;
    }
}

// Point n of column c of the first pass's input.
__device__ __forceinline__ double2 load_point(const Load& ld, long long n, int c, int C, int N) {
    if (ld.mode == kLoadHermitian) {
        if (n < ld.NB) return ld.c[n * C + c];
        const double2 v = ld.c[(N - n) * C + c];
        return make_double2(v.x, -v.y);
    }
    double v = 0.0;
    const bool f32 = ld.mode == kLoadRealPackF32;
    if (n < ld.La) {
        v = f32 ? real_at<float>(ld.a, n * C + c) : real_at<double>(ld.a, n * C + c);
    } else if (n < ld.La + ld.Lx) {
        const int b = c / ld.ch, cc = c - b * ld.ch;
        const long long i = ((long long)b * ld.Lx + n - ld.La) * ld.ch + cc;
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

__device__ __forceinline__ void store_point(const Store& st, long long d, int c, int C,
                                            double2 v) {
    if (!stored(st, d)) return;
    if (st.mode == kStoreComplex) {
        st.c[d * C + c] = v;
        return;
    }
    const long long o = (d - st.lo) * C + c;
    double y = v.x * st.scale;
    if (st.mode == kStoreRealCrop) {
        if (st.add != nullptr) y += st.add[o];
        st.r[o] = y;
    } else {
        if (st.addf != nullptr) y += (double)st.addf[o];
        st.rf[o] = (float)y;
    }
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

__global__ void __launch_bounds__(kMaxThreads, 1)
fft_block_kernel(Load ld, Store st, Pass ps, const double2* __restrict__ tw, int N, int C,
                 double sign) {
    extern __shared__ double2 buf[];
    const int lanes = (N / ps.P) * C;
    const int l0 = blockIdx.x * ps.T;
    const Tile tl{buf, ps.P, lane_points(ps.P), ps.nsa, min(ps.T, lanes - l0), l0, C, N, sign, tw};
    load_tile(tl, ps, ld);
    run_stages(tl, ps);
    store_tile(tl, ps, st);
}

// The resampler's inverse with its overlap-add, for a plan of one pass:
// block col < C + ch. Column col - ch's tail (or the carried overlap for
// col < ch), times 1/N, then ratio, rounded to float32, goes to `prev`;
// then block col < C stores y at (col / ch, d, col % ch) = head of column
// col + prev, and a block col >= C stores the overlap carried out.
__global__ void __launch_bounds__(kMaxThreads, 1)
fft_ola_f32_kernel(Load ld, Store st, Pass ps, const double2* __restrict__ tw, int N, int C,
                   double sign) {
    extern __shared__ double2 buf[];
    const int stride = lane_points(N);
    float* prev = reinterpret_cast<float*>(buf + stride);
    const int half = N / 2, ch = st.ch, col = blockIdx.x;
    if (col >= ch) {
        const Tile tl{buf, N, stride, 1, 1, col - ch, C, N, sign, tw};
        load_tile(tl, ps, ld);
        run_stages(tl, ps);
        for (int d = threadIdx.x; d < half; d += blockDim.x) {
            prev[d] = (float)((buf[pad(half + d)].x * st.scale) * st.ratio);
        }
    } else {
        for (int d = threadIdx.x; d < half; d += blockDim.x) prev[d] = st.ov_in[(long long)d * ch + col];
    }
    __syncthreads();
    if (col < C) {
        const Tile tl{buf, N, stride, 1, 1, col, C, N, sign, tw};
        load_tile(tl, ps, ld);
        run_stages(tl, ps);
        const long long o = (long long)(col / ch) * half * ch + col % ch;
        for (int d = threadIdx.x; d < half; d += blockDim.x) {
            st.y[o + (long long)d * ch] = (float)((buf[pad(d)].x * st.scale) * st.ratio + (double)prev[d]);
        }
    } else {
        for (int d = threadIdx.x; d < half; d += blockDim.x) {
            st.ov_out[(long long)d * ch + (col - C)] = prev[d];
        }
    }
}

// The overlap-add of fft_ola_f32_kernel over the scaled inverse s [N, C]
// (times 1/N already) that a plan of more passes stored.
__global__ void ola_f32_kernel(const double* __restrict__ s, Store st, int N, int C) {
    const int half = N / 2, ch = st.ch, cols = C + ch;
    const long long total = (long long)half * cols;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const int d = (int)(i / cols), col = (int)(i % cols);
        const double prev = col >= ch
            ? (double)(float)(s[(long long)(half + d) * C + col - ch] * st.ratio)
            : (double)st.ov_in[(long long)d * ch + col];
        if (col < C) {
            const long long o = ((long long)(col / ch) * half + d) * ch + col % ch;
            st.y[o] = (float)(s[(long long)d * C + col] * st.ratio + prev);
        } else {
            st.ov_out[(long long)d * ch + (col - C)] = (float)prev;
        }
    }
}

// A global pass: one stage of radix R (too large for a block) at Ns over
// the whole transform, one thread per output point and column.
__global__ void fft_global_kernel(Load ld, Store st, Pass ps, const double2* __restrict__ tw,
                                  int N, int C, double sign) {
    const int R = ps.P, Ns = ps.nsa, M = N / R;
    const int e_k = N / (Ns * R);
    const long long total = (long long)N * C;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const int d = (int)(i / C), c = (int)(i % C);
        if (ps.first && ld.keep > 0) {
            if (ld.mode == kLoadRealPackF32) keep_row<float>(ld, d, c, C);
            else keep_row<double>(ld, d, c, C);
        }
        if (ps.last && !stored(st, d)) continue;
        const int k = d % Ns;
        const int q = (d / Ns) % R;
        const int j = (d / (Ns * R)) * Ns + k;
        const int e = k * e_k + q * M;  // < N
        double2 acc = ps.first ? load_point(ld, j, c, C, N) : ps.in[(long long)j * C + c];
        int idx = 0;
        for (int r = 1; r < R; ++r) {
            idx += e;
            if (idx >= N) idx -= N;
            const long long n = j + (long long)r * M;
            const double2 v = ps.first ? load_point(ld, n, c, C, N) : ps.in[n * C + c];
            acc = cadd(acc, cmul(v, twiddle(tw, idx, sign)));
        }
        if (ps.last) store_point(st, d, c, C, acc);
        else ps.out[i] = acc;
    }
}

unsigned grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : (blocks < 1 ? 1 : blocks));
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

// All passes of one transform: the first loads through `first`, the last
// stores through `last`, the ones between go through work slots [N, C]
// (slot p % 2 for pass p's output). `tables` is the plan's table
// (ops/fft_conv.py `fft_tables`): the twiddles W^i, i < N, complex128,
// then for each block pass its P digit-reversed positions, int32. With ola,
// the last store is the resampler's overlap-add: fused into the one pass
// of a plan of one, else into work slot min(passes - 1, 2) as the scaled
// real inverse, then ola_f32_kernel.
// The kernels run_fft has launched, every transform together (host side):
// how a caller checks that a transform runs as its plan's passes.
unsigned long long fft_launches = 0;

int run_fft(const int* plan, const void* tables, const Load& first, const Store& last,
            double2* work, int N, int C, double sign, cudaStream_t stream) {
    static unsigned block_smem = 0, ola_smem = 0;
    Plan pl;
    if (tables == nullptr || !parse_plan(plan, N, &pl)) return (int)cudaErrorInvalidValue;
    const double2* tw = static_cast<const double2*>(tables);
    const int* perm = reinterpret_cast<const int*>(tw + N);
    const bool ola = last.mode == kStoreOlaF32;
    const bool ola_fused = ola && pl.n == 1 && pl.kind[0] != kGlobalPass;
    if (ola_fused && (pl.pass[0].T != 1 || pl.smem[0] < lane_points(N) * 16 + (N / 2) * 4)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long nc = (long long)N * C;
    Store fin = last;
    if (ola && !ola_fused) {  // the scaled inverse, then the overlap-add
        fin = Store{kStoreRealCrop, nullptr, 0,
                    reinterpret_cast<double*>(work + (pl.n - 1 < 2 ? pl.n - 1 : 2) * nc), 0, N,
                    nullptr, last.scale};
    }
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < pl.n; ++i) {
        Pass ps = pl.pass[i];
        ps.first = i == 0;
        ps.last = i == pl.n - 1;
        ps.in = i > 0 ? work + ((i - 1) % 2) * nc : nullptr;
        ps.out = i < pl.n - 1 ? work + (i % 2) * nc : nullptr;
        ps.perm = perm;
        if (pl.kind[i] != kGlobalPass) perm += ps.P;
        if (pl.kind[i] == kGlobalPass) {
            fft_global_kernel<<<grid_for(nc), kThreads, 0, stream>>>(first, fin, ps, tw, N, C, sign);
        } else if (ola_fused) {
            err = allow_smem(fft_ola_f32_kernel, &ola_smem);
            if (err != cudaSuccess) return (int)err;
            fft_ola_f32_kernel<<<C + last.ch, pl.threads[i], pl.smem[i], stream>>>(first, fin, ps, tw,
                                                                                   N, C, sign);
        } else {
            err = allow_smem(fft_block_kernel, &block_smem);
            if (err != cudaSuccess) return (int)err;
            const long long blocks = ((long long)(N / ps.P) * C + ps.T - 1) / ps.T;
            fft_block_kernel<<<(unsigned)blocks, pl.threads[i], pl.smem[i], stream>>>(
                first, fin, ps, tw, N, C, sign);
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        ++fft_launches;
    }
    if (ola && !ola_fused) {
        ola_f32_kernel<<<grid_for((long long)(N / 2) * (C + last.ch)), kThreads, 0, stream>>>(
            fin.r, last, N, C);
        err = cudaGetLastError();
        if (err == cudaSuccess) ++fft_launches;
    }
    return (int)err;
}

bool shape_ok(int N, int C) { return N > 0 && C > 0 && (long long)N * C < (1LL << 31); }

int rfft_pack(int mode, const int* plan, const void* tables, const void* a, long long La,
              const void* x, long long Lx, int blocks, void* kept, long long keep, void* X,
              void* work, int N, int C, void* stream) {
    if (!shape_ok(N, C) || La < 0 || Lx < 0 || La + Lx > N || blocks < 1 || C % blocks ||
        keep < 0 || keep > La + Lx || (blocks > 1 && (La > 0 || keep > 0)) ||
        (keep > 0 && kept == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const Load first{mode, nullptr, 0, a, La, x, Lx, C / blocks, kept, keep};
    const Store last{kStoreComplex, static_cast<double2*>(X), N / 2 + 1};
    return run_fft(plan, tables, first, last, static_cast<double2*>(work),
                   N, C, 1.0, static_cast<cudaStream_t>(stream));
}

int irfft_crop(bool f32, const int* plan, const void* tables, const void* Y, void* work, void* out,
               long long lo, long long L, const void* add, int N, int C, void* stream) {
    if (!shape_ok(N, C) || L <= 0 || lo < 0 || lo + L > N) return (int)cudaErrorInvalidValue;
    const Load first{kLoadHermitian, static_cast<const double2*>(Y), N / 2 + 1};
    Store last{f32 ? kStoreRealCropF32 : kStoreRealCrop, nullptr, 0, nullptr, lo, L, nullptr,
               1.0 / N};
    if (f32) {
        last.rf = static_cast<float*>(out);
        last.addf = static_cast<const float*>(add);
    } else {
        last.r = static_cast<double*>(out);
        last.add = static_cast<const double*>(add);
    }
    return run_fft(plan, tables, first, last, static_cast<double2*>(work),
                   N, C, -1.0, static_cast<cudaStream_t>(stream));
}

}  // namespace

// X[N/2+1, C] = rfft([a | x | 0], n = N) along axis 0 by the plan `plan`
// with its table `tables` on the card (ops/fft_conv.py fft_tables(N)). a is [La, C] (may be empty), x
// is [blocks * Lx, C / blocks] (blocks > 1: column b * (C / blocks) + c is
// inner block b of channel c, and a is empty), La + Lx <= N. With keep > 0
// the last keep rows of [a | x] are stored in kept [keep, C]. work holds
// the plan's complex [N, C] slots (none for one pass). Returns a CUDA
// error code (0 on success). The caller checks shapes, dtypes and
// contiguity.
extern "C" int dsp_rfft_pack_c128(const int* plan, const void* tables, const void* a, long long La,
                                  const void* x, long long Lx, int blocks, void* kept,
                                  long long keep, void* X, void* work, int N, int C,
                                  void* stream) {
    return rfft_pack(kLoadRealPack, plan, tables, a, La, x, Lx, blocks, kept, keep, X, work, N, C,
                     stream);
}

// rfft_pack on float32 a and x (and kept): the spectrum is complex128.
extern "C" int dsp_rfft_pack_f32(const int* plan, const void* tables, const void* a, long long La,
                                 const void* x, long long Lx, int blocks, void* kept,
                                 long long keep, void* X, void* work, int N, int C,
                                 void* stream) {
    return rfft_pack(kLoadRealPackF32, plan, tables, a, La, x, Lx, blocks, kept, keep, X, work, N, C,
                     stream);
}

// out[L, C] = irfft(Y, n = N)[lo : lo + L] (+ add[L, C] when add is not
// null) along axis 0; Y is [N/2+1, C], 0 <= lo, lo + L <= N.
extern "C" int dsp_irfft_crop_c128(const int* plan, const void* tables, const void* Y, void* work,
                                   void* out, long long lo, long long L, const void* add, int N,
                                   int C, void* stream) {
    return irfft_crop(false, plan, tables, Y, work, out, lo, L, add, N, C, stream);
}

// irfft_crop with a float32 out and add: the inverse in float64, each
// point rounded once on its store.
extern "C" int dsp_irfft_crop_f32(const int* plan, const void* tables, const void* Y, void* work,
                                  void* out, long long lo, long long L, const void* add, int N,
                                  int C, void* stream) {
    return irfft_crop(true, plan, tables, Y, work, out, lo, L, add, N, C, stream);
}

// The resampler's inverse and overlap-add in float32 out: Y [N/2+1, C]
// half spectra, C = blocks * ch columns (block-major); y [blocks, N/2, ch],
// ov_out and ov_in [N/2, ch] float32; every value times 1/N, then ratio.
// work holds the plan's slots, plus one for a plan of more than one pass.
extern "C" int dsp_irfft_ola_f32(const int* plan, const void* tables, const void* Y, void* work,
                                 void* y, void* ov_out, const void* ov_in, double ratio, int N,
                                 int C, int ch, void* stream) {
    if (!shape_ok(N, C) || N % 2 || ch <= 0 || C % ch) return (int)cudaErrorInvalidValue;
    const Load first{kLoadHermitian, static_cast<const double2*>(Y), N / 2 + 1};
    Store last{kStoreOlaF32, nullptr, 0, nullptr, 0, 0, nullptr, 1.0 / N};
    last.y = static_cast<float*>(y);
    last.ov_out = static_cast<float*>(ov_out);
    last.ov_in = static_cast<const float*>(ov_in);
    last.ratio = ratio;
    last.ch = ch;
    return run_fft(plan, tables, first, last, static_cast<double2*>(work),
                   N, C, -1.0, static_cast<cudaStream_t>(stream));
}

namespace {

// out = three byte ranges laid end to end: [0, e0) from s0, [e0, e1) from
// s1, [e1, total) from s2, copied W bytes a thread (every range start and
// end a multiple of W).
template <class W>
__global__ void copy3_kernel(const char* __restrict__ s0, const char* __restrict__ s1,
                             const char* __restrict__ s2, long long e0, long long e1,
                             char* __restrict__ out, long long total) {
    const long long n = total / (long long)sizeof(W);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const long long o = i * (long long)sizeof(W);
        const char* src = o < e0 ? s0 + o : (o < e1 ? s1 + (o - e0) : s2 + (o - e1));
        *reinterpret_cast<W*>(out + o) = *reinterpret_cast<const W*>(src);
    }
}

int splice(int elem, const void* a, const void* x, void* out, long long L, long long Lx,
           long long lo, long long shift, int C, void* stream) {
    if (L <= 0 || C <= 0 || Lx < 0) return (int)cudaErrorInvalidValue;
    // out rows [0, lo_c) from a, [lo_c, hi_c) from x, [hi_c, L) from a
    const long long lo_c = lo < 0 ? 0 : (lo > L ? L : lo);
    const long long hi_end = lo + Lx;
    const long long hi_c = hi_end < 0 ? 0 : (hi_end > L ? L : hi_end);
    const long long row = (long long)C * elem;
    const char* s0 = static_cast<const char*>(a) + shift * row;
    const char* s1 = static_cast<const char*>(x) + (lo_c - lo) * row;
    const char* s2 = static_cast<const char*>(a) + (hi_c + shift) * row;
    const long long e0 = lo_c * row, e1 = hi_c * row, total = L * row;
    // the widest copy that every start and end allows
    unsigned long long bits = (unsigned long long)e0 | (unsigned long long)e1 |
                              (unsigned long long)total | (unsigned long long)out;
    if (e0 > 0) bits |= (unsigned long long)s0;
    if (e1 > e0) bits |= (unsigned long long)s1;
    if (total > e1) bits |= (unsigned long long)s2;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    char* o = static_cast<char*>(out);
    if (bits % 16 == 0) {
        copy3_kernel<int4><<<grid_for(total / 16), kThreads, 0, st>>>(s0, s1, s2, e0, e1, o, total);
    } else if (bits % 8 == 0) {
        copy3_kernel<long long><<<grid_for(total / 8), kThreads, 0, st>>>(s0, s1, s2, e0, e1, o, total);
    } else if (bits % 4 == 0) {
        copy3_kernel<int><<<grid_for(total / 4), kThreads, 0, st>>>(s0, s1, s2, e0, e1, o, total);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The kernels the transforms have launched so far, on the calling process.
extern "C" unsigned long long dsp_fft_launches() { return fft_launches; }

// out[n, c] = x[n - lo, c] for lo <= n < lo + Lx, else a[n + shift, c];
// n in [0, L). Every row read lies inside its tensor (the caller checks).
extern "C" int dsp_splice_f64(const void* a, const void* x, void* out, long long L, long long Lx,
                              long long lo, long long shift, int C, void* stream) {
    return splice(8, a, x, out, L, Lx, lo, shift, C, stream);
}

// The same on float32.
extern "C" int dsp_splice_f32(const void* a, const void* x, void* out, long long L, long long Lx,
                              long long lo, long long shift, int C, void* stream) {
    return splice(4, a, x, out, L, Lx, lo, shift, C, stream);
}
