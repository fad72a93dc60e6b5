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
// The transform is a mixed-radix FFT (its passes in fft_pass.cuh, which
// csrc/resample.cu shares) whose radices (8, 4, 2, 3, 5, 7 and larger
// primes) the plan (ops/fft_conv.py `fft_plan`, computed in Python
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
// * irfft_ola (float64 samples): the same overlap-add store with float64
//   y and overlap, each product and sum rounded on its own as the float64
//   step's torch ops round them. The resampler takes these three
//   transforms' wrappers only where its plans do not fit its one-launch
//   step (csrc/resample.cu), which runs the same passes (fft_pass.cuh).
//
// float32 FFT convolution (dsp_tpu runs K5-K7 in complex64 under float32,
// fft_conv.py:97, :144, :220): the engines' steps take rfft_pack_f32 (the
// float32 [a | x] pack and float32 kept rows), irfft_crop_f32 (the crop, and
// the Nupols tail's float32 addend added in float64, stored rounded once)
// and splice_f32; the transforms between stay float64.
//
// The stream axis (split and batched processing): S streams of C channels
// are one transform of S·C columns, the streams' tensors grouped
// (fft_pass.cuh `grouped`: column s·C + c is column c of stream s's rows):
// rfft_pack reads a [S, La, C] and x [S, Lx, C], stores the kept rows
// [S, keep, C] and X [S, N/2+1, C]; irfft_crop reads Y [S, N/2+1, C] and
// the addend [S, L, C] and stores [S, L, C]; splice copies each stream's
// three row ranges. The resampler's inverse with its overlap-add takes S
// streams of nb inner blocks: stream s's first block adds the carried
// overlap ov_in[s], and ov_out[s] is its last block's tail. Each column
// runs the passes of a one-stream call: the same bits, in one launch a
// pass.

#include "fft_pass.cuh"

namespace {

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

// The column whose tail output column q of the overlap-add takes (-1: the
// carried overlap of stream *s, channel *cc): q < C is column q, block
// (q / ch) % nb of stream (q / ch) / nb, whose predecessor is column q - ch
// but for a stream's first block; q >= C stores stream (q - C) / ch's
// overlap carried out, the tail of its last block.
__device__ __forceinline__ int ola_source(int q, int C, int ch, int nb, int* s, int* cc) {
    if (q < C) {
        const int g = q / ch;
        *s = g / nb;
        *cc = q - g * ch;
        return g % nb ? q - ch : -1;
    }
    const int j = q - C;
    *s = j / ch;
    *cc = j - *s * ch;
    return ((*s + 1) * nb - 1) * ch + *cc;
}

// The resampler's inverse with its overlap-add, for a plan of one pass, in
// the sample type T (float: irfft_ola_f32; double: irfft_ola): block
// q < C + S ch (S streams of nb inner blocks). The tail of the column
// ola_source names (or the stream's carried overlap), times 1/N, then
// ratio, rounded to T (ola_tail), goes to `prev`; then block q < C stores
// y at (q / ch, d, q % ch) = head of column q + prev (ola_out), and a block
// q >= C stores its stream's overlap carried out.
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
fft_ola_kernel(Load ld, Store st, Pass ps, const double2* __restrict__ tw, int N, int C,
               double sign) {
    extern __shared__ double2 buf[];
    const int stride = lane_points(N);
    T* prev = reinterpret_cast<T*>(buf + stride);
    const int half = N / 2, ch = st.ch, col = blockIdx.x;
    int s, cc;
    const int src = ola_source(col, C, ch, st.nb, &s, &cc);
    if (src >= 0) {
        const Tile tl{buf, N, stride, 1, 1, src, C, N, sign, tw};
        load_tile(tl, ps, ld);
        run_stages(tl, ps);
        for (int d = threadIdx.x; d < half; d += blockDim.x) {
            prev[d] = ola_tail<T>(buf[pad(half + d)].x, st.scale, st.ratio);
        }
    } else {
        const T* ov_in = static_cast<const T*>(st.ov_in) + (long long)s * half * ch;
        for (int d = threadIdx.x; d < half; d += blockDim.x) prev[d] = ov_in[(long long)d * ch + cc];
    }
    __syncthreads();
    if (col < C) {
        const Tile tl{buf, N, stride, 1, 1, col, C, N, sign, tw};
        load_tile(tl, ps, ld);
        run_stages(tl, ps);
        const long long o = (long long)(col / ch) * half * ch + col % ch;
        T* y = static_cast<T*>(st.y);
        for (int d = threadIdx.x; d < half; d += blockDim.x) {
            y[o + (long long)d * ch] = ola_out(buf[pad(d)].x, st.scale, st.ratio, prev[d]);
        }
    } else {
        T* ov_out = static_cast<T*>(st.ov_out) + (long long)s * half * ch;
        for (int d = threadIdx.x; d < half; d += blockDim.x) ov_out[(long long)d * ch + cc] = prev[d];
    }
}

// The overlap-add of fft_ola_kernel over the scaled inverse s [N, C]
// (times 1/N already) that a plan of more passes stored: each tail times
// ratio rounded to T, then y as the torch ops of the float64 step's plain
// version order it (float64: each product and sum rounded on its own) or as
// irfft_ola_f32 has always stored it (float32: rounded once).
template <class T>
__global__ void ola_kernel(const double* __restrict__ s, Store st, int N, int C) {
    const int half = N / 2, ch = st.ch, cols = C + C / st.nb;
    const long long total = (long long)half * cols;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const T* ov_in = static_cast<const T*>(st.ov_in);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const int d = (int)(i / cols), col = (int)(i % cols);
        int sm, cc;
        const int src = ola_source(col, C, ch, st.nb, &sm, &cc);
        const T prev = src >= 0 ? (T)__dmul_rn(s[(long long)(half + d) * C + src], st.ratio)
                                : ov_in[((long long)sm * half + d) * ch + cc];
        if (col < C) {
            const long long o = ((long long)(col / ch) * half + d) * ch + col % ch;
            const double h = s[(long long)d * C + col];
            if constexpr (sizeof(T) == sizeof(float)) {
                static_cast<float*>(st.y)[o] = (float)(h * st.ratio + (double)prev);
            } else {
                static_cast<double*>(st.y)[o] = __dadd_rn(__dmul_rn(h, st.ratio), prev);
            }
        } else {
            static_cast<T*>(st.ov_out)[((long long)sm * half + d) * ch + cc] = prev;
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


// All passes of one transform: the first loads through `first`, the last
// stores through `last`, the ones between go through work slots [N, C]
// (slot p % 2 for pass p's output). `tables` is the plan's table
// (ops/fft_conv.py `fft_tables`): the twiddles W^i, i < N, complex128,
// then for each block pass its P digit-reversed positions, int32. With ola
// (kStoreOlaF32, kStoreOlaF64), the last store is the resampler's
// overlap-add: fused into the one pass of a plan of one, else into work
// slot min(passes - 1, 2) as the scaled real inverse, then ola_kernel.
// The kernels run_fft has launched, every transform together (host side):
// how a caller checks that a transform runs as its plan's passes.
unsigned long long fft_launches = 0;

int run_fft(const int* plan, const void* tables, const Load& first, const Store& last,
            double2* work, int N, int C, double sign, cudaStream_t stream) {
    static unsigned block_smem = 0, ola_smem[2] = {0, 0};
    Plan pl;
    if (tables == nullptr || !parse_plan(plan, N, &pl)) return (int)cudaErrorInvalidValue;
    const double2* tw = static_cast<const double2*>(tables);
    const int* perm = reinterpret_cast<const int*>(tw + N);
    const bool ola = last.mode == kStoreOlaF32 || last.mode == kStoreOlaF64;
    const bool f64 = last.mode == kStoreOlaF64;
    const bool ola_fused = ola && pl.n == 1 && pl.kind[0] != kGlobalPass;
    // the fused overlap-add keeps the tail in the sample type beside the lane
    const int ola_smem_bytes = lane_points(N) * 16 + (N / 2) * (f64 ? 8 : 4);
    if (ola_fused && (pl.pass[0].T != 1 || ola_smem_bytes > kSmemLimit)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long nc = (long long)N * C;
    const int ola_cols = ola ? C + C / last.nb : 0;  // the columns and the overlaps carried out
    Store fin = last;
    if (ola && !ola_fused) {  // the scaled inverse, then the overlap-add
        fin = Store{kStoreRealCrop, nullptr, 0,
                    reinterpret_cast<double*>(work + (pl.n - 1 < 2 ? pl.n - 1 : 2) * nc), 0, N,
                    nullptr, last.scale};
        fin.ch = C;
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
            const auto kernel = f64 ? fft_ola_kernel<double> : fft_ola_kernel<float>;
            err = allow_smem(kernel, &ola_smem[f64]);
            if (err != cudaSuccess) return (int)err;
            kernel<<<ola_cols, pl.threads[i], ola_smem_bytes, stream>>>(first, fin, ps, tw, N, C,
                                                                         sign);
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
        const auto kernel = f64 ? ola_kernel<double> : ola_kernel<float>;
        kernel<<<grid_for((long long)(N / 2) * ola_cols), kThreads, 0, stream>>>(fin.r, last, N,
                                                                                C);
        err = cudaGetLastError();
        if (err == cudaSuccess) ++fft_launches;
    }
    return (int)err;
}

bool shape_ok(int N, int C) { return N > 0 && C > 0 && (long long)N * C < (1LL << 31); }

int rfft_pack(int mode, const int* plan, const void* tables, const void* a, long long La,
              const void* x, long long Lx, int blocks, void* kept, long long keep, void* X,
              void* work, int N, int C, int grouped_out, void* stream) {
    if (!shape_ok(N, C) || La < 0 || Lx < 0 || La + Lx > N || blocks < 1 || C % blocks ||
        keep < 0 || keep > La + Lx || (keep > 0 && kept == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const Load first{mode, nullptr, 0, a, La, x, Lx, C / blocks, kept, keep};
    Store last{kStoreComplex, static_cast<double2*>(X), N / 2 + 1};
    last.ch = grouped_out ? C / blocks : C;
    return run_fft(plan, tables, first, last, static_cast<double2*>(work),
                   N, C, 1.0, static_cast<cudaStream_t>(stream));
}

int irfft_crop(bool f32, const int* plan, const void* tables, const void* Y, void* work, void* out,
               long long lo, long long L, const void* add, int N, int C, int ch, void* stream) {
    if (!shape_ok(N, C) || L <= 0 || lo < 0 || lo + L > N || ch <= 0 || C % ch) {
        return (int)cudaErrorInvalidValue;
    }
    Load first{kLoadHermitian, static_cast<const double2*>(Y), N / 2 + 1};
    first.ch = ch;
    Store last{f32 ? kStoreRealCropF32 : kStoreRealCrop, nullptr, 0, nullptr, lo, L, nullptr,
               1.0 / N};
    last.ch = ch;
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
// with its table `tables` on the card (ops/fft_conv.py fft_tables(N)), in
// `blocks` groups of C / blocks columns (inner blocks, or streams): a is
// [blocks, La, C / blocks] (may be empty), x [blocks, Lx, C / blocks]
// (column b * (C / blocks) + c is channel c of group b), La + Lx <= N.
// With keep > 0 the last keep rows of [a | x] are stored in kept
// [blocks, keep, C / blocks]. X is [N/2+1, C], or with grouped_out
// [blocks, N/2+1, C / blocks]. work holds the plan's complex [N, C] slots
// (none for one pass). Returns a CUDA error code (0 on success). The
// caller checks shapes, dtypes and contiguity.
extern "C" int dsp_rfft_pack_c128(const int* plan, const void* tables, const void* a, long long La,
                                  const void* x, long long Lx, int blocks, void* kept,
                                  long long keep, void* X, void* work, int N, int C,
                                  int grouped_out, void* stream) {
    return rfft_pack(kLoadRealPack, plan, tables, a, La, x, Lx, blocks, kept, keep, X, work, N, C,
                     grouped_out, stream);
}

// rfft_pack on float32 a and x (and kept): the spectrum is complex128.
extern "C" int dsp_rfft_pack_f32(const int* plan, const void* tables, const void* a, long long La,
                                 const void* x, long long Lx, int blocks, void* kept,
                                 long long keep, void* X, void* work, int N, int C,
                                 int grouped_out, void* stream) {
    return rfft_pack(kLoadRealPackF32, plan, tables, a, La, x, Lx, blocks, kept, keep, X, work, N, C,
                     grouped_out, stream);
}

// out[L, C] = irfft(Y, n = N)[lo : lo + L] (+ add[L, C] when add is not
// null) along axis 0; Y is [N/2+1, C], 0 <= lo, lo + L <= N; all three in
// groups of ch columns (streams): Y [C / ch, N/2+1, ch], out and add
// [C / ch, L, ch].
extern "C" int dsp_irfft_crop_c128(const int* plan, const void* tables, const void* Y, void* work,
                                   void* out, long long lo, long long L, const void* add, int N,
                                   int C, int ch, void* stream) {
    return irfft_crop(false, plan, tables, Y, work, out, lo, L, add, N, C, ch, stream);
}

// irfft_crop with a float32 out and add: the inverse in float64, each
// point rounded once on its store.
extern "C" int dsp_irfft_crop_f32(const int* plan, const void* tables, const void* Y, void* work,
                                  void* out, long long lo, long long L, const void* add, int N,
                                  int C, int ch, void* stream) {
    return irfft_crop(true, plan, tables, Y, work, out, lo, L, add, N, C, ch, stream);
}

namespace {

int irfft_ola(int mode, const int* plan, const void* tables, const void* Y, void* work, void* y,
              void* ov_out, const void* ov_in, double ratio, int N, int C, int ch, int nb,
              void* stream) {
    if (!shape_ok(N, C) || N % 2 || ch <= 0 || nb <= 0 || C % ((long long)ch * nb)) {
        return (int)cudaErrorInvalidValue;
    }
    Load first{kLoadHermitian, static_cast<const double2*>(Y), N / 2 + 1};
    first.ch = C;
    Store last{mode, nullptr, 0, nullptr, 0, 0, nullptr, 1.0 / N};
    last.y = y;
    last.ov_out = ov_out;
    last.ov_in = ov_in;
    last.ratio = ratio;
    last.ch = ch;
    last.nb = nb;
    return run_fft(plan, tables, first, last, static_cast<double2*>(work),
                   N, C, -1.0, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The resampler's inverse and overlap-add in float32 out: Y [N/2+1, C]
// half spectra, C = blocks * ch columns (block-major): S = blocks / nb
// streams of nb inner blocks; y [blocks, N/2, ch], ov_out and ov_in
// [S, N/2, ch] float32 (stream s's first block adds ov_in[s]); every value
// times 1/N, then ratio. work holds the plan's slots, plus one for a plan
// of more than one pass.
extern "C" int dsp_irfft_ola_f32(const int* plan, const void* tables, const void* Y, void* work,
                                 void* y, void* ov_out, const void* ov_in, double ratio, int N,
                                 int C, int ch, int nb, void* stream) {
    return irfft_ola(kStoreOlaF32, plan, tables, Y, work, y, ov_out, ov_in, ratio, N, C, ch, nb,
                     stream);
}

// The same with float64 y, ov_out and ov_in: the float64 resampler step's
// inverse and overlap-add where its plans take more than one launch
// (ops/resample_ops.py `irfft_ola`).
extern "C" int dsp_irfft_ola_f64(const int* plan, const void* tables, const void* Y, void* work,
                                 void* y, void* ov_out, const void* ov_in, double ratio, int N,
                                 int C, int ch, int nb, void* stream) {
    return irfft_ola(kStoreOlaF64, plan, tables, Y, work, y, ov_out, ov_in, ratio, N, C, ch, nb,
                     stream);
}

namespace {

// out = three byte ranges laid end to end: [0, e0) from s0, [e0, e1) from
// s1, [e1, total) from s2, copied W bytes a thread (every range start and
// end a multiple of W); S streams: stream s's out `total` bytes after the
// one before's, its s0 and s2 `sa` after, its s1 `sx` after.
template <class W>
__global__ void copy3_kernel(const char* __restrict__ s0, const char* __restrict__ s1,
                             const char* __restrict__ s2, long long e0, long long e1,
                             char* __restrict__ out, long long total, int S, long long sa,
                             long long sx) {
    const long long per = total / (long long)sizeof(W), n = per * S;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const long long s = S == 1 ? 0 : i / per;
        const long long o = (i - s * per) * (long long)sizeof(W);
        const char* src = o < e0 ? s0 + s * sa + o
                                 : (o < e1 ? s1 + s * sx + (o - e0) : s2 + s * sa + (o - e1));
        *reinterpret_cast<W*>(out + s * total + o) = *reinterpret_cast<const W*>(src);
    }
}

int splice(int elem, const void* a, const void* x, void* out, long long L, long long Lx,
           long long lo, long long shift, int C, int S, long long La, void* stream) {
    if (L <= 0 || C <= 0 || Lx < 0 || S <= 0 || La < 0) return (int)cudaErrorInvalidValue;
    // out rows [0, lo_c) from a, [lo_c, hi_c) from x, [hi_c, L) from a
    const long long lo_c = lo < 0 ? 0 : (lo > L ? L : lo);
    const long long hi_end = lo + Lx;
    const long long hi_c = hi_end < 0 ? 0 : (hi_end > L ? L : hi_end);
    const long long row = (long long)C * elem;
    const char* s0 = static_cast<const char*>(a) + shift * row;
    const char* s1 = static_cast<const char*>(x) + (lo_c - lo) * row;
    const char* s2 = static_cast<const char*>(a) + (hi_c + shift) * row;
    const long long e0 = lo_c * row, e1 = hi_c * row, total = L * row;
    const long long sa = La * row, sx = Lx * row;  // a stream's a and x, in bytes
    // the widest copy that every start and end allows
    unsigned long long bits = (unsigned long long)e0 | (unsigned long long)e1 |
                              (unsigned long long)total | (unsigned long long)out;
    if (S > 1) bits |= (unsigned long long)sa | (unsigned long long)sx;
    if (e0 > 0) bits |= (unsigned long long)s0;
    if (e1 > e0) bits |= (unsigned long long)s1;
    if (total > e1) bits |= (unsigned long long)s2;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    char* o = static_cast<char*>(out);
    const long long all = total * S;
    if (bits % 16 == 0) {
        copy3_kernel<int4><<<grid_for(all / 16), kThreads, 0, st>>>(s0, s1, s2, e0, e1, o, total,
                                                                    S, sa, sx);
    } else if (bits % 8 == 0) {
        copy3_kernel<long long><<<grid_for(all / 8), kThreads, 0, st>>>(s0, s1, s2, e0, e1, o,
                                                                         total, S, sa, sx);
    } else if (bits % 4 == 0) {
        copy3_kernel<int><<<grid_for(all / 4), kThreads, 0, st>>>(s0, s1, s2, e0, e1, o, total, S,
                                                                  sa, sx);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The kernels the transforms have launched so far, on the calling process.
extern "C" unsigned long long dsp_fft_launches() { return fft_launches; }

// out[n, c] = x[n - lo, c] for lo <= n < lo + Lx, else a[n + shift, c];
// n in [0, L), for each of S streams (a [S, La, C], x [S, Lx, C], out
// [S, L, C]). Every row read lies inside its tensor (the caller checks).
extern "C" int dsp_splice_f64(const void* a, const void* x, void* out, long long L, long long Lx,
                              long long lo, long long shift, int C, int S, long long La,
                              void* stream) {
    return splice(8, a, x, out, L, Lx, lo, shift, C, S, La, stream);
}

// The same on float32.
extern "C" int dsp_splice_f32(const void* a, const void* x, void* out, long long L, long long Lx,
                              long long lo, long long shift, int C, int S, long long La,
                              void* stream) {
    return splice(4, a, x, out, L, Lx, lo, shift, C, S, La, stream);
}
