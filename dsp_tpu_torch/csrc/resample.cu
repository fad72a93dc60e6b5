// K8: the rational resampler's step, float64 and float32 samples, for Hopper
// (sm_90a).
//
// Replaces dsp_tpu/ops/resample_ops.py:144 `SpectralResampler.block` and its
// float32 form `_block_df` (:191): every inner block of a chain block goes
// through the forward transform at 2·in_len (zero-padded), the spectral fold
// (the gather of the input spectrum by the index walk's input bins, the two
// conj masks, the product with the prototype filter's spectrum and the
// segment sum into the out_len + 1 output bins), the inverse transform at
// 2·out_len, the scale by 1/N and the rate ratio, and the 50% overlap-add
// with the block before (the carried overlap for the first).
//
//   Y[l, c] = sum_{e in bin l} conj^c2( conj^c1( X[j_e, c] ) * s_e )
//
// The walk's output bin is not monotone (it bounces between bins 0 and
// out_len), so the host inverts it into a per-bin list (CSR) in table
// order: one thread per bin sums its entries in that order, with no
// atomics, so the result does not depend on the launch. The products and
// sums are written out with __dmul_rn / __dadd_rn / __dsub_rn, as
// (ac - bd) + (ad + bc)i: nvcc contracts nothing into an FMA, so each entry
// rounds as a plain complex product does (fold_bin).
//
// Two kernels:
//
// * resample_step_kernel, the step in one launch wherever both transforms
//   are one pass of csrc/fft_conv.cu's plan and fit one block's shared
//   memory (every rate pair the repo uses; ops/resample_ops.py decides
//   when the resampler is built). Thread block (g, c) owns output columns
//   b = g m .. g m + m - 1 of channel c, one lane each (m = 1 until the
//   columns outnumber the card's SMs, then as many as fill them once): it
//   loads inner block b of x in place into its forward transform's
//   digit-reversed positions (as rfft_pack loads it), runs the forward
//   pass, folds the spectrum from shared memory straight into the
//   inverse's digit-reversed load positions with the Hermitian extension
//   (as irfft_crop's load places it), runs the inverse pass and stores
//   y = head_b + tail_(b-1), each times 1/N and then the ratio
//   (fft_pass.cuh's ola_tail and ola_out); the last column's tail is the
//   overlap carried out. So the spectra never reach device memory and the
//   step is one launch where it was three (and five torch ops in float64).
//   The passes, their order, the twiddles and the fold's products are
//   those of the three launches it replaces, so y and the overlap equal
//   theirs bit for bit.
//   The tail hand-off: within a block, lane t takes lane t - 1's tail. The
//   blocks of a channel run in clusters of kMaxCluster along g (fewer
//   where the channel has fewer blocks); each writes its last lane's scaled
//   tail into its successor's shared memory (distributed shared memory),
//   then the cluster synchronises once. The first block of every cluster
//   but the first transforms its predecessor's column itself first; column
//   0 takes the carried overlap.
// * resample_fold_kernel, the fold alone on spectra in device memory, for
//   the route of three launches (rfft_pack, this, irfft_ola: plans of more
//   than one pass, e.g. a ratio with a prime above 8192).
//
// The stream axis (split and batched processing): x [S, n in_len, C], the
// overlaps [S, out_len, C] and y [S, n out_len, C]. The grid's second
// dimension runs the S·C (stream, channel) pairs; the clusters lie along
// the first, so a cluster's blocks and their tail hand-off never leave one
// stream's channel, and the first inner block of stream s takes stream s's
// carried overlap, never another stream's last tail. m, the inner blocks a
// thread block carries, is chosen on the S·C·n columns. Each column runs
// the passes of a one-stream call: the same bits.
//
// What bounds it on the card: a step at the main path's shapes (48 kHz,
// 4 inner blocks of 588 frames, stereo: 8 columns of 1,176 and 1,280-point
// transforms) reads 38 KB and writes 41 KB, and does ~1 MFLOP of float64:
// under a microsecond of either. The launch and each column's chain of
// dependent stages (a load, four stages, the fold, four stages, a store,
// each behind a barrier) on one block bound it, so the design spends one
// launch and keeps everything between in shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_pass.cuh"

namespace cg = cooperative_groups;

// The resampler's constants, made once by the host (ops/resample_ops.py
// `SpectralResampler`, as kernels.ResampleStepCfg) and handed over by
// address every call; outside the unnamed namespace, as the exported entry
// takes it.
struct ResampleStepCfg {
    const int* plan_f;      // host: fft_plan(2 in_len, 1)'s int array
    const int* plan_i;      // host: fft_plan(2 out_len, 1)'s
    const void* tables_f;   // device: fft_tables(2 in_len)
    const void* tables_i;   // device: fft_tables(2 out_len)
    const int* ptr;         // device: the fold's CSR tables
    const int* j;
    const int* flags;
    const void* s;
    double ratio;
    int in_len, out_len;
};

namespace {

constexpr int kFoldThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size

// Bin l of the fold from the spectrum X(j), j in [0, in_len].
template <class Get>
__device__ __forceinline__ double2 fold_bin(const int* __restrict__ ptr, const int* __restrict__ j,
                                            const int* __restrict__ flags,
                                            const double2* __restrict__ s, int l, Get X) {
    double2 acc = make_double2(0.0, 0.0);
    for (int e = ptr[l]; e < ptr[l + 1]; ++e) {
        double2 x = X(j[e]);
        const int f = flags[e];
        if (f & 1) x.y = -x.y;
        const double2 w = s[e];
        double2 v = make_double2(__dsub_rn(__dmul_rn(x.x, w.x), __dmul_rn(x.y, w.y)),
                                 __dadd_rn(__dmul_rn(x.x, w.y), __dmul_rn(x.y, w.x)));
        if (f & 2) v.y = -v.y;
        acc.x = __dadd_rn(acc.x, v.x);
        acc.y = __dadd_rn(acc.y, v.y);
    }
    return acc;
}

__global__ void resample_fold_kernel(const double2* __restrict__ X, double2* __restrict__ Y,
                                     const int* __restrict__ ptr, const int* __restrict__ j,
                                     const int* __restrict__ flags,
                                     const double2* __restrict__ s, int n_out, int ncol) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)n_out * ncol) return;
    const int l = (int)(i / ncol);
    const int c = (int)(i % ncol);
    Y[i] = fold_bin(ptr, j, flags, s, l, [&](int jj) { return X[(long long)jj * ncol + c]; });
}

// What the step's blocks share: the one pass of each plan, the fold's CSR
// tables, the tensors and the shape.
struct StepArgs {
    Pass fwd, inv;              // fwd: with its digit-reversed positions
    const double2* tw_f;        // the forward's twiddles W^i, i < 2 in_len
    const double2* tw_i;        // the inverse's, i < 2 out_len
    const int* perm_i;          // the inverse's digit-reversed positions
    const int* ptr;             // the fold: CSR of out_len + 2 offsets
    const int* j;
    const int* flags;
    const double2* s;
    const void* x;              // [S, n in_len, C]
    void* y;                    // [S, n out_len, C]
    void* ov_out;               // [S, out_len, C]
    const void* ov_in;          // [S, out_len, C]
    double scale, ratio;        // 1 / (2 out_len), out_len / in_len
    int in_len, out_len, n;
    int C;                      // channels a stream (gridDim.y = S C)
    int m;                      // inner blocks (lanes) a thread block
    int cluster;                // thread blocks a cluster
};

// Inner blocks b0 .. b0 + lanes - 1 of channel c of x (a stream's
// [n in_len, C]), lane t for b0 + t: each
// loaded in place, zero-padded, to its forward transform's digit-reversed
// positions in bufF (rfft_pack's inner-block read), the forward pass, the
// fold into the inverse's load positions in bufI with the Hermitian
// extension (irfft_crop's load), the inverse pass: point d of lane t at
// bufI[t lane_points(2 out_len) + pad(d)]. Each lane's arithmetic is that
// of a transform alone.
template <class T>
__device__ __forceinline__ void columns(const StepArgs& a, const T* x, int b0, int lanes, int c,
                                        double2* bufF, double2* bufI) {
    constexpr int kLoads = 8;  // loads in flight a thread before it stores any
    const int Nf = 2 * a.in_len, Ni = 2 * a.out_len, C = a.C;
    const int sf = lane_points(Nf), si = lane_points(Ni), nb = a.out_len + 1;
    const int points = lanes * Nf;
    for (int i0 = threadIdx.x; i0 < points; i0 += kLoads * blockDim.x) {
        double v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int i = i0 + u * blockDim.x;
            const int t = i / Nf, r = i - t * Nf;
            v[u] = i < points && r < a.in_len
                       ? (double)x[((long long)(b0 + t) * a.in_len + r) * C + c] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i < points) {
                const int t = i / Nf, r = i - t * Nf;
                bufF[t * sf + pad(__ldg(a.fwd.perm + r))] = make_double2(v[u], 0.0);
            }
        }
    }
    __syncthreads();
    run_stages(Tile{bufF, Nf, sf, 1, lanes, 0, 1, Nf, 1.0, a.tw_f}, a.fwd);
    for (int i = threadIdx.x; i < lanes * nb; i += blockDim.x) {
        const int t = i / nb, l = i - t * nb;
        const double2* X = bufF + t * sf;
        double2* Y = bufI + t * si;
        const double2 v = fold_bin(a.ptr, a.j, a.flags, a.s, l,
                                   [&](int jj) { return X[pad(jj)]; });
        Y[pad(__ldg(a.perm_i + l))] = v;
        if (l > 0 && l < a.out_len) Y[pad(__ldg(a.perm_i + Ni - l))] = make_double2(v.x, -v.y);
    }
    __syncthreads();
    run_stages(Tile{bufI, Ni, si, 1, lanes, 0, 1, Ni, -1.0, a.tw_i}, a.inv);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Grid (groups of m inner blocks rounded up to whole clusters, S C): block
// (g, s C + c) owns inner blocks g m .. g m + m - 1 of channel c of stream
// s, lane t's predecessor being lane t - 1 and lane 0's the last lane of
// block g - 1 (stream s's carried overlap for g = 0). A block past the last
// inner block only takes part in its cluster's barriers.
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1) resample_step_kernel(const StepArgs a) {
    extern __shared__ double2 smem[];
    const int half = a.out_len, m = a.m;
    const int si = lane_points(2 * a.out_len);
    double2* bufF = smem;
    double2* bufI = smem + m * lane_points(2 * a.in_len);
    T* prev = reinterpret_cast<T*>(bufI + m * si);  // lane 0's predecessor's tail
    const int g = blockIdx.x, C = a.C, s = blockIdx.y / C, c = blockIdx.y - s * C;
    const int b0 = g * m, lanes = min(m, a.n - b0), rank = g % a.cluster;
    const bool live = b0 < a.n, clustered = a.cluster > 1;
    // this stream's samples, output and overlaps
    const T* x = static_cast<const T*>(a.x) + (long long)s * a.n * a.in_len * C;
    T* y = static_cast<T*>(a.y) + (long long)s * a.n * half * C;
    const long long ov0 = (long long)s * half * C;
    if (clustered) cluster_arrive_relaxed();  // this block has started
    if (live) {
        if (b0 == 0) {
            const T* ov_in = static_cast<const T*>(a.ov_in) + ov0;
            for (int d = threadIdx.x; d < half; d += blockDim.x) prev[d] = ov_in[(long long)d * C + c];
        } else if (rank == 0) {  // no block of this cluster holds inner block b0 - 1
            columns<T>(a, x, b0 - 1, 1, c, bufF, bufI);
            for (int d = threadIdx.x; d < half; d += blockDim.x) {
                prev[d] = ola_tail<T>(bufI[pad(half + d)].x, a.scale, a.ratio);
            }
            __syncthreads();
        }
        columns<T>(a, x, b0, lanes, c, bufF, bufI);
    }
    const double2* last = bufI + (live ? lanes - 1 : 0) * si;  // the last lane's inverse
    if (clustered) {
        cluster_wait();  // every block of the cluster has started: its shared memory is there
        if (live && rank + 1 < a.cluster && b0 + m < a.n) {
            T* next = cg::this_cluster().map_shared_rank(prev, rank + 1);
            for (int d = threadIdx.x; d < half; d += blockDim.x) {
                next[d] = ola_tail<T>(last[pad(half + d)].x, a.scale, a.ratio);
            }
        }
        cg::this_cluster().sync();  // the tails are in place; no block leaves before they are read
    }
    if (!live) return;
    if (b0 + lanes == a.n) {
        T* ov_out = static_cast<T*>(a.ov_out) + ov0;
        for (int d = threadIdx.x; d < half; d += blockDim.x) {
            ov_out[(long long)d * C + c] = ola_tail<T>(last[pad(half + d)].x, a.scale, a.ratio);
        }
    }
    for (int i = threadIdx.x; i < lanes * half; i += blockDim.x) {
        const int t = i / half, d = i - t * half;
        const T p = t == 0 ? prev[d]
                           : ola_tail<T>(bufI[(t - 1) * si + pad(half + d)].x, a.scale, a.ratio);
        y[((long long)(b0 + t) * half + d) * C + c] =
            ola_out(bufI[t * si + pad(d)].x, a.scale, a.ratio, p);
    }
}

// A block pass's threads for T lanes of P points (ops/fft_conv.py FftPlan):
// about 4 points a thread, a multiple of 32, at most kMaxThreads.
int pass_threads(int T, int P) {
    const int t = ((T * P / 4 + 31) / 32) * 32;
    return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

long long step_smem(int m, int Nf, int Ni, int out_len) {
    return 16LL * m * (lane_points(Nf) + lane_points(Ni)) + 8LL * out_len;
}

unsigned long long resample_launches = 0;

template <class T>
int launch_step(const ResampleStepCfg* cfg, const void* x, void* y, void* ov_out,
                const void* ov_in, int n, int C, int S, cudaStream_t stream) {
    static unsigned smem_done = 0;
    if (cfg == nullptr || n < 1 || C < 1 || S < 1 || (long long)S * C > 65535 ||
        cfg->in_len < 1 || cfg->out_len < 1 || cfg->tables_f == nullptr ||
        cfg->tables_i == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    const int Nf = 2 * cfg->in_len, Ni = 2 * cfg->out_len;
    Plan pf, pi;
    if (!parse_plan(cfg->plan_f, Nf, &pf) || !parse_plan(cfg->plan_i, Ni, &pi) || pf.n != 1 ||
        pi.n != 1 || pf.kind[0] == kGlobalPass || pi.kind[0] == kGlobalPass ||
        pf.pass[0].T != 1 || pi.pass[0].T != 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (step_smem(1, Nf, Ni, cfg->out_len) > kSmemLimit) return (int)cudaErrorInvalidValue;
    // inner blocks a thread block: enough that the blocks about fill the
    // card's SMs once, as few as shared memory and a pass's points allow
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess || sms < 1) return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
    }
    const int P = pf.pass[0].P > pi.pass[0].P ? pf.pass[0].P : pi.pass[0].P;
    int m = (int)(((long long)n * S * C + sms - 1) / sms);
    m = m < n ? m : n;
    while (m > 1 && (step_smem(m, Nf, Ni, cfg->out_len) > kSmemLimit ||
                     (long long)m * P > kBlockPoints)) {
        --m;
    }
    const long long smem = step_smem(m, Nf, Ni, cfg->out_len);
    const int groups = (n + m - 1) / m;
    StepArgs a{};
    a.fwd = pf.pass[0];
    a.fwd.first = 1;
    a.fwd.last = 0;
    a.tw_f = static_cast<const double2*>(cfg->tables_f);
    a.fwd.perm = reinterpret_cast<const int*>(a.tw_f + Nf);
    a.fwd.in = nullptr;
    a.fwd.out = nullptr;
    a.inv = pi.pass[0];
    a.inv.first = a.inv.last = 0;
    a.inv.in = nullptr;
    a.inv.out = nullptr;
    a.tw_i = static_cast<const double2*>(cfg->tables_i);
    a.perm_i = reinterpret_cast<const int*>(a.tw_i + Ni);
    a.inv.perm = a.perm_i;
    a.ptr = cfg->ptr;
    a.j = cfg->j;
    a.flags = cfg->flags;
    a.s = static_cast<const double2*>(cfg->s);
    a.x = x;
    a.y = y;
    a.ov_out = ov_out;
    a.ov_in = ov_in;
    a.scale = 1.0 / Ni;
    a.ratio = cfg->ratio;
    a.in_len = cfg->in_len;
    a.out_len = cfg->out_len;
    a.n = n;
    a.C = C;
    a.m = m;
    a.cluster = kMaxCluster < groups ? kMaxCluster : groups;
    cudaError_t err = allow_smem(resample_step_kernel<T>, &smem_done);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1] = {};
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3((unsigned)((groups + a.cluster - 1) / a.cluster * a.cluster),
                      (unsigned)(S * C), 1);
    const int tf = pass_threads(m, pf.pass[0].P), ti = pass_threads(m, pi.pass[0].P);
    lc.blockDim = dim3((unsigned)(tf > ti ? tf : ti), 1, 1);
    lc.dynamicSmemBytes = (size_t)smem;
    lc.stream = stream;
    lc.attrs = attr;
    lc.numAttrs = a.cluster > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&lc, resample_step_kernel<T>, a);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess) ++resample_launches;
    return (int)err;
}

}  // namespace

// Y[n_out, ncol] from X[n_in, ncol] through the CSR tables ptr[n_out + 1],
// j, flags, s[ptr[n_out]]. Returns cudaGetLastError() after the launch (0
// on success). The caller (dsp_tpu_torch/ops/resample_ops.py) checks shapes,
// dtypes and contiguity.
extern "C" int dsp_resample_fold_c128(const void* X, void* Y, const int* ptr, const int* j,
                                      const int* flags, const void* s, int n_out, int ncol,
                                      void* stream) {
    if (n_out <= 0 || ncol <= 0) return (int)cudaErrorInvalidValue;
    const long long total = (long long)n_out * ncol;
    const unsigned blocks = (unsigned)((total + kFoldThreads - 1) / kFoldThreads);
    resample_fold_kernel<<<blocks, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double2*>(X), static_cast<double2*>(Y), ptr, j, flags,
        static_cast<const double2*>(s), n_out, ncol);
    return (int)cudaGetLastError();
}

// The step on S streams of n inner blocks of C channels: x [S, n in_len, C]
// and the carried overlap ov_in [S, out_len, C] in, y [S, n out_len, C] and
// the overlap carried out ov_out [S, out_len, C] out, all float64 (f32 = 0)
// or float32 (f32 = 1). Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue, with nothing launched, where the plans are not one
// block pass each or do not fit a block's shared memory. The caller checks
// shapes, dtypes and contiguity.
extern "C" int dsp_resample_step(const ResampleStepCfg* cfg, const void* x, void* y, void* ov_out,
                                 const void* ov_in, int n, int C, int S, int f32, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return f32 ? launch_step<float>(cfg, x, y, ov_out, ov_in, n, C, S, st)
               : launch_step<double>(cfg, x, y, ov_out, ov_in, n, C, S, st);
}

// The steps dsp_resample_step has launched in this process.
extern "C" unsigned long long dsp_resample_launches() { return resample_launches; }
