// The tiles of K16's plain mode (csrc/stats.cu) and K17 (csrc/levels.cu):
// a thread block takes kTile samples of up to kGroup channels of a block
// [B, n] and stages them in shared memory, each channel's row padded so that
// the lanes' segments of kSeg samples (lane l: samples 8l .. 8l + 7) sit in
// distinct banks.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tile_slab {

constexpr int kTile = 256;             // samples a tile
constexpr int kSeg = 8;                // samples a lane, kTile / 32
constexpr int kGroup = 8;              // channels a tile
constexpr int kPad = 32 * (kSeg + 1);  // a channel's padded row of the slab

// where channel c's sample t of the tile sits in the slab
__device__ __forceinline__ int at(int c, int t) {
    return c * kPad + (t >> 3) * (kSeg + 1) + (t & 7);
}

// Stage samples [t0, t0 + rows) of channels [c0, c0 + ng) of xs [B, n] in
// x (kGroup · kPad values). With one channel group the rows are one
// contiguous run, read in 16-byte loads where it is aligned. Every thread
// of the block calls it; the caller synchronises before reading x.
template <typename T>
__device__ void load(T* x, const T* __restrict__ xs, int n, int groups, int c0, int ng, int t0,
                     int rows) {
    if (groups == 1) {
        const T* src = xs + (size_t)t0 * n;
        const int cnt = rows * n;
        constexpr int kVec = 16 / sizeof(T);
        int done = 0;
        if (((size_t)src & 15) == 0) {
            using V = typename std::conditional<sizeof(T) == 8, double2, float4>::type;
            const V* v = reinterpret_cast<const V*>(src);
            for (int q = threadIdx.x; q < cnt / kVec; q += blockDim.x) {
                const V w = v[q];
                const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
                for (int u = 0; u < kVec; ++u) {
                    const int i = q * kVec + u;
                    x[at(i % n, i / n)] = e[u];
                }
            }
            done = cnt / kVec * kVec;
        }
        for (int i = done + (int)threadIdx.x; i < cnt; i += blockDim.x) x[at(i % n, i / n)] = src[i];
    } else {
        for (int i = threadIdx.x; i < rows * ng; i += blockDim.x) {
            const int t = i / ng, c = i - t * ng;
            x[at(c, t)] = xs[(size_t)(t0 + t) * n + c0 + c];
        }
    }
}

}  // namespace tile_slab
