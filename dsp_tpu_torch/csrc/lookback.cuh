// A single-pass scan across the thread blocks of one launch, shared by K1
// (csrc/lti_blocked.cu), K11 (csrc/m4_env.cu), matrix4_mb's K12-K13
// (csrc/m4mb_audio.cu), K16's plain mode (csrc/stats.cu) and K17
// (csrc/levels.cu): the reduce-then-scan of an affine recurrence in one
// launch, in a fixed order so that every run gives the same bits.
//
// A launch cuts its sequence into tiles, a block a tile. Each block
//   1. takes a ticket: tiles are numbered in the order blocks start, so a
//      block only ever waits on blocks that are already running, whatever
//      order the card schedules them in;
//   2. composes its tile from a zero start and publishes that aggregate
//      (its flag set to the launch's tag);
//   3. waits until every tile before it has published, and combines their
//      aggregates with the carried start value, each times the power of
//      the tile map for its distance, in tile order (a decoupled look-back
//      that always reaches tile 0: the sum and its rounding do not depend
//      on which tiles happened to finish first). Where the map varies from
//      tile to tile (carry_affine), each tile publishes its maps and the
//      waiting tile applies them to the carried values one after another.
// No tile waits on another's wait, so the tiles' waits overlap.
// The flags carry the launch's epoch, so nothing is cleared between
// launches: the last block to finish zeroes the ticket and done counters
// and bumps the epoch, which the next launch on the stream reads at its
// start (a CUDA graph's replays too). tag = epoch + 1; a zeroed scratch
// (epoch 0) holds no flag of any launch.
//
// Scratch (two device buffers a device and stream, dsp_tpu_torch/kernels.py
// lookback_scratch): the flag words, unsigned head[4] = {tickets, done,
// epoch, 0} then flag[slots], zeroed when made and holding nothing but
// tags after that; and the aggregates, double agg[slots][width]. The two
// never share storage, so launches with different numbers of tiles or
// widths on one stream (K1's bank beside K11's envelopes) cannot read one
// another's aggregates as flags: a flag word only ever holds the tag of a
// launch before this one, or this one's.

#pragma once

#include <cuda_runtime.h>

namespace lookback {

// A wait that outlasts this many sleeps (seconds) is a fault in the
// scratch or the tickets: the kernel traps, and the launch fails, rather
// than hold the card.
constexpr long long kSpinLimit = 1LL << 26;

struct Scratch {
    unsigned* head;
    unsigned* flag;
    double* agg;
};

__host__ __device__ inline Scratch carve(unsigned* flags, double* agg) {
    Scratch s;
    s.head = flags;
    s.flag = flags + 4;
    s.agg = agg;
    return s;
}

// The block's ticket in tk[0] and the launch's tag in tk[1], for every
// thread.
__device__ inline void begin(const Scratch& s, unsigned* tk) {
    if (threadIdx.x == 0) {
        tk[0] = atomicAdd(&s.head[0], 1u);
        tk[1] = *(volatile unsigned*)&s.head[2] + 1u;
    }
    __syncthreads();
}

// Publish `slot`: thread 0 copies the tile's `width` values from vals
// (shared memory, complete for every thread) to the slot and sets its flag
// behind a fence. Every thread of the block calls it.
__device__ inline void publish(const Scratch& s, long long slot, unsigned tag, const double* vals,
                               int width) {
    __syncthreads();
    if (threadIdx.x == 0) {
        double* dst = s.agg + slot * width;
        for (int e = 0; e < width; ++e) dst[e] = vals[e];
        __threadfence();
        atomicExch(&s.flag[slot], tag);
    }
}

// The calling thread waits until `slot` is published; after a barrier that
// follows, the block reads its values with __ldcg.
__device__ inline void wait(const Scratch& s, long long slot, unsigned tag) {
    const volatile unsigned* f = s.flag + slot;
    long long spins = 0;
    while (*f != tag) {
        __nanosleep(32);
        if (++spins > kSpinLimit) __trap();  // a tile that never publishes
    }
    __threadfence();
}

// The general affine form: each of `width` lanes carries a value through
// maps that vary from tile to tile, v <- a·v + b. A tile publishes its maps
// as a[width] then b[width] (publish with 2·width values) at slot base + its
// index; carry_affine waits for every tile before t and applies their maps
// to the values in v
// (shared memory: the launch's start values on entry, tile t's on return)
// one after another, in tile order, each an FMA. A value is carried, never
// a composed map, so a tile's values meet every earlier map in the same
// order whatever the tile length and the card's timing. buf (shared
// memory, kAffineLook · 2 · width doubles) stages the maps. Every thread of
// the block calls it; it ends on a barrier.
constexpr int kAffineLook = 64;

__device__ inline void carry_affine(const Scratch& s, long long base, long long t, unsigned tag,
                                    int width, double* v, double* buf) {
    for (long long j = threadIdx.x; j < t; j += blockDim.x) wait(s, base + j, tag);
    __syncthreads();
    const int w2 = 2 * width;
    for (long long j0 = 0; j0 < t; j0 += kAffineLook) {
        const int cnt = (int)(t - j0 < kAffineLook ? t - j0 : kAffineLook);
        for (int q = threadIdx.x; q < cnt * w2; q += blockDim.x)
            buf[q] = __ldcg(s.agg + (base + j0) * w2 + q);
        __syncthreads();
        for (int e = threadIdx.x; e < width; e += blockDim.x) {
            double x = v[e];
            for (int i = 0; i < cnt; ++i) x = __fma_rn(buf[i * w2 + e], x, buf[i * w2 + width + e]);
            v[e] = x;
        }
        __syncthreads();
    }
}

// The max-affine form (K17's levels meters): each of `width` lanes carries
// two values through maps that vary from tile to tile, u <- a·u + b and
// v <- max(c, a·v + b). Tile j publishes its maps as a[width], b[width],
// c[width] at slot base + j·stride (every slot of the launch 3·width
// doubles); carry_max_affine waits for every tile before t and applies
// their maps to u and v (shared memory, v[0..width) and v[width..2·width):
// the launch's start values on entry, tile t's on return) one after
// another, in tile order, each an FMA (and a max). As in carry_affine, a
// value is carried, never a composed map. buf (shared memory,
// kMaxAffineLook · 3 · width doubles) stages the maps. Every thread of the
// block calls it; it ends on a barrier.
constexpr int kMaxAffineLook = 64;

__device__ inline void carry_max_affine(const Scratch& s, long long base, long long stride,
                                        long long t, unsigned tag, int width, double* v,
                                        double* buf) {
    for (long long j = threadIdx.x; j < t; j += blockDim.x) wait(s, base + j * stride, tag);
    __syncthreads();
    const int w3 = 3 * width;
    for (long long j0 = 0; j0 < t; j0 += kMaxAffineLook) {
        const int cnt = (int)(t - j0 < kMaxAffineLook ? t - j0 : kMaxAffineLook);
#pragma unroll 4
        for (int q = threadIdx.x; q < cnt * w3; q += blockDim.x)
            buf[q] = __ldcg(s.agg + (base + (j0 + q / w3) * stride) * w3 + q % w3);
        __syncthreads();
        for (int e = threadIdx.x; e < width; e += blockDim.x) {
            double u = v[e], m = v[width + e];
            for (int i = 0; i < cnt; ++i) {
                const double* f = buf + i * w3;
                u = __fma_rn(f[e], u, f[width + e]);
                m = fmax(f[2 * width + e], __fma_rn(f[e], m, f[width + e]));
            }
            v[e] = u;
            v[width + e] = m;
        }
        __syncthreads();
    }
}

// The last block of the launch to get here resets the counters and moves
// the epoch on. Every thread of the block calls it, last.
__device__ inline void end(const Scratch& s) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
        if (atomicAdd(&s.head[1], 1u) == nblocks - 1u) {
            atomicExch(&s.head[0], 0u);
            atomicExch(&s.head[1], 0u);
            atomicAdd(&s.head[2], 1u);
            __threadfence();
        }
    }
}

}  // namespace lookback
