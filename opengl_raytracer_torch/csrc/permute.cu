// G3: the integrator's reorder and restore permutations, for Hopper.
//
// Replace the multi-operand sorts that carry the per-ray columns in the
// JAX integrator (opengl_raytracer_tpu/ops/integrator.py:209-268 and
// :336-354, XLA sorts, not Pallas kernels).  The port sorts only the keys
// (G10, csrc/radix_sort.cu, which hands back the sorted keys and the int32
// permutation) and moves the columns, in two launches forward and one
// back:
//
//   * reorder_index_kernel, then reorder_kernel: out row r at position i is
//     column r at perm[i], for the 12 float columns (origin, direction, ray
//     colour, incoming light) as the rows of one (12, n) buffer, the seed
//     and the int32 original index; alive = keys_s[i] != INT32_MAX (the
//     dead-ray sentinel of G2's int32 keys), read from the sorted keys in
//     order.  Each ray moves only what the frame reads again, as the JAX
//     reorder does:
//       - a live ray's incoming light is zero (light is added only where a
//         path ends: an emitter hit or a miss clears alive, shade.cu), so
//         the kernel writes +0.0 for it without a read (JAX :267-268);
//       - a dead ray's origin, direction and ray colour are never read
//         again (the traversals take t0 = -BIG for it, K2 selects on
//         was_hit), so the kernel writes 0.0 for them without a read and
//         reads only the dead ray's light (JAX carries it in the origin
//         slots, :235; its other columns are junk there, zeros here);
//       - a dead ray's seed is read only when the caller returns the seed
//         (return_seed: rays_per_pixel > 1 chains it across samples, JAX
//         :134-137); otherwise 0;
//       - with seed reconstruction (one sample a pixel, return_seed off),
//         a live ray's seed is not read at all: the index pass computes it
//         from the ray's original index, which it reads anyway, and the
//         gather runs without its seed row (the JAX package's seed_recon,
//         renderer.py:165-179, integrator.py:237-249).  Below.
//   * restore_kernel: the incoming light, and the seed only when the
//     caller returns it, scattered back to pixel order, out[orig[i]] =
//     in[i] (JAX :345-353).
//
// Both equal their plain versions (ops/permute.py) bit for bit: they copy
// and select, and compute nothing.
//
// Seed reconstruction.  Before bounce segment i >= 1 a live ray has drawn
// exactly 5 + 3i values since its pixel seed: G1's three warm-ups and two
// jitter draws, then 3 at each segment it lived through.  That holds only
// because K2 draws 3 values for every ray and keeps the new state exactly
// where the ray was alive and hit (shade.cu:94-99, :197), and a ray stays
// alive only through hits.  The LCG composes in closed form, so the state
// is seed * a + c mod 2^32 with (a, c) = advance_constants(5 + 3i)
// (ops/rng.py), and the pixel seed is ray_pixel_seed (step_block.cuh) of
// the ray's step index g = base + orig: G1's own rule, padding rays
// included (the JAX closure has no padding case; here a padding ray can be
// live, so it must get G1's pixel (0, 0) at the step's frame).  The frame
// number and the band window are read from the step block at run time;
// base, n_rays, n_band, tw, a and c are fixed for a renderer and a bounce,
// so a CUDA graph may hold them.  A dead ray's seed stays 0.
//
// What bounds them on the card: traffic between L2 and the SMs, most of it
// scattered sectors, not DRAM bytes.  A read by a permuted index (and the
// restore's write) is a 4- or 8-byte access that moves a 32-byte sector;
// index, key and output accesses are coalesced.  A live ray costs 11
// scattered reads (9 columns, seed, index; 10 with seed reconstruction)
// and a dead one 4 (3 columns, index; 5 with the seed); the restore 3
// scattered writes a ray (4 with the seed).  The gather's grid walks the
// columns, one at a time, so a column's scattered reads (8 or 16 MB at 2M
// rays) stay in the 50 MB L2; its rows read one int32 a ray (index and
// liveness, from the index pass) where each would otherwise read a
// 4-byte index and a 4-byte key.  Dead rays hold the largest key and sort
// to the tail, so the live/dead branch is the same for every lane of a
// warp but the one warp at the boundary.

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_block.cuh"

namespace {

constexpr int kCols = 12;
constexpr int kRows = 10;  // the gather's: 3 origin/incoming, 6
                           // direction/colour, the seed
constexpr int kDeadKey = 0x7FFFFFFF;
constexpr int kBlock = 256;
constexpr int kRays = 8;  // rays a thread of the gather

struct Cols12 {
    const float* c[kCols];
};

// Seed reconstruction's by-value arguments: the chunk's first step index,
// the step's rays, the band's pixels and row width, and the LCG advance of
// the draws made so far, advance_constants(5 + 3i).
struct Recon {
    long long base, n_rays, n_band;
    int tw;
    uint32_t a, c;
};

// The index type of the reconstruction's pixel arithmetic: long long,
// which holds every step.  chip_smoke.py (phase 3c) times a build with
// -DOGLRT_RECON_INDEX=uint32_t against it on a 1080p frame's states, where
// that narrower build is exact (base + n, n_rays and n_band below 2^32).
#ifndef OGLRT_RECON_INDEX
#define OGLRT_RECON_INDEX long long
#endif

__device__ __forceinline__ uint32_t recon_seed(const StepBlock* blk,
                                               const Recon& rc, int o) {
    using I = OGLRT_RECON_INDEX;
    I x, y;
    const uint32_t s = ray_pixel_seed<I>(blk, (I)(rc.base + o), (I)rc.n_rays,
                                         (I)rc.n_band, (I)rc.tw, x, y);
    return s * rc.a + rc.c;
}

// Column k of ``in`` by selects over constant offsets: indexing the
// parameter array by a run-time k would copy it to local memory.
__device__ __forceinline__ const float* pick(const Cols12& in, int k) {
    const float* s = in.c[0];
#pragma unroll
    for (int j = 1; j < kCols; ++j) s = k == j ? in.c[j] : s;
    return s;
}

// The reorder's first launch: each ray's permuted index with its liveness
// in the sign, pa[i] = alive ? perm[i] : ~perm[i] (int32, so the gather's
// rows read 4 bytes a ray, not an 8-byte index and a 4-byte key each), and
// the outputs that need nothing else: the original index orig[perm[i]]
// (one scattered read), alive, and with seed reconstruction the seed,
// computed from that original index in registers.
template <bool kRecon>
__global__ void __launch_bounds__(kBlock)
reorder_index_kernel(const int* __restrict__ perm,
                     const int* __restrict__ keys_s,
                     const int* __restrict__ orig, int* __restrict__ pa,
                     int* __restrict__ orig_out, bool* __restrict__ alive_out,
                     const StepBlock* __restrict__ blk, Recon rc,
                     long long* __restrict__ seed_out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int p = perm[i];
    const bool live = keys_s[i] != kDeadKey;
    pa[i] = live ? p : ~p;
    const int o = orig[p];
    orig_out[i] = o;
    alive_out[i] = live;
    if (kRecon) seed_out[i] = live ? (long long)recon_seed(blk, rc, o) : 0;
}

// The gather: blockIdx.y picks the row: 0-2 origin axis a (a live ray's
// origin, a dead ray's light; each writes both outputs of its axis), 3-8
// direction and ray colour, 9 the seed (not launched with seed
// reconstruction: the index pass wrote it).  Blocks run x-fastest, so the card
// works through one row at a time.  Each thread moves kRays rays of its
// row, kBlock apart (coalesced), with every load of a phase issued
// before the next phase: kRays scattered reads in flight a thread.
template <bool kSeed>
__global__ void __launch_bounds__(kBlock)
reorder_kernel(const int* __restrict__ pa, Cols12 in,
               const long long* __restrict__ seed, float* __restrict__ out,
               long long* __restrict__ seed_out, long long n) {
    const long long base =
        (long long)blockIdx.x * kBlock * kRays + threadIdx.x;
    long long at[kRays];
    bool ok[kRays], live[kRays];
    int p[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
        at[k] = base + (long long)k * kBlock;
        ok[k] = at[k] < n;
        const int q = ok[k] ? pa[at[k]] : -1;
        live[k] = q >= 0;
        p[k] = live[k] ? q : ~q;
    }
    const int r = blockIdx.y;
    if (r < 3) {
        float v[kRays];
#pragma unroll
        for (int k = 0; k < kRays; ++k)
            if (ok[k]) v[k] = pick(in, live[k] ? r : 9 + r)[p[k]];
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
            if (!ok[k]) continue;
            out[r * n + at[k]] = live[k] ? v[k] : 0.0f;
            out[(9 + r) * n + at[k]] = live[k] ? 0.0f : v[k];
        }
    } else if (r < 9) {
        const float* src = pick(in, r);
        float v[kRays];
#pragma unroll
        for (int k = 0; k < kRays; ++k) v[k] = live[k] ? src[p[k]] : 0.0f;
#pragma unroll
        for (int k = 0; k < kRays; ++k)
            if (ok[k]) out[r * n + at[k]] = v[k];
    } else {
        long long v[kRays];
#pragma unroll
        for (int k = 0; k < kRays; ++k)
            v[k] = (live[k] || (kSeed && ok[k])) ? seed[p[k]] : 0;
#pragma unroll
        for (int k = 0; k < kRays; ++k)
            if (ok[k]) seed_out[at[k]] = v[k];
    }
}

// blockIdx.y picks the column: 0-2 incoming light, 3 the seed (launched
// only when the caller returns it; one scattered destination at a time, as
// the reorder reads one source).  One ray a thread.
__global__ void __launch_bounds__(kBlock)
restore_kernel(const int* __restrict__ orig, const float* __restrict__ i0,
               const float* __restrict__ i1, const float* __restrict__ i2,
               const long long* __restrict__ seed, float* __restrict__ out,
               long long* __restrict__ seed_out, long long n) {
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i >= n) return;
    const int r = blockIdx.y;
    const int o = orig[i];
    if (r == 3)
        seed_out[o] = seed[i];
    else
        out[r * n + o] = (r == 0 ? i0 : (r == 1 ? i1 : i2))[i];
}

}  // namespace

// perm: int32 (n < 2^31); cols: 12 float column pointers; pa: an (n,)
// int32 scratch buffer; out: (12, n) float32.  blk null: the seed is
// gathered; else (return_seed off) it is reconstructed from the step block
// blk and base, n_rays, n_band, tw, a and c (Recon).  Two launches on the
// stream, the index pass first.
extern "C" int oglrt_reorder(const int* perm, const int* keys_s,
                             const float* const* cols, const long long* seed,
                             const int* orig, int* pa, float* out,
                             long long* seed_out, int* orig_out,
                             bool* alive_out, int return_seed,
                             const void* blk, long long base,
                             long long n_rays, long long n_band, int tw,
                             uint32_t a, uint32_t c, long long n,
                             void* stream) {
    if (n > 0) {
        Cols12 in;
        for (int r = 0; r < kCols; ++r) in.c[r] = cols[r];
        cudaStream_t st = (cudaStream_t)stream;
        const Recon rc{base, n_rays, n_band, tw, a, c};
        const StepBlock* b = (const StepBlock*)blk;
        const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
        if (b)
            reorder_index_kernel<true><<<blocks, kBlock, 0, st>>>(
                perm, keys_s, orig, pa, orig_out, alive_out, b, rc, seed_out,
                n);
        else
            reorder_index_kernel<false><<<blocks, kBlock, 0, st>>>(
                perm, keys_s, orig, pa, orig_out, alive_out, b, rc, seed_out,
                n);
        const dim3 grid(
            (unsigned)((n + kBlock * kRays - 1) / (kBlock * kRays)),
            b ? kRows - 1 : kRows);
        if (return_seed)
            reorder_kernel<true><<<grid, kBlock, 0, st>>>(pa, in, seed, out,
                                                          seed_out, n);
        else
            reorder_kernel<false><<<grid, kBlock, 0, st>>>(pa, in, seed, out,
                                                           seed_out, n);
    }
    return (int)cudaGetLastError();
}

// out: (3, n) float32; seed and seed_out null: the light alone.
extern "C" int oglrt_restore(const int* orig, const float* i0,
                             const float* i1, const float* i2,
                             const long long* seed, float* out,
                             long long* seed_out, long long n, void* stream) {
    if (n > 0) {
        const dim3 grid((unsigned)((n + kBlock - 1) / kBlock), seed ? 4 : 3);
        restore_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
            orig, i0, i1, i2, seed, out, seed_out, n);
    }
    return (int)cudaGetLastError();
}
