// G3: the integrator's reorder and restore permutations, for Hopper.
//
// Replace the multi-operand sorts that carry every per-ray column in the
// JAX integrator (opengl_raytracer_tpu/ops/integrator.py:209-268 and
// :336-354, XLA sorts, not Pallas kernels).  The port sorts only the keys
// (torch.argsort) and moves the columns with one launch each way:
//
//   * reorder_kernel: out row r at position i is column r at perm[i], for
//     the 12 float columns (origin, direction, ray colour, incoming light),
//     written as the rows of one (12, n) buffer so each stays contiguous
//     for the traversal; also the sorted seed and original index and
//     alive = keys[perm[i]] != INT32_MAX (the dead-ray sentinel of G2's
//     int32 keys);
//   * restore_kernel: incoming light and seed scattered back to pixel
//     order, out[orig[i]] = in[i].
//
// The JAX package folds incoming light into the origin columns and may
// rebuild the seed from the original index: those answer the TPU's
// per-column cost of a sort network.  Here a gather pays per byte, and the
// folds would cost selects on both sides, so every column rides as it is.
// Both are permutations, so they equal their plain versions
// (ops/permute.py) bit for bit.
//
// What bounds them on the card: bytes.  The reorder reads an 8-byte index,
// a 4-byte key, 48 bytes of columns, a seed and an index, and writes 48 +
// 17 bytes (about 140 bytes a ray); the restore moves 28 bytes in and 20
// out.  Reads (and the restore's writes) by a permuted index are scattered
// 4- or 8-byte accesses, each of which moves a 32-byte sector between L2
// and the SM; writes and index reads are coalesced.  So the design keeps
// the scattered side in L2: the grid's second dimension walks the
// columns, one at a time, instead of one thread carrying a ray's 15.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 12;
constexpr int kDeadKey = 0x7FFFFFFF;

struct Cols12 {
    const float* c[kCols];
};

// blockIdx.y picks the column: 0-11 the float columns, 12 the seed, 13
// the original index, 14 alive from the key.  Blocks run x-fastest, so the
// card works through one column at a time and that column's scattered
// reads (8 or 16 MB) stay in the 50 MB L2.  On an H100 at 2,073,600 rays
// (chip_smoke.py's glue phase) one thread per ray reading all 15 columns,
// a 140 MB working set, took 0.87 ms on a random permutation; this
// layout 0.32 ms.
__global__ void __launch_bounds__(256)
reorder_kernel(const long long* __restrict__ perm, const int* __restrict__ keys,
               Cols12 in, const long long* __restrict__ seed,
               const long long* __restrict__ orig, float* __restrict__ out,
               long long* __restrict__ seed_out, long long* __restrict__ orig_out,
               bool* __restrict__ alive_out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long p = perm[i];
    const int r = blockIdx.y;
    if (r < kCols) {
        // selects over constant offsets: indexing the parameter array by r
        // would copy it to local memory
        const float* src = in.c[0];
#pragma unroll
        for (int k = 1; k < kCols; ++k) src = r == k ? in.c[k] : src;
        out[r * n + i] = src[p];
    } else if (r == kCols) {
        seed_out[i] = seed[p];
    } else if (r == kCols + 1) {
        orig_out[i] = orig[p];
    } else {
        alive_out[i] = keys[p] != kDeadKey;
    }
}

// blockIdx.y picks the column: 0-2 incoming light, 3 the seed (one
// scattered destination at a time, as the reorder reads one source).
__global__ void __launch_bounds__(256)
restore_kernel(const long long* __restrict__ orig, const float* __restrict__ i0,
               const float* __restrict__ i1, const float* __restrict__ i2,
               const long long* __restrict__ seed, float* __restrict__ out,
               long long* __restrict__ seed_out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long o = orig[i];
    const int r = blockIdx.y;
    if (r == 3) {
        seed_out[o] = seed[i];
    } else {
        const float* src = r == 0 ? i0 : (r == 1 ? i1 : i2);
        out[r * n + o] = src[i];
    }
}

}  // namespace

// cols: 12 float column pointers; out: (12, n) float32.
extern "C" int oglrt_reorder(const long long* perm, const int* keys,
                             const float* const* cols, const long long* seed,
                             const long long* orig, float* out,
                             long long* seed_out, long long* orig_out,
                             bool* alive_out, long long n, void* stream) {
    if (n > 0) {
        Cols12 in;
        for (int r = 0; r < kCols; ++r) in.c[r] = cols[r];
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        reorder_kernel<<<dim3((unsigned)grid, kCols + 3), block, 0,
                         (cudaStream_t)stream>>>(
            perm, keys, in, seed, orig, out, seed_out, orig_out, alive_out, n);
    }
    return (int)cudaGetLastError();
}

// out: (3, n) float32.
extern "C" int oglrt_restore(const long long* orig, const float* i0,
                             const float* i1, const float* i2,
                             const long long* seed, float* out,
                             long long* seed_out, long long n, void* stream) {
    if (n > 0) {
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        restore_kernel<<<dim3((unsigned)grid, 4), block, 0,
                         (cudaStream_t)stream>>>(
            orig, i0, i1, i2, seed, out, seed_out, n);
    }
    return (int)cudaGetLastError();
}
