// G2: the rays' coherence sort keys, as int32, for Hopper.
//
// Replaces the key math that the JAX integrator fuses under jax.jit before
// every reorder sort (opengl_raytracer_tpu/ops/morton.py:47-78, not a
// Pallas kernel): the origin quantized to the scene's box at 512 levels
// and Morton-interleaved, the direction quantized at 4 and 16 levels, the
// key assembled direction-major, clamped below the dead-ray sentinel and
// set to it for dead rays.  The port's plain version
// (ops/morton.py:sort_keys_i32_plain) runs some 60 torch kernels a
// bounce; here one thread per ray does them all.
//
// The key is written as int32, the uint32 key minus 2^31: the map keeps
// the order and sends the sentinel 0xFFFFFFFF to INT32_MAX, so a stable
// sort of these keys gives the permutation of the uint32 keys and dead
// rays still sort last, while the radix sort does half the passes of the
// plain version's int64 keys.
//
// Bit for bit against the plain version ON THE CARD, NaN and infinite
// columns included: the arithmetic is the plain version's, op for op, with
// round-to-nearest intrinsics; its division by the box's extent (a Python
// number) is, as PyTorch's CUDA division computes it, a product with the
// float32 reciprocal; the clamp lets NaN through as torch.clamp does, the
// float -> int64 conversion is the same truncating cvt that torch's cast
// compiles to, and the integer mixing is done in int64 as the plain
// version does it, so whatever a NaN converts to lands as it does there.
//
// What bounds it on the card: bytes.  Per ray it reads six float columns
// and an alive flag (25 bytes) and writes a 4-byte key, against some 60
// integer and float operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the plain version's int64 values, held as their two's-complement bits so
// that left shifts wrap as torch's do
typedef unsigned long long u64;

// torch.clamp(x, 0, hi).to(torch.int64): NaN (x != x) passes the clamp
__device__ __forceinline__ u64 quantize(float x, float hi) {
    const float c = x != x ? x : fminf(fmaxf(x, 0.0f), hi);
    return (u64)(long long)c;
}

__device__ __forceinline__ u64 spread3(u64 x) {
    x = x & 0x3FF;
    x = (x | (x << 16)) & 0x030000FF;
    x = (x | (x << 8)) & 0x0300F00F;
    x = (x | (x << 4)) & 0x030C30C3;
    x = (x | (x << 2)) & 0x09249249;
    return x;
}

struct Box {
    float lo[3];
    float inv_ext[3];  // float32(1 / extent), extent >= 1e-6
};

__global__ void __launch_bounds__(256)
coherence_key_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const bool* __restrict__ alive, Box box,
                     int* __restrict__ key_out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float o[3] = {ox[i], oy[i], oz[i]};
    const float d[3] = {dx[i], dy[i], dz[i]};
    u64 q[3], dq[3];
    float h[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        q[a] = quantize(mul(mul(sub(o[a], box.lo[a]), box.inv_ext[a]), 512.0f), 511.0f);
        h[a] = add(mul(d[a], 0.5f), 0.5f);
        dq[a] = quantize(mul(h[a], 4.0f), 3.0f);
    }
    const u64 dir6 = (dq[0] << 4) | (dq[1] << 2) | dq[2];
    const u64 dq4y = quantize(mul(h[1], 16.0f), 15.0f);
    const u64 dq4z = quantize(mul(h[2], 16.0f), 15.0f);
    const u64 dfine6 = ((dq4y & 3) << 4) | dq4z;
    // m is below 2^30, so its right shifts are the plain version's
    const u64 m = spread3(q[0]) | (spread3(q[1]) << 1) | (spread3(q[2]) << 2);
    // clamp_max and where act on the signed int64 key
    long long key = (long long)((dir6 << 26) | ((m >> 15) << 14) | (dfine6 << 8)
                                | ((m >> 7) & 0xFF));
    const long long dead = 0xFFFFFFFFLL;
    key = key < dead - 1 ? key : dead - 1;
    if (alive && !alive[i]) key = dead;
    // .to(torch.int32) keeps the low 32 bits
    key_out[i] = (int)(unsigned)(u64)(key - 2147483648LL);
}

}  // namespace

// alive may be null (every ray live)
extern "C" int oglrt_sort_keys(const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const bool* alive, const float* lo,
                               const float* inv_ext, int* key_out, long long n,
                               void* stream) {
    if (n > 0) {
        Box box;
        for (int a = 0; a < 3; ++a) {
            box.lo[a] = lo[a];
            box.inv_ext[a] = inv_ext[a];
        }
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        coherence_key_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            ox, oy, oz, dx, dy, dz, alive, box, key_out, n);
    }
    return (int)cudaGetLastError();
}
