// G1: the per-pixel ray front, for Hopper.
//
// Replaces what the JAX renderer fuses under jax.jit ahead of its first
// traversal (opengl_raytracer_tpu/renderer.py:162-199 and the band's pixel
// list and frame numbers of _tile_step, :300-353; not a Pallas kernel):
// each ray's pixel and frame number, the pixel seed x*1973 ^ y*9277 ^
// frame*1664525, three LCG warm-ups, uv at the pixel centre, the
// angle-linear direction, two jitter draws, the normalizes, and the
// camera-position origin columns (fragment.glsl:376-407).  The port's plain
// version (ops/front.py:ray_front_plain) runs these as some 100 torch
// kernels of int64-emulated uint32 math; here one thread per ray does them
// all.
//
// Ray g of a step (g = base + i in this chunk) is pixel j = g mod n_band
// of the band, row-major from its bottom GL row: px = col0 + j mod tw, py =
// py0 + j / tw, at frame number frame + g / n_band (frames_per_step copies
// of the band follow each other).  With blocks (the "packet" traversal on
// a band whose rows are a multiple of 8 and tw of 16), pixel j is taken in
// 8x16 blocks instead, each block a 128-ray packet (step_block.cuh:
// band_xy; the JAX renderer's to_blocks, renderer.py:322-336).  Rays at
// or past n_rays pad the last chunk: pixel (0, 0) at the step's frame.
// The rule and the pixel seed are step_block.cuh's ray_pixel_seed, which
// G3's index pass shares to rebuild a live ray's seed (permute.cu).  The
// window, the frame number, the camera and the jitter are read from the
// step block (step_block.cuh), so a captured step replays with new values.
//
// Bit for bit against the plain version ON THE CARD: seeds are exact
// uint32 math (the int64 frame number is taken mod 2^32, so frame numbers
// near 2^32 and px * 1973 wrap as there), and every float operation is a
// round-to-nearest intrinsic in torch's evaluation order.  Two divisions
// of the plain version are by a Python number, which PyTorch's CUDA
// division computes as a product with the float32 reciprocal
// (BinaryDivTrueKernel.cu): (px + 0.5) / width is px_f * inv_w here, and
// the RNG's / 2^32 is exact either way.  The other divisions are tensor
// by tensor and stay __fdiv_rn.
//
// What bounds it on the card: bytes.  Per ray it writes six float columns
// and a seed, 32 bytes, and reads nothing but the block, against some 60
// operations: one coalesced pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_block.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float draw(uint32_t& state) {
    // fragment.glsl:206-218; x * 2 is exact, so a contracted x * 2 - 1
    // rounds as the two torch ops do
    state = state * 747796405u + 2891336453u;
    const uint32_t t = state >> ((state >> 28) + 4u);
    uint32_t r = (t ^ state) * 277803737u;
    r = (r >> 22) ^ r;
    return __uint2float_rn(r) / 4294967296.0f * 2.0f - 1.0f;
}

__device__ __forceinline__ float norm_len(const float* d) {
    return __fsqrt_rn(add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2])));
}

struct Front {
    float dir_start_x, dir_start_y, x_step, y_step;
    float inv_w, inv_h;  // float32(1 / width), float32(1 / height)
    long long base, n_rays, n_band;
    int tw;
};

template <bool kBlocks>
__global__ void __launch_bounds__(256)
ray_front_kernel(const StepBlock* __restrict__ blk, Front c,
                 float* __restrict__ out, long long* __restrict__ seed_out,
                 long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long long x, y;
    uint32_t s = ray_pixel_seed<long long, kBlocks>(
        blk, c.base + i, c.n_rays, c.n_band, c.tw, x, y);
    const float* pos = blk->cam;
    const float* right = blk->cam + 3;
    const float* up = blk->cam + 6;
    const float* forward = blk->cam + 9;
#pragma unroll
    for (int k = 0; k < 3; ++k) s = s * 747796405u + 2891336453u;

    const float u = mul(add(__ll2float_rn(x), 0.5f), c.inv_w);
    const float v = mul(add(__ll2float_rn(y), 0.5f), c.inv_h);
    const float dx = add(c.dir_start_x, mul(u, c.x_step));
    const float dy = add(c.dir_start_y, mul(v, c.y_step));
    float d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        d[a] = add(add(mul(right[a], dx), mul(up[a], dy)), forward[a]);
    float len = norm_len(d);
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = dvd(d[a], len);

    const float r1 = draw(s);
    const float r2 = draw(s);
    const float jitter = blk->jitter;
#pragma unroll
    for (int a = 0; a < 3; ++a)
        d[a] = add(d[a], mul(add(mul(right[a], r1), mul(up[a], r2)), jitter));
    len = norm_len(d);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        out[a * n + i] = pos[a];
        out[(3 + a) * n + i] = dvd(d[a], len);
    }
    seed_out[i] = (long long)s;
}

}  // namespace

// out: (6, n) float32, rows ox oy oz dx dy dz, for rays base .. base + n - 1
// of a step of n_rays rays over a band of n_band pixels, tw a row, in 8x16
// blocks when blocks is 1.
extern "C" int oglrt_ray_front(const void* blk, long long base,
                               long long n_rays, long long n_band, int tw,
                               int blocks, float dir_start_x,
                               float dir_start_y, float x_step, float y_step,
                               float inv_w, float inv_h, float* out,
                               long long* seed_out, long long n,
                               void* stream) {
    if (n > 0) {
        Front c;
        c.dir_start_x = dir_start_x;
        c.dir_start_y = dir_start_y;
        c.x_step = x_step;
        c.y_step = y_step;
        c.inv_w = inv_w;
        c.inv_h = inv_h;
        c.base = base;
        c.n_rays = n_rays;
        c.n_band = n_band;
        c.tw = tw;
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        if (blocks)
            ray_front_kernel<true><<<(unsigned)grid, block, 0,
                                     (cudaStream_t)stream>>>(
                (const StepBlock*)blk, c, out, seed_out, n);
        else
            ray_front_kernel<false><<<(unsigned)grid, block, 0,
                                      (cudaStream_t)stream>>>(
                (const StepBlock*)blk, c, out, seed_out, n);
    }
    return (int)cudaGetLastError();
}
