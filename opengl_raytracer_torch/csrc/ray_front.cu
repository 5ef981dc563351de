// G1: the per-pixel ray front, for Hopper.
//
// Replaces what the JAX renderer fuses under jax.jit ahead of its first
// traversal (opengl_raytracer_tpu/renderer.py:162-199, not a Pallas
// kernel): the pixel seed x*1973 ^ y*9277 ^ frame*1664525, three LCG
// warm-ups, uv at the pixel centre, the angle-linear direction, two jitter
// draws, the normalizes, and the camera-position origin columns
// (fragment.glsl:376-407).  The port's plain version
// (ops/front.py:ray_front_plain) runs these as some 100 torch kernels of
// int64-emulated uint32 math; here one thread per ray does them all.
//
// Bit for bit against the plain version ON THE CARD: seeds are exact
// uint32 math (the int64 inputs are taken mod 2^32, so frame numbers near
// 2^32 and px * 1973 wrap as there), and every float operation is a
// round-to-nearest intrinsic in torch's evaluation order.  Two divisions
// of the plain version are by a Python number, which PyTorch's CUDA
// division computes as a product with the float32 reciprocal
// (BinaryDivTrueKernel.cu): (px + 0.5) / width is px_f * inv_w here, and
// the RNG's / 2^32 is exact either way.  The other divisions are tensor
// by tensor and stay __fdiv_rn.
//
// What bounds it on the card: bytes.  Per ray it reads px, py (and a frame
// number under frame batching), 16-24 bytes, and writes six float columns
// and a seed, 32 bytes, against some 60 operations: one coalesced pass.

#include <cuda_runtime.h>
#include <stdint.h>

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
    float pos[3], right[3], up[3], forward[3];
    float dir_start_x, dir_start_y, x_step, y_step;
    float inv_w, inv_h;  // float32(1 / width), float32(1 / height)
    float jitter;
    uint32_t frame_term;  // (frame * 1664525) mod 2^32 when no frame column
};

__global__ void __launch_bounds__(256)
ray_front_kernel(const long long* __restrict__ px, const long long* __restrict__ py,
                 const long long* __restrict__ frames, Front c,
                 float* __restrict__ out, long long* __restrict__ seed_out,
                 long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long x = px[i], y = py[i];
    const uint32_t f = frames ? (uint32_t)frames[i] * 1664525u : c.frame_term;
    uint32_t s = ((uint32_t)x * 1973u) ^ ((uint32_t)y * 9277u) ^ f;
#pragma unroll
    for (int k = 0; k < 3; ++k) s = s * 747796405u + 2891336453u;

    const float u = mul(add(__ll2float_rn(x), 0.5f), c.inv_w);
    const float v = mul(add(__ll2float_rn(y), 0.5f), c.inv_h);
    const float dx = add(c.dir_start_x, mul(u, c.x_step));
    const float dy = add(c.dir_start_y, mul(v, c.y_step));
    float d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        d[a] = add(add(mul(c.right[a], dx), mul(c.up[a], dy)), c.forward[a]);
    float len = norm_len(d);
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = dvd(d[a], len);

    const float r1 = draw(s);
    const float r2 = draw(s);
#pragma unroll
    for (int a = 0; a < 3; ++a)
        d[a] = add(d[a], mul(add(mul(c.right[a], r1), mul(c.up[a], r2)), c.jitter));
    len = norm_len(d);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        out[a * n + i] = c.pos[a];
        out[(3 + a) * n + i] = dvd(d[a], len);
    }
    seed_out[i] = (long long)s;
}

}  // namespace

// out: (6, n) float32, rows ox oy oz dx dy dz; frames may be null.
extern "C" int oglrt_ray_front(const long long* px, const long long* py,
                               const long long* frames, unsigned frame_term,
                               const float* cam /* pos right up forward */,
                               float dir_start_x, float dir_start_y,
                               float x_step, float y_step, float inv_w,
                               float inv_h, float jitter, float* out,
                               long long* seed_out, long long n, void* stream) {
    if (n > 0) {
        Front c;
        for (int a = 0; a < 3; ++a) {
            c.pos[a] = cam[a];
            c.right[a] = cam[3 + a];
            c.up[a] = cam[6 + a];
            c.forward[a] = cam[9 + a];
        }
        c.dir_start_x = dir_start_x;
        c.dir_start_y = dir_start_y;
        c.x_step = x_step;
        c.y_step = y_step;
        c.inv_w = inv_w;
        c.inv_h = inv_h;
        c.jitter = jitter;
        c.frame_term = frame_term;
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        ray_front_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            px, py, frames, c, out, seed_out, n);
    }
    return (int)cudaGetLastError();
}
