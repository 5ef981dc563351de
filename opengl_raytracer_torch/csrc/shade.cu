// K2: fused shade / scatter / bounce-state update, for Hopper.
//
// Replaces the Pallas kernel `_shade_kernel` of
// opengl_raytracer_tpu/ops/shade.py (launched by `shade_update`).  One
// thread per ray computes, in the JAX kernel's operation order and with its
// guards (shade.py:101-173):
//   * finalize_hit: hit point, barycentric normal from n0/n1/n2 with the
//     face-normal fallback when |raw| <= 1e-20, flipped toward the ray;
//   * scatter: normalize(n + xi) (lambertian) or the hemisphere flip of xi,
//     reflect, and the roughness lerp with its zero-stays-zero guards;
//   * the state update: incoming light, throughput, next origin and
//     direction, seed and alive.
// It also folds in what the JAX wrapper does outside its kernel: the
// material row gather table[clip(index)] (shade.py:192-193) and the three
// RNG draws with the advanced seed (shade.py:188-190).  The table and index
// are the wrapper's arguments: the slot-order rows sh_slot by leaf slot
// after the sub-block traversal, the triangle-order rows sh_abc by
// triangle after every other traversal (intersect.py:244-248).  The draws are exact
// uint32 math, the uint32 -> float conversion rounds to nearest and the
// divide by 2^32 is exact, so seed and alive are bit-identical to the JAX
// package.  The float arithmetic is written with round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn),
// which nvcc never contracts into FMAs, in the order of the plain torch
// version (ops/shade.py), so the kernel reproduces that version bit for
// bit; against the JAX kernel (XLA contracts) floats agree to contraction
// rounding.
//
// The sky colour, the emission scale and the lambertian switch are read
// from the step block (step_block.cuh) when the kernel runs, so a captured
// step replays with the values of the step it serves.
//
// What bounds it on the card: bytes.  Per ray it reads 13 float columns,
// a seed, an alive flag, a slot and one 96-byte material row (a gather),
// and writes 12 float columns, a seed and a flag - about 220 bytes against
// some 150 flops, far below the H100's flop-to-byte ratio.  One pass over
// coalesced columns is the design; the material gather hits L2 for the
// scene sizes of the main path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_block.cuh"

namespace {

constexpr float kBig = 1e30f;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}
__device__ __forceinline__ float len3(const float* a) { return __fsqrt_rn(dot3(a, a)); }

__device__ __forceinline__ float draw(uint32_t& state) {
    // fragment.glsl:206-218
    state = state * 747796405u + 2891336453u;
    const uint32_t t = state >> ((state >> 28) + 4u);
    uint32_t r = (t ^ state) * 277803737u;
    r = (r >> 22) ^ r;
    return __uint2float_rn(r) / 4294967296.0f * 2.0f - 1.0f;
}

struct Cols3 {
    const float* x;
    const float* y;
    const float* z;
};

struct OutCols3 {
    float* x;
    float* y;
    float* z;
};

__global__ void __launch_bounds__(256)
shade_kernel(const float* __restrict__ sh_slot, int n_slot,
             const int* __restrict__ slot, const float* __restrict__ t_in,
             const float* __restrict__ u_in, const float* __restrict__ v_in,
             Cols3 o_in, Cols3 d_in, Cols3 rc_in, Cols3 inc_in,
             const bool* __restrict__ alive_in,
             const long long* __restrict__ seed_in,
             const StepBlock* __restrict__ blk, OutCols3 o_out, OutCols3 d_out, OutCols3 rc_out,
             OutCols3 inc_out, bool* __restrict__ alive_out,
             long long* __restrict__ seed_out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int lam = blk->lambertian;
    const float em_scale = blk->em_scale;

    const uint32_t seed_old = (uint32_t)seed_in[i];
    uint32_t seed_new = seed_old;
    float xi[3];
    xi[0] = draw(seed_new);
    xi[1] = draw(seed_new);
    xi[2] = draw(seed_new);

    int s = slot[i];
    s = s < 0 ? 0 : (s > n_slot - 1 ? n_slot - 1 : s);
    const float* abc = sh_slot + (long long)s * 24;
    float m[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) m[k] = __ldg(abc + k);
    // material row (models/scene.py): n0 n1 | emission roughness | n2 |
    // face | pad pad | color | emission_color | pad pad
    const float emission = m[6];
    const float rough = m[7];

    const float t = t_in[i], u = u_in[i], v = v_in[i];
    const float o[3] = {o_in.x[i], o_in.y[i], o_in.z[i]};
    const float d[3] = {d_in.x[i], d_in.y[i], d_in.z[i]};
    const float rc[3] = {rc_in.x[i], rc_in.y[i], rc_in.z[i]};
    const float inc[3] = {inc_in.x[i], inc_in.y[i], inc_in.z[i]};
    const bool alive = alive_in[i];
    const bool did_hit = t < kBig;

    // --- finalize_hit (fragment.glsl:146-176) ---
    const float w = sub(sub(1.0f, u), v);
    float raw[3], face[3], normal[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        raw[a] = add(add(mul(m[a], w), mul(m[3 + a], u)), mul(m[8 + a], v));
        face[a] = m[11 + a];
    }
    const float raw_len = len3(raw);
    const bool ok_len = raw_len > 1e-20f;
    const float den_raw = fmaxf(raw_len, kTiny);
    const float den_face = fmaxf(len3(face), kTiny);
#pragma unroll
    for (int a = 0; a < 3; ++a) normal[a] = ok_len ? dvd(raw[a], den_raw) : dvd(face[a], den_face);
    if (dot3(d, normal) > 0.0f) {
#pragma unroll
        for (int a = 0; a < 3; ++a) normal[a] = -normal[a];
    }

    // --- scatter (fragment.glsl:220-240, :320) ---
    float diffuse[3], spec[3], out[3];
    if (lam) {  // normalize(normal + xi)
        float sv[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) sv[a] = add(normal[a], xi[a]);
        const float s_len = fmaxf(len3(sv), kTiny);
#pragma unroll
        for (int a = 0; a < 3; ++a) diffuse[a] = dvd(sv[a], s_len);
    } else {  // xi flipped into the normal's hemisphere
        float xh[3];
        const bool hflip = dot3(xi, normal) < 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) xh[a] = hflip ? -xi[a] : xi[a];
        const float h_len = fmaxf(len3(xh), kTiny);
#pragma unroll
        for (int a = 0; a < 3; ++a) diffuse[a] = dvd(xh[a], h_len);
    }
    const float d_dn = dot3(d, normal);
#pragma unroll
    for (int a = 0; a < 3; ++a) spec[a] = sub(d[a], mul(mul(2.0f, d_dn), normal[a]));
    const float dif_len = len3(diffuse);
    const float spec_len = len3(spec);
    const float tt = sub(1.0f, rough);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float g0 = dif_len > 0.0f ? dvd(diffuse[a], fmaxf(dif_len, kTiny)) : 0.0f;
        const float g1 = spec_len > 0.0f ? dvd(spec[a], fmaxf(spec_len, kTiny)) : 0.0f;
        out[a] = add(mul(g0, sub(1.0f, tt)), mul(g1, tt));
    }
    const float o_len = fmaxf(len3(out), kTiny);

    // --- bounce-state update (fragment.glsl:309-350) ---
    const bool was_hit = alive && did_hit;
    const bool was_miss = alive && !did_hit;
    const float em = mul(emission, em_scale);
    const float* sky = blk->sky;
    float r_inc[3], r_rc[3], r_o[3], r_d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        r_inc[a] = add(add(inc[a], was_hit ? mul(mul(m[19 + a], em), rc[a]) : 0.0f),
                       was_miss ? sky[a] : 0.0f);
        r_rc[a] = was_hit ? mul(rc[a], m[16 + a]) : rc[a];
        r_o[a] = was_hit ? add(add(o[a], mul(d[a], t)), mul(normal[a], 1e-4f)) : o[a];
        r_d[a] = was_hit ? dvd(out[a], o_len) : d[a];
    }
    o_out.x[i] = r_o[0];
    o_out.y[i] = r_o[1];
    o_out.z[i] = r_o[2];
    d_out.x[i] = r_d[0];
    d_out.y[i] = r_d[1];
    d_out.z[i] = r_d[2];
    rc_out.x[i] = r_rc[0];
    rc_out.y[i] = r_rc[1];
    rc_out.z[i] = r_rc[2];
    inc_out.x[i] = r_inc[0];
    inc_out.y[i] = r_inc[1];
    inc_out.z[i] = r_inc[2];
    seed_out[i] = (long long)(was_hit ? seed_new : seed_old);
    alive_out[i] = was_hit && !(emission > 0.0f);
}

}  // namespace

extern "C" int oglrt_shade(
    const float* sh_slot, int n_slot, const int* slot, const float* t,
    const float* u, const float* v, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* rc0, const float* rc1, const float* rc2, const float* in0,
    const float* in1, const float* in2, const bool* alive,
    const long long* seed, const void* blk, float* no0, float* no1,
    float* no2, float* nd0,
    float* nd1, float* nd2, float* nrc0, float* nrc1, float* nrc2,
    float* nin0, float* nin1, float* nin2, bool* alive_out,
    long long* seed_out, long long n, void* stream) {
    if (n > 0) {
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        shade_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            sh_slot, n_slot, slot, t, u, v, Cols3{ox, oy, oz},
            Cols3{dx, dy, dz}, Cols3{rc0, rc1, rc2}, Cols3{in0, in1, in2},
            alive, seed, (const StepBlock*)blk, OutCols3{no0, no1, no2}, OutCols3{nd0, nd1, nd2},
            OutCols3{nrc0, nrc1, nrc2}, OutCols3{nin0, nin1, nin2},
            alive_out, seed_out, n);
    }
    return (int)cudaGetLastError();
}
