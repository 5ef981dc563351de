// K1: nearest-hit BVH traversal over the sub-block tables, for Hopper.
//
// Replaces the Pallas kernel `_traverse_kernel` of
// opengl_raytracer_tpu/ops/subblock_traversal.py (launched by
// `_raycast_one_part`, wrapped by `raycast_subblock`).  That kernel's 64-row
// packet pool, one-hot stacks and scalar round trips answer the TPU's vector
// memory and its lack of dynamic lane indexing; here each thread walks one
// ray with a private stack, over the SAME tables (ops/wide2.py), so the two
// packages can be compared ray by ray.
//
// Tables (row-major, 128 floats per row):
//   node_rows[w]: child j's [min.xyz, max.xyz] at [j*6, j*6+6); at
//     [48 + oct*8 + k] the far-first push order for octant `oct`, packed as
//     exact-integer floats entry*8 + j.  entry >= 0 is a wide node,
//     -q-1 is leaf octet q, EMPTY_PACKED an empty slot.
//   tri_rows[q]: triangle j at [j*16, j*16+12) as v0, e1, e2, face.
//
// Semantics kept from the Pallas kernel:
//   * inverses 1/d clamped to +-1e18; slab as b*inv - o*inv; a child is
//     opened iff far >= near && far >= 0 && near <= best_t;
//   * children are pushed far-first so that they pop near-first.  The order
//     comes from THIS ray's octant (sign bits of d); the Pallas kernel uses
//     its packet's dominant octant, which changes only which slot wins at
//     an exact t tie;
//   * EPS Moller-Trumbore with t = -(r.face)/det and a strict < update;
//     slot = q*8 + j;
//   * a dead ray enters with t0 = -BIG and can neither open nodes nor
//     accept hits (it exits at once here).
// A push that would pass the stack's end is counted into `overflow` (the
// Pallas kernel drops such pushes silently).  The wide-depth cap of
// ops/wide2.py (max_depth <= 15) keeps a single stack under
// (max_depth + 1) * 7 + 1 <= 113 entries, so the count stays 0 for every
// scene the builder accepts.
//
// The arithmetic is written with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts into FMAs,
// in the order of the plain torch version (ops/subblock_traversal.py), so
// the kernel reproduces that version bit for bit.  (The Pallas kernel, run
// by XLA, contracts; against it t agrees to contraction rounding.)
//
// What bounds it on the card: dependent loads of 512-byte node rows and
// 384-byte leaf octets (the tables stay in L2), and warp divergence when
// the 32 rays of a warp walk different subtrees - not FLOPs.  This first
// version keeps one ray per thread with the stack in local memory; the
// reorder sort in the integrator makes neighbouring threads' rays coherent.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;
constexpr int kOrd0 = 48;
constexpr int kEmpty = -(1 << 20);
constexpr int kStack = 128;
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;
constexpr float kInvClamp = 1e18f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const float* __restrict__ t0,
                const float* __restrict__ node_rows,
                const float* __restrict__ tri_rows,
                float* __restrict__ t_out, int* __restrict__ slot_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ overflow, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float bt = t0[i];
    int bslot = 0;
    float bu = 0.0f, bv = 0.0f;

    if (bt > -kBig) {
        const float o0 = ox[i], o1 = oy[i], o2 = oz[i];
        const float d0 = dx[i], d1 = dy[i], d2 = dz[i];
        const float inv0 = fminf(fmaxf(__fdiv_rn(1.0f, d0), -kInvClamp), kInvClamp);
        const float inv1 = fminf(fmaxf(__fdiv_rn(1.0f, d1), -kInvClamp), kInvClamp);
        const float inv2 = fminf(fmaxf(__fdiv_rn(1.0f, d2), -kInvClamp), kInvClamp);
        const float oi0 = mul(o0, inv0), oi1 = mul(o1, inv1), oi2 = mul(o2, inv2);
        const int oct = ((d0 < 0.0f) << 2) | ((d1 < 0.0f) << 1) | (d2 < 0.0f);

        int stack[kStack];
        int sp = 0;
        stack[sp++] = 0;  // the root wide node
        int dropped = 0;

        while (sp > 0) {
            const int e = stack[--sp];
            if (e >= 0) {
                const float* row = node_rows + (long long)e * kRow;
                const float* ord = row + kOrd0 + oct * 8;
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int pk = (int)__ldg(ord + k);
                    const int ent = pk >> 3;
                    if (ent == kEmpty) continue;
                    const float* b = row + (pk & 7) * 6;
                    const float t1x = sub(mul(__ldg(b + 0), inv0), oi0);
                    const float t1y = sub(mul(__ldg(b + 1), inv1), oi1);
                    const float t1z = sub(mul(__ldg(b + 2), inv2), oi2);
                    const float t2x = sub(mul(__ldg(b + 3), inv0), oi0);
                    const float t2y = sub(mul(__ldg(b + 4), inv1), oi1);
                    const float t2z = sub(mul(__ldg(b + 5), inv2), oi2);
                    const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                             fminf(t1z, t2z));
                    const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                            fmaxf(t1z, t2z));
                    if (far >= near && far >= 0.0f && near <= bt) {
                        if (sp < kStack) {
                            stack[sp++] = ent;
                        } else {
                            ++dropped;
                        }
                    }
                }
            } else {
                const int q = -e - 1;
                const float* row = tri_rows + (long long)q * kRow;
#pragma unroll 2
                for (int j = 0; j < 8; ++j) {
                    const float* c = row + j * 16;
                    const float v0x = __ldg(c + 0), v0y = __ldg(c + 1), v0z = __ldg(c + 2);
                    const float e1x = __ldg(c + 3), e1y = __ldg(c + 4), e1z = __ldg(c + 5);
                    const float e2x = __ldg(c + 6), e2y = __ldg(c + 7), e2z = __ldg(c + 8);
                    const float fx = __ldg(c + 9), fy = __ldg(c + 10), fz = __ldg(c + 11);
                    const float det = dot3(d0, d1, d2, fx, fy, fz);
                    const float inv_det = __fdiv_rn(1.0f, det);
                    const float rx = sub(o0, v0x), ry = sub(o1, v0y), rz = sub(o2, v0z);
                    const float t = mul(-dot3(rx, ry, rz, fx, fy, fz), inv_det);
                    const float px = sub(mul(ry, d2), mul(rz, d1));
                    const float py = sub(mul(rz, d0), mul(rx, d2));
                    const float pz = sub(mul(rx, d1), mul(ry, d0));
                    const float u = mul(-dot3(e2x, e2y, e2z, px, py, pz), inv_det);
                    const float v = mul(dot3(e1x, e1y, e1z, px, py, pz), inv_det);
                    const bool valid = fabsf(det) >= kEps && t > kEps && u >= 0.0f &&
                                       v >= 0.0f && add(u, v) <= 1.0f;
                    if (valid && t < bt) {  // strict <, fragment.glsl:275
                        bt = t;
                        bslot = q * 8 + j;
                        bu = u;
                        bv = v;
                    }
                }
            }
        }
        if (dropped) atomicAdd(overflow, dropped);
    }
    t_out[i] = bt;
    slot_out[i] = bslot;
    u_out[i] = bu;
    v_out[i] = bv;
}

}  // namespace

extern "C" int oglrt_subblock_traverse(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t0, const float* node_rows,
    const float* tri_rows, float* t_out, int* slot_out, float* u_out,
    float* v_out, int* overflow, long long n, void* stream) {
    if (n > 0) {
        const int block = 128;
        const long long grid = (n + block - 1) / block;
        traverse_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            ox, oy, oz, dx, dy, dz, t0, node_rows, tri_rows, t_out, slot_out,
            u_out, v_out, overflow, n);
    }
    return (int)cudaGetLastError();
}
