// G7: the per-ray stackless BVH walk ("bvh"), for Hopper.
//
// Replaces the JAX package's raycast_bvh (opengl_raytracer_tpu/ops/
// traversal.py:56; an XLA while loop under jax.jit, not a Pallas kernel).
// The port's plain version (ops/traversal.py:_walk_plain) steps every ray
// still walking once a loop iteration and asks the host after each whether
// one is left, a sync that a CUDA graph cannot hold; here one thread walks
// one ray to its end, so the step's graph can hold the traversal.
//
// The walk, as the plain version's: the binary BVH in DFS preorder with
// miss links (ops/bvh.py).  At each node the slab test with the unclamped
// 1 / d, (box - o) * inv, a NaN in any of the six slab values (an
// axis-parallel ray on a slab plane) keeping the box closed, as torch's
// minimum and amax propagate it; the box is entered iff far >= near, far >=
// 0 and max(near, 0) <= the nearest hit so far.  An entered leaf tests its
// first min(count, max_leaf) triangles by Moller-Trumbore with a strict <
// one after another, then the walk follows the miss link; an entered inner
// node steps to its first child (node + 1), a missed node to its miss link.
// A dead ray (active false) enters nothing and reports t = BIG.
//
// Bit for bit against the plain version ON THE CARD: every float operation
// is a round-to-nearest intrinsic in torch's order (1 / d is torch's
// reciprocal, an IEEE division), and the winner among equal t is the first
// tested, as the plain version's strict < keeps it.  Each ray visits and
// tests in the layout's miss-link preorder, so the winner at an exact-t tie
// is the plain version's.
//
// What bounds it on the card: operations (some 25 a node visit, 46 a full
// triangle test) against a 28-byte ray in and 16 bytes out; the tables are
// read through L1 and L2.  What the design does about it:
// - records (ops/traversal.py:node_records, ops/intersect.py:tri_records):
//   a node is 32 bytes (min xyz, miss; max xyz, first + 1 | count << 21) or
//   48 where those do not fit, a triangle 48 (v0, e1, e2, face); each is
//   read with 16-byte __ldg loads, not 9 or 12 scalar loads from four or
//   five tables;
// - while-while (Aila and Laine 2009, "Understanding the Efficiency of Ray
//   Traversal on GPUs"): a lane that enters a leaf holds it and waits until
//   every lane of its warp holds one or is done, then the warp tests its
//   leaves together, so node steps and triangle tests do not interleave
//   across a warp's lanes; a lane never steps past a held leaf, so the
//   per-ray order above is kept;
// - a triangle's u and v are computed only where t would win (|det| >= EPS
//   and EPS < t < the nearest hit), which decides the same accepts.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

struct Rays {
    const float* o[3];
    const float* d[3];
    const bool* active;  // may be null
};

struct Out {
    float* t;
    int* tri;
    float* u;
    float* v;
};

// kWide: 48-byte node records (first and count whole), else 32-byte ones.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(Rays r, const int4* __restrict__ nodes, int n_nodes,
                const float4* __restrict__ tris, int max_leaf, Out out,
                long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_range = i < n;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f}, inv[3];
    if (in_range) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            o[a] = r.o[a][i];
            d[a] = r.d[a][i];
        }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) inv[a] = __fdiv_rn(1.0f, d[a]);
    const bool live = in_range && (r.active == nullptr || r.active[i]);
    float bt = kBig, bu = 0.0f, bv = 0.0f;
    int btri = 0;
    // Every lane of a warp stays in the loop until the warp is done: the
    // votes need them all.  node >= n_nodes: this lane is done.
    int node = live ? 0 : n_nodes;
    int leaf_first = 0, leaf_m = 0;  // a held leaf: leaf_m > 0
    while (__any_sync(kFull, node < n_nodes || leaf_m > 0)) {
        if (leaf_m == 0 && node < n_nodes) {
            const int4* rec = nodes + (long long)node * (kWide ? 3 : 2);
            const int4 a = __ldg(rec), b = __ldg(rec + 1);
            const float lo[3] = {__int_as_float(a.x), __int_as_float(a.y),
                                 __int_as_float(a.z)};
            const float hi[3] = {__int_as_float(b.x), __int_as_float(b.y),
                                 __int_as_float(b.z)};
            int first, count;
            if (kWide) {
                const int4 c = __ldg(rec + 2);
                first = b.w;
                count = c.x;
            } else {
                first = (b.w & ((1 << 21) - 1)) - 1;
                count = (int)((unsigned)b.w >> 21);
            }
            bool nan = false;
            float near = 0.0f, far = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float l = mul(sub(lo[k], o[k]), inv[k]);
                const float h = mul(sub(hi[k], o[k]), inv[k]);
                nan |= (l != l) || (h != h);
                const float mn = fminf(l, h), mx = fmaxf(l, h);
                near = k == 0 ? mn : fmaxf(near, mn);
                far = k == 0 ? mx : fminf(far, mx);
            }
            const bool hit = !nan && far >= near && far >= 0.0f;
            const bool entered = hit && fmaxf(near, 0.0f) <= bt;
            if (entered && count > 0) {
                leaf_first = first;
                leaf_m = count < max_leaf ? count : max_leaf;
            }
            node = (entered && count <= 0) ? node + 1 : a.w;
        }
        // Test the held leaves once every lane holds one or is done.
        if (__all_sync(kFull, leaf_m > 0 || node >= n_nodes)) {
            for (int k = 0; k < leaf_m; ++k) {
                const float4* q = tris + (long long)(leaf_first + k) * 3;
                const float4 x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
                // v0 = x.xyz, e1 = (x.w, y.x, y.y), e2 = (y.z, y.w, z.x),
                // face = z.yzw
                const float det = dot3(d[0], d[1], d[2], z.y, z.z, z.w);
                const float inv_det = __fdiv_rn(1.0f, det);
                const float rx = sub(o[0], x.x), ry = sub(o[1], x.y),
                            rz = sub(o[2], x.z);
                const float t = mul(-dot3(rx, ry, rz, z.y, z.z, z.w), inv_det);
                if (fabsf(det) >= kEps && t > kEps && t < bt) {
                    const float px = sub(mul(ry, d[2]), mul(rz, d[1]));
                    const float py = sub(mul(rz, d[0]), mul(rx, d[2]));
                    const float pz = sub(mul(rx, d[1]), mul(ry, d[0]));
                    const float u = mul(-dot3(y.z, y.w, z.x, px, py, pz),
                                        inv_det);
                    const float v = mul(dot3(x.w, y.x, y.y, px, py, pz),
                                        inv_det);
                    if (u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f) {
                        bt = t;  // strict <, fragment.glsl:275
                        btri = leaf_first + k;
                        bu = u;
                        bv = v;
                    }
                }
            }
            leaf_m = 0;
        }
    }
    if (in_range) {
        out.t[i] = bt;
        out.tri[i] = btri;
        out.u[i] = bu;
        out.v[i] = bv;
    }
}

}  // namespace

// o*, d*: (n,) float32 columns; active may be null; nodes: (n_nodes, 8)
// int32 records, or (n_nodes, 12) with wide; tris: (T, 12) float32
// records.
extern "C" int oglrt_bvh_walk(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const bool* active, const int* nodes, int wide,
                              int n_nodes, const float* tris, int max_leaf,
                              float* t, int* tri, float* u, float* v,
                              long long n, void* stream) {
    if (n > 0) {
        const Rays r{{ox, oy, oz}, {dx, dy, dz}, active};
        const Out o{t, tri, u, v};
        const long long grid = (n + kThreads - 1) / kThreads;
        const auto* nd = reinterpret_cast<const int4*>(nodes);
        const auto* tr = reinterpret_cast<const float4*>(tris);
        if (wide)
            bvh_walk_kernel<true><<<(unsigned)grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
                r, nd, n_nodes, tr, max_leaf, o, n);
        else
            bvh_walk_kernel<false><<<(unsigned)grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
                r, nd, n_nodes, tr, max_leaf, o, n);
    }
    return (int)cudaGetLastError();
}
