// G7: the per-ray stackless BVH walk ("bvh"), for Hopper.
//
// Replaces the JAX package's raycast_bvh (opengl_raytracer_tpu/ops/
// traversal.py; an XLA while loop under jax.jit, not a Pallas kernel).  The
// port's plain version (ops/traversal.py:_walk_plain) steps every ray still
// walking once a loop iteration and asks the host after each whether one
// is left, a sync that a CUDA graph cannot hold; here one thread walks one
// ray to its end, so the step's graph can hold the traversal.
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
// A dead ray (active false) starts at t = -BIG, enters nothing and reports
// t = BIG.
//
// Bit for bit against the plain version ON THE CARD: every float operation
// is a round-to-nearest intrinsic in torch's order (1 / d is torch's
// reciprocal, an IEEE division), and the winner among equal t is the first
// tested, as the plain version's strict < keeps it.
//
// What bounds it on the card: operations, for any scene worth a BVH: some
// 25 a node visit and 46 a triangle test against a 28-byte ray in and 16
// bytes out, the node and triangle tables read through L1 and L2.  One
// thread a ray keeps the walk simple; its lanes diverge as rays take
// different paths, which is why "auto" never picks it (K1 and K3 walk
// 8-wide nodes).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

struct Tables {
    const float* node_min;  // (N, 3)
    const float* node_max;  // (N, 3)
    const int* node_miss;
    const int* node_first;
    const int* node_count;  // 0 for an inner node
    const float* v0;  // (T, 3) each
    const float* e1;
    const float* e2;
    const float* face;
    int n_nodes;
    int max_leaf;
};

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

__global__ void __launch_bounds__(128)
bvh_walk_kernel(Rays r, Tables s, Out out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float o[3], d[3], inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        o[a] = r.o[a][i];
        d[a] = r.d[a][i];
        inv[a] = __fdiv_rn(1.0f, d[a]);
    }
    const bool live = r.active == nullptr || r.active[i];
    float bt = live ? kBig : -kBig, bu = 0.0f, bv = 0.0f;
    int btri = 0;
    int node = 0;
    while (node < s.n_nodes) {
        bool nan = false;
        float near = 0.0f, far = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float lo = mul(sub(__ldg(s.node_min + node * 3 + a), o[a]), inv[a]);
            const float hi = mul(sub(__ldg(s.node_max + node * 3 + a), o[a]), inv[a]);
            nan |= (lo != lo) || (hi != hi);
            const float mn = fminf(lo, hi), mx = fmaxf(lo, hi);
            near = a == 0 ? mn : fmaxf(near, mn);
            far = a == 0 ? mx : fminf(far, mx);
        }
        const bool hit = !nan && far >= near && far >= 0.0f;
        const bool entered = hit && fmaxf(near, 0.0f) <= bt;
        const int count = __ldg(s.node_count + node);
        if (entered && count > 0) {
            const int first = __ldg(s.node_first + node);
            const int m = count < s.max_leaf ? count : s.max_leaf;
            for (int k = 0; k < m; ++k) {
                const int q = (first + k) * 3;
                const float* v0 = s.v0 + q;
                const float* e1 = s.e1 + q;
                const float* e2 = s.e2 + q;
                const float* f = s.face + q;
                const float det = dot3(d[0], d[1], d[2], f[0], f[1], f[2]);
                const float inv_det = __fdiv_rn(1.0f, det);
                const float rx = sub(o[0], v0[0]), ry = sub(o[1], v0[1]),
                            rz = sub(o[2], v0[2]);
                const float t = mul(-dot3(rx, ry, rz, f[0], f[1], f[2]), inv_det);
                const float px = sub(mul(ry, d[2]), mul(rz, d[1]));
                const float py = sub(mul(rz, d[0]), mul(rx, d[2]));
                const float pz = sub(mul(rx, d[1]), mul(ry, d[0]));
                const float u = mul(-dot3(e2[0], e2[1], e2[2], px, py, pz), inv_det);
                const float v = mul(dot3(e1[0], e1[1], e1[2], px, py, pz), inv_det);
                const bool valid = fabsf(det) >= kEps && t > kEps && u >= 0.0f
                                   && v >= 0.0f && add(u, v) <= 1.0f;
                if (valid && t < bt) {  // strict <, fragment.glsl:275
                    bt = t;
                    btri = first + k;
                    bu = u;
                    bv = v;
                }
            }
        }
        node = (entered && count <= 0) ? node + 1 : __ldg(s.node_miss + node);
    }
    out.t[i] = r.active != nullptr && !live ? kBig : bt;
    out.tri[i] = btri;
    out.u[i] = bu;
    out.v[i] = bv;
}

}  // namespace

// o*, d*: (n,) float32 columns; active may be null; the tables as
// SceneData holds them.
extern "C" int oglrt_bvh_walk(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const bool* active, const float* node_min,
                              const float* node_max, const int* node_miss,
                              const int* node_first, const int* node_count,
                              int n_nodes, const float* v0, const float* e1,
                              const float* e2, const float* face, int max_leaf,
                              float* t, int* tri, float* u, float* v,
                              long long n, void* stream) {
    if (n > 0) {
        const Rays r{{ox, oy, oz}, {dx, dy, dz}, active};
        const Tables s{node_min, node_max, node_miss, node_first, node_count,
                       v0, e1, e2, face, n_nodes, max_leaf};
        const long long grid = (n + 127) / 128;
        bvh_walk_kernel<<<(unsigned)grid, 128, 0, (cudaStream_t)stream>>>(
            r, s, Out{t, tri, u, v}, n);
    }
    return (int)cudaGetLastError();
}
