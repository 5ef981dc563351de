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
// Bit for bit against the plain version ON THE CARD: the records, their
// loads and the float operations are bvh_walk.cuh's, shared with G9, and
// the winner among equal t is the first tested, as the plain version's
// strict < keeps it.  Each ray visits and tests in the layout's miss-link
// preorder, so the winner at an exact-t tie is the plain version's.
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

#include "bvh_walk.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;

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
            const Node nd = load_node<kWide>(nodes, node);
            const bool entered = enters(nd, o, inv, bt);
            if (entered && nd.count > 0) {
                leaf_first = nd.first;
                leaf_m = nd.count < max_leaf ? nd.count : max_leaf;
            }
            node = (entered && nd.count <= 0) ? node + 1 : nd.miss;
        }
        // Test the held leaves once every lane holds one or is done.
        if (__all_sync(kFull, leaf_m > 0 || node >= n_nodes)) {
            for (int k = 0; k < leaf_m; ++k)
                test_triangle(tris, leaf_first + k, o, d, bt, btri, bu, bv);
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
