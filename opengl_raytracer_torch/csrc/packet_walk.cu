// G9: the packet walk ("packet"), for Hopper.
//
// Replaces the JAX package's raycast_packet (opengl_raytracer_tpu/ops/
// traversal.py:121; an XLA while loop under jax.jit over [P, 128] arrays,
// not a Pallas kernel).  The port's plain version (ops/traversal.py:
// _packet_plain) steps every packet still walking once a loop iteration
// and asks the host after each whether one is left, a sync that a CUDA
// graph cannot hold; here one 128-thread block walks one packet to its
// end, so the step's graph can hold the traversal.
//
// The walk, as the JAX package's: rays g = 128 p .. 128 p + 127 form
// packet p and share ONE node pointer over the binary BVH in DFS preorder
// with miss links (ops/bvh.py).  At each node every ray runs G7's slab test
// against its own nearest hit; the node is opened when any ray of the
// packet enters it (__syncthreads_or).  An opened leaf: every
// ray tests its first min(count, max_leaf) triangles by Moller-Trumbore
// with a strict <, one after another, then the packet follows the miss
// link; an opened inner node steps to its first child (node + 1), a node
// no ray enters to its miss link.  A dead ray (active false) starts at
// best t = -BIG, so it opens nothing and accepts nothing, and reports
// t = BIG; a packet with no live ray is done at once.  A ray meets the
// leaves the packet opens in the same preorder its own walk would, with a
// nearest hit no farther at each, so its nearest t is the per-ray walk's
// (the winner at an exact-t tie may differ) wherever its own slab tests
// are conservative.  A ray in a box's face plane (a NaN slab value) opens
// nothing itself but tests the leaves its packet opens, so it may hit
// where the per-ray walk misses, as in the JAX package.
//
// Bit for bit against the plain version ON THE CARD: the records, their
// 16-byte __ldg loads and the float operations are G7's (bvh_walk.cuh),
// and a ray tests the packet's leaves in the packet's order, as the plain
// version does.
//
// What bounds it on the card: operations (some 26 a node and a live ray,
// 20 a triangle test's t side and a live ray, 26 more a candidate) against
// a 28-byte ray in and 16 bytes out; the records are read through L1 and
// L2.  The walk is a chain of dependent steps a packet (load a node, test
// it, decide, go on), so its time is the chain's latency as much as its
// issue.  What the design does about it:
// - one ray a thread, a 128-thread block a packet: a visit's slab tests
//   run on the block's four warps at once (four schedulers), and the open
//   decision is one __syncthreads_or.  One warp a packet at four rays a
//   lane runs each visit's and each slot test's four rays on one
//   scheduler, and measured slower on the H100 (PERF.md, section 6);
// - an opened leaf's triangle records are staged into shared memory, a
//   record a thread (three 16-byte loads), so each warp reads them there
//   instead of waiting on L1 or L2 once a triangle; the next visit's
//   barrier orders the block's reads of one leaf before the next leaf's
//   writes, so staging adds one barrier a leaf;
// - the node pointer is uniform across the block, so a visit's control
//   flow has no divergence; its price is the nodes that only some of its
//   rays need: the packet's visits times its live rays over their own
//   visits (the waste that chip_smoke.py prints);
// - the IEEE division of a triangle test runs whatever the sign of t
//   (bvh_walk.cuh:hit_test<false>): the sign test G7 runs measured slower
//   here, where a warp's 32 rays rarely all skip it (PERF.md, section 6);
//   u and v are computed only where t would win.

#include "bvh_walk.cuh"

namespace {

constexpr int kPacket = 128;  // rays a packet, threads a block

template <bool kWide>
__global__ void __launch_bounds__(kPacket)
packet_walk_kernel(Rays r, const int4* __restrict__ nodes, int n_nodes,
                   const float4* __restrict__ tris, int max_leaf, Out out) {
    __shared__ Tri leaf[kPacket];  // an opened leaf's records
    const long long i = (long long)blockIdx.x * kPacket + threadIdx.x;
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
    // the packet's node pointer: the same in every thread of the block
    int node = __syncthreads_or(live) ? 0 : n_nodes;
    while (node < n_nodes) {
        const Node nd = load_node<kWide>(nodes, node);
        const bool open = __syncthreads_or(enters(nd, o, inv, bt));
        if (open && nd.count > 0) {
            const int m = nd.count < max_leaf ? nd.count : max_leaf;
            for (int b = 0; b < m; b += kPacket) {
                if (b > 0) __syncthreads();  // the last chunk is read
                const int c = m - b < kPacket ? m - b : kPacket;
                if ((int)threadIdx.x < c)
                    leaf[threadIdx.x] =
                        load_tri(tris, nd.first + b + threadIdx.x);
                __syncthreads();
                for (int k = 0; k < c; ++k)
                    hit_test<false>(leaf[k], nd.first + b + k, o, d, bt,
                                    btri, bu, bv);
            }
            node = nd.miss;
        } else {
            node = open ? node + 1 : nd.miss;
        }
    }
    out.t[i] = live ? bt : kBig;
    out.tri[i] = btri;
    out.u[i] = bu;
    out.v[i] = bv;
}

}  // namespace

// o*, d*: (n,) float32 columns, n a multiple of 128; active may be null;
// nodes: (n_nodes, 8) int32 records, or (n_nodes, 12) with wide; tris:
// (T, 12) float32 records.
extern "C" int oglrt_packet_walk(const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const bool* active, const int* nodes,
                                 int wide, int n_nodes, const float* tris,
                                 int max_leaf, float* t, int* tri, float* u,
                                 float* v, long long n, void* stream) {
    if (n % kPacket) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const Rays r{{ox, oy, oz}, {dx, dy, dz}, active};
        const Out o{t, tri, u, v};
        const unsigned grid = (unsigned)(n / kPacket);
        const auto* nd = reinterpret_cast<const int4*>(nodes);
        const auto* tr = reinterpret_cast<const float4*>(tris);
        if (wide)
            packet_walk_kernel<true><<<grid, kPacket, 0,
                                       (cudaStream_t)stream>>>(
                r, nd, n_nodes, tr, max_leaf, o);
        else
            packet_walk_kernel<false><<<grid, kPacket, 0,
                                        (cudaStream_t)stream>>>(
                r, nd, n_nodes, tr, max_leaf, o);
    }
    return (int)cudaGetLastError();
}
