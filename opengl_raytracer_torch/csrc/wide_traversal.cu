// K3: nearest-hit traversal over the 8-wide BVH, for Hopper.
//
// Replaces the Pallas kernel `_traverse_kernel` of
// opengl_raytracer_tpu/ops/pallas_traversal.py:69 (launched at :295 by
// `raycast_pallas`).  That kernel marries 1024 rays to one node pointer and
// an SMEM stack, selects node and octet records with arithmetic one-hot
// blends and folds the children's hit flags into a scalar bitmask: answers
// to Mosaic's (8, 128) vector tiles and its lack of dynamic lane indexing.
// Here each thread walks one ray over the SAME tree, read in a Hopper
// layout packed from the TPU tiles at upload (ops/wide_bvh.pack_k3; the
// plain torch version, ops/pallas_traversal.py, reads the tiles
// themselves), so the two packages can be compared ray by ray:
//   nodes[w]  (64 words, 256 B): the 8 child boxes as structure of arrays
//     lo.x[8] lo.y[8] lo.z[8] hi.x[8] hi.y[8] hi.z[8] (f32), the 8 child
//     entries (i32: >= 0 a wide node, -(q << 10 | (n - 1)) - 1 the leaf of
//     n triangles starting at octet q, EMPTY_PACKED none), and per octant
//     one word: the near-first slot order, 3 bits a rank, under the mask
//     of the non-empty slots (bits 24-31);
//   octets[q] (96 floats, 384 B): triangle j's v0, face, e1, e2 at 12j.
//
// What bounds it on this card.  Not bytes: a launch moves 44 B a ray, and
// the tables of a scene of a few ten thousand triangles sit in the 50 MB
// L2.  On a scene of two million triangles they do not (about 115 MB in
// this layout), so an octet read may go to HBM.  The fp32 work is small
// too (some thousands of operations a ray, a bound of about a tenth of a
// millisecond a 2M-ray launch).  What the walk pays for is the latency of
// the loads it chains (entry -> node -> child -> octet), and, above all,
// the leaf side: a leaf of up to 32 triangles tests up to four octets,
// where the sub-block kernel (K1) tests one.  The design:
//   * a stack of node groups, one 32-bit entry per open node: the node
//     and the mask of its children still to visit, by near-first rank in
//     this ray's octant.  A visit pushes at most one group, so at most
//     max_depth + 1 are open (one per node on the path from the root).
//     The top group lives in registers, the rest in this thread's column
//     of shared memory (stride = block size: no bank conflicts).  The
//     column is compiled for 16 groups and for 71 (the deepest tree the
//     wide builder accepts, max_depth 70: its MAX_STACK of 512 entries);
//     the wrapper picks the smaller that holds the scene's depth.  No
//     register array is indexed at run time, so no local memory is used;
//   * 16-byte loads: 12 and the octant's word for a node visit, all issued
//     before the first use, then one word, the entry of the child it
//     enters; two for a triangle's t and a third for its edges.  The visit
//     holds no entries in registers (the word's mask closes empty slots),
//     so ptxas fits it in 80 registers (six blocks of four warps an SM)
//     without spilling.  The walk is latency-bound, so warps per SM
//     matter: on the H100 a build at 96 registers (five blocks) ran slower
//     than one at 80 that spilled 24 bytes, and a minBlocks hint of 6 in
//     __launch_bounds__ gave the same 80 registers but a slower walk.
//     A dropped group is counted in a register and added to `overflow`
//     once: an atomic at the push itself, though never executed, made the
//     walk much slower;
//   * a two-phase loop (Aila and Laine's while-while, HPG 2009): nodes
//     until the next entry is a leaf, then leaves until the next entry is
//     a node, so a warp's lanes run like bodies together.  A leaf tests
//     its own n triangles, slots 8q .. 8q + n - 1, one after another: the
//     count rides in the entry the visit already loaded, so it costs no
//     load of its own;
//   * a triangle's test stops at |det| < EPS or at a t that cannot be
//     accepted (t <= EPS or t >= best_t), before its edges are loaded.
//
// Semantics kept from the Pallas kernel (pallas_traversal.py lines), and
// from the plain version bit for bit:
//   * the slab test with the UNCLAMPED inverse 1/d, as (b - o) * inv
//     (:76, :123-134).  An axis-parallel ray whose origin lies on a slab
//     plane makes 0 * inf = NaN, which jnp.minimum/maximum (and torch's)
//     propagate, so that child is not opened.  Here min and max are the
//     plain fminf/fmaxf, which drop a NaN, plus one test: a child whose six
//     slab values hold a NaN stays closed.  Without a NaN both forms give
//     the same near and far; with one, the propagating form's near or far
//     is NaN and `far >= near` fails.  Only a ray with a non-finite origin
//     or inverse can make a NaN, so the test runs for those rays alone.
//     A child is opened iff far >= near && far >= 0 && max(near, 0) <=
//     best_t (:135-138), tested when its parent is visited;
//   * empty child slots hold finite swapped boxes that pass the slab test;
//     only their EMPTY_PACKED entry keeps them closed (:160-166), here
//     through the order word's mask, packed from the entries;
//   * the Pallas kernel tests a fixed ceil(max_leaf / 8) octets from a
//     leaf's first one, reading into neighbouring leaves' real triangles
//     (:182-184), because its tiles hold only the first octet.  Here a leaf
//     tests exactly its own triangles, counted from the scene's node_count.
//     That leaves the nearest hit as it is: every triangle a ray can hit is
//     tested in its own leaf, whose box holds the hit point; only the slot
//     that wins an exact t tie between two triangles can differ;
//   * within an octet the Pallas kernel takes the least t, the lowest slot
//     among equal t, and across octets a strict < (:216-223).  That is one
//     sequential strict < over the octet's slots in increasing order,
//     starting from the best t: the first slot reaching the least t wins
//     in both, and neither updates unless that t beats the best.  So the
//     triangles are tested one after another, and the edge test of one
//     whose t does not beat the running best is skipped;
//   * children are visited near-first in the order of THIS ray's octant: a
//     group pops its lowest remaining rank, the order in which the plain
//     version's far-first pushes pop.  The Pallas kernel takes its block's
//     dominant octant (:93-97), which changes only which slot wins at an
//     exact t tie, and opens a node for its whole block when any of its
//     rays opens it (:140-146), so a ray lying in a box's face plane (a
//     NaN slab) can miss here where the Pallas kernel hits;
//   * a dead ray enters with t0 = -BIG and leaves at once with t = -BIG.
// The arithmetic is written with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts into FMAs,
// in the order of the plain version, so t, slot, u and v are its values
// bit for bit.  A group push past the shared column is counted into
// `overflow`.
//
// Built with -DOGLRT_K3_PROFILE (opengl_raytracer_torch/probes/k3.py), the
// same source exports instead `oglrt_wide_traverse_profile`: the same walk
// with clock64() sums per stage (group pop, node fetch, slab tests, group
// push, octet fetch, triangle tests) and event counts (per leaf entry its
// octets, ceil(n / 8), and its n triangles tested), reduced per warp, and
// each leaf entry counted by its first octet; and
// `oglrt_k3_octet_fetch`, which reads chosen octets through this file's
// own triangle loads and writes them back in the TPU tiles' lane order.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kDone = INT_MIN;
constexpr int kCountBits = 10;  // a leaf entry: first octet, count - 1
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// Triangle j of an octet: v0.xyz + face.x, face.yz + e1.xy (its t needs
// only these two), and e1.z + e2.xyz (its barycentrics).
__device__ __forceinline__ void load_tri_t(const float4* __restrict__ ob, int j,
                                           float4& a, float4& b) {
    a = __ldg(ob + 3 * j);
    b = __ldg(ob + 3 * j + 1);
}
__device__ __forceinline__ float4 load_tri_edges(const float4* __restrict__ ob,
                                                 int j) {
    return __ldg(ob + 3 * j + 2);
}

#ifdef OGLRT_K3_PROFILE
enum { kPop, kNodeFetch, kSlab, kPush, kOctetFetch, kTriangles, kStages };
enum { kVisits, kLeaves, kOctets, kCandidates, kGroupPushes, kGroupPops,
       kSmemPushes, kSmemPops, kSlots, kCounts };
struct Prof {
    unsigned long long cyc[kStages];
    unsigned long long cnt[kCounts];
    unsigned sink;
    int* leaf_hist;
};
#define PROF_PARAM , Prof& prof
#define PROF_PASS , prof
#define PROF_T(name) const long long name = clock64()
#define PROF_ADD(stage, t) prof.cyc[stage] += (unsigned long long)(clock64() - (t))
#define PROF_CNT(c) ++prof.cnt[c]
#define PROF_CNTN(c, k) prof.cnt[c] += (unsigned long long)(k)
#define PROF_SINK(x) prof.sink ^= (x)
#define PROF_LEAF(first) atomicAdd(prof.leaf_hist + (first), 1)
#else
#define PROF_PARAM
#define PROF_PASS
#define PROF_T(name)
#define PROF_ADD(stage, t)
#define PROF_CNT(c)
#define PROF_CNTN(c, k)
#define PROF_SINK(x)
#define PROF_LEAF(first)
#endif

// Entry of slot s (0-7) of a node's two entry vectors, without indexing a
// register array (which would go to local memory).
__device__ __forceinline__ int pick(const int4& a, const int4& b, unsigned s) {
    const int lo = (s & 2) ? ((s & 1) ? a.w : a.z) : ((s & 1) ? a.y : a.x);
    const int hi = (s & 2) ? ((s & 1) ? b.w : b.z) : ((s & 1) ? b.y : b.x);
    return (s & 4) ? hi : lo;
}

// The open node groups of one ray: `top` in registers (node << 8 | mask of
// near-first ranks still to visit; 0 = none), older ones in the thread's
// shared-memory column of kCol entries.
template <int kCol>
struct Groups {
    unsigned top;
    int sp;
    int dropped;
    unsigned* col;

    __device__ __forceinline__ void push(unsigned g PROF_PARAM) {
        PROF_T(t);
        PROF_CNT(kGroupPushes);
        if (top) {
            if (sp < kCol) {
                col[sp++ * kBlock] = top;
                PROF_CNT(kSmemPushes);
            } else {
                ++dropped;  // the group is lost, and counted
            }
        }
        top = g;
        PROF_ADD(kPush, t);
    }

    // The next entry to visit: the nearest child still open in the top
    // group, or kDone when no group is open.
    __device__ __forceinline__ int pop(const int4* __restrict__ nodes, int oct
                                       PROF_PARAM) {
        if (!top) return kDone;
        PROF_T(t);
        const unsigned w = top >> 8;
        unsigned m = top & 0xFFu;
        const int4* nb = nodes + (size_t)w * 16;
        const int4 e0 = __ldg(nb + 12), e1 = __ldg(nb + 13);
        const unsigned ord = __ldg(reinterpret_cast<const unsigned*>(nb) + 56 + oct);
        const unsigned r = __ffs(m) - 1;
        const int child = pick(e0, e1, (ord >> (3 * r)) & 7u);
        m &= m - 1;
        if (m) {
            top = (w << 8) | m;
        } else if (sp) {
            top = col[--sp * kBlock];
            PROF_CNT(kSmemPops);
        } else {
            top = 0;
        }
        PROF_CNT(kGroupPops);
        PROF_ADD(kPop, t);
        return child;
    }
};

template <int kCol>
__device__ __forceinline__ void trace_ray(
    long long i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t0, const int4* __restrict__ nodes,
    const float4* __restrict__ octets, unsigned* col,
    float* __restrict__ t_out, int* __restrict__ slot_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ overflow PROF_PARAM) {
    float bt = t0[i];
    int bslot = 0;
    float bu = 0.0f, bv = 0.0f;

    if (bt > -kBig) {
        const float o0 = ox[i], o1 = oy[i], o2 = oz[i];
        const float d0 = dx[i], d1 = dy[i], d2 = dz[i];
        const float inv0 = __fdiv_rn(1.0f, d0);
        const float inv1 = __fdiv_rn(1.0f, d1);
        const float inv2 = __fdiv_rn(1.0f, d2);
        // only 0 * inf (or a non-finite origin) makes a NaN slab value
        const bool maybe_nan = !(isfinite(inv0) && isfinite(inv1) &&
                                 isfinite(inv2) && isfinite(o0) &&
                                 isfinite(o1) && isfinite(o2));
        const int oct = ((d0 < 0.0f) << 2) | ((d1 < 0.0f) << 1) | (d2 < 0.0f);

        Groups<kCol> g{0u, 0, 0, col};
        int cur = 0;  // the root wide node
        for (;;) {
            while (cur >= 0) {  // node phase
                PROF_T(tf);
                const float4* fb = reinterpret_cast<const float4*>(nodes + (size_t)cur * 16);
                const float4 lx0 = __ldg(fb + 0), lx1 = __ldg(fb + 1);
                const float4 ly0 = __ldg(fb + 2), ly1 = __ldg(fb + 3);
                const float4 lz0 = __ldg(fb + 4), lz1 = __ldg(fb + 5);
                const float4 hx0 = __ldg(fb + 6), hx1 = __ldg(fb + 7);
                const float4 hy0 = __ldg(fb + 8), hy1 = __ldg(fb + 9);
                const float4 hz0 = __ldg(fb + 10), hz1 = __ldg(fb + 11);
                const unsigned ord =
                    __ldg(reinterpret_cast<const unsigned*>(fb) + 56 + oct);
                PROF_SINK(__float_as_uint(lx0.x) ^ __float_as_uint(lx1.x) ^
                          __float_as_uint(ly0.x) ^ __float_as_uint(ly1.x) ^
                          __float_as_uint(lz0.x) ^ __float_as_uint(lz1.x) ^
                          __float_as_uint(hx0.x) ^ __float_as_uint(hx1.x) ^
                          __float_as_uint(hy0.x) ^ __float_as_uint(hy1.x) ^
                          __float_as_uint(hz0.x) ^ __float_as_uint(hz1.x) ^ ord);
                PROF_ADD(kNodeFetch, tf);
                PROF_CNT(kVisits);

                PROF_T(ts);
                const float lx[8] = {lx0.x, lx0.y, lx0.z, lx0.w, lx1.x, lx1.y, lx1.z, lx1.w};
                const float ly[8] = {ly0.x, ly0.y, ly0.z, ly0.w, ly1.x, ly1.y, ly1.z, ly1.w};
                const float lz[8] = {lz0.x, lz0.y, lz0.z, lz0.w, lz1.x, lz1.y, lz1.z, lz1.w};
                const float hx[8] = {hx0.x, hx0.y, hx0.z, hx0.w, hx1.x, hx1.y, hx1.z, hx1.w};
                const float hy[8] = {hy0.x, hy0.y, hy0.z, hy0.w, hy1.x, hy1.y, hy1.z, hy1.w};
                const float hz[8] = {hz0.x, hz0.y, hz0.z, hz0.w, hz1.x, hz1.y, hz1.z, hz1.w};
                unsigned hit = 0;  // by slot
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float t1x = mul(sub(lx[j], o0), inv0);
                    const float t1y = mul(sub(ly[j], o1), inv1);
                    const float t1z = mul(sub(lz[j], o2), inv2);
                    const float t2x = mul(sub(hx[j], o0), inv0);
                    const float t2y = mul(sub(hy[j], o1), inv1);
                    const float t2z = mul(sub(hz[j], o2), inv2);
                    const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                             fminf(t1z, t2z));
                    const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                            fmaxf(t1z, t2z));
                    bool open = far >= near && far >= 0.0f &&
                                fmaxf(near, 0.0f) <= bt;
                    if (maybe_nan)
                        open = open && !(isnan(t1x) || isnan(t1y) || isnan(t1z) ||
                                         isnan(t2x) || isnan(t2y) || isnan(t2z));
                    hit |= (unsigned)open << j;
                }
                hit &= ord >> 24;  // empty slots stay closed
                unsigned m = 0;  // by near-first rank
#pragma unroll
                for (int r = 0; r < 8; ++r)
                    m |= ((hit >> ((ord >> (3 * r)) & 7u)) & 1u) << r;
                PROF_ADD(kSlab, ts);

                if (m) {
                    const unsigned r = __ffs(m) - 1;
                    const int child = __ldg(reinterpret_cast<const int*>(fb) + 48 +
                                            ((ord >> (3 * r)) & 7u));
                    m &= m - 1;
                    if (m) g.push(((unsigned)cur << 8) | m PROF_PASS);
                    cur = child;
                } else {
                    cur = g.pop(nodes, oct PROF_PASS);
                }
            }
            if (cur == kDone) break;
            do {  // leaf phase: cur = -(q << 10 | (n - 1)) - 1
                const int e = -cur - 1;
                const int n = (e & ((1 << kCountBits) - 1)) + 1;
                const int base = (e >> kCountBits) * 8;  // slot of triangle 0
                const float4* ob = octets + (size_t)base * 3;
                PROF_CNT(kLeaves);
                PROF_CNTN(kOctets, (n + 7) >> 3);
                PROF_CNTN(kSlots, n);
                PROF_LEAF(base >> 3);
                // not unrolled: unrolled 2x and 4x, this loop of n steps ran
                // slower on the H100
#pragma unroll 1
                for (int j = 0; j < n; ++j) {
                    PROF_T(tl);
                    float4 a, b;  // v0.xyz, face.x; face.yz, e1.xy
                    load_tri_t(ob, j, a, b);
                    PROF_SINK(__float_as_uint(a.x) ^ __float_as_uint(b.x));
                    PROF_ADD(kOctetFetch, tl);
                    PROF_T(tt);
                    const float det = dot3(d0, d1, d2, a.w, b.x, b.y);
                    if (fabsf(det) >= kEps) {
                        const float inv_det = __fdiv_rn(1.0f, det);
                        const float rx = sub(o0, a.x), ry = sub(o1, a.y),
                                    rz = sub(o2, a.z);
                        const float t = mul(-dot3(rx, ry, rz, a.w, b.x, b.y), inv_det);
                        if (t > kEps && t < bt) {  // strict <, fragment.glsl:275
                            const float4 c = load_tri_edges(ob, j);  // e1.z, e2.xyz
                            PROF_CNT(kCandidates);
                            const float px = sub(mul(ry, d2), mul(rz, d1));
                            const float py = sub(mul(rz, d0), mul(rx, d2));
                            const float pz = sub(mul(rx, d1), mul(ry, d0));
                            const float u = mul(-dot3(c.y, c.z, c.w, px, py, pz), inv_det);
                            const float v = mul(dot3(b.z, b.w, c.x, px, py, pz), inv_det);
                            if (u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f) {
                                bt = t;
                                bslot = base + j;
                                bu = u;
                                bv = v;
                            }
                        }
                    }
                    PROF_ADD(kTriangles, tt);
                }
                cur = g.pop(nodes, oct PROF_PASS);
            } while (cur < 0 && cur != kDone);
            if (cur == kDone) break;
        }
        if (g.dropped) atomicAdd(overflow, g.dropped);
    }
    t_out[i] = bt;
    slot_out[i] = bslot;
    u_out[i] = bu;
    v_out[i] = bv;
}

#ifndef OGLRT_K3_PROFILE

template <int kCol>
__global__ void __launch_bounds__(kBlock)
wide_traverse_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ t0, const int4* __restrict__ nodes,
                     const float4* __restrict__ octets,
                     float* __restrict__ t_out, int* __restrict__ slot_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ overflow, long long n) {
    __shared__ unsigned stack[kCol * kBlock];
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i < n)
        trace_ray<kCol>(i, ox, oy, oz, dx, dy, dz, t0, nodes, octets,
                        stack + threadIdx.x, t_out, slot_out, u_out, v_out,
                        overflow);
}

template <int kCol>
void launch(const float* ox, const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, const float* t0, const void* nodes,
            const void* octets, float* t_out, int* slot_out, float* u_out,
            float* v_out, int* overflow, long long n, cudaStream_t stream) {
    const long long grid = (n + kBlock - 1) / kBlock;
    wide_traverse_kernel<kCol><<<(unsigned)grid, kBlock, 0, stream>>>(
        ox, oy, oz, dx, dy, dz, t0, static_cast<const int4*>(nodes),
        static_cast<const float4*>(octets), t_out, slot_out, u_out, v_out,
        overflow, n);
}

}  // namespace

extern "C" int oglrt_wide_traverse(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t0, const void* nodes,
    const void* octets, int groups, float* t_out, int* slot_out, float* u_out,
    float* v_out, int* overflow, long long n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (groups == 16) {
        launch<16>(ox, oy, oz, dx, dy, dz, t0, nodes, octets, t_out, slot_out,
                   u_out, v_out, overflow, n, s);
    } else if (groups == 71) {
        launch<71>(ox, oy, oz, dx, dy, dz, t0, nodes, octets, t_out, slot_out,
                   u_out, v_out, overflow, n, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

#else  // OGLRT_K3_PROFILE

__device__ __forceinline__ void warp_sum_into(unsigned long long x,
                                              unsigned long long* dst) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if ((threadIdx.x & 31) == 0 && x) atomicAdd(dst, x);
}

template <int kCol>
__global__ void __launch_bounds__(kBlock)
wide_traverse_profile_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t0, const int4* __restrict__ nodes,
    const float4* __restrict__ octets, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ overflow,
    unsigned long long* __restrict__ prof_out, int* __restrict__ leaf_hist,
    unsigned* __restrict__ sink, long long n) {
    __shared__ unsigned stack[kCol * kBlock];
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    Prof prof = {};
    prof.leaf_hist = leaf_hist;
    if (i < n)
        trace_ray<kCol>(i, ox, oy, oz, dx, dy, dz, t0, nodes, octets,
                        stack + threadIdx.x, t_out, slot_out, u_out, v_out,
                        overflow, prof);
    // every lane of the warp reaches here: sum the warp's counters, then one
    // atomic per counter per warp
#pragma unroll
    for (int k = 0; k < kStages; ++k) warp_sum_into(prof.cyc[k], prof_out + k);
#pragma unroll
    for (int k = 0; k < kCounts; ++k)
        warp_sum_into(prof.cnt[k], prof_out + kStages + k);
    unsigned s = prof.sink;
    for (int off = 16; off > 0; off >>= 1) s ^= __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) atomicXor(sink, s);
}

// One block per requested octet, one thread per triangle: the triangle
// read with K3's own loads, written in the TPU tiles' lane order
// [v0, e1, e2, face, 0 0 0 0] (16 floats).
__global__ void octet_fetch_kernel(const float4* __restrict__ octets,
                                   const long long* __restrict__ idx,
                                   float* __restrict__ out) {
    const int j = threadIdx.x;
    const float4* ob = octets + idx[blockIdx.x] * 24;
    float4 a, b;
    load_tri_t(ob, j, a, b);
    const float4 c = load_tri_edges(ob, j);
    float* o = out + ((size_t)blockIdx.x * 8 + j) * 16;
    const float lanes[16] = {a.x, a.y, a.z, b.z, b.w, c.x, c.y, c.z,
                             c.w, a.w, b.x, b.y, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = lanes[k];
}

template <int kCol>
void launch_profile(const float* ox, const float* oy, const float* oz,
                    const float* dx, const float* dy, const float* dz,
                    const float* t0, const void* nodes, const void* octets,
                    float* t_out, int* slot_out, float* u_out, float* v_out,
                    int* overflow, unsigned long long* prof, int* leaf_hist,
                    unsigned* sink, long long n, cudaStream_t stream) {
    const long long grid = (n + kBlock - 1) / kBlock;
    wide_traverse_profile_kernel<kCol><<<(unsigned)grid, kBlock, 0, stream>>>(
        ox, oy, oz, dx, dy, dz, t0, static_cast<const int4*>(nodes),
        static_cast<const float4*>(octets), t_out, slot_out, u_out, v_out,
        overflow, prof, leaf_hist, sink, n);
}

}  // namespace

extern "C" int oglrt_wide_traverse_profile(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t0, const void* nodes,
    const void* octets, int groups, float* t_out, int* slot_out, float* u_out,
    float* v_out, int* overflow, unsigned long long* prof, int* leaf_hist,
    unsigned* sink, long long n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (groups == 16) {
        launch_profile<16>(ox, oy, oz, dx, dy, dz, t0, nodes, octets, t_out,
                           slot_out, u_out, v_out, overflow, prof,
                           leaf_hist, sink, n, s);
    } else if (groups == 71) {
        launch_profile<71>(ox, oy, oz, dx, dy, dz, t0, nodes, octets, t_out,
                           slot_out, u_out, v_out, overflow, prof,
                           leaf_hist, sink, n, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int oglrt_k3_octet_fetch(const void* octets, const long long* idx,
                                    int n_idx, float* out, void* stream) {
    if (n_idx > 0)
        octet_fetch_kernel<<<n_idx, 8, 0, (cudaStream_t)stream>>>(
            static_cast<const float4*>(octets), idx, out);
    return (int)cudaGetLastError();
}

#endif  // OGLRT_K3_PROFILE
