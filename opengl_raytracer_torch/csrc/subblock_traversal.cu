// K1: nearest-hit BVH traversal over the sub-block tables, for Hopper.
//
// Replaces the Pallas kernel `_traverse_kernel` of
// opengl_raytracer_tpu/ops/subblock_traversal.py (launched by
// `_raycast_one_part`, wrapped by `raycast_subblock`).  That kernel's 64-row
// packet pool, one-hot stacks and scalar round trips answer the TPU's vector
// memory and its lack of dynamic lane indexing; here each thread walks one
// ray over the SAME tree (ops/wide2.py), read in a Hopper layout packed from
// its rows at upload (ops/wide2.pack_k1), so the two packages can be
// compared ray by ray:
//   nodes[w]  (64 words, 256 B): the 8 child boxes as structure of arrays
//     lo.x[8] lo.y[8] lo.z[8] hi.x[8] hi.y[8] hi.z[8] (f32), the 8 child
//     entries (i32: >= 0 a node, -q-1 leaf octet q, kEmpty none), and per
//     octant the near-first child order, 8 x 3 bits in one word;
//   octets[q] (96 floats, 384 B): triangle j's v0, face, e1, e2 at 12j.
// Both are read with 16-byte loads: 14 for a node visit, 2 per triangle
// for its t, and a third for its barycentrics when t beats the best hit.
//
// One entry point, oglrt_subblock_traverse_parts, walks the scene's whole
// part chain in ONE launch a bounce segment: subblock_traverse_parts_kernel
// for two parts or more, subblock_traverse_one_kernel for one (the same
// walk and resolution with the part's tables as plain arguments, which
// measured 5% faster there).  A thread loads its ray once (origin,
// direction, entry t from G5's prologue; the inverses and the octant
// computed once), walks parts 0 .. P-1 in the fixed order, carrying its
// best hit (t in a register; part, slot, u, v in its shared column) from
// part to part, and resolves the winner itself: a miss gives t = BIG and
// u = v = 0, the slot is clamped into the winning part's remap, tri =
// remap[slot] and that part's slot base is added.  The parts' tables come
// as one kernel parameter (__grid_constant__, up to 16 parts: the most any
// split makes).  One loop runs over all the parts: when a ray's last group
// of a part closes it goes on at the next part's root, so a warp's lanes
// do not wait for each other at the parts' borders (a loop a part, which
// made them wait, was 9% slower on the Happy Buddha's 4 parts).  Carried t
// and a strict < keep the chain's rules: a later part accepts only a
// strictly nearer hit, so a tie goes to the earlier part, and each ray
// visits and tests what the parts walked one by one would.
//
// What bounds it on this card (an H100 80GB HBM3 at 700 W, measured by
// chip_smoke.py): not bytes (a part's tables, 2-23 MB, sit in the 50 MB
// L2; the Happy Buddha's 4 parts, 92 MB together, do not, but the sorted
// rays of a wave touch few nodes of each, and one launch over all four ran
// faster than a launch a part; a launch moves ~52 B per ray) and not FP32
// rate: 2M random rays cost ~2.7 G operations, a bound of ~0.04 ms, a
// tenth of the launch or less.  It is the latency of the dependent loads
// a ray's walk chains together (entry -> node -> child -> octet), and above
// all the leaf side: the stage profile (probes/k1.py) puts ~71% of the
// cycles of a frame's bounce segments in octet fetch and triangle tests.
// Divergence costs little there: sorted by the integrator, a segment's
// warps keep 0.74-0.96 of their lanes busy (0.35 on unsorted random rays).
// The design:
//   * a stack of node groups: one 32-bit entry per open node, holding the
//     node and the mask of its children still to visit in this ray's
//     near-first order.  A visit pushes at most one entry (the tree's depth
//     bound of ops/wide2.py, max_depth <= 15, bounds the open nodes at 16),
//     the top entry lives in registers and the rest in this thread's column
//     of shared memory (stride = block size: no bank conflicts; 8 KB a
//     block, and 1.5 KB more for the best hit's slot, u and v, which only
//     an accepted hit writes), so no local memory is touched;
//   * 16-byte loads of 256-byte nodes, all issued before the first use,
//     instead of 56 scalar loads spread over three lines of a 512-byte row;
//   * a two-phase loop (Aila and Laine's while-while, HPG 2009): nodes
//     until the next entry is a leaf octet, then octets until the next is
//     a node, so a warp's lanes run node bodies together and leaf bodies
//     together more often;
//   * a triangle's test stops at |det| < EPS or at a t that cannot be
//     accepted (t <= EPS or t >= best_t), before its edges are loaded and
//     its barycentrics computed: the rest of the test cannot accept it.
// The kernel is latency-bound, so warps per SM matter: both kernels run at
// 64 registers (8 blocks of 4 warps an SM; the chain kernel by its launch
// bounds); a cap below that spilled and ran slower on the card, and so did
// persistent warps fetching rays from a counter and staging the tree's top
// nodes in shared memory (PERF.md).
//
// Semantics kept from the Pallas kernel, and from the plain torch version
// (ops/subblock_traversal.py) bit for bit:
//   * inverses 1/d clamped to +-1e18; slab as b*inv - o*inv; a child is
//     opened iff far >= near && far >= 0 && near <= best_t, tested when its
//     parent is visited;
//   * children are visited near-first in the order of THIS ray's octant
//     (sign bits of d): a group pops its lowest remaining rank, which is the
//     order in which the plain version's far-first pushes pop (the Pallas
//     kernel uses its packet's dominant octant, which changes only which
//     slot wins at an exact t tie);
//   * EPS Moller-Trumbore with t = -(r.face)/det and a strict < update;
//     slot = q*8 + j;
//   * a dead ray enters with t0 = -BIG and can neither open nodes nor
//     accept hits (it exits at once here).
// The arithmetic is written with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __frcp_rn: 1/x correctly rounded, as the plain
// version's 1.0 / x), which nvcc never contracts into FMAs, in the order of
// the plain version, so t, slot, u and v are its values bit for bit.
// A group push past the shared column's end is counted into `overflow`.
//
// Built with -DOGLRT_K1_PROFILE (opengl_raytracer_torch/probes/k1.py), the
// same source exports `oglrt_subblock_traverse_profile` instead: the same
// walk, with clock64() sums per stage (group pop, node fetch, slab tests,
// group push, octet fetch, triangle tests) and event counts, reduced per
// warp into `prof`.  Each fetch stage ends in a use of every load it issued
// (an XOR into a sink word), so its cycles include the loads' latency.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
// Node groups per thread in shared memory.  At most max_depth + 1 <= 16
// groups are open at once (one per node on the path from the root), one
// of them in registers, so 16 leave one to spare.
constexpr int kGroups = 16;
// Rows of a thread's shared column past its groups: the best hit's slot,
// u and v (struct Best).
constexpr int kSlotRow = kGroups, kURow = kGroups + 1, kVRow = kGroups + 2;
constexpr int kRows = kGroups + 3;
constexpr int kMaxParts = 16;  // the most parts any split makes
// A hit's slot q*8+j within its part is below 2^19 (ops/wide2.MAX_OCTETS
// = 2^16 octets); the chain keeps the part in the bits above kPartShift.
constexpr int kPartShift = 24;
constexpr int kSlotMask = (1 << kPartShift) - 1;
constexpr int kEmpty = -(1 << 20);
constexpr int kDone = INT_MIN;
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

#ifdef OGLRT_K1_PROFILE
enum { kPop, kNodeFetch, kSlab, kPush, kOctetFetch, kTriangles, kStages };
enum { kVisits, kOctets, kGroupPushes, kGroupPops, kSmemPushes, kSmemPops,
       kEdgeLoads, kCounts };
struct Prof {
    unsigned long long cyc[kStages];
    unsigned long long cnt[kCounts];
    unsigned sink;
};
#define PROF_PARAM , Prof& prof
#define PROF_PASS , prof
#define PROF_T(name) const long long name = clock64()
#define PROF_ADD(stage, t) prof.cyc[stage] += (unsigned long long)(clock64() - (t))
#define PROF_CNT(c) ++prof.cnt[c]
#define PROF_SINK(x) prof.sink ^= (x)
#else
#define PROF_PARAM
#define PROF_PASS
#define PROF_T(name)
#define PROF_ADD(stage, t)
#define PROF_CNT(c)
#define PROF_SINK(x)
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
// shared-memory column.
struct Groups {
    unsigned top;
    int sp;
    int dropped;
    unsigned* col;

    __device__ __forceinline__ void push(unsigned g PROF_PARAM) {
        PROF_T(t);
        PROF_CNT(kGroupPushes);
        if (top) {
            if (sp < kGroups) {
                col[sp++ * kBlock] = top;
                PROF_CNT(kSmemPushes);
            } else {
                ++dropped;
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

// One ray, loaded and prepared once for every part it walks: origin,
// direction, the clamped inverses 1/d, o * inv and the octant of d.
struct Ray {
    float o0, o1, o2, d0, d1, d2;
    float inv0, inv1, inv2, oi0, oi1, oi2;
    int oct;
};

__device__ __forceinline__ Ray load_ray(
    long long i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz) {
    Ray ray;
    ray.o0 = ox[i];
    ray.o1 = oy[i];
    ray.o2 = oz[i];
    ray.d0 = dx[i];
    ray.d1 = dy[i];
    ray.d2 = dz[i];
    ray.inv0 = fminf(fmaxf(__frcp_rn(ray.d0), -kInvClamp), kInvClamp);
    ray.inv1 = fminf(fmaxf(__frcp_rn(ray.d1), -kInvClamp), kInvClamp);
    ray.inv2 = fminf(fmaxf(__frcp_rn(ray.d2), -kInvClamp), kInvClamp);
    ray.oi0 = mul(ray.o0, ray.inv0);
    ray.oi1 = mul(ray.o1, ray.inv1);
    ray.oi2 = mul(ray.o2, ray.inv2);
    ray.oct = ((ray.d0 < 0.0f) << 2) | ((ray.d1 < 0.0f) << 1) | (ray.d2 < 0.0f);
    return ray;
}

// The best hit so far.  t lives in a register: every slab test and
// triangle test reads it.  Its slot (part << kPartShift | q*8+j, q*8+j in
// the part whose walk accepted it; 0 while nothing has been accepted), u
// and v are written only when a hit is accepted and read once at the end,
// so they live in rows kSlotRow, kURow and kVRow of the thread's shared
// column: that keeps the chain kernel within 64 registers.
struct Best {
    float t;
    unsigned* col;

    __device__ __forceinline__ void start(float t0) {
        t = t0;
        col[kSlotRow * kBlock] = 0u;
        col[kURow * kBlock] = 0u;  // +0.0f
        col[kVRow * kBlock] = 0u;
    }
    __device__ __forceinline__ void accept(float t_hit, int slot, float u,
                                           float v) {
        t = t_hit;
        col[kSlotRow * kBlock] = (unsigned)slot;
        col[kURow * kBlock] = __float_as_uint(u);
        col[kVRow * kBlock] = __float_as_uint(v);
    }
    __device__ __forceinline__ int slot() const { return (int)col[kSlotRow * kBlock]; }
    __device__ __forceinline__ float u() const { return __uint_as_float(col[kURow * kBlock]); }
    __device__ __forceinline__ float v() const { return __uint_as_float(col[kVRow * kBlock]); }
};

// A part's tables for the one-launch chain: its nodes and octets, its
// remap (slot -> triangle) and the scene slot of its slot 0.
struct Part {
    const int4* nodes;
    const float4* octets;
    const int* remap;
    int n_remap;
    int slot_base;
};

struct Parts {  // one kernel parameter: 16 x 32 B + 4
    Part p[kMaxParts];
    int n;
};

// What one walk reads: the tables of one part (OnePart), or of a chain of
// parts (Chain), walked one after another; next() moves to the next part,
// or returns false after the last.  `tag` is the part << kPartShift.  The
// chain reads a part's table pointers from the kernel parameter where it
// uses them (carrying them in registers instead measured no faster).
struct OnePart {
    const int4* nodes_;
    const float4* octets_;
    static constexpr int tag = 0;
    __device__ __forceinline__ const int4* nodes() const { return nodes_; }
    __device__ __forceinline__ const float4* octets() const { return octets_; }
    __device__ __forceinline__ bool next() const { return false; }
};

struct Chain {
    const Parts& parts;
    int tag;
    __device__ __forceinline__ int part() const { return tag >> kPartShift; }
    __device__ __forceinline__ const int4* nodes() const {
        return parts.p[part()].nodes;
    }
    __device__ __forceinline__ const float4* octets() const {
        return parts.p[part()].octets;
    }
    __device__ __forceinline__ bool next() {
        tag += 1 << kPartShift;
        return part() < parts.n;
    }
};

// The walk of one live ray: each part's tree from its root, with `best` as
// the bound a child's slab test and a triangle's t must beat (strict <),
// updated at each accepted hit and carried into the next part.  When a
// part's last group closes, the same loop goes on at the next part's root,
// so a warp's lanes need not wait for each other at the parts' borders:
// each lane's own sequence of visits and tests is that of the parts walked
// one by one.  The groups are empty on entry and on return; pushes they
// drop add to g.dropped.  Both kernels walk through this function.
template <class Tables>
__device__ __forceinline__ void walk(const Ray& ray, Tables& tab, Best& best,
                                     Groups& g PROF_PARAM) {
    int cur = 0;  // the root wide node of the first part
    for (;;) {
        while (cur >= 0) {  // node phase
            PROF_T(tf);
            const float4* fb = reinterpret_cast<const float4*>(tab.nodes() + (size_t)cur * 16);
            const float4 lx0 = __ldg(fb + 0), lx1 = __ldg(fb + 1);
            const float4 ly0 = __ldg(fb + 2), ly1 = __ldg(fb + 3);
            const float4 lz0 = __ldg(fb + 4), lz1 = __ldg(fb + 5);
            const float4 hx0 = __ldg(fb + 6), hx1 = __ldg(fb + 7);
            const float4 hy0 = __ldg(fb + 8), hy1 = __ldg(fb + 9);
            const float4 hz0 = __ldg(fb + 10), hz1 = __ldg(fb + 11);
            const int4 e0 = __ldg(tab.nodes() + (size_t)cur * 16 + 12);
            const int4 e1 = __ldg(tab.nodes() + (size_t)cur * 16 + 13);
            const unsigned ord =
                __ldg(reinterpret_cast<const unsigned*>(fb) + 56 + ray.oct);
            PROF_SINK(__float_as_uint(lx0.x) ^ __float_as_uint(lx1.x) ^
                      __float_as_uint(ly0.x) ^ __float_as_uint(ly1.x) ^
                      __float_as_uint(lz0.x) ^ __float_as_uint(lz1.x) ^
                      __float_as_uint(hx0.x) ^ __float_as_uint(hx1.x) ^
                      __float_as_uint(hy0.x) ^ __float_as_uint(hy1.x) ^
                      __float_as_uint(hz0.x) ^ __float_as_uint(hz1.x) ^
                      (unsigned)e0.x ^ (unsigned)e1.x ^ ord);
            PROF_ADD(kNodeFetch, tf);
            PROF_CNT(kVisits);

            PROF_T(ts);
            const float lx[8] = {lx0.x, lx0.y, lx0.z, lx0.w, lx1.x, lx1.y, lx1.z, lx1.w};
            const float ly[8] = {ly0.x, ly0.y, ly0.z, ly0.w, ly1.x, ly1.y, ly1.z, ly1.w};
            const float lz[8] = {lz0.x, lz0.y, lz0.z, lz0.w, lz1.x, lz1.y, lz1.z, lz1.w};
            const float hx[8] = {hx0.x, hx0.y, hx0.z, hx0.w, hx1.x, hx1.y, hx1.z, hx1.w};
            const float hy[8] = {hy0.x, hy0.y, hy0.z, hy0.w, hy1.x, hy1.y, hy1.z, hy1.w};
            const float hz[8] = {hz0.x, hz0.y, hz0.z, hz0.w, hz1.x, hz1.y, hz1.z, hz1.w};
            const int ent[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
            unsigned hit = 0;  // by slot
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float t1x = sub(mul(lx[j], ray.inv0), ray.oi0);
                const float t1y = sub(mul(ly[j], ray.inv1), ray.oi1);
                const float t1z = sub(mul(lz[j], ray.inv2), ray.oi2);
                const float t2x = sub(mul(hx[j], ray.inv0), ray.oi0);
                const float t2y = sub(mul(hy[j], ray.inv1), ray.oi1);
                const float t2z = sub(mul(hz[j], ray.inv2), ray.oi2);
                const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                         fminf(t1z, t2z));
                const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                        fmaxf(t1z, t2z));
                if (far >= near && far >= 0.0f && near <= best.t && ent[j] != kEmpty)
                    hit |= 1u << j;
            }
            unsigned m = 0;  // by near-first rank
#pragma unroll
            for (int r = 0; r < 8; ++r)
                m |= ((hit >> ((ord >> (3 * r)) & 7u)) & 1u) << r;
            PROF_ADD(kSlab, ts);

            if (m) {
                const unsigned r = __ffs(m) - 1;
                const int child = pick(e0, e1, (ord >> (3 * r)) & 7u);
                m &= m - 1;
                if (m) g.push(((unsigned)cur << 8) | m PROF_PASS);
                cur = child;
            } else {
                cur = g.pop(tab.nodes(), ray.oct PROF_PASS);
            }
        }
        if (cur == kDone) {
            if (!tab.next()) break;
            cur = 0;  // the next part's root
            continue;
        }
        do {  // leaf phase: cur = -q-1
            const int q = -cur - 1;
            const float4* ob = tab.octets() + (size_t)q * 24;
            PROF_CNT(kOctets);
#pragma unroll 2
            for (int j = 0; j < 8; ++j) {
                PROF_T(tf);
                const float4 a = __ldg(ob + 3 * j);  // v0.xyz, face.x
                const float4 b = __ldg(ob + 3 * j + 1);  // face.yz, e1.xy
                PROF_SINK(__float_as_uint(a.x) ^ __float_as_uint(b.x));
                PROF_ADD(kOctetFetch, tf);
                PROF_T(tt);
                const float det = dot3(ray.d0, ray.d1, ray.d2, a.w, b.x, b.y);
                if (fabsf(det) >= kEps) {
                    const float inv_det = __frcp_rn(det);
                    const float rx = sub(ray.o0, a.x), ry = sub(ray.o1, a.y), rz = sub(ray.o2, a.z);
                    const float t = mul(-dot3(rx, ry, rz, a.w, b.x, b.y), inv_det);
                    if (t > kEps && t < best.t) {  // strict <, fragment.glsl:275
                        const float4 c = __ldg(ob + 3 * j + 2);  // e1.z, e2.xyz
                        PROF_CNT(kEdgeLoads);
                        const float px = sub(mul(ry, ray.d2), mul(rz, ray.d1));
                        const float py = sub(mul(rz, ray.d0), mul(rx, ray.d2));
                        const float pz = sub(mul(rx, ray.d1), mul(ry, ray.d0));
                        const float u = mul(-dot3(c.y, c.z, c.w, px, py, pz), inv_det);
                        const float v = mul(dot3(b.z, b.w, c.x, px, py, pz), inv_det);
                        if (u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f) {
                            best.accept(t, tab.tag | (q * 8 + j), u, v);
                        }
                    }
                }
                PROF_ADD(kTriangles, tt);
            }
            cur = g.pop(tab.nodes(), ray.oct PROF_PASS);
        } while (cur < 0 && cur != kDone);
        if (cur == kDone) {
            if (!tab.next()) break;
            cur = 0;
        }
    }
}

// Ray i's walk of one part from its entry t t0[i], into `best`.
__device__ __forceinline__ void trace_ray(
    long long i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t0, const int4* __restrict__ nodes,
    const float4* __restrict__ octets, Best& best,
    int* __restrict__ overflow PROF_PARAM) {
    best.start(t0[i]);
    if (best.t > -kBig) {
        const Ray ray = load_ray(i, ox, oy, oz, dx, dy, dz);
        Groups g{0u, 0, 0, best.col};
        OnePart tab{nodes, octets};
        walk(ray, tab, best, g PROF_PASS);
        if (g.dropped) atomicAdd(overflow, g.dropped);
    }
}

// The chain's answer for ray i, its best hit resolved in the part whose
// remap and slot base are given: t = BIG and u = v = 0 on a miss, the slot
// clamped into the remap, tri = remap[slot], the slot base added.
__device__ __forceinline__ void write_resolved(
    long long i, const Best& best, const int* __restrict__ remap, int n_remap,
    int slot_base, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ slot_out) {
    const bool did_hit = best.t < kBig && best.t > -kBig;
    const int slot = best.slot() & kSlotMask;
    const int s = slot > n_remap - 1 ? n_remap - 1 : slot;
    t_out[i] = did_hit ? best.t : kBig;
    tri_out[i] = __ldg(remap + s);
    u_out[i] = did_hit ? best.u() : 0.0f;
    v_out[i] = did_hit ? best.v() : 0.0f;
    slot_out[i] = s + slot_base;
}

#ifndef OGLRT_K1_PROFILE

// The chain of ONE part, resolved: what the chain kernel does at P = 1,
// with the part's tables as plain pointer arguments.  The chain kernel,
// whose parameter is the table of parts, ran this one-part walk 5% slower
// on the same rays (4.94 against 4.70 ms a 1080p frame of the minidragon
// scene), also with its part-0 pointers passed apart; so one part takes
// this kernel.
__global__ void __launch_bounds__(kBlock)
subblock_traverse_one_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t0, const int4* __restrict__ nodes,
    const float4* __restrict__ octets, const int* __restrict__ remap,
    int n_remap, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ slot_out, int* __restrict__ overflow, long long n) {
    __shared__ unsigned stack[kRows * kBlock];
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i >= n) return;
    Best best{0.0f, stack + threadIdx.x};
    trace_ray(i, ox, oy, oz, dx, dy, dz, t0, nodes, octets, best, overflow);
    write_resolved(i, best, remap, n_remap, 0, t_out, tri_out, u_out, v_out,
                   slot_out);
}

// The whole chain in one launch (two parts or more): a live ray walks
// parts 0 .. n-1 in order, carrying its best hit from part to part, then
// resolves it in the part that holds it (write_resolved).  A miss resolves
// in part 0 at slot 0.  Dead rays (t0 = -BIG) walk nothing and come out
// missed.
// Eight blocks an SM hold it to 64 registers, as the one-part kernel
// compiles (left to itself, ptxas gives it 72 and 7 blocks an SM); with the
// best hit's slot, u and v in shared memory it spills nothing there.
__global__ void __launch_bounds__(kBlock, 8)
subblock_traverse_parts_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t0, const __grid_constant__ Parts parts,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ slot_out, int* __restrict__ overflow, long long n) {
    __shared__ unsigned stack[kRows * kBlock];
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i >= n) return;
    Best best{0.0f, stack + threadIdx.x};
    best.start(t0[i]);
    if (best.t > -kBig) {
        const Ray ray = load_ray(i, ox, oy, oz, dx, dy, dz);
        Groups g{0u, 0, 0, best.col};
        Chain tab{parts, 0};
        walk(ray, tab, best, g);
        if (g.dropped) atomicAdd(overflow, g.dropped);
    }
    const Part& w = parts.p[best.slot() >> kPartShift];
    write_resolved(i, best, w.remap, w.n_remap, w.slot_base, t_out, tri_out,
                   u_out, v_out, slot_out);
}

}  // namespace

// parts: n_parts rows of 5 host words (nodes, octets, remap, n_remap,
// slot_base), 1 <= n_parts <= kMaxParts.
extern "C" int oglrt_subblock_traverse_parts(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t0, const long long* parts,
    int n_parts, float* t_out, int* tri_out, float* u_out, float* v_out,
    int* slot_out, int* overflow, long long n, void* stream) {
    if (n_parts < 1 || n_parts > kMaxParts) return (int)cudaErrorInvalidValue;
    Parts ps{};
    for (int k = 0; k < n_parts; ++k) {
        const long long* row = parts + 5 * k;
        ps.p[k] = Part{reinterpret_cast<const int4*>(row[0]),
                       reinterpret_cast<const float4*>(row[1]),
                       reinterpret_cast<const int*>(row[2]), (int)row[3],
                       (int)row[4]};
    }
    ps.n = n_parts;
    const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
    if (n > 0 && n_parts == 1) {
        const Part& w = ps.p[0];
        subblock_traverse_one_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
            ox, oy, oz, dx, dy, dz, t0, w.nodes, w.octets, w.remap, w.n_remap,
            t_out, tri_out, u_out, v_out, slot_out, overflow, n);
    } else if (n > 0) {
        subblock_traverse_parts_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
            ox, oy, oz, dx, dy, dz, t0, ps, t_out, tri_out, u_out, v_out,
            slot_out, overflow, n);
    }
    return (int)cudaGetLastError();
}

#else  // OGLRT_K1_PROFILE

__device__ __forceinline__ void warp_sum_into(unsigned long long x,
                                              unsigned long long* dst) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if ((threadIdx.x & 31) == 0 && x) atomicAdd(dst, x);
}

// A part's raw answer for ray i: t (t0 where nothing beat it), slot, u, v.
__device__ __forceinline__ void write_raw(long long i, const Best& best,
                                          float* __restrict__ t_out,
                                          int* __restrict__ slot_out,
                                          float* __restrict__ u_out,
                                          float* __restrict__ v_out) {
    t_out[i] = best.t;
    slot_out[i] = best.slot();
    u_out[i] = best.u();
    v_out[i] = best.v();
}

__global__ void __launch_bounds__(kBlock)
traverse_profile_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                        const float* __restrict__ oz, const float* __restrict__ dx,
                        const float* __restrict__ dy, const float* __restrict__ dz,
                        const float* __restrict__ t0, const int4* __restrict__ nodes,
                        const float4* __restrict__ octets, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ overflow,
                        unsigned long long* __restrict__ prof_out,
                        unsigned* __restrict__ sink, long long n) {
    __shared__ unsigned stack[kRows * kBlock];
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    Prof prof = {};
    if (i < n) {
        Best best{0.0f, stack + threadIdx.x};
        trace_ray(i, ox, oy, oz, dx, dy, dz, t0, nodes, octets, best, overflow,
                  prof);
        write_raw(i, best, t_out, slot_out, u_out, v_out);
    }
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

}  // namespace

extern "C" int oglrt_subblock_traverse_profile(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t0, const void* nodes,
    const void* octets, float* t_out, int* slot_out, float* u_out,
    float* v_out, int* overflow, unsigned long long* prof, unsigned* sink,
    long long n, void* stream) {
    if (n > 0) {
        const long long grid = (n + kBlock - 1) / kBlock;
        traverse_profile_kernel<<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(
            ox, oy, oz, dx, dy, dz, t0, static_cast<const int4*>(nodes),
            static_cast<const float4*>(octets), t_out, slot_out, u_out, v_out,
            overflow, prof, sink, n);
    }
    return (int)cudaGetLastError();
}

#endif  // OGLRT_K1_PROFILE
