// The device math of the two BVH walks, G7 (bvh_walk.cu, a ray a thread)
// and G9 (packet_walk.cu, a 128-ray packet a block): the node and triangle
// records, their 16-byte __ldg loads, the slab test and Moller-Trumbore,
// with the sign test before the division (G7) or without it (G9); G8
// (brute_sweep.cu) shares the arithmetic helpers and the ray and output
// columns.
//
// Bit for bit against the plain versions (ops/traversal.py: _walk_plain,
// _packet_plain; ops/intersect.py: _sweep_plain) ON THE CARD: every float
// operation is a round-to-nearest intrinsic in torch's order, 1 / d and 1
// / det are IEEE divisions (torch's reciprocal), and nothing is
// contracted (no --use_fast_math).

#pragma once

#include <cuda_runtime.h>

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

struct Node {
    float lo[3], hi[3];
    int miss, first, count;
};

// The records (ops/traversal.py:node_records, ops/intersect.py:
// tri_records): a node is 32 bytes (min xyz, miss; max xyz, first + 1 |
// count << 21) or, with kWide, 48 where those do not fit (min xyz, miss;
// max xyz, first; count, 0, 0, 0); a triangle 48 (v0, e1, e2, face).
template <bool kWide>
__device__ __forceinline__ Node load_node(const int4* __restrict__ nodes,
                                          int node) {
    const int4* rec = nodes + (long long)node * (kWide ? 3 : 2);
    const int4 a = __ldg(rec), b = __ldg(rec + 1);
    Node n;
    n.lo[0] = __int_as_float(a.x);
    n.lo[1] = __int_as_float(a.y);
    n.lo[2] = __int_as_float(a.z);
    n.hi[0] = __int_as_float(b.x);
    n.hi[1] = __int_as_float(b.y);
    n.hi[2] = __int_as_float(b.z);
    n.miss = a.w;
    if (kWide) {
        const int4 c = __ldg(rec + 2);
        n.first = b.w;
        n.count = c.x;
    } else {
        n.first = (b.w & ((1 << 21) - 1)) - 1;
        n.count = (int)((unsigned)b.w >> 21);
    }
    return n;
}

// The slab test with the unclamped 1 / d, (box - o) * inv, a NaN in any of
// the six slab values (an axis-parallel ray on a slab plane) keeping the
// box closed, as torch's minimum and amax propagate it: the box is entered
// iff far >= near, far >= 0 and max(near, 0) <= bt, the nearest hit so far
// (fragment.glsl:261-262; a dead ray's bt = -BIG enters nothing).
__device__ __forceinline__ bool enters(const Node& n, const float* o,
                                       const float* inv, float bt) {
    bool nan = false;
    float near = 0.0f, far = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float l = mul(sub(n.lo[k], o[k]), inv[k]);
        const float h = mul(sub(n.hi[k], o[k]), inv[k]);
        nan |= (l != l) || (h != h);
        const float mn = fminf(l, h), mx = fmaxf(l, h);
        near = k == 0 ? mn : fmaxf(near, mn);
        far = k == 0 ? mx : fminf(far, mx);
    }
    const bool hit = !nan && far >= near && far >= 0.0f;
    return hit && fmaxf(near, 0.0f) <= bt;
}

// Whether t = num * (1 / det) can pass t > EPS, decided before the IEEE
// division, for |det| >= EPS (a NaN det fails that test first): num * det
// > 0.  With |det| >= EPS, 1 / det is nonzero with det's sign (finite, or
// +-0 where det is +-inf), so where num is +-0 or NaN, or its sign is not
// det's, t is +-0, negative or NaN and t > EPS is false; where num has
// det's sign but num * det rounds to +0 (below 2^-150), |t| < 2^-149 /
// det^2 (1 + 2^-23) < 1e-32, and t > EPS is false too.  Skipping where
// the product is not positive therefore skips only pairs the plain
// versions reject (ops/intersect.py:divides is the same test).
__device__ __forceinline__ bool ahead(float num, float det) {
    return mul(num, det) > 0.0f;
}

// A triangle record in registers: v0 = x.xyz, e1 = (x.w, y.x, y.y), e2 =
// (y.z, y.w, z.x), face = z.yzw.
struct Tri {
    float4 x, y, z;
};

__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris,
                                        int idx) {
    const float4* q = tris + (long long)idx * 3;
    return Tri{__ldg(q), __ldg(q + 1), __ldg(q + 2)};
}

// Moller-Trumbore (the plain versions' intersect.mt_single) of triangle
// idx, whose record is tr: accepted iff |det| >= EPS, EPS < t < bt (strict
// <, so the first tested wins at equal t; fragment.glsl:275), u >= 0, v >=
// 0 and u + v <= 1; u and v are computed only where t would win, which
// decides the same accepts.  With kSign the IEEE division runs only where
// t can be positive (|det| >= EPS and ahead), which G7 gains from (its
// lanes test leaves of their own); G9 runs it unconditionally, as a
// division whose operand is ready early overlaps the rest of the test
// (its build with the sign test measured slower; PERF.md, section 6).
template <bool kSign>
__device__ __forceinline__ void hit_test(const Tri& tr, int idx,
                                         const float* o, const float* d,
                                         float& bt, int& btri, float& bu,
                                         float& bv) {
    const float4 x = tr.x, y = tr.y, z = tr.z;
    const float det = dot3(d[0], d[1], d[2], z.y, z.z, z.w);
    const float rx = sub(o[0], x.x), ry = sub(o[1], x.y), rz = sub(o[2], x.z);
    const float num = -dot3(rx, ry, rz, z.y, z.z, z.w);
    if (kSign && !(fabsf(det) >= kEps && ahead(num, det))) return;
    const float inv_det = __fdiv_rn(1.0f, det);
    const float t = mul(num, inv_det);
    if ((kSign || fabsf(det) >= kEps) && t > kEps && t < bt) {
        const float px = sub(mul(ry, d[2]), mul(rz, d[1]));
        const float py = sub(mul(rz, d[0]), mul(rx, d[2]));
        const float pz = sub(mul(rx, d[1]), mul(ry, d[0]));
        const float u = mul(-dot3(y.z, y.w, z.x, px, py, pz), inv_det);
        const float v = mul(dot3(x.w, y.x, y.y, px, py, pz), inv_det);
        if (u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f) {
            bt = t;
            btri = idx;
            bu = u;
            bv = v;
        }
    }
}

// hit_test of triangle idx loaded from the records, with the sign test
// (G7: a ray a thread).
__device__ __forceinline__ void test_triangle(const float4* __restrict__ tris,
                                              int idx, const float* o,
                                              const float* d, float& bt,
                                              int& btri, float& bu,
                                              float& bv) {
    hit_test<true>(load_tri(tris, idx), idx, o, d, bt, btri, bu, bv);
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
