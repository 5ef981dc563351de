// G8: the brute-force sweep ("brute"; "auto" on scenes of at most 128
// triangles and on scenes with a leaf over 1024), for Hopper.
//
// Replaces the JAX package's raycast_brute (opengl_raytracer_tpu/ops/
// intersect.py:120; XLA matmuls over (rays x 2048-triangle) chunks under
// jax.jit, not a Pallas kernel).  The JAX package chunks the rays because
// its per-(ray, triangle) state lives in HBM; here each ray's nearest hit
// lives in registers and nothing of a pair is stored.
//
// What it computes, as the plain version (ops/intersect.py:_sweep_plain):
// for every ray against every triangle, in triangle order, the
// plane-determinant form of Moller-Trumbore,
//     det = d . face,  t = (v0.face - o.face) / det,
//     u = -((o x d).e2 - d.(e2 x v0)) / det,
//     v =  ((o x d).e1 - d.(e1 x v0)) / det,
// accepted iff |det| >= EPS, t > EPS, u >= 0, v >= 0, u + v <= 1, and kept
// iff t < the nearest so far (strict <, fragment.glsl:275), so on equal t
// the lowest index wins, as the plain version's argmin does.  A dead ray
// (active false) skips the sweep and reports t = BIG, tri 0, u = v = 0.
//
// Bit for bit against the plain version ON THE CARD: every float operation
// is a round-to-nearest intrinsic (__f*_rn, never contracted into an FMA)
// in the plain version's order: dot products (a0 b0 + a1 b1) + a2 b2,
// cross products a_i b_j - a_j b_i, 1 / det an IEEE division as torch's
// reciprocal.
//
// What bounds it on the card: operations.  A pair costs some 18 operations
// up to t and 30 more for u, v and the accept, against 28 bytes a ray in,
// 16 out and 48 a triangle.  What the design does about it:
// - one ray a thread; the triangles pass through shared memory a tile of
//   kThreads at a time, each with d0 = v0.face, q1 = e1 x v0 and q2 = e2 x
//   v0 computed once a tile by one thread from its 48-byte record
//   (ops/intersect.py:tri_records), so a pair does only the ray's side;
//   every lane reads the same triangle, a broadcast with no bank conflict;
// - u and v are computed only where t would win (|det| >= EPS and EPS < t
//   < the nearest hit), which decides the same accepts;
// - a block whose rays are all dead skips the sweep.
// Two rays a thread (one staged-triangle load and loop step for both),
// and the sign test before the division that G7 runs (bvh_walk.cuh:
// ahead), both measured slower on the H100 (PERF.md, section 6): a pair's
// work is its arithmetic, which neither reduces, two rays a thread cost
// registers and so warps, and a warp skips a division only where none of
// its 32 rays needs it.

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 256;  // rays a block, triangles a tile

// A staged triangle, 64 bytes: (face.xyz, d0), (e1.xyz, e2.x),
// (e2.yz, q1.xy), (q1.z, q2.xyz).
struct Staged {
    float4 a, b, c, e;
};

__global__ void __launch_bounds__(kThreads)
brute_sweep_kernel(Rays r, const float4* __restrict__ tris, int n_tris,
                   Out out, long long n) {
    __shared__ Staged tile[kThreads];
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool in_range = i < n;
    const bool live = in_range && (r.active == nullptr || r.active[i]);
    float bt = kBig, bu = 0.0f, bv = 0.0f;
    int btri = 0;
    if (__syncthreads_or(live)) {
        float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
        if (in_range) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                o[a] = r.o[a][i];
                d[a] = r.d[a][i];
            }
        }
        // o x d
        const float cx = sub(mul(o[1], d[2]), mul(o[2], d[1]));
        const float cy = sub(mul(o[2], d[0]), mul(o[0], d[2]));
        const float cz = sub(mul(o[0], d[1]), mul(o[1], d[0]));
        for (int base = 0; base < n_tris; base += kThreads) {
            const int k = base + threadIdx.x;
            if (k < n_tris) {
                // v0 = x.xyz, e1 = (x.w, y.x, y.y), e2 = (y.z, y.w, z.x),
                // face = z.yzw
                const float4* q = tris + (long long)k * 3;
                const float4 x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
                const float d0 = dot3(x.x, x.y, x.z, z.y, z.z, z.w);
                // e1 x v0, e2 x v0
                const float q1x = sub(mul(y.x, x.z), mul(y.y, x.y));
                const float q1y = sub(mul(y.y, x.x), mul(x.w, x.z));
                const float q1z = sub(mul(x.w, x.y), mul(y.x, x.x));
                const float q2x = sub(mul(y.w, x.z), mul(z.x, x.y));
                const float q2y = sub(mul(z.x, x.x), mul(y.z, x.z));
                const float q2z = sub(mul(y.z, x.y), mul(y.w, x.x));
                tile[threadIdx.x] = Staged{make_float4(z.y, z.z, z.w, d0),
                                           make_float4(x.w, y.x, y.y, y.z),
                                           make_float4(y.w, z.x, q1x, q1y),
                                           make_float4(q1z, q2x, q2y, q2z)};
            }
            __syncthreads();
            const int m = n_tris - base < kThreads ? n_tris - base : kThreads;
            if (live) {
#pragma unroll 4
                for (int j = 0; j < m; ++j) {
                    const float4 f = tile[j].a;
                    const float det = dot3(d[0], d[1], d[2], f.x, f.y, f.z);
                    if (!(fabsf(det) >= kEps)) continue;
                    const float inv_det = __fdiv_rn(1.0f, det);
                    const float t = mul(
                        sub(f.w, dot3(o[0], o[1], o[2], f.x, f.y, f.z)),
                        inv_det);
                    if (!(t > kEps && t < bt)) continue;
                    const float4 b = tile[j].b, c = tile[j].c, e = tile[j].e;
                    // e1 = b.xyz, e2 = (b.w, c.x, c.y), q1 = (c.z, c.w,
                    // e.x), q2 = e.yzw
                    const float u = mul(
                        -sub(dot3(cx, cy, cz, b.w, c.x, c.y),
                             dot3(d[0], d[1], d[2], e.y, e.z, e.w)),
                        inv_det);
                    const float v = mul(
                        sub(dot3(cx, cy, cz, b.x, b.y, b.z),
                            dot3(d[0], d[1], d[2], c.z, c.w, e.x)),
                        inv_det);
                    if (u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f) {
                        bt = t;
                        btri = base + j;
                        bu = u;
                        bv = v;
                    }
                }
            }
            __syncthreads();  // the tile is read before the next is staged
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

// o*, d*: (n,) float32 columns; active may be null; tris: (n_tris, 12)
// float32 records (v0, e1, e2, face).
extern "C" int oglrt_brute_sweep(const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const bool* active, const float* tris,
                                 int n_tris, float* t, int* tri, float* u,
                                 float* v, long long n, void* stream) {
    if (n > 0) {
        const Rays r{{ox, oy, oz}, {dx, dy, dz}, active};
        const long long grid = (n + kThreads - 1) / kThreads;
        brute_sweep_kernel<<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
            r, reinterpret_cast<const float4*>(tris), n_tris,
            Out{t, tri, u, v}, n);
    }
    return (int)cudaGetLastError();
}
