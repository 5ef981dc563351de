// K3: nearest-hit traversal over the 8-wide BVH tiles, for Hopper.
//
// Replaces the Pallas kernel `_traverse_kernel` of
// opengl_raytracer_tpu/ops/pallas_traversal.py (launched by
// `raycast_pallas`).  That kernel marries 1024 rays to one node pointer and
// an SMEM stack, selects node and octet records with arithmetic one-hot
// blends, folds the children's hit flags into a scalar bitmask by an
// any-reduction and pulls each push entry out with a masked sum: all
// answers to Mosaic's (8, 128) vector tiles and its lack of dynamic lane
// indexing.  Here each thread walks one ray with a private stack, and reads
// the SAME tables (ops/wide_bvh.py, models/scene.py) by index arithmetic, so
// the two packages can be compared ray by ray:
//   pw_tiles (W/8, 8, 128): child j of wide node w at tile w/8, row j,
//     lanes (w%8)*16 + 0..5 [bmin.xyz, bmax.xyz]; the rank-j push entry of
//     octant o at lane (w%8)*16 + 6 + o, packed as the exact-integer float
//     entry*8 + child.  entry >= 0 is a wide node, -q-1 the leaf whose
//     triangles start at octet q, EMPTY_PACKED an empty child slot.
//   pl_tri_tiles (G, 8, 128): triangle slot s at tile s/64, row s%8, lanes
//     ((s%64)/8)*16 + 0..11 as [v0, e1, e2, face].
//
// Semantics kept from the Pallas kernel (pallas_traversal.py lines):
//   * the slab test with the unclamped inverse 1/d, as (b - o) * inv
//     (:76, :123-134).  An axis-parallel ray whose origin lies on a slab
//     plane makes 0 * inf = NaN, which jnp.minimum/maximum propagate, so
//     that child is not opened; fminf/fmaxf would drop the NaN and open it,
//     so min and max here are NaN-propagating.  A child is opened iff
//     far >= near && far >= 0 && max(near, 0) <= best_t (:135-138);
//   * empty child slots hold finite swapped boxes that pass the slab test;
//     only the EMPTY_PACKED sentinel keeps them off the stack.  The packed
//     entry is decoded with an arithmetic shift (:160-166);
//   * a leaf tests a fixed `leaf_octets` octets from its first one, reading
//     into neighbouring leaves' real triangles (:182-184); the table's
//     slack keeps the read inside it, and octets past its end are skipped;
//   * within an octet the least t wins and the lowest slot among equal t;
//     across octets and nodes the update is a strict < (:216-223); the
//     Moller-Trumbore form and acceptance test are those of :203-216;
//   * the push order comes from THIS ray's octant; the Pallas kernel takes
//     its block's dominant octant (:93-97), which changes only which slot
//     wins at an exact t tie.  The Pallas kernel opens a node for its whole
//     block when any of its rays opens it (:140-146); that finds nothing
//     nearer while slab tests are conservative, but a ray lying in a box's
//     face plane (a NaN slab) can miss here where the Pallas kernel hits;
//   * a dead ray enters with t0 = -BIG, can neither open nodes nor accept
//     hits, and leaves with t = -BIG (it exits at once here).
// The winner's barycentrics come from its own test, in the formula the JAX
// wrapper recomputes them with outside its kernel (:314-322).
//
// The per-ray stack holds at most (max_depth + 2) * 7 + 4 entries
// (ops/wide_bvh.py); the kernel is compiled for 64, 128 and 512 entries and
// the wrapper picks the smallest that holds the scene's bound, so local
// memory is reserved for no more than the tree needs.  A push past the end
// is counted into `overflow` (the Pallas kernel drops it silently).
//
// The arithmetic is written with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts into FMAs,
// in the order of the plain torch version (ops/pallas_traversal.py), so the
// kernel reproduces that version bit for bit.
//
// What bounds it on the card: per node, eight dependent reads of 24-byte
// child boxes and eight push entries scattered over a 4 KB tile (512 bytes
// apart), and per leaf octet eight 48-byte triangle reads 512 bytes apart;
// the tables stay in L2.  Rays of one warp walk different subtrees, so
// warps diverge.  This first version keeps one ray per thread with the
// stack in local memory and relies on the integrator's coherence sort to
// make neighbouring threads' rays alike; making it fast (node records laid
// out for coalesced reads, warp-coherent traversal) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;
constexpr int kRow = 128;
constexpr int kGroup = 16;
constexpr int kOrdLane0 = 6;
constexpr int kEmpty = -(1 << 20);
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
// NaN-propagating min and max, as torch.minimum / jnp.minimum.
__device__ __forceinline__ float nmin(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <int kStack>
__global__ void __launch_bounds__(128)
wide_traverse_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ t0,
                     const float* __restrict__ pw_tiles,
                     const float* __restrict__ tri_tiles, long long n_octets,
                     int leaf_octets, float* __restrict__ t_out,
                     int* __restrict__ slot_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ overflow,
                     long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float bt = t0[i];
    int bslot = 0;
    float bu = 0.0f, bv = 0.0f;

    if (bt > -kBig) {
        const float o0 = ox[i], o1 = oy[i], o2 = oz[i];
        const float d0 = dx[i], d1 = dy[i], d2 = dz[i];
        const float inv0 = __fdiv_rn(1.0f, d0);
        const float inv1 = __fdiv_rn(1.0f, d1);
        const float inv2 = __fdiv_rn(1.0f, d2);
        const int oct = ((d0 < 0.0f) << 2) | ((d1 < 0.0f) << 1) | (d2 < 0.0f);

        int stack[kStack];
        int sp = 0;
        stack[sp++] = 0;  // the root wide node
        int dropped = 0;

        while (sp > 0) {
            const int e = stack[--sp];
            if (e >= 0) {
                const float* g = pw_tiles + (long long)(e >> 3) * kTile +
                                 (e & 7) * kGroup;
                unsigned opened = 0;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float* b = g + j * kRow;
                    const float t1x = mul(sub(__ldg(b + 0), o0), inv0);
                    const float t1y = mul(sub(__ldg(b + 1), o1), inv1);
                    const float t1z = mul(sub(__ldg(b + 2), o2), inv2);
                    const float t2x = mul(sub(__ldg(b + 3), o0), inv0);
                    const float t2y = mul(sub(__ldg(b + 4), o1), inv1);
                    const float t2z = mul(sub(__ldg(b + 5), o2), inv2);
                    const float near = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)),
                                            nmin(t1z, t2z));
                    const float far = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)),
                                           nmax(t1z, t2z));
                    if (far >= near && far >= 0.0f && nmax(near, 0.0f) <= bt) {
                        opened |= 1u << j;
                    }
                }
                const float* ord = g + kOrdLane0 + oct;
#pragma unroll
                for (int r = 0; r < 8; ++r) {  // far first: rank 0 pops last
                    const int pk = (int)__ldg(ord + r * kRow);
                    const int ent = pk >> 3;
                    if (((opened >> (pk & 7)) & 1u) && ent != kEmpty) {
                        if (sp < kStack) {
                            stack[sp++] = ent;
                        } else {
                            ++dropped;
                        }
                    }
                }
            } else {
                const int first = -e - 1;
                for (int k = 0; k < leaf_octets; ++k) {
                    const int q = first + k;
                    if (q >= n_octets) break;
                    const float* oc = tri_tiles + (long long)(q >> 3) * kTile +
                                      (q & 7) * kGroup;
                    float tm = 0.0f, um = 0.0f, vm = 0.0f;
                    int jm = 0;
#pragma unroll 2
                    for (int j = 0; j < 8; ++j) {
                        const float* c = oc + j * kRow;
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
                        const float tc = valid ? t : kBig;
                        if (j == 0 || tc < tm) {  // lowest slot among equal t
                            tm = tc;
                            jm = j;
                            um = u;
                            vm = v;
                        }
                    }
                    if (tm < bt) {  // strict <, fragment.glsl:275
                        bt = tm;
                        bslot = q * 8 + jm;
                        bu = um;
                        bv = vm;
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

template <int kStack>
void launch(const float* ox, const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, const float* t0,
            const float* pw_tiles, const float* tri_tiles, long long n_octets,
            int leaf_octets, float* t_out, int* slot_out, float* u_out,
            float* v_out, int* overflow, long long n, cudaStream_t stream) {
    const int block = 128;
    const long long grid = (n + block - 1) / block;
    wide_traverse_kernel<kStack><<<(unsigned)grid, block, 0, stream>>>(
        ox, oy, oz, dx, dy, dz, t0, pw_tiles, tri_tiles, n_octets, leaf_octets,
        t_out, slot_out, u_out, v_out, overflow, n);
}

}  // namespace

extern "C" int oglrt_wide_traverse(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t0, const float* pw_tiles,
    const float* tri_tiles, long long n_octets, int leaf_octets,
    int stack_size, float* t_out, int* slot_out, float* u_out, float* v_out,
    int* overflow, long long n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (stack_size == 64) {
        launch<64>(ox, oy, oz, dx, dy, dz, t0, pw_tiles, tri_tiles, n_octets,
                   leaf_octets, t_out, slot_out, u_out, v_out, overflow, n, s);
    } else if (stack_size == 128) {
        launch<128>(ox, oy, oz, dx, dy, dz, t0, pw_tiles, tri_tiles, n_octets,
                    leaf_octets, t_out, slot_out, u_out, v_out, overflow, n, s);
    } else if (stack_size == 512) {
        launch<512>(ox, oy, oz, dx, dy, dz, t0, pw_tiles, tri_tiles, n_octets,
                    leaf_octets, t_out, slot_out, u_out, v_out, overflow, n, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
