// G5: K3's wrapper prologue and epilogue, for Hopper.
//
// Replaces what the JAX wide-BVH wrapper does around its kernel launch
// (opengl_raytracer_tpu/ops/pallas_traversal.py:270-279 and the entry t
// before it; XLA ops, not a Pallas kernel), which the port's
// ops/pallas_traversal.py:raycast_pallas ran as about ten torch kernels a
// bounce: the prologue builds K3's entry t from the active mask (BIG for a
// live ray, -BIG for a dead one, which K3 leaves untouched); the epilogue
// resolves K3's output: the hit mask (-BIG < t < BIG), t = BIG on a miss,
// tri = remap[slot] with the slot clamped into the table (a JAX gather
// clamps), and u = v = 0 on a miss.  Two entry points, one launch each.
// K3's own source is not touched: it keeps its 80 registers and its time.
// The prologue also gives K1's chain kernel (subblock_traversal.cu) its
// entry t; that kernel resolves its own hits.
//
// Every output is a select, a clamp or a table read, so both equal their
// plain versions bit for bit.
//
// What bounds it on the card: bytes.  The prologue reads a flag and writes
// a float a ray (5 bytes); the epilogue reads t, slot, u, v and one remap
// entry and writes t, tri, u, v (36 bytes) against a handful of
// operations.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(256)
wide_prologue_kernel(const bool* __restrict__ active, float* __restrict__ t0,
                     long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    t0[i] = (active == nullptr || active[i]) ? kBig : -kBig;
}

__global__ void __launch_bounds__(256)
wide_epilogue_kernel(const float* __restrict__ t, const int* __restrict__ slot,
                     const float* __restrict__ u, const float* __restrict__ v,
                     const int* __restrict__ remap, int n_remap,
                     float* __restrict__ t_out, int* __restrict__ tri_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float ti = t[i];
    const bool did_hit = (ti < kBig) && (ti > -kBig);
    int s = slot[i];
    s = s < 0 ? 0 : (s > n_remap - 1 ? n_remap - 1 : s);
    t_out[i] = did_hit ? ti : kBig;
    tri_out[i] = __ldg(remap + s);
    u_out[i] = did_hit ? u[i] : 0.0f;
    v_out[i] = did_hit ? v[i] : 0.0f;
}

inline unsigned grid_of(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

// active may be null (every ray live).
extern "C" int oglrt_wide_prologue(const bool* active, float* t0, long long n,
                                   void* stream) {
    if (n > 0)
        wide_prologue_kernel<<<grid_of(n), 256, 0, (cudaStream_t)stream>>>(
            active, t0, n);
    return (int)cudaGetLastError();
}

extern "C" int oglrt_wide_epilogue(const float* t, const int* slot,
                                   const float* u, const float* v,
                                   const int* remap, int n_remap, float* t_out,
                                   int* tri_out, float* u_out, float* v_out,
                                   long long n, void* stream) {
    if (n > 0)
        wide_epilogue_kernel<<<grid_of(n), 256, 0, (cudaStream_t)stream>>>(
            t, slot, u, v, remap, n_remap, t_out, tri_out, u_out, v_out, n);
    return (int)cudaGetLastError();
}
