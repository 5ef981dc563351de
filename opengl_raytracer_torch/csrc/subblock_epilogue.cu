// G4: K1's part epilogue, for Hopper.
//
// Replaces what the JAX sub-block wrapper does around each part's kernel
// launch (opengl_raytracer_tpu/ops/subblock_traversal.py:842-853 and the
// part combine and active mask at :672-693, XLA ops, not a Pallas kernel): the hit mask,
// the slot clamp, tri = remap[slot], the three selects of a miss, the
// part's slot base, the strict-< combine with the earlier parts' nearest
// hit (ties keep the earlier part), and the active mask: the next part's
// entry t (-BIG for an inactive ray) or, after the last part, t = BIG for
// an inactive ray.  The port's plain version
// (ops/subblock_traversal.py:_epilogue_plain) runs about 12 torch kernels
// a part; here one thread per ray does them all, one launch a part.
//
// It is a kernel of its own, not folded into K1's launch: K1's walk keeps
// its 64 registers and its timing untouched, and its profile build (the
// same source, probes/k1.py) is left as it is.  Every output is a select,
// a clamp, an integer add or a table read, so it equals the plain version
// bit for bit.
//
// What bounds it on the card: bytes.  Per ray it reads K1's t, slot, u, v,
// one remap entry, the earlier parts' five columns (from the second part
// on) and the active flag, and writes five columns and the next entry t:
// 37-61 bytes against a dozen operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

struct Hit {  // a Nearest's columns
    float* t;
    int* tri;
    float* u;
    float* v;
    int* slot;
};

struct HitIn {
    const float* t;
    const int* tri;
    const float* u;
    const float* v;
    const int* slot;
};

__global__ void __launch_bounds__(256)
part_epilogue_kernel(HitIn k1, const int* __restrict__ remap, int n_remap,
                     int slot_base, HitIn prev, const bool* __restrict__ active,
                     int last, Hit out, float* __restrict__ next_t0, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float t = k1.t[i];
    const bool did_hit = (t < kBig) && (t > -kBig);
    int s = k1.slot[i];
    s = s < 0 ? 0 : (s > n_remap - 1 ? n_remap - 1 : s);
    float rt = did_hit ? t : kBig;
    int rtri = __ldg(remap + s);
    float ru = did_hit ? k1.u[i] : 0.0f;
    float rv = did_hit ? k1.v[i] : 0.0f;
    int rslot = s + slot_base;
    if (prev.t) {
        const float pt = prev.t[i];
        if (!(rt < pt)) {  // strict <: ties keep the earlier part
            rt = pt;
            rtri = prev.tri[i];
            ru = prev.u[i];
            rv = prev.v[i];
            rslot = prev.slot[i];
        }
    }
    if (active) {
        const bool a = active[i];
        if (last) {
            rt = a ? rt : kBig;
        } else {
            next_t0[i] = a ? rt : -kBig;
        }
    }
    out.t[i] = rt;
    out.tri[i] = rtri;
    out.u[i] = ru;
    out.v[i] = rv;
    out.slot[i] = rslot;
}

}  // namespace

// prev_* null for the first part; active and next_t0 may be null.
extern "C" int oglrt_subblock_epilogue(
    const float* t, const int* slot, const float* u, const float* v,
    const int* remap, int n_remap, int slot_base, const float* prev_t,
    const int* prev_tri, const float* prev_u, const float* prev_v,
    const int* prev_slot, const bool* active, int last, float* out_t,
    int* out_tri, float* out_u, float* out_v, int* out_slot, float* next_t0,
    long long n, void* stream) {
    if (n > 0) {
        const int block = 256;
        const long long grid = (n + block - 1) / block;
        part_epilogue_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            HitIn{t, nullptr, u, v, slot}, remap, n_remap, slot_base,
            HitIn{prev_t, prev_tri, prev_u, prev_v, prev_slot}, active, last,
            Hit{out_t, out_tri, out_u, out_v, out_slot}, next_t0, n);
    }
    return (int)cudaGetLastError();
}
