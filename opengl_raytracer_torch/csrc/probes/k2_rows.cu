// K2's row fetch, measured apart from its math: two sums over material rows
// gathered by slot, for Hopper.
//
// The counterpart of the probe kernels `_sum_kernel_t` and
// `_sum_kernel_inker` of experiments/shadeglue_ab.py (:89, :92), which
// priced how the JAX shade kernel is fed its rows.  Each computes the
// probe's 24-term weighted sum of the row of slot[i]:
//     acc = x[0]; acc = acc + x[a] * (1 + a), a = 1 .. 23,
// once reading the (S, 24) row table that K2 (csrc/shade.cu) reads, as
// six 16-byte loads of a 96-byte row, and once reading a pre-transposed
// (24, S) table, 24 scalar loads 4*S bytes apart.  The arithmetic is
// written with round-to-nearest intrinsics in that order, so both equal
// the plain torch version (opengl_raytracer_torch/probes/k2.py) bit for
// bit.  One thread a ray; the sums are the probe's, not K2's shading.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float term(float acc, float x, int a) {
    return __fadd_rn(acc, __fmul_rn(x, (float)(1 + a)));
}

__global__ void __launch_bounds__(kBlock)
rows_sum_kernel(const float4* __restrict__ table, const int* __restrict__ slots,
                float* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i >= n) return;
    const float4* r = table + (size_t)slots[i] * 6;
    const float4 q0 = __ldg(r + 0), q1 = __ldg(r + 1), q2 = __ldg(r + 2);
    const float4 q3 = __ldg(r + 3), q4 = __ldg(r + 4), q5 = __ldg(r + 5);
    const float x[24] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                         q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w,
                         q4.x, q4.y, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w};
    float acc = x[0];
#pragma unroll
    for (int a = 1; a < 24; ++a) acc = term(acc, x[a], a);
    out[i] = acc;
}

__global__ void __launch_bounds__(kBlock)
cols_sum_kernel(const float* __restrict__ table_t, long long S,
                const int* __restrict__ slots, float* __restrict__ out,
                long long n) {
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i >= n) return;
    const float* c = table_t + slots[i];
    float acc = __ldg(c);
#pragma unroll
    for (int a = 1; a < 24; ++a) acc = term(acc, __ldg(c + a * S), a);
    out[i] = acc;
}

}  // namespace

extern "C" int oglrt_k2_rows_sum(const void* table, const int* slots,
                                 float* out, long long n, void* stream) {
    if (n > 0)
        rows_sum_kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0,
                          (cudaStream_t)stream>>>(
            static_cast<const float4*>(table), slots, out, n);
    return (int)cudaGetLastError();
}

extern "C" int oglrt_k2_cols_sum(const float* table_t, long long S,
                                 const int* slots, float* out, long long n,
                                 void* stream) {
    if (n > 0)
        cols_sum_kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0,
                          (cudaStream_t)stream>>>(table_t, S, slots, out, n);
    return (int)cudaGetLastError();
}
