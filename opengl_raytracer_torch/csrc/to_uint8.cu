// The App's display conversion, for Hopper: a finished sweep's (H, W, 3)
// float32 accumulation to (H, W, 3) uint8, on the step's stream.
//
// Replaces no TPU kernel.  The reference blits its RGBA32F accumulation
// to the 8-bit framebuffer on the GPU (main.py:397-399); the JAX package
// and the port's App before it read the float frame back and converted it
// on the host (utils/image.py:to_uint8, NumPy).  This kernel converts on
// the card, so the App copies 1 byte a channel to the host and not 4.
//
// Bit for bit with to_uint8 on finite values: clamp to [0, 1], multiply by
// 255 in float32 (round to nearest, no contraction: there is no add), round
// half to even (__float2int_rn, as np.round), convert.
//
// What bounds it on the card: bytes, 4 read and 1 written a channel
// (24,883,200 + 6,220,800 at 1920x1080: 9.3 us at 3.35 TB/s), against one
// multiply a channel.  Each thread converts 4 channels with one 16-byte
// load and one 4-byte store; a second launch of one block converts the
// last n % 4 channels, which no 1080p frame has.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned int to_byte(float x) {
    const float c = fminf(fmaxf(x, 0.0f), 1.0f);
    return (unsigned int)__float2int_rn(__fmul_rn(c, 255.0f));
}

__global__ void __launch_bounds__(256)
to_uint8_kernel(const float4* __restrict__ src, unsigned int* __restrict__ dst,
                long long n4) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n4) return;
    const float4 v = src[i];
    dst[i] = to_byte(v.x) | (to_byte(v.y) << 8) | (to_byte(v.z) << 16)
             | (to_byte(v.w) << 24);
}

__global__ void to_uint8_tail_kernel(const float* __restrict__ src,
                                     unsigned char* __restrict__ dst,
                                     long long first, long long n) {
    const long long i = first + threadIdx.x;
    if (i < n) dst[i] = (unsigned char)to_byte(src[i]);
}

}  // namespace

// src: n float32 (16-byte aligned), dst: n uint8 (4-byte aligned).
extern "C" int oglrt_to_uint8(const float* src, unsigned char* dst,
                              long long n, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long n4 = n / 4;
    if (n4 > 0) {
        const unsigned int blocks = (unsigned int)((n4 + 255) / 256);
        to_uint8_kernel<<<blocks, 256, 0, s>>>(
            reinterpret_cast<const float4*>(src),
            reinterpret_cast<unsigned int*>(dst), n4);
    }
    if (n % 4) to_uint8_tail_kernel<<<1, 4, 0, s>>>(src, dst, 4 * n4, n);
    return (int)cudaGetLastError();
}
