// G6: the band fold, for Hopper.
//
// Replaces the JAX tile step's merge of a band into the accumulation
// (opengl_raytracer_tpu/renderer.py:367-391, with the frames_per_step sum
// of :367-368; XLA ops under jax.jit, not a Pallas kernel), which the
// port's plain version (ops/fold.py:fold_plain) runs as about a dozen
// torch kernels: the sum of the step's n_frames colour sets, the flip from
// GL rows (bottom up) to accum rows (top row first), the remainder-tile
// mask (band columns left of dx0 and rows below dy0 keep their value), and
// the running mean (prev * fc + sum) / (fc + weight) with fc the frame
// count as float32, written in place into accum.
//
// One thread a band pixel, row-major from the bottom GL row; its colour is
// that of ray j of each band copy: j is the pixel's own row-major index or,
// with blocks (the "packet" traversal's 8x16 pixel blocks), its position in
// the order G1 gave the rays (step_block.cuh:block_pos; the JAX step's
// inverse of to_blocks, renderer.py:369-374).  accum is read and written
// in the row-major path's order either way.
//
// The window (col0, row0, dx0, dy0), the frame count and accum's address
// are read from the step block (step_block.cuh), so a captured step folds
// each tile of each frame into whatever buffer the block names.
//
// Bit for bit against the plain version ON THE CARD: the colour sets are
// added one after another, and the mean's product, sum and quotient are
// round-to-nearest intrinsics in torch's order; the divisor is a float32
// tensor there (fc + weight), which torch divides IEEE-exactly, as the
// JAX fold divides.
//
// What bounds it on the card: bytes.  Per band pixel it reads 3 x n_frames
// colours and the 3 accum values and writes 3, against 3 x (n_frames + 2)
// operations.

#include <cuda_runtime.h>

#include "step_block.cuh"

namespace {

template <bool kBlocks>
__global__ void __launch_bounds__(256)
band_fold_kernel(const StepBlock* __restrict__ blk, const float* __restrict__ c0,
                 const float* __restrict__ c1, const float* __restrict__ c2,
                 long long n_band, int tw, int th, int n_frames, float weight,
                 int width) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_band) return;
    const int x = (int)(i % tw);
    const int y = (int)(i / tw);  // GL row of the band, from its bottom
    if (x < blk->dx0 || y < blk->dy0) return;  // the remainder tile's mask
    const long long j = kBlocks ? block_pos(x, y, tw) : i;  // its ray
    float* accum = reinterpret_cast<float*>(blk->accum);
    const long long p =
        ((long long)(blk->row0 + th - 1 - y) * width + blk->col0 + x) * 3;
    const float fc = __ll2float_rn(blk->frame);
    const float den = __fadd_rn(fc, weight);
    const float* cols[3] = {c0, c1, c2};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float s = cols[a][j];
        for (int f = 1; f < n_frames; ++f)
            s = __fadd_rn(s, cols[a][(long long)f * n_band + j]);
        accum[p + a] = __fdiv_rn(__fadd_rn(__fmul_rn(accum[p + a], fc), s), den);
    }
}

}  // namespace

// colors: three float32 columns of n_frames * n_band rays each (a step's
// frame copies of the band one after another, row-major from the bottom
// row, or in 8x16 blocks when blocks is 1); accum: the block's, (height,
// width, 3) float32.
extern "C" int oglrt_band_fold(const void* blk, const float* c0,
                               const float* c1, const float* c2,
                               long long n_band, int tw, int th, int n_frames,
                               float weight, int width, int blocks,
                               void* stream) {
    if (n_band > 0) {
        const long long grid = (n_band + 255) / 256;
        if (blocks)
            band_fold_kernel<true><<<(unsigned)grid, 256, 0,
                                     (cudaStream_t)stream>>>(
                (const StepBlock*)blk, c0, c1, c2, n_band, tw, th, n_frames,
                weight, width);
        else
            band_fold_kernel<false><<<(unsigned)grid, 256, 0,
                                      (cudaStream_t)stream>>>(
                (const StepBlock*)blk, c0, c1, c2, n_band, tw, th, n_frames,
                weight, width);
    }
    return (int)cudaGetLastError();
}
