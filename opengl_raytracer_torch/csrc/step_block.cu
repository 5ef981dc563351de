// The step block's write, for Hopper.
//
// Before every step the host writes the step's values (step_block.cuh)
// into the renderer's block.  They travel as the launch's by-value
// argument, which CUDA copies when the launch is enqueued, so the host may
// build the next step's values while the card still runs this one: a
// pinned host buffer rewritten for step n + 1 before the stream had copied
// step n's would race.  It stands for the JAX package's passing of traced
// arguments to the jitted step (opengl_raytracer_tpu/renderer.py:495-500),
// not a Pallas kernel.  One warp writes the 32 words; its cost is the
// launch.

#include <cuda_runtime.h>

#include "step_block.cuh"

namespace {

struct Words {
    int w[sizeof(StepBlock) / 4];
};

__global__ void write_block_kernel(int* __restrict__ block, Words v) {
    block[threadIdx.x] = v.w[threadIdx.x];
}

}  // namespace

extern "C" int oglrt_write_block(int* block, const int* words, void* stream) {
    Words v;
    for (int k = 0; k < (int)(sizeof(Words) / 4); ++k) v.w[k] = words[k];
    write_block_kernel<<<1, sizeof(Words) / 4, 0, (cudaStream_t)stream>>>(block, v);
    return (int)cudaGetLastError();
}
