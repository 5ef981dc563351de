// The step block: every value a tile step takes that changes from step to
// step, in one small device buffer (ops/step_block.py writes it; its
// WORDS and field offsets must match this struct).  The kernels of a step
// read it at run time, so one CUDA graph of the step serves every frame
// number, tile, camera, sky, jitter and lambertian setting, and every
// accumulation buffer: the JAX package's traced arguments of the jitted
// step (opengl_raytracer_tpu/renderer.py:495-500).

#pragma once

#include <stdint.h>

struct StepBlock {
    long long frame;   // the step's frame number (G1 seeds it mod 2^32)
    long long accum;   // address of the (H, W, 3) float32 accumulation
    int col0, py0;     // the band's first column and GL row
    int dx0, dy0;      // leading columns and rows the merge masks out
    int row0;          // the band's top row in accum (top row first)
    int lambertian;    // 1 or 0
    float cam[12];     // pos, right, up, forward
    float sky[3];      // SKY_COLOR * sky brightness
    float em_scale;    // 2 when lambertian, else 1
    float jitter;
    int pad[5];
};

static_assert(sizeof(StepBlock) == 128, "StepBlock is 32 words");

// Ray g of a step, the rule G1 seeds by (ray_front.cu; ops/front.py:
// band_pixels): pixel j = g mod n_band of the band, row-major from its
// bottom GL row, x = col0 + j mod tw, y = py0 + j / tw, at frame number
// frame + g / n_band (frames_per_step copies of the band follow each
// other); a ray at or past n_rays pads the last chunk as pixel (0, 0) at
// the step's frame, with no g / n_band added.  Sets x and y and returns the
// pixel seed x*1973 ^ y*9277 ^ frame*1664525 (fragment.glsl:390), all
// mod 2^32 (the int64 frame number wraps there).  I is the index type:
// long long (G1 and G3's index pass); permute.cu's timed uint32_t build
// gives the same seed where g, n_rays and n_band are below 2^32, as the
// frame number is only ever used mod 2^32.
template <typename I>
__device__ __forceinline__ uint32_t ray_pixel_seed(const StepBlock* blk,
                                                   I g, I n_rays, I n_band,
                                                   I tw, I& x, I& y) {
    uint32_t frame = (uint32_t)blk->frame;
    x = 0;
    y = 0;
    if (g < n_rays) {
        const I j = g % n_band;
        x = (I)blk->col0 + j % tw;
        y = (I)blk->py0 + j / tw;
        frame += (uint32_t)(g / n_band);
    }
    return ((uint32_t)x * 1973u) ^ ((uint32_t)y * 9277u)
           ^ (frame * 1664525u);
}
