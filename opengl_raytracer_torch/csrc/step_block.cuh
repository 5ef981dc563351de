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

// Pixel j of a band tw pixels wide, as (column, row) from its bottom-left:
// row-major, j mod tw and j / tw; or, with kBlocks (the "packet" traversal
// when the band's rows are a multiple of 8 and tw of 16, JAX renderer.py:
// 322-336), in 8x16 pixel blocks, each a whole 128-ray packet: block b =
// j / 128 is the (b mod tw/16)-th block of the (b / (tw/16))-th band of 8
// rows, and k = j mod 128 its pixel (k mod 16, k / 16).  G1 gives ray j its
// pixel by this rule and G6 folds into each pixel its ray's colour
// (block_pos, the inverse in blocks).
template <bool kBlocks, typename I>
__device__ __forceinline__ void band_xy(I j, I tw, I& x, I& y) {
    if (kBlocks) {
        const I b = j / 128, k = j % 128, nbx = tw / 16;
        x = b % nbx * 16 + k % 16;
        y = b / nbx * 8 + k / 16;
    } else {
        x = j % tw;
        y = j / tw;
    }
}

// The position j in 8x16 block order of the band's pixel (x, y), tw a
// row: band_xy<true>'s inverse.
__device__ __forceinline__ long long block_pos(int x, int y, int tw) {
    return ((long long)(y / 8) * (tw / 16) + x / 16) * 128 + y % 8 * 16
           + x % 16;
}

// Ray g of a step, the rule G1 seeds by (ray_front.cu; ops/front.py:
// band_pixels): pixel j = g mod n_band of the band (band_xy: row-major, or
// with kBlocks in 8x16 blocks), x = col0 + its column, y = py0 + its row,
// at frame number frame + g / n_band (frames_per_step copies of the band
// follow each other); a ray at or past n_rays pads the last chunk as pixel
// (0, 0) at the step's frame, with no g / n_band added.  Sets x and y and
// returns the pixel seed x*1973 ^ y*9277 ^ frame*1664525
// (fragment.glsl:390), all mod 2^32 (the int64 frame number wraps there).
// I is the index type: long long (G1 and G3's index pass); permute.cu's
// timed uint32_t build gives the same seed where g, n_rays and n_band are
// below 2^32, as the frame number is only ever used mod 2^32.  G3 rebuilds
// seeds only in row-major order: the block order's steps carry the seed.
template <typename I, bool kBlocks = false>
__device__ __forceinline__ uint32_t ray_pixel_seed(const StepBlock* blk,
                                                   I g, I n_rays, I n_band,
                                                   I tw, I& x, I& y) {
    uint32_t frame = (uint32_t)blk->frame;
    x = 0;
    y = 0;
    if (g < n_rays) {
        I jx, jy;
        band_xy<kBlocks>(g % n_band, tw, jx, jy);
        x = (I)blk->col0 + jx;
        y = (I)blk->py0 + jy;
        frame += (uint32_t)(g / n_band);
    }
    return ((uint32_t)x * 1973u) ^ ((uint32_t)y * 9277u)
           ^ (frame * 1664525u);
}
