// The step block: every value a tile step takes that changes from step to
// step, in one small device buffer (ops/step_block.py writes it; its
// WORDS and field offsets must match this struct).  The kernels of a step
// read it at run time, so one CUDA graph of the step serves every frame
// number, tile, camera, sky, jitter and lambertian setting, and every
// accumulation buffer: the JAX package's traced arguments of the jitted
// step (opengl_raytracer_tpu/renderer.py:495-500).

#pragma once

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
