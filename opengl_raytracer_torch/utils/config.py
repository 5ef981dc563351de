"""Render configuration (a copy of ``opengl_raytracer_tpu/utils/config.py``).

The reference hard-codes its knobs in ``main.py``'s ``__main__`` block
(reference: main.py:447-470) and threads them through ``App(...)``
(main.py:16).  Here they live in one frozen dataclass; per-frame values
(camera, frame counter, sky brightness, jitter) are arguments of
``Renderer.step`` instead.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs of a render.

    Attributes mirror the reference's App parameters (main.py:16,
    main.py:447-454):

    width, height: render resolution in pixels (reference ``window_size``).
    bounces: user-facing bounce count. NOTE the reference passes
        ``bounces + 1`` to the shader as ``nBounces`` (main.py:186); we
        preserve that quirk, so the integrator loop runs ``bounces + 1``
        iterations.
    rays_per_pixel: independent paths averaged per pixel per frame
        (fragment.glsl:352-366).
    jitter_amount: anti-aliasing jitter scale (fragment.glsl:398).
    lambertian: scatter mode toggle (fragment.glsl:220-232); also doubles
        emitted light (fragment.glsl:329-331).
    sky_brightness: multiplier on the constant sky color
        (fragment.glsl:242-244).
    tile_size: number of tiles per axis (the reference's ``tileSize``
        parameter divides the window, main.py:125-126). 1 = whole frame
        per step.  Need not divide the frame exactly — remainder tiles
        are masked like the reference's modulo gating.
    max_leaf_tris: BVH leaf size passed to the builder.  The traversal
        leaf-loop bound is always derived from the scene's actual BVH
        (renderer.resolve_leaf_bound), not from this value.
    traversal: "auto" | "brute" | "bvh" | "packet" | "pallas" | "pallas2",
        the names of the JAX package.  "brute" sweeps every triangle,
        "bvh" walks the binary BVH per ray, "packet" walks it a 128-ray
        packet at a time (8x16 pixel blocks where the tile allows), "pallas"
        runs the wide-BVH kernel (K3) and "pallas2" the sub-block kernel
        (K1).
        "auto" picks brute force for scenes of up to 128 triangles, else
        "pallas2" when the scene has sub-block tables, else "pallas"
        (renderer.resolve_traversal).
    ray_chunk: rays processed per inner chunk (bounds peak memory). 0 =
        whole frame at once, up to 2M rays per chunk.
    aspect: display aspect ratio for ray generation (reference main.py:137
        uses sw/sh — the DISPLAY size); 0 = use width/height.
    sort_every: reorder-sort cadence in bounces (1 = sort before every
        bounce segment, 2 = every other, ...).  A pure perf knob: the
        sort + final restore are permutations carrying per-ray RNG state,
        so the image is bit-identical at any cadence.
    frames_per_step: progressive frames converged per tile step (F>1
        batches F frames' sample streams into one render; per-sample RNG
        streams are the per-frame streams, so the image matches F
        sequential steps to float associativity).
    """

    width: int = 1920
    height: int = 1080
    bounces: int = 4
    rays_per_pixel: int = 1
    jitter_amount: float = 0.001
    lambertian: bool = True
    sky_brightness: float = 1.0
    tile_size: int = 1
    max_leaf_tris: int = 32
    traversal: str = "auto"
    ray_chunk: int = 0
    aspect: float = 0.0
    sort_every: int = 1
    frames_per_step: int = 1

    @property
    def ray_aspect(self) -> float:
        """Aspect ratio for ray generation.  The reference derives it from
        the DISPLAY size (main.py:137: ``sw / sh``), not the render size;
        0.0 (the default) means "no separate display" and falls back to
        width/height."""
        return self.aspect if self.aspect else self.width / self.height

    @property
    def n_bounces(self) -> int:
        """Iterations of the bounce loop (reference quirk: bounces + 1,
        main.py:186)."""
        return self.bounces + 1

    @property
    def tile_w(self) -> int:
        """Pixels per tile along x (reference main.py:125)."""
        return self.width // self.tile_size

    @property
    def tile_h(self) -> int:
        """Pixels per tile along y (reference main.py:126)."""
        return self.height // self.tile_size

    @property
    def num_tiles_x(self) -> int:
        """Tiles along x (reference main.py:156)."""
        return (self.width + self.tile_w - 1) // self.tile_w

    @property
    def num_tiles_y(self) -> int:
        """Tiles along y (reference main.py:157)."""
        return (self.height + self.tile_h - 1) // self.tile_h


SKY_COLOR = (0.1, 0.6, 0.92)
"""Constant sky color (fragment.glsl:388)."""
