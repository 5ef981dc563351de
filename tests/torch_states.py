"""Inputs shared by the port's CPU tests and the CUDA tests of its
kernels (tests/test_torch_cuda.py), which build them alike: the states of
the seed-reconstruction tests (G3's plain version in
tests/test_torch_glue.py), the reference's box (the small-scene
traversals in tests/test_torch_traversal.py) and the keys of the sort's
tests (G10, tests/test_torch_sort.py).  Imports torch and the port
only, as the CUDA tests run where JAX is absent."""

import numpy as np
import torch

from opengl_raytracer_torch import Rect
from opengl_raytracer_torch.ops.camera import make_camera


def box_objects():
    """The reference's default scene without its two meshes
    (opengl_raytracer_tpu/presets.py:25-46): 7 boxes, 84 triangles, which
    "auto" renders by brute force."""
    return [
        Rect([8, 5, 0.1], [0, 0, 30], [0, 0, 0], [1, 0.25, 0.3],
             roughness=1, scale=10),
        Rect([8, 5, 0.1], [0, 0, -30], [0, 0, 0], [0.3, 0.25, 1],
             roughness=1, scale=10),
        Rect([8, 6, 0.1], [0, -25, 0], [90, 0, 0], [0.25, 1, 0.3],
             roughness=1, scale=10),
        Rect([6, 8, 0.1], [25, 0, 0], [0, 90, 0], [0.9, 0.9, 0.9],
             roughness=0, scale=10),
        Rect([8, 6, 0.1], [0, 25, 0], [90, 0, 0], [1, 1, 1],
             roughness=1, scale=10),
        Rect([5, 5, 0.25], [0, 23.9, 0], [-90, 0, 0], [0, 0, 0],
             [1, 1, 1], 1.5, scale=5),
        Rect([6, 8, 0.1], [-35, 0, 0], [0, 90, 0], [0.9, 0.9, 0.9],
             roughness=1, scale=10),
    ]


SORT_KINDS = ("random", "equal", "dead", "distinct16", "sorted", "reversed")


def sort_keys_case(kind: str, n: int, seed: int = 0) -> torch.Tensor:
    """(n,) int32 keys for the sort's tests: full-range random (the
    extremes included), all one key, all the dead-ray key, 16 distinct
    values (ties: the sort must be stable), random keys presorted, and
    the same reversed."""
    from opengl_raytracer_torch.ops.morton import DEAD_KEY32

    g = np.random.default_rng(seed)
    if kind == "equal":
        k = np.full(n, -123_457, np.int64)
    elif kind == "dead":
        k = np.full(n, DEAD_KEY32, np.int64)
    elif kind == "distinct16":
        k = g.integers(-2**31, 2**31, 16)[g.integers(0, 16, n)]
    else:
        k = g.integers(-2**31, 2**31, n)
        k[:2] = [-2**31, 2**31 - 1][:n]
        if kind == "sorted":
            k = np.sort(k)
        elif kind == "reversed":
            k = np.sort(k)[::-1]
        elif kind != "random":
            raise ValueError(kind)
    return torch.from_numpy(np.ascontiguousarray(k).astype(np.int32))


def recon_states(device, frame, F=2, tw=20, rows=12, chunk=256, W=64, H=48,
                 seed=21):
    """Pre-reorder states of a step's own rays at bounces 1-4, for seed
    reconstruction: F copies of a ``tw`` x ``rows`` band of a W x H frame
    from frame number ``frame``, in chunks of ``chunk`` rays (the last
    padded past the step's rays).  Each chunk's seeds come from the ray
    front's plain version; before bounce i a live ray holds its seed after
    3i more draws and a dead one junk, ~40% of the rays are dead (padding
    rays too: some stay live) and every ray sits at a random position
    (``orig`` a permutation).  Returns [(name, state, recon, draws)], the
    state ``permute.reorder``'s first 8 arguments.

    The carried seeds come from ``rng.advance_n``, the closed form the
    reconstruction itself uses, so these states hold G1's pixel rule and
    its 5 draws, not the 3 draws a bounce makes: those are proven by
    ``test_seed_recon_frame_bit_identical`` (tests/test_torch_render.py: a
    frame with the seed rebuilt against one that carries it) and
    ``test_advance_constants_are_the_frames_draws``
    (tests/test_torch_rng_camera.py)."""
    from opengl_raytracer_torch.ops import front, morton, permute, radix_sort
    from opengl_raytracer_torch.ops import rng
    from opengl_raytracer_torch.ops import step_block

    g = np.random.default_rng(seed)
    camera = make_camera((0.5, 1.0, 4.0), (170.0, -5.0))
    block = step_block.new(device)
    step_block.write(block, step_block.pack(frame, (8, 6, 0, 0, 0), camera,
                                            1.0, 0.4, True))
    n_band = tw * rows
    n_rays = F * n_band
    out = []
    for base in range(0, n_rays, chunk):
        _, _, seed0 = front.ray_front_plain(block, base, chunk, n_rays,
                                            n_band, tw, W, H, None)
        recon = permute.SeedRecon(block, base, n_rays, n_band, tw)
        for i in range(1, 5):
            orig = torch.from_numpy(g.permutation(chunk).astype(np.int32)
                                    ).to(device)
            live = torch.from_numpy(g.uniform(size=chunk) < 0.6).to(device)
            keys = torch.from_numpy(g.integers(-2**31, 2**31 - 1, chunk)
                                    .astype(np.int32)).to(device)
            keys = torch.where(live, keys, morton.DEAD_KEY32)
            junk = torch.from_numpy(g.integers(0, 2**32, chunk)).to(device)
            seed = torch.where(live, rng.advance_n(seed0[orig.long()], 3 * i),
                               junk)
            cols = [torch.from_numpy(g.normal(size=chunk).astype(np.float32))
                    .to(device) for _ in range(12)]
            for c in cols[9:]:  # a live ray carries no light
                c[live] = 0.0
            groups = tuple(tuple(cols[3 * k:3 * k + 3]) for k in range(4))
            keys_s, perm = radix_sort.sort_rays(keys.cpu())
            out.append((f"base{base}_b{i}",
                        (keys_s.to(device), perm.to(device), *groups, seed,
                         orig), recon,
                        front.FRONT_DRAWS + 3 * i))
    return out
