"""Monte-Carlo path integrator: scatter model + bounce loop + sample loop.

The shader's path logic (fragment.glsl:220-366), as in
``opengl_raytracer_tpu/ops/integrator.py``:

* ``scatter_soa`` — ``diffuse()`` (fragment.glsl:220-232), ``reflect`` and
  ``lerp()`` (fragment.glsl:234-240); ``scatter`` is its AoS form (the
  JAX package's compatibility surface, off the main path);
* ``raytrace`` — the bounce loop (fragment.glsl:309-350).  With
  ``reorder`` (the wide-BVH kernels' traversals), before bounce segment
  ``i`` where ``i >= 1`` and ``(i - 1) % sort_every == 0`` (every segment
  but the first at the default cadence 1), rays are reordered by a
  Morton/octant coherence key (int32 keys, ``morton.sort_keys``; a
  stable radix sort, ``radix_sort.sort_rays`` (G10), which returns the
  sorted keys with the int32 permutation; one gather,
  ``permute.reorder``, that moves only the columns a ray still needs, as
  the JAX sort's folds do, ``opengl_raytracer_tpu/ops/integrator.py:226-268``),
  and at the end the light is scattered back to pixel order by each ray's
  int32 original index (``permute.restore``; the seed too only with
  ``return_seed``, JAX ``:345-353``).  At one sample a pixel the
  reorder rebuilds a live ray's seed from its original index instead of
  moving it (``seed_recon``, as the JAX integrator's, ``:237-249``).
  Each segment, the traversal finds the nearest hits and the fused shade
  kernel (K2) updates the path state.  Terminated paths carry an
  ``alive`` mask; dead rays keep their frozen light;
* ``trace`` — ``rays_per_pixel`` independent paths averaged, the RNG state
  carried sequentially across samples (fragment.glsl:352-366).

All per-ray vec3 state travels as 3-tuples of (R,) columns.
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import permute, radix_sort, rng
from opengl_raytracer_torch.ops.front import FRONT_DRAWS
from opengl_raytracer_torch.ops.intersect import TINY, shading_table
from opengl_raytracer_torch.ops.morton import sort_keys


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def scatter_soa(seed, n3, d3, roughness, lambertian: bool):
    """Next bounce direction; returns (new_seed, (dx, dy, dz)).

    Draws three RNG values (fragment.glsl:221), computes the mirror
    direction with ``reflect`` and blends by ``1 - roughness``."""
    seed, x0 = rng.random_value(seed)
    seed, x1 = rng.random_value(seed)
    seed, x2 = rng.random_value(seed)
    xi = (x0, x1, x2)

    if lambertian:
        # normalize(normal + xi), denominator clamped at a denormal tiny
        s = tuple(n3[a] + xi[a] for a in range(3))
        s_len = _norm3(*s).clamp_min(TINY)
        diffuse = tuple(s[a] / s_len for a in range(3))
    else:
        # hemisphere mode: sign-flip xi into the normal's hemisphere
        flip = (xi[0] * n3[0] + xi[1] * n3[1] + xi[2] * n3[2]) < 0.0
        xi_h = tuple(torch.where(flip, -xi[a], xi[a]) for a in range(3))
        h_len = _norm3(*xi_h).clamp_min(TINY)
        diffuse = tuple(xi_h[a] / h_len for a in range(3))

    # GLSL reflect(I, N) = I - 2*dot(N, I)*N (fragment.glsl:320).
    d_dn = d3[0] * n3[0] + d3[1] * n3[1] + d3[2] * n3[2]
    spec = tuple(d3[a] - 2.0 * d_dn * n3[a] for a in range(3))

    # lerp(diffuseDir, specularDir, roughness): both inputs renormalized
    # with the zero-stays-zero guard, then the blend renormalized.
    dif_len = _norm3(*diffuse)
    g0 = tuple(torch.where(dif_len > 0.0, diffuse[a] / dif_len.clamp_min(TINY),
                           0.0) for a in range(3))
    spec_len = _norm3(*spec)
    g1 = tuple(torch.where(spec_len > 0.0, spec[a] / spec_len.clamp_min(TINY),
                           0.0) for a in range(3))
    t = 1.0 - roughness
    out = tuple(g0[a] * (1.0 - t) + g1[a] * t for a in range(3))
    o_len = _norm3(*out).clamp_min(TINY)
    return seed, tuple(out[a] / o_len for a in range(3))


def scatter(seed, normal, ray_dir, roughness, lambertian: bool):
    """AoS wrapper over :func:`scatter_soa` (the JAX package's
    ``scatter``): (R, 3) normal and direction in, (new_seed, (R, 3))
    out."""
    seed, d = scatter_soa(seed, tuple(normal[..., a] for a in range(3)),
                          tuple(ray_dir[..., a] for a in range(3)),
                          roughness, lambertian)
    return seed, torch.stack(d, -1)


def raytrace(scene, raycast_fn, o3, d3, seed0, block, n_bounces: int,
             reorder: bool = False, sort_every: int = 1,
             return_seed: bool = True, seed_recon=None):
    """One path per ray: returns (incoming light 3x(R,), final seed), both
    in the input ray order.

    ``raycast_fn(o3, d3, alive)`` returns a ``Nearest``; its rays' shading
    rows are picked by ``intersect.shading_table``; the shade kernel reads
    the sky colour and ``lambertian`` from the step ``block``
    (``ops/step_block.py``).  ``reorder`` sorts the
    rays by coherence key before bounce segment ``i >= 1`` where ``(i - 1)
    % sort_every == 0`` (the JAX renderer's ``reorder`` and the JAX
    ``raytrace``'s cadence, ``integrator.py:209``): every segment but the
    first at ``sort_every=1``.  A skipped segment traverses the rays in
    the order of the last reorder, one sort stale, the dead among the
    live; every kernel takes ``alive`` per ray, and the reorder and
    restore are permutations carrying all per-ray state, so the light is
    the same at any cadence.  ``return_seed=False``
    (single-sample callers, as in the JAX ``raytrace``, ``:134-137``) lets
    the reorder drop a dead ray's seed and the restore the seed column;
    with ``reorder`` the seed returned is then None.

    ``seed_recon`` (a ``permute.SeedRecon`` of how ``seed0`` was made;
    used only with ``reorder``; the reorder refuses it with
    ``return_seed``) lets each reorder
    rebuild a live ray's seed from its original index instead of moving
    it: a live ray before segment ``i`` has drawn the front's draws and
    exactly 3 at each earlier segment (K2 draws 3 for every ray and keeps
    them only where the ray was alive and hit, and only a hit keeps a ray
    alive), so its state is a closed-form LCG advance of its pixel seed
    (``ops/permute.py``).  A skipped reorder changes nothing there: K2
    draws 3 for every ray at every segment, sorted or not."""
    from opengl_raytracer_torch.ops.shade import shade_update

    R = o3[0].shape[0]
    dev = o3[0].device
    lo, hi = scene.root_min, scene.root_max

    ones = torch.ones(R, dtype=torch.float32, device=dev)
    zeros = torch.zeros(R, dtype=torch.float32, device=dev)
    origin, direction = tuple(o3), tuple(d3)
    ray_color = (ones, ones, ones)
    incoming = (zeros, zeros, zeros)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    seed = seed0
    orig = torch.arange(R, dtype=torch.int32, device=dev)

    for i in range(int(n_bounces)):
        if reorder and i > 0 and (i - 1) % sort_every == 0:
            # Primary rays arrive screen-coherent; bounce rays are sorted.
            # Dead rays hold the sentinel key and sort to the tail, and
            # alive is re-derived from the sorted keys (G2 keys, G10 sort,
            # G3 gather).  On a skipped segment K2's columns go straight on.
            keys_s, perm = radix_sort.sort_rays(
                sort_keys(origin, direction, lo, hi, alive))
            draws = FRONT_DRAWS + 3 * i
            origin, direction, ray_color, incoming, alive, seed, orig = (
                permute.reorder(keys_s, perm, origin, direction, ray_color,
                                incoming, seed, orig, return_seed,
                                seed_recon, draws))

        nearest = raycast_fn(origin, direction, alive)
        table, index = shading_table(scene, nearest)
        origin, direction, ray_color, incoming, alive, seed = shade_update(
            table, index, nearest, origin, direction, ray_color, incoming,
            alive, seed, block)

    if not reorder:
        return incoming, seed
    # Restore pixel order by scattering into each ray's original index (G3).
    return permute.restore(incoming, seed if return_seed else None, orig)


def trace(scene, raycast_fn, o3, d3, seed0, block, n_bounces: int,
          rays_per_pixel: int, reorder: bool = False, sort_every: int = 1,
          seed_recon=None):
    """Average ``rays_per_pixel`` independent paths (fragment.glsl:352-366).
    Returns (color, new seed), the color a 3-tuple of (R,) columns: the
    restore's own at one sample.

    With one sample the per-pixel seed dies here (each frame reseeds from
    the pixel and the frame number), so the restore drops it and ``seed0``
    stands in for it, as in the JAX ``trace`` (:381-386); ``seed_recon``
    (:func:`raytrace`) is passed on only then: later samples chain the
    seed, which the reorder carries (JAX ``renderer.py:166``)."""
    colors = []
    seed = seed0
    one = rays_per_pixel == 1
    for _ in range(rays_per_pixel):
        color, seed = raytrace(scene, raycast_fn, o3, d3, seed, block,
                               n_bounces, reorder, sort_every,
                               return_seed=not one,
                               seed_recon=seed_recon if one else None)
        colors.append(color)
    if one:
        return colors[0], seed0 if seed is None else seed
    return tuple(torch.stack([c[a] for c in colors]).mean(dim=0)
                 for a in range(3)), seed

