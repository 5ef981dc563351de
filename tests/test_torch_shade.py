"""K2's plain torch version against the JAX package's shading, on both
tables the wrapper takes:

* ``(sh_slot, slot)`` against the JAX fused shade kernel
  (``opengl_raytracer_tpu/ops/shade.py:shade_update``, interpret mode);
* ``(sh_abc, tri)`` against the JAX integrator's unfused path
  (``opengl_raytracer_tpu/ops/integrator.py:281-311``: ``finalize_hit_soa``
  gathering ``sh_abc[tri]``, ``scatter_soa`` and the state update), which
  the brute, BVH and wide-BVH traversals run;

and the AoS wrappers ``finalize_hit`` (``Hit``) and ``scatter`` against
the JAX package's.

Same NumPy inputs on both sides: a scene's material tables, and random
hits (slots or triangles, t with misses mixed in, barycentrics), ray
state, alive flags and uint32 seeds over the full range.  Tolerance as in
tests/test_shade.py: floats ``rtol=1e-5, atol=1e-6`` (mul+add contraction
differs between the two programs); seed and alive exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.ops.integrator import scatter as j_scatter
from opengl_raytracer_tpu.ops.integrator import scatter_soa as j_scatter_soa
from opengl_raytracer_tpu.ops.intersect import Nearest as JNearest
from opengl_raytracer_tpu.ops.intersect import finalize_hit as j_finalize_aos
from opengl_raytracer_tpu.ops.intersect import finalize_hit_soa as j_finalize
from opengl_raytracer_tpu.ops.shade import shade_update as j_shade_update

from opengl_raytracer_torch import make_camera, scene_from_numpy
from opengl_raytracer_torch.ops import step_block
from opengl_raytracer_torch.utils.config import SKY_COLOR
from opengl_raytracer_torch.ops.integrator import scatter
from opengl_raytracer_torch.ops.intersect import (BIG, Hit, Nearest,
                                                  finalize_hit, shading_table)
from opengl_raytracer_torch.ops.shade import shade_update
from test_torch_scene import jax_native  # noqa: F401 (autouse)

R = 1024


@pytest.fixture(scope="module")
def scenes():
    jdata = JScene([
        JRect([0, -1, 0], [14, 0.4, 14], [0.7, 0.8, 0.6], roughness=0.9),
        JRect([0.5, 0.6, 1.0], [1.2, 1.8, 0.9], [0.9, 0.3, 0.2],
              roughness=0.4),
        JRect([-1.5, 0.2, -0.5], [0.8, 0.8, 0.8], [1, 1, 1],
              emission=2.5, roughness=1.0),
        JRect([1.8, 0.1, -1.2], [0.6, 1.1, 0.6], [0.2, 0.4, 0.9],
              roughness=0.0),
    ], max_leaf_tris=8).send()
    fields = {k: np.asarray(getattr(jdata, k)) for k in jdata._fields
              if k != "p2_extra"}
    fields["p2_extra"] = ()
    return jdata, scene_from_numpy(fields, "cpu")


def _inputs(n_rows, seed=3):
    g = np.random.default_rng(seed)
    f32 = np.float32
    t = g.uniform(0.1, 10.0, R).astype(f32)
    t[g.uniform(size=R) < 0.2] = BIG  # misses
    u = g.uniform(0, 1, R).astype(f32)
    v = (g.uniform(0, 1, R) * (1 - u)).astype(f32)
    d = g.normal(size=(3, R))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return dict(
        slot=g.integers(0, n_rows, R).astype(np.int32), t=t, u=u, v=v,
        o=g.uniform(-4, 4, (3, R)).astype(f32), d=d.astype(f32),
        rc=g.uniform(0, 1, (3, R)).astype(f32),
        inc=g.uniform(0, 1, (3, R)).astype(f32),
        alive=g.uniform(size=R) < 0.8,
        seed=g.integers(0, 2**32, R, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("lambertian", [True, False])
def test_shade_plain_matches_jax_kernel(scenes, lambertian):
    jdata, tdata = scenes
    x = _inputs(tdata.sh_slot.shape[0])
    sky = np.asarray(SKY_COLOR, np.float32) * np.float32(0.8)
    em_scale = 2.0 if lambertian else 1.0

    jn = JNearest(t=jnp.asarray(x["t"]), tri=jnp.zeros(R, jnp.int32),
                  u=jnp.asarray(x["u"]), v=jnp.asarray(x["v"]),
                  slot=jnp.asarray(x["slot"]))
    col3 = lambda k: tuple(jnp.asarray(c) for c in x[k])  # noqa: E731
    ref = j_shade_update(jdata, jn, col3("o"), col3("d"), col3("rc"),
                         col3("inc"), jnp.asarray(x["alive"]),
                         jnp.asarray(x["seed"]), jnp.asarray(sky),
                         np.float32(em_scale), lambertian, interpret=True)

    tn = Nearest(t=torch.from_numpy(x["t"]), tri=torch.zeros(R, dtype=torch.int32),
                 u=torch.from_numpy(x["u"]), v=torch.from_numpy(x["v"]),
                 slot=torch.from_numpy(x["slot"]))
    got = _port_shade(tdata, tn, x, sky, em_scale, lambertian)
    _assert_shade_equal(ref, got, x)


def _port_shade(tdata, tn, x, sky, em_scale, lambertian):
    """The port's shade with the sky colour ``SKY_COLOR * 0.8`` and the
    emission scale of ``lambertian`` in a step block."""
    table, index = shading_table(tdata, tn)
    tcol3 = lambda k: tuple(torch.from_numpy(c) for c in x[k])  # noqa: E731
    block = step_block.new("cpu")
    step_block.write(block, step_block.pack(
        0, (0,) * 5, make_camera([0, 0, 0], [0, 0]), 0.8, 0.0, lambertian))
    v = step_block.values(block)
    assert v.sky == tuple(float(c) for c in sky) and v.em_scale == em_scale
    return shade_update(table, index, tn, tcol3("o"), tcol3("d"),
                        tcol3("rc"), tcol3("inc"), torch.from_numpy(x["alive"]),
                        torch.from_numpy(x["seed"].astype(np.int64)), block)


def _assert_shade_equal(ref, got, x):
    for g_ref, g_got in zip(ref[:4], got[:4]):
        for a in range(3):
            np.testing.assert_allclose(np.asarray(g_ref[a]), g_got[a].numpy(),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref[4]), got[4].numpy())
    np.testing.assert_array_equal(np.asarray(ref[5]).astype(np.int64),
                                  got[5].numpy())
    # the inputs exercise every branch: hits, misses, emissive kills
    assert got[4].sum() > 0 and (~got[4] & torch.from_numpy(x["alive"])).sum() > 0


def _j_unfused_shade(jdata, jn, o3, d3, rc3, inc3, alive, seed, sky,
                     em_scale, lambertian):
    """The JAX integrator's unfused bounce update (integrator.py:281-311)."""
    hit = j_finalize(jdata, o3, d3, jn)
    seed_h, new_dir = j_scatter_soa(seed, hit.normal, d3, hit.roughness,
                                    lambertian)
    was_hit = alive & hit.did_hit
    was_miss = alive & ~hit.did_hit
    em = hit.emission * em_scale
    inc = tuple(inc3[a]
                + jnp.where(was_hit, hit.emission_color[a] * em * rc3[a], 0.0)
                + jnp.where(was_miss, sky[a], 0.0) for a in range(3))
    rc = tuple(jnp.where(was_hit, rc3[a] * hit.color[a], rc3[a])
               for a in range(3))
    o = tuple(jnp.where(was_hit, hit.point[a] + hit.normal[a] * np.float32(1e-4),
                        o3[a]) for a in range(3))
    d = tuple(jnp.where(was_hit, new_dir[a], d3[a]) for a in range(3))
    seed = jnp.where(was_hit, seed_h, seed)
    return o, d, rc, inc, was_hit & ~(hit.emission > 0.0), seed


@pytest.mark.parametrize("lambertian", [True, False])
def test_shade_plain_on_triangle_table_matches_jax_unfused(scenes, lambertian):
    """Without a slot (brute, bvh and the wide-BVH traversal) the wrapper
    shades from sh_abc by triangle, as the JAX integrator's unfused path
    does."""
    jdata, tdata = scenes
    x = _inputs(tdata.sh_abc.shape[0], seed=5)
    tri = x.pop("slot")
    sky = np.asarray(SKY_COLOR, np.float32) * np.float32(0.8)
    em_scale = 2.0 if lambertian else 1.0

    jn = JNearest(t=jnp.asarray(x["t"]), tri=jnp.asarray(tri),
                  u=jnp.asarray(x["u"]), v=jnp.asarray(x["v"]))
    col3 = lambda k: tuple(jnp.asarray(c) for c in x[k])  # noqa: E731
    ref = _j_unfused_shade(jdata, jn, col3("o"), col3("d"), col3("rc"),
                           col3("inc"), jnp.asarray(x["alive"]),
                           jnp.asarray(x["seed"]), jnp.asarray(sky),
                           np.float32(em_scale), lambertian)

    tn = Nearest(t=torch.from_numpy(x["t"]), tri=torch.from_numpy(tri),
                 u=torch.from_numpy(x["u"]), v=torch.from_numpy(x["v"]))
    assert shading_table(tdata, tn)[0] is tdata.sh_abc
    got = _port_shade(tdata, tn, x, sky, em_scale, lambertian)
    _assert_shade_equal(ref, got, x)


@pytest.mark.parametrize("slots", [True, False])
def test_finalize_hit_aos_matches_jax(scenes, slots):
    """``finalize_hit`` with (R, 3) origins and directions, shading by
    slot (sub-block traversal) or by triangle, against the JAX
    ``finalize_hit``: ``Hit``'s fields, their shapes, did_hit exact."""
    jdata, tdata = scenes
    x = _inputs(tdata.sh_slot.shape[0] if slots else tdata.sh_abc.shape[0],
                seed=7)
    idx = x["slot"]
    kw = dict(slot=idx) if slots else {}
    jn = JNearest(t=jnp.asarray(x["t"]), tri=jnp.asarray(idx),
                  u=jnp.asarray(x["u"]), v=jnp.asarray(x["v"]),
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    tn = Nearest(t=torch.from_numpy(x["t"]), tri=torch.from_numpy(idx),
                 u=torch.from_numpy(x["u"]), v=torch.from_numpy(x["v"]),
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    o, d = x["o"].T.copy(), x["d"].T.copy()
    ref = j_finalize_aos(jdata, jnp.asarray(o), jnp.asarray(d), jn)
    got = finalize_hit(tdata, torch.from_numpy(o), torch.from_numpy(d), tn)
    assert isinstance(got, Hit) and got._fields == ref._fields
    np.testing.assert_array_equal(np.asarray(ref.did_hit), got.did_hit.numpy())
    for name in Hit._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.shape == r.shape, name
        np.testing.assert_allclose(r, g, rtol=1e-5, atol=1e-6, err_msg=name)
    assert got.did_hit.any() and not got.did_hit.all()


@pytest.mark.parametrize("lambertian", [True, False])
def test_scatter_aos_matches_jax(lambertian):
    """``scatter`` on (R, 3) normals and directions and uint32 seeds over
    the full range, against the JAX ``scatter``: seed exact, direction
    within the shade tolerance."""
    g = np.random.default_rng(11)
    n = g.normal(size=(R, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = g.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n, d = n.astype(np.float32), d.astype(np.float32)
    rough = g.uniform(0, 1, R).astype(np.float32)
    rough[:16] = (0, 1) * 8  # mirror and diffuse ends
    seed = g.integers(0, 2**32, R, dtype=np.uint64).astype(np.uint32)
    jseed, jdir = j_scatter(jnp.asarray(seed), jnp.asarray(n),
                            jnp.asarray(d), jnp.asarray(rough), lambertian)
    tseed, tdir = scatter(torch.from_numpy(seed.astype(np.int64)),
                          torch.from_numpy(n), torch.from_numpy(d),
                          torch.from_numpy(rough), lambertian)
    np.testing.assert_array_equal(np.asarray(jseed).astype(np.int64),
                                  tseed.numpy())
    assert tdir.shape == (R, 3)
    np.testing.assert_allclose(np.asarray(jdir), tdir.numpy(), rtol=1e-5,
                               atol=1e-6)
