"""The benchmark's scenes, built from a configuration.

A frozen NumPy copy of the stand-in functions that ``chip_smoke.py`` times
(``_lat_long_grid``, ``_cells``, ``_bumpy``, ``_lat_long``,
``standin_objects``) and of the reference's box primitive (a cube of 12
triangles, scaled, rotated by XYZ Euler degrees and moved, as
``object.py:241-307`` of ``pirosow/openGL_raytracer`` bakes it).  The
benchmark makes every triangle, normal and material here; the program is
handed them only through its ``Triangles`` container, and the plain
reference (``rtbench/reference/``) reads the same arrays.
"""

from __future__ import annotations

import numpy as np

# the reference's camera (main.py:151-152)
CAM_POS = (-33.7, 14.8, -21.1)
CAM_DIR = (65.0, -25.4)
# the Cornell box's inner faces (the walls' centres less half their 1-unit
# thickness): x from the back wall to the mirror, y floor to ceiling, z
# blue wall to red wall
BOX_LO = (-34.5, -24.5, -29.5)
BOX_HI = (24.5, 24.5, 29.5)


def _lat_long_grid(n_lat, n_lon):
    """Unit vectors, theta and phi on an (n_lat+1) x (n_lon+1) lat-long
    grid."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                    axis=-1)
    return unit, T, P


def _cells(a):
    """Two triangles per cell of a grid of (..., k) values (polar cells
    included, as a UV sphere is tessellated) -> (2 * cells, 3, k)."""
    c00, c10 = a[:-1, :-1], a[1:, :-1]
    c11, c01 = a[1:, 1:], a[:-1, 1:]
    k = a.shape[-1]
    return np.concatenate([np.stack([c00, c10, c11], -2).reshape(-1, 3, k),
                           np.stack([c00, c11, c01], -2).reshape(-1, 3, k)])


def _bumpy(t, p):
    return 1.0 + 0.15 * np.sin(7 * t) * np.cos(7 * p)


def _lat_long(center, radius, n_lat, n_lon, smooth):
    """Triangles of a lat-long sphere, two per cell.  ``radius(theta, phi)``
    may vary."""
    unit, T, P = _lat_long_grid(n_lat, n_lon)
    pts = unit * radius(T, P)[..., None] + np.asarray(center, np.float64)
    tris = _cells(pts).astype(np.float32)
    normals = _cells(unit).astype(np.float32) if smooth else None
    return tris, normals


def face_normals(tris: np.ndarray) -> np.ndarray:
    """(T, 3, 3) per-vertex normals, each the triangle's unit geometric
    normal (a degenerate triangle's stays 0)."""
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    ln[ln == 0] = 1.0
    return np.repeat((n / ln)[:, None, :], 3, axis=1).astype(np.float32)


def _euler_xyz(deg) -> np.ndarray:
    rx, ry, rz = np.deg2rad(np.asarray(deg, np.float64))
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return Rx @ (Ry @ Rz)


def box(size, pos, eulers, scale) -> tuple[np.ndarray, np.ndarray]:
    """A box's 12 triangles and their per-vertex normals, (12, 3, 3) each:
    two a face, corners (0, 1, 2) and (0, 2, 3), baked as
    ``(R S) p + pos`` with normals through the inverse transpose of
    ``R S``, renormalised."""
    h = np.asarray(size, np.float32) / 2.0
    hx, hy, hz = (float(x) for x in h)
    faces = (
        ((-hx, -hy, hz), (hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz), (0, 0, 1)),
        ((hx, -hy, -hz), (-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz),
         (0, 0, -1)),
        ((-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz), (-hx, hy, -hz), (0, 1, 0)),
        ((-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz), (-hx, -hy, hz),
         (0, -1, 0)),
        ((hx, -hy, hz), (hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz), (1, 0, 0)),
        ((-hx, -hy, -hz), (-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz),
         (-1, 0, 0)),
    )
    pts, nrm = [], []
    for p0, p1, p2, p3, n in faces:
        pts += [p0, p1, p2, p0, p2, p3]
        nrm += [n] * 6
    pts = np.asarray(pts, np.float32)
    nrm = np.asarray(nrm, np.float32)
    rs = _euler_xyz(eulers) @ np.diag([scale] * 3).astype(np.float32)
    world = pts @ rs.T + np.asarray(pos, np.float32)
    wn = nrm @ np.linalg.inv(rs).T.astype(np.float32).T
    ln = np.linalg.norm(wn, axis=1, keepdims=True)
    ln[ln == 0] = 1.0
    wn = wn / ln
    return (world.astype(np.float32).reshape(12, 3, 3),
            wn.astype(np.float32).reshape(12, 3, 3))


# The reference's seven boxes (main.py:46-99, 84 triangles): size, position, Euler
# degrees, colour, emission colour, emission, roughness, scale.
BOXES = (
    ((8, 5, 0.1), (0, 0, 30), (0, 0, 0), (1, 0.25, 0.3), (0, 0, 0), 0.0, 1, 10),
    ((8, 5, 0.1), (0, 0, -30), (0, 0, 0), (0.3, 0.25, 1), (0, 0, 0), 0.0, 1,
     10),
    ((8, 6, 0.1), (0, -25, 0), (90, 0, 0), (0.25, 1, 0.3), (0, 0, 0), 0.0, 1,
     10),
    ((6, 8, 0.1), (25, 0, 0), (0, 90, 0), (0.9, 0.9, 0.9), (0, 0, 0), 0.0, 0,
     10),
    ((8, 6, 0.1), (0, 25, 0), (90, 0, 0), (1, 1, 1), (0, 0, 0), 0.0, 1, 10),
    ((5, 5, 0.25), (0, 23.9, 0), (-90, 0, 0), (0, 0, 0), (1, 1, 1), 1.5, 0, 5),
    ((6, 8, 0.1), (-35, 0, 0), (0, 90, 0), (0.9, 0.9, 0.9), (0, 0, 0), 0.0, 1,
     10),
)


def objects(dragon_cells, ball_cells=(32, 64), dragon_triangles=None) -> list:
    """The reference's default scene (main.py:19-99) with procedural
    stand-ins for its two OBJ meshes: a bumpy sphere of ``dragon_cells``
    (n_lat, n_lon) for the dragon, its first ``dragon_triangles`` when
    given (the last ones lie in the south polar row), a smooth sphere of
    ``ball_cells`` for the mirror ball; then the seven boxes.  Each object
    is a dict of ``tris`` and ``normals`` ((T, 3, 3) float32), ``color``,
    ``emission_color``, ``emission``, ``roughness``."""
    bumpy, _ = _lat_long([-5, -10, 0],
                         lambda t, p: 9.0 * _bumpy(t, p), *dragon_cells,
                         smooth=False)
    bumpy = bumpy[:dragon_triangles]
    ball, ball_n = _lat_long([-25, -20, 20], lambda t, p: np.full_like(t, 7.0),
                             *ball_cells, smooth=True)
    out = [dict(tris=bumpy, normals=face_normals(bumpy),
                color=(0.96, 0.96, 0.86), emission_color=(0, 0, 0),
                emission=0.0, roughness=1.0),
           dict(tris=ball, normals=ball_n, color=(1, 1, 1),
                emission_color=(0, 0, 0), emission=0.0, roughness=0.0)]
    for size, pos, eul, col, emc, em, rough, scale in BOXES:
        tris, nrm = box(size, pos, eul, scale)
        out.append(dict(tris=tris, normals=nrm, color=col, emission_color=emc,
                        emission=float(em), roughness=float(rough)))
    return out


def triangle_count(scene: dict) -> int:
    """Triangles of a configuration's ``scene`` recipe."""
    (a, b), (c, d) = scene["dragon_cells"], scene["ball_cells"]
    dragon = min(2 * a * b, scene.get("dragon_triangles") or 2 * a * b)
    return dragon + 2 * c * d + 12 * len(BOXES)


def build(scene: dict) -> tuple[list, tuple, tuple]:
    """(objects, camera position, camera yaw/pitch) of a configuration's
    ``scene`` recipe, at the reference's pose.  Every run of a cell renders
    this same scene from this same pose, whatever its seed: a seed that
    moved the camera or the bumps changed a frame's work by up to 13%."""
    objs = objects(scene["dragon_cells"], scene["ball_cells"],
                   scene.get("dragon_triangles"))
    return objs, CAM_POS, CAM_DIR


def flatten(objs: list) -> dict:
    """The scene's triangles and per-triangle materials as flat arrays, in
    object order: v0, v1, v2, n0, n1, n2 (T, 3), color and emission_color
    (T, 3), emission and roughness (T,), all float32."""
    tris = np.concatenate([o["tris"] for o in objs])
    nrm = np.concatenate([o["normals"] for o in objs])
    counts = [o["tris"].shape[0] for o in objs]

    def per_tri(key, width):
        return np.concatenate([
            np.broadcast_to(np.asarray(o[key], np.float32), (n, width))
            for o, n in zip(objs, counts)]).astype(np.float32)

    return dict(v0=tris[:, 0], v1=tris[:, 1], v2=tris[:, 2], n0=nrm[:, 0],
                n1=nrm[:, 1], n2=nrm[:, 2], color=per_tri("color", 3),
                emission_color=per_tri("emission_color", 3),
                emission=per_tri("emission", 1)[:, 0],
                roughness=per_tri("roughness", 1)[:, 0])
