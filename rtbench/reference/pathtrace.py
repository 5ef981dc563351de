"""The plain reference: the reference shader's per-pixel path tracing
(``pirosow/openGL_raytracer`` fragment.glsl:106-414, as ``tests/oracle.py``
transcribes it) in plain PyTorch, for a sample of pixels and frames.

It imports nothing of the program.  It takes the triangles, normals and
materials that ``rtbench/scenes.py`` made, the camera pose and the frame
numbers, and builds its own acceleration structure: a complete binary tree
over the triangles, split top down at the median along each node's longest
axis, ``LEAF`` triangles a leaf, walked with a stack per ray in lock step;
the few triangles longer than a twentieth of the scene are tested by every
ray.  A walk finds the nearest triangle that the
shader's test accepts, whatever tree it walks, so the tree changes only
the time.

``dtype`` is the precision of every float operation: ``torch.float32`` is
the reference; a lower one (``torch.bfloat16``) is the control that the
comparison must refuse.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
SKY = (0.1, 0.6, 0.92)  # fragment.glsl:388
EPS = 1e-6  # the triangle test's parallel and self-hit bound
LEAF = 8
STACK = 64


# ----------------------------------------------------------------- RNG

def rand(state: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """fragment.glsl:206-218 on uint32 states held in int64: the next state
    and a value in [-1, 1]."""
    state = (state * 747796405 + 2891336453) & MASK
    t = state >> ((state >> 28) + 4)
    result = ((t ^ state) * 277803737) & MASK
    result = (result >> 22) ^ result
    value = result.to(torch.float32) / 4294967296.0 * 2.0 - 1.0
    return state, value.to(dtype)


def seeds(px: torch.Tensor, py: torch.Tensor, frame: torch.Tensor):
    """fragment.glsl:390: ``x*1973 ^ y*9277 ^ frame*1664525`` mod 2^32."""
    f = frame & MASK
    f = (f * (1664525 & 0xFFFF) + (((f * (1664525 >> 16)) & 0xFFFF) << 16)) \
        & MASK
    return ((px * 1973) & MASK) ^ ((py * 9277) & MASK) ^ f


# -------------------------------------------------------------- camera

def camera_basis(cam_dir) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(right, up, forward) from yaw and pitch in degrees (main.py:211-237)."""
    yaw = math.radians(float(cam_dir[0]))
    pitch = math.radians(float(cam_dir[1]))
    forward = np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                        math.cos(yaw) * math.cos(pitch)], np.float32)
    forward /= np.linalg.norm(forward)
    right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), forward)
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    up /= np.linalg.norm(up)
    return right, up, forward


def _norm(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True)).clamp_min(1e-30)


def primary_rays(px, py, frame, width: int, height: int, cam_pos, cam_dir,
                 jitter: float, dtype, device):
    """Origins, directions and RNG states of the primary rays of pixels
    (px, py) (py from the bottom row) at ``frame`` (fragment.glsl:376-407):
    the seed and three warm-up draws, the angle-linear direction at the
    pixel's centre, two jitter draws."""
    state = seeds(px, py, frame)
    for _ in range(3):
        state, _ = rand(state, dtype)
    right, up, fwd = (torch.tensor(a, dtype=dtype, device=device)
                      for a in camera_basis(cam_dir))
    fov = math.radians(90.0)
    aspect = width / height
    f32 = np.float32
    sx, sy = float(f32(-fov / 2 * aspect)), float(f32(-fov / 2))
    kx, ky = float(f32(fov * aspect)), float(f32(fov))
    u = ((px.to(torch.float32) + 0.5) / width).to(dtype)
    v = ((py.to(torch.float32) + 0.5) / height).to(dtype)
    d = (right * (sx + u * kx)[:, None] + up * (sy + v * ky)[:, None] + fwd)
    d = _norm(d)
    state, j1 = rand(state, dtype)
    state, j2 = rand(state, dtype)
    d = _norm(d + (right * j1[:, None] + up * j2[:, None]) * jitter)
    o = torch.tensor(np.asarray(cam_pos, np.float32), dtype=dtype,
                     device=device).expand_as(d).clone()
    return o, d, state


# ----------------------------------------------------------------- tree

class Tree:
    """A complete binary tree over the scene's small triangles, each node's
    split at the median centroid along its longest axis, ``LEAF`` triangles
    a leaf; node ``i``'s children are
    ``2i + 1`` and ``2i + 2``, the leaves the last ``n_leaves`` nodes.
    Boxes are widened by a relative 1e-5 so that rounding in the slab test
    never culls a triangle the triangle test would accept."""

    def __init__(self, flat: dict, dtype, device):
        f = {k: torch.as_tensor(np.ascontiguousarray(flat[k]), device=device)
             for k in ("v0", "v1", "v2", "n0", "n1", "n2", "color",
                       "emission_color", "emission", "roughness")}
        v0 = f["v0"].float()
        e1 = f["v1"].float() - v0
        e2 = f["v2"].float() - v0
        face = torch.linalg.cross(e1, e2)
        # triangles longer than a twentieth of the scene (the box's walls
        # and light) are tested by every ray; the rest go in the tree
        lo3 = torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2)
        hi3 = torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2)
        extent = (hi3 - lo3).amax(1)
        scene = (hi3.amax(0) - lo3.amin(0)).max()
        big = extent > scene / 20
        self.big = torch.nonzero(big).squeeze(1)
        self.big_cols = tuple(x[self.big].to(dtype)
                              for x in (v0, e1, e2, face))
        small = torch.nonzero(~big).squeeze(1)
        T = small.shape[0]
        n_leaves = 1 << max(0, math.ceil(math.log2(max(1, -(-T // LEAF)))))
        slots = torch.full((n_leaves * LEAF,), -1, dtype=torch.int64,
                           device=device)
        slots[:T] = small
        cen = torch.full((n_leaves * LEAF, 3), float("inf"), device=device)
        cen[:T] = v0[small] + (e1[small] + e2[small]) / 3.0
        # top down, each node's triangles split at the median of their
        # centroids along its longest axis (padding sorts last)
        nodes = 1
        while nodes < n_leaves:
            c = cen.view(nodes, -1, 3)
            fin = torch.isfinite(c[..., :1])
            ext = (torch.where(fin, c, -float("inf")).amax(1)
                   - torch.where(fin, c, float("inf")).amin(1))
            axis = torch.nan_to_num(ext, nan=-1.0, neginf=-1.0).argmax(1)
            key = c.gather(2, axis[:, None, None].expand(-1, c.shape[1], 1))
            order = key.squeeze(2).argsort(dim=1, stable=True)
            slots = slots.view(nodes, -1).gather(1, order).reshape(-1)
            cen = c.gather(1, order[..., None].expand(-1, -1, 3)).reshape(
                -1, 3)
            nodes *= 2
        self.n_leaves = n_leaves
        self.n_small = T
        self.tri = slots.view(n_leaves, LEAF)
        ok = (slots >= 0)[:, None]
        idx = slots.clamp_min(0)
        pts = torch.stack([v0[idx], v0[idx] + e1[idx], v0[idx] + e2[idx],
                           f["v1"].float()[idx], f["v2"].float()[idx]], 1)
        inf = torch.tensor(float("inf"), device=device)
        blo = torch.where(ok, pts.min(1).values, inf).view(n_leaves, LEAF, 3)
        bhi = torch.where(ok, pts.max(1).values, -inf).view(n_leaves, LEAF, 3)
        levels_lo, levels_hi = [blo.min(1).values], [bhi.max(1).values]
        while levels_lo[-1].shape[0] > 1:
            a, b = levels_lo[-1], levels_hi[-1]
            levels_lo.append(torch.minimum(a[0::2], a[1::2]))
            levels_hi.append(torch.maximum(b[0::2], b[1::2]))
        box_lo = torch.cat(levels_lo[::-1])
        box_hi = torch.cat(levels_hi[::-1])
        # a node over padding alone is empty: no ray enters it
        self.full = torch.isfinite(box_lo).all(1)
        pad = 1e-5 * torch.maximum(box_lo.abs(), box_hi.abs()) + 1e-5
        pad = torch.where(self.full[:, None], pad, 0.0)
        self.box_lo = (box_lo - pad).to(dtype)
        self.box_hi = (box_hi + pad).to(dtype)
        # the triangle test's columns per leaf slot (padding: face 0, so
        # det 0 and never accepted)
        self.v0 = torch.where(ok, v0[idx], 0).view(n_leaves, LEAF, 3).to(dtype)
        self.e1 = torch.where(ok, e1[idx], 0).view(n_leaves, LEAF, 3).to(dtype)
        self.e2 = torch.where(ok, e2[idx], 0).view(n_leaves, LEAF, 3).to(dtype)
        self.face = torch.where(ok, face[idx], 0).view(n_leaves, LEAF,
                                                       3).to(dtype)
        # shading rows in scene order
        self.n = torch.stack([f["n0"], f["n1"], f["n2"]], 1).to(dtype)
        self.face_all = face.to(dtype)
        self.color = f["color"].to(dtype)
        self.emission_color = f["emission_color"].to(dtype)
        self.emission = f["emission"].to(dtype)
        self.roughness = f["roughness"].to(dtype)

    def _boxes(self, node, o, inv):
        t1 = (self.box_lo[node] - o) * inv
        t2 = (self.box_hi[node] - o) * inv
        near = torch.fmin(t1, t2).nan_to_num(nan=-float("inf")).amax(-1)
        far = torch.fmax(t1, t2).nan_to_num(nan=float("inf")).amin(-1)
        return near, far

    def nearest(self, o, d):
        """(t, triangle, u, v) of each ray's nearest accepted hit; t inf
        and triangle -1 on a miss."""
        R, dev, dt = o.shape[0], o.device, o.dtype
        inv = 1.0 / d
        best_t = torch.full((R,), float("inf"), dtype=dt, device=dev)
        best_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros(R, dtype=dt, device=dev)
        best_v = torch.zeros(R, dtype=dt, device=dev)
        if self.big.numel():
            for a in range(0, R, 1 << 15):
                ri = torch.arange(a, min(R, a + (1 << 15)), device=dev)
                self._test(ri, self.big_cols, self.big[None], o, d, best_t,
                           best_tri, best_u, best_v)
        if not self.n_small:
            return best_t, best_tri, best_u, best_v
        stack = torch.zeros((R, STACK), dtype=torch.int64, device=dev)
        stack_t = torch.zeros((R, STACK), dtype=dt, device=dev)
        sp = torch.zeros(R, dtype=torch.int64, device=dev)
        root = torch.zeros(R, dtype=torch.int64, device=dev)
        near, far = self._boxes(root, o, inv)
        hit = far >= near.clamp_min(0)
        stack_t[:, 0] = near
        sp[hit] = 1
        first_leaf = self.n_leaves - 1
        idx = torch.nonzero(sp > 0).squeeze(1)
        while idx.numel():
            s = sp[idx] - 1
            sp[idx] = s
            node = stack[idx, s]
            live = stack_t[idx, s] < best_t[idx]
            idx, node = idx[live], node[live]
            leaf = node >= first_leaf
            li, ln = idx[leaf], node[leaf] - first_leaf
            if li.numel():
                self._leaf(li, ln, o, d, best_t, best_tri, best_u, best_v)
            ii, inode = idx[~leaf], node[~leaf]
            if ii.numel():
                kids = torch.stack([2 * inode + 1, 2 * inode + 2], 1)
                cn, cf = self._boxes(kids, o[ii, None], inv[ii, None])
                ok = ((cf >= cn.clamp_min(0)) & (cn < best_t[ii, None])
                      & self.full[kids])
                # the nearer child goes on top
                swap = cn[:, 1] > cn[:, 0]
                order = torch.stack([swap.long(), 1 - swap.long()], 1)
                kids = kids.gather(1, order)
                cn = cn.gather(1, order)
                ok = ok.gather(1, order)
                for k in range(2):
                    m = ok[:, k]
                    r = ii[m]
                    p = sp[r]
                    stack[r, p] = kids[m, k]
                    stack_t[r, p] = cn[m, k]
                    sp[r] = p + 1
            idx = torch.nonzero(sp > 0).squeeze(1)
        return best_t, best_tri, best_u, best_v

    def _leaf(self, ri, leaf, o, d, best_t, best_tri, best_u, best_v):
        self._test(ri, tuple(x[leaf] for x in (self.v0, self.e1, self.e2,
                                               self.face)),
                   self.tri[leaf], o, d, best_t, best_tri, best_u, best_v)

    @staticmethod
    def _test(ri, cols, tri, o, d, best_t, best_tri, best_u, best_v):
        """The shader's triangle test (fragment.glsl:106-143, the plane
        determinant form) of rays ``ri`` against triangles ``cols`` (v0,
        e1, e2, face: (n or 1, L, 3)), scene ids ``tri`` (n or 1, L); a
        hit replaces the best only when strictly nearer."""
        oo, dd = o[ri, None], d[ri, None]
        v0, e1, e2, face = cols
        det = (dd * face).sum(-1)
        inv = 1.0 / det
        ro = oo - v0
        t = -(ro * face).sum(-1) * inv
        perp = torch.linalg.cross(ro, dd.expand_as(ro))
        u = -(e2 * perp).sum(-1) * inv
        v = (e1 * perp).sum(-1) * inv
        ok = ((det.abs() >= EPS) & (t > EPS) & (u >= 0) & (v >= 0)
              & (u + v <= 1))
        t = torch.where(ok, t, float("inf"))
        tmin, k = t.min(1)
        better = tmin < best_t[ri]
        r = ri[better]
        k = k[better]
        best_t[r] = tmin[better]
        best_tri[r] = tri.expand(ri.shape[0], -1)[better].gather(
            1, k[:, None])[:, 0]
        best_u[r] = u[better].gather(1, k[:, None])[:, 0]
        best_v[r] = v[better].gather(1, k[:, None])[:, 0]


# --------------------------------------------------------------- paths

def trace(tree: Tree, o, d, state, n_segments: int, lambertian: bool,
          sky_brightness: float, live=None):
    """The bounce loop (fragment.glsl:309-350): (R, 3) incoming light.
    ``live``, when given, an (n_segments,) int64 array, gains the number
    of rays still alive as each segment starts."""
    R, dev, dt = o.shape[0], o.device, o.dtype
    incoming = torch.zeros((R, 3), dtype=dt, device=dev)
    ray_color = torch.ones((R, 3), dtype=dt, device=dev)
    sky = torch.tensor(SKY, dtype=dt, device=dev) * sky_brightness
    em_scale = 2.0 if lambertian else 1.0
    idx = torch.arange(R, device=dev)
    for seg in range(n_segments):
        if live is not None:
            live[seg] += idx.numel()
        if not idx.numel():
            break
        t, tri, u, v = tree.nearest(o[idx], d[idx])
        miss = tri < 0
        incoming[idx[miss]] += sky
        hit = ~miss
        idx, t, tri, u, v = idx[hit], t[hit], tri[hit], u[hit], v[hit]
        oo, dd = o[idx], d[idx]
        point = oo + dd * t[:, None]
        w = 1.0 - u - v
        nrm = tree.n[tri]
        n = nrm[:, 0] * w[:, None] + nrm[:, 1] * u[:, None] \
            + nrm[:, 2] * v[:, None]
        ln = torch.sqrt((n * n).sum(-1, keepdim=True))
        face = tree.face_all[tri]
        n = torch.where(ln > 1e-20, n / ln.clamp_min(1e-30), _norm(face))
        n = torch.where((dd * n).sum(-1, keepdim=True) > 0, -n, n)
        s = state[idx]
        s, r0 = rand(s, dt)
        s, r1 = rand(s, dt)
        s, r2 = rand(s, dt)
        state[idx] = s
        xi = torch.stack([r0, r1, r2], 1)
        if lambertian:
            diffuse = _norm(n + xi)
        else:
            xi = torch.where((xi * n).sum(-1, keepdim=True) < 0, -xi, xi)
            diffuse = _norm(xi)
        spec = dd - 2.0 * (dd * n).sum(-1, keepdim=True) * n
        tt = (1.0 - tree.roughness[tri])[:, None]
        new_d = _norm(_norm(diffuse) * (1.0 - tt) + _norm(spec) * tt)
        em = tree.emission[tri]
        incoming[idx] += (tree.emission_color[tri] * (em * em_scale)[:, None]
                          * ray_color[idx])
        ray_color[idx] = ray_color[idx] * tree.color[tri]
        o[idx] = point + n * 1e-4
        d[idx] = new_d
        idx = idx[~(em > 0)]
    return incoming


def render_mean(tree: Tree, flat_index: np.ndarray, frames: int, width: int,
                height: int, cam_pos, cam_dir, render: dict, dtype,
                device, block: int = 1 << 18, live=None) -> np.ndarray:
    """The mean colour over frames 0 .. frames - 1 of the pixels at
    ``flat_index`` (row-major from the top row, as ``accum`` holds them):
    (K, 3) float64.  Rays go in blocks of at most ``block``; ``live`` as
    :func:`trace` takes it."""
    k = torch.as_tensor(np.asarray(flat_index, np.int64), device=device)
    row, px = k // width, k % width
    py = height - 1 - row
    K = k.shape[0]
    total = torch.zeros((K, 3), dtype=torch.float64, device=device)
    per = max(1, block // K)
    for f0 in range(0, frames, per):
        fr = torch.arange(f0, min(frames, f0 + per), device=device)
        F = fr.shape[0]
        o, d, state = primary_rays(
            px.repeat(F), py.repeat(F), fr.repeat_interleave(K), width,
            height, cam_pos, cam_dir, render["jitter_amount"], dtype, device)
        c = trace(tree, o, d, state, render["bounces"] + 1,
                  render["lambertian"], render["sky_brightness"], live)
        total += c.double().view(F, K, 3).sum(0)
    return (total / frames).cpu().numpy()
