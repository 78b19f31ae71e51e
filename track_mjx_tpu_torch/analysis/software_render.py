"""A painter's-algorithm rasterizer in numpy alone, for the rollout videos.

Port of track_mjx_tpu/analysis/software_render.py. The JAX package's
`SoftwareRenderer` draws MuJoCo's abstract scene (mjv_updateScene) onto a
matplotlib canvas; this one draws the same elements from the port's own
kinematics (analysis/render.py hands it each element's type, position,
orientation, scene size and rgba) and needs neither mujoco nor matplotlib:

- spheres and ellipsoids are discs (radius: the sphere's, the mean of the
  ellipsoid's three), capsules and cylinders stadiums (the segment between
  the end caps' centres, thickened by the radius), boxes and meshes the
  convex hull of their eight bounding corners, clipped at the near plane,
  planes a backdrop (a square of half-width size[0], or 20 where that is 0);
- each element is drawn in its rgba over what lies behind it, the farthest
  first (by the depth of its centre; planes before everything); elements
  whose alpha is below 0.02, or whose pose is not finite, are not drawn;
- the perspective is the camera's: `fovy` (degrees) over the image height,
  the near plane at `znear`.

Edges are antialiased as a canvas does: each pixel is covered by the share
that a one-pixel ramp across the shape's edge gives it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# mjtGeom values drawn (decor and label types above MESH are not)
PLANE, HFIELD, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX, MESH = range(8)
MIN_ALPHA = 0.02
PLANE_EXTENT = 20.0

_BOX_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], dtype=np.float64)
_PLANE_CORNERS = _BOX_CORNERS[::2, :2]


def scene_size(types: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """The sizes mjv_updateScene gives a geom or site of each type: (r, r, r)
    for a sphere, (r, r, half-length) for a capsule or cylinder, the model's
    size for the others."""
    types, sizes = np.asarray(types), np.asarray(sizes, np.float64)
    out = sizes.copy()
    sphere = types == SPHERE
    out[sphere] = sizes[sphere, :1]
    round_ = (types == CAPSULE) | (types == CYLINDER)
    out[round_] = np.stack([sizes[round_, 0], sizes[round_, 0], sizes[round_, 1]], axis=-1)
    return out


@dataclasses.dataclass
class Camera:
    """A perspective camera: eye, unit forward and up vectors (world), the
    vertical field of view in degrees and the near plane's distance."""

    eye: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    fovy: float
    znear: float


def convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain: points [N, 2] -> hull vertices [M, 2],
    counter-clockwise in (x, y)."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 2:
        return pts

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and (
                (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1]) - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])
            ) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def clip_points_near(pts_cam: np.ndarray, near: float) -> np.ndarray:
    """A convex corner set (camera space, z the depth) clipped to z >= near:
    the corners in front, and where a pair of corners straddles the plane,
    the point where their segment crosses it."""
    eps = near * 1.0001
    front = pts_cam[:, 2] >= eps
    if front.all():
        return pts_cam
    i, j = np.triu_indices(len(pts_cam), 1)
    cross = front[i] != front[j]
    i, j = i[cross], j[cross]
    zi, zj = pts_cam[i, 2], pts_cam[j, 2]
    t = ((eps - zi) / (zj - zi))[:, None]
    return np.concatenate([pts_cam[front], pts_cam[i] + t * (pts_cam[j] - pts_cam[i])], axis=0)


class SoftwareRenderer:
    """Frames of `height` x `width` (uint8 RGB) on a white background."""

    def __init__(self, height: int = 480, width: int = 640):
        self.height = int(height)
        self.width = int(width)

    def _frustum(self, camera: Camera):
        near = float(camera.znear)
        half_h = near * np.tan(np.deg2rad(float(camera.fovy)) / 2)
        return near, half_h * self.width / self.height, half_h

    def _to_screen(self, pts_cam: np.ndarray, frustum) -> np.ndarray:
        """Camera-space points [N, 3] (x right, y up, z depth) -> pixel
        coordinates [N, 2] (u right, v down; pixel (i, j) spans [i, i+1])."""
        near, half_w, half_h = frustum
        z = np.maximum(pts_cam[:, 2], near * 1.0001)
        u = (pts_cam[:, 0] * near / z + half_w) / (2 * half_w) * self.width
        v = (1 - (pts_cam[:, 1] * near / z + half_h) / (2 * half_h)) * self.height
        return np.stack([u, v], axis=-1)

    def items(self, camera: Camera, types, pos, mat, size, rgba) -> list:
        """The frame's 2-D shapes, farthest first: (kind, payload, rgba) with
        kind "disc" (centre [2], radius px), "stadium" (ends [2, 2], radius
        px) or "hull" (vertices [M, 2]). `types` [N], `pos` [N, 3], `mat`
        [N, 3, 3] (the element's axes as columns), `size` [N, 3] (scene
        sizes), `rgba` [N, 4]."""
        fwd = np.asarray(camera.forward, np.float64)
        fwd = fwd / np.linalg.norm(fwd)
        up = np.asarray(camera.up, np.float64)
        up = up - fwd * (up @ fwd)
        up = up / np.linalg.norm(up)
        basis = np.stack([np.cross(fwd, up), up, fwd])  # rows: right, up, forward
        eye = np.asarray(camera.eye, np.float64)
        frustum = self._frustum(camera)
        near, half_w, _ = frustum
        px_per_unit = self.width / (2 * half_w)

        def cam_space(p):
            return (np.atleast_2d(p) - eye) @ basis.T

        out = []  # (depth, order, kind, payload, rgba)
        for i in range(len(types)):
            t = int(types[i])
            color = np.clip(np.asarray(rgba[i], np.float64), 0, 1)
            p, m, s = (np.asarray(a[i], np.float64) for a in (pos, mat, size))
            if color[3] < MIN_ALPHA or t > MESH or not (np.isfinite(p).all() and np.isfinite(m).all()):
                continue
            if t == PLANE:
                ext = PLANE_EXTENT if s[0] == 0 else s[0]
                corners = p + _PLANE_CORNERS @ np.stack([m[:, 0], m[:, 1]]) * ext
                cc = clip_points_near(cam_space(corners), near)
                if len(cc) >= 3:
                    out.append((1e9, i, "hull", self._to_screen(cc, frustum), color))
                continue
            c = cam_space(p)[0]
            if c[2] <= near:
                continue
            depth = c[2]
            if t in (SPHERE, ELLIPSOID):
                r = float(np.mean(s[: (1 if t == SPHERE else 3)]))
                out.append((depth, i, "disc", (self._to_screen(c[None], frustum)[0], r * near / depth * px_per_unit),
                            color))
            elif t in (CAPSULE, CYLINDER):
                axis = m[:, 2] * s[2]
                ends = cam_space(np.stack([p - axis, p + axis]))
                if np.all(ends[:, 2] <= near):
                    continue
                ends[:, 2] = np.maximum(ends[:, 2], near * 1.0001)
                out.append((depth, i, "stadium", (self._to_screen(ends, frustum), s[0] * near / depth * px_per_unit),
                            color))
            else:  # box, mesh, height field: the hull of the bounding corners
                half = np.where(s > 0, s, 1e-3)
                cc = clip_points_near(cam_space(p + (_BOX_CORNERS * half) @ m.T), near)
                if len(cc) >= 3:
                    out.append((depth, i, "hull", self._to_screen(cc, frustum), color))
        out.sort(key=lambda it: (-it[0], it[1]))
        return [(kind, payload, color) for _, _, kind, payload, color in out]

    def render(self, camera: Camera, types, pos, mat, size, rgba) -> np.ndarray:
        """One frame, uint8 [height, width, 3]."""
        img = np.ones((self.height, self.width, 3))
        for kind, payload, color in self.items(camera, types, pos, mat, size, rgba):
            if kind == "disc":
                centre, r_px = payload
                self._paint_round(img, centre[None], max(r_px, 0.5), color)
            elif kind == "stadium":
                ends, r_px = payload
                self._paint_round(img, ends, max(2 * r_px, 1.0) / 2, color)
            else:
                hull = convex_hull_2d(payload)
                if len(hull) >= 3:
                    self._paint_hull(img, hull, color)
        return np.round(img * 255).astype(np.uint8)

    def _window(self, lo: np.ndarray, hi: np.ndarray):
        """Pixel index ranges covering [lo, hi] (u, v), clamped to the frame."""
        c0, r0 = (max(0, int(np.floor(x)) - 1) for x in lo)
        c1 = min(self.width, int(np.ceil(hi[0])) + 1)
        r1 = min(self.height, int(np.ceil(hi[1])) + 1)
        return r0, r1, c0, c1

    def _blend(self, img, window, coverage, color) -> None:
        r0, r1, c0, c1 = window
        a = (color[3] * coverage)[..., None]
        img[r0:r1, c0:c1] = img[r0:r1, c0:c1] * (1 - a) + color[:3] * a

    def _grid(self, window):
        r0, r1, c0, c1 = window
        return np.meshgrid(np.arange(c0, c1) + 0.5, np.arange(r0, r1) + 0.5)

    def _paint_round(self, img, ends: np.ndarray, radius: float, color) -> None:
        """A disc (one end) or a stadium (two): every pixel within `radius`
        of the point or segment."""
        if not np.isfinite(ends).all():
            return
        window = self._window(ends.min(0) - radius, ends.max(0) + radius)
        if window[0] >= window[1] or window[2] >= window[3]:
            return
        u, v = self._grid(window)
        a = ends[0]
        if len(ends) == 1:
            dist = np.hypot(u - a[0], v - a[1])
        else:
            d = ends[1] - a
            t = np.clip(((u - a[0]) * d[0] + (v - a[1]) * d[1]) / max(float(d @ d), 1e-12), 0, 1)
            dist = np.hypot(u - a[0] - t * d[0], v - a[1] - t * d[1])
        self._blend(img, window, np.clip(radius + 0.5 - dist, 0, 1), color)

    def _paint_hull(self, img, hull: np.ndarray, color) -> None:
        """A convex polygon (counter-clockwise in (u, v)): coverage from the
        distance outside its farthest edge line."""
        lo = np.maximum(hull.min(0), -1.0)
        hi = np.minimum(hull.max(0), [self.width + 1.0, self.height + 1.0])
        window = self._window(lo, hi)
        if window[0] >= window[1] or window[2] >= window[3]:
            return
        u, v = self._grid(window)
        edges = np.roll(hull, -1, axis=0) - hull
        length = np.hypot(edges[:, 0], edges[:, 1])
        keep = length > 1e-12
        p0, edges, length = hull[keep], edges[keep], length[keep]
        # outward normal of a counter-clockwise (x, y) polygon: (ey, -ex)
        nx, ny = edges[:, 1] / length, -edges[:, 0] / length
        dist = (u[..., None] - p0[:, 0]) * nx + (v[..., None] - p0[:, 1]) * ny
        self._blend(img, window, np.clip(0.5 - dist.max(-1), 0, 1), color)
