"""AR overlay (the JAX package's orb_slam_system_tpu/models/ar.py, in place
of the reference's ROS AR node, Examples/ROS/ORB_SLAM2/src/AR/
{ros_mono_ar.cc, ViewerAR.cc}): fit the dominant plane of the map points
and draw a cube anchored on it into the camera frame, headless (lines
burned into the grayscale image) instead of a GL window.

Host code on the map's host copies; ARDemo.process tracks each frame
through System.track_monocular, so on the card it runs the System's
kernels and nothing else. Departs from the JAX module in one place:
_draw_line clips the segment to the image before sampling it, so a cube
vertex far off screen costs samples bounded by the image's size (the JAX
version samples the whole segment and keeps the samples inside).
"""

from __future__ import annotations

import numpy as np

from orb_slam_system_tpu_torch.models.viewer import clip_segment


def fit_plane(points: np.ndarray, iters: int = 100, th: float = 0.02,
              seed: int = 0):
    """RANSAC plane fit (the reference's ViewerAR DetectPlane). points:
    f32[N,3]. Returns (normal, d, inlier_mask) with n.x + d = 0, or None
    where the points are too few or degenerate."""
    n_pts = len(points)
    if n_pts < 10:
        return None
    rng = np.random.default_rng(seed)
    best = None
    best_inl = 0
    for _ in range(iters):
        idx = rng.choice(n_pts, 3, replace=False)
        p0, p1, p2 = points[idx]
        n = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        d = -n @ p0
        dist = np.abs(points @ n + d)
        inl = (dist < th).sum()
        if inl > best_inl:
            best_inl = inl
            best = (n, d, dist < th)
    if best is None or best_inl < 0.3 * n_pts:
        return None
    # Least squares on the inliers.
    n, d, mask = best
    P = points[mask]
    centroid = P.mean(0)
    _, _, Vt = np.linalg.svd(P - centroid)
    n = Vt[2]
    d = -n @ centroid
    return n, d, mask


def cube_vertices(center: np.ndarray, normal: np.ndarray, size: float):
    """The 8 vertices of a cube standing on the plane at `center`, +normal
    up."""
    n = normal / np.linalg.norm(normal)
    a = np.cross(n, [1.0, 0.0, 0.0])
    if np.linalg.norm(a) < 1e-6:
        a = np.cross(n, [0.0, 1.0, 0.0])
    a = a / np.linalg.norm(a)
    b = np.cross(n, a)
    h = size / 2.0
    base = [center + sa * h * a + sb * h * b
            for sa in (-1, 1) for sb in (-1, 1)]
    top = [v + size * n for v in base]
    return np.stack(base + top)


CUBE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
              (4, 5), (5, 7), (7, 6), (6, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_cube(img: np.ndarray, Tcw: np.ndarray, K: np.ndarray,
              center: np.ndarray, normal: np.ndarray, size: float = 0.1):
    """Project the cube's wireframe into img (u8/f32 [H,W]); returns a u8
    copy. Nothing is drawn when a vertex is within 5 cm of the camera's
    plane or behind it."""
    out = np.clip(img, 0, 255).astype(np.uint8).copy()
    V = cube_vertices(center, normal, size)
    Xc = V @ Tcw[:3, :3].T + Tcw[:3, 3]
    if (Xc[:, 2] <= 0.05).any():
        return out
    uv = ((Xc[:, :2] / Xc[:, 2:3]) @ np.diag([K[0, 0], K[1, 1]])
          + [K[0, 2], K[1, 2]])
    for a, b in CUBE_EDGES:
        _draw_line(out, uv[a], uv[b])
    return out


def _draw_line(img, p0, p1, value=255):
    """The segment's pixels inside the image set to `value`."""
    seg = clip_segment(p0, p1, img.shape[1], img.shape[0])
    if seg is None:
        return
    p0, p1 = seg
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    ts = np.linspace(0, 1, n + 1)
    xs = np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int)
    ys = np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = value


class ARDemo:
    """Per-frame AR overlay (the reference ros_mono_ar.cc flow): track the
    frame, fit a plane once the map has more than 50 points, draw the
    anchored cube on every tracked frame."""

    def __init__(self, system, cube_size: float = 0.1):
        self.system = system
        self.cube_size = cube_size
        self.plane = None

    def process(self, img: np.ndarray, timestamp: float):
        Tcw = self.system.track_monocular(img, timestamp)
        if Tcw is None:
            return np.clip(img, 0, 255).astype(np.uint8)
        if self.plane is None:
            arena = self.system.arena
            pts = (np.stack([mp.pos for mp in arena.mps.values()])
                   if arena.n_points() else None)
            if pts is not None and len(pts) > 50:
                fit = fit_plane(pts)
                if fit is not None:
                    n, d, mask = fit
                    self.plane = (n, pts[mask].mean(0))
        if self.plane is None:
            return np.clip(img, 0, 255).astype(np.uint8)
        n, center = self.plane
        return draw_cube(img, Tcw, self.system.cfg.camera.K, center, n,
                         self.cube_size)
