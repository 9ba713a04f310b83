"""Synthetic sequence rendering with exact ground-truth poses.

The reference repo has no test assets (SURVEY.md §4); public benchmark
datasets are not available in this environment. These renderers produce
deterministic, feature-rich sequences with analytic ground truth so unit,
golden and end-to-end ATE tests run hermetically.

Scenes:
  * Textured plane (z = plane_z): rendered by homography warp. Exercises the
    homography branch of two-view initialization (reference
    src/Initializer.cc:493-651 ReconstructH).
  * Random 3D point cloud rendered as intensity blobs: exercises the
    fundamental-matrix branch (ReconstructF, :406-490) and triangulation.

All rendering is host-side numpy (test/bench data generation is not part of
the device compute path).
"""

from __future__ import annotations

import numpy as np


def make_texture(size: int = 1024, block: int = 8, seed: int = 7) -> np.ndarray:
    """High-contrast, locally DISTINCTIVE texture: multi-scale block noise
    whose mixture varies across the image, so different regions produce
    different descriptor statistics (place recognition can tell locations
    apart — a uniform block pattern is perceptually aliased everywhere)."""
    rng = np.random.default_rng(seed)

    def blocks(b):
        small = rng.uniform(0, 255, size=(size // b, size // b))
        return np.kron(small, np.ones((b, b)))

    layers = np.stack([blocks(block // 2 if block >= 8 else 4),
                       blocks(block), blocks(block * 2), blocks(block * 4)])
    # Smooth low-frequency mixing weights: each region favors a different
    # scale mixture.
    gsz = 8
    w = rng.uniform(0, 1, size=(4, gsz, gsz))
    w = np.kron(w, np.ones((size // gsz, size // gsz)))
    w = w / np.maximum(w.sum(axis=0, keepdims=True), 1e-9)
    tex = (layers * w).sum(axis=0)
    lo, hi = tex.min(), tex.max()
    tex = 30.0 + (tex - lo) / max(hi - lo, 1e-9) * 195.0
    return tex.astype(np.float32)


def _bilinear_sample(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = np.clip(x - x0, 0.0, 1.0)
    fy = np.clip(y - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    ).astype(np.float32)


class PlanarSceneRenderer:
    """Camera viewing the textured plane z = 0 from z < 0 (optical axis +z).

    World: plane z=0 textured with `texture`, world (x, y) in meters mapped to
    texture pixels by `tex_scale` (pixels per meter). Camera pose Tcw maps
    world -> camera. Pixels with rays missing the plane render to mid-gray.
    """

    def __init__(self, K: np.ndarray, width: int, height: int,
                 texture: np.ndarray | None = None, tex_scale: float = 256.0,
                 supersample: int = 2):
        self.K = K.astype(np.float64)
        self.Kinv = np.linalg.inv(self.K)
        self.width = width
        self.height = height
        self.texture = make_texture() if texture is None else texture
        self.tex_scale = tex_scale
        # Anti-aliasing factor: render at supersample x resolution and box-
        # average, modelling a real sensor's integration over the pixel
        # area. Point-sampling hard texture edges aliases so badly that the
        # intensity centroid (IC angle) and BRIEF bits decorrelate between
        # adjacent frames — real cameras do not do that.
        self.supersample = max(1, int(supersample))

    def render(self, Tcw: np.ndarray) -> np.ndarray:
        """Tcw: 4x4 world->camera. Returns f32[H, W] grayscale in [0, 255]."""
        R = Tcw[:3, :3].astype(np.float64)
        t = Tcw[:3, 3].astype(np.float64)
        # Camera center in world coords.
        C = -R.T @ t
        ss = self.supersample
        # Subpixel grid: pixel (u,v) integrates samples at
        # u + (k + 0.5)/ss - 0.5 for k in [0, ss).
        base_u = np.arange(self.width * ss) / ss - 0.5 + 0.5 / ss
        base_v = np.arange(self.height * ss) / ss - 0.5 + 0.5 / ss
        u, v = np.meshgrid(base_u, base_v)
        pix = np.stack([u.ravel(), v.ravel(), np.ones(u.size)], axis=0)
        rays_cam = self.Kinv @ pix
        rays_world = R.T @ rays_cam
        # Intersect z = 0: C_z + s * d_z = 0.
        dz = rays_world[2]
        s = np.where(np.abs(dz) > 1e-9, -C[2] / np.where(np.abs(dz) > 1e-9, dz, 1.0), -1.0)
        X = C[0] + s * rays_world[0]
        Y = C[1] + s * rays_world[1]
        ok = s > 0
        tx = X * self.tex_scale + self.texture.shape[1] / 2.0
        ty = Y * self.tex_scale + self.texture.shape[0] / 2.0
        vals = _bilinear_sample(self.texture, tx, ty)
        vals = np.where(ok, vals, 127.0)
        img = vals.reshape(self.height * ss, self.width * ss)
        if ss > 1:
            img = img.reshape(self.height, ss, self.width, ss).mean(axis=(1, 3))
        return img.astype(np.float32)

    def render_depth(self, Tcw: np.ndarray) -> np.ndarray:
        """Analytic depth map (camera-frame z) of the plane per pixel; 0
        where the ray misses the plane. For RGB-D pipeline tests."""
        R = Tcw[:3, :3].astype(np.float64)
        t = Tcw[:3, 3].astype(np.float64)
        C = -R.T @ t
        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        pix = np.stack([u.ravel(), v.ravel(), np.ones(u.size)], axis=0)
        rays_world = R.T @ (self.Kinv @ pix)
        dz = rays_world[2]
        s = np.where(np.abs(dz) > 1e-9, -C[2] / np.where(np.abs(dz) > 1e-9, dz, 1.0), -1.0)
        depth = np.where(s > 0, s, 0.0)  # Xc = s * Kinv pix -> z_cam = s
        return depth.reshape(self.height, self.width).astype(np.float32)

    def render_stereo(self, Tcw: np.ndarray, baseline: float):
        """Rectified stereo pair: right camera displaced by `baseline` along
        the camera x-axis (Xc_right = Xc_left - (b,0,0))."""
        left = self.render(Tcw)
        Tr = Tcw.copy()
        Tr[0, 3] -= baseline
        right = self.render(Tr)
        return left, right


def orbit_trajectory(n_frames: int, radius: float = 0.15, depth: float = -2.0,
                     yaw_amp: float = 0.02, tilt: float = 0.25,
                     seed: int = 3) -> list[np.ndarray]:
    """Smooth lateral-arc camera trajectory above the plane (camera at
    z=depth<0 looking at +z). Returns list of Tcw (world->camera) 4x4.

    `tilt` pitches the camera off the plane normal so the plane is viewed
    obliquely — a fronto-parallel planar view has the classic two-fold
    homography decomposition ambiguity and (correctly) cannot initialize.
    Baseline between consecutive frames is small (good for tracking) while
    total translation is large enough for confident two-view initialization.
    """
    ct, st_ = np.cos(tilt), np.sin(tilt)
    R_tilt = np.array([[1.0, 0.0, 0.0], [0.0, ct, -st_], [0.0, st_, ct]])
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        # Camera center moves along an arc in the z=depth plane.
        cx = radius * np.sin(2 * np.pi * a * 0.5)
        cy = 0.5 * radius * (1 - np.cos(2 * np.pi * a * 0.5))
        yaw = yaw_amp * np.sin(2 * np.pi * a)
        cr, sr = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]]) @ R_tilt
        C = np.array([cx, cy, depth])
        R = Rwc.T
        t = -R @ C
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return poses


def loop_trajectory(n_frames: int, radius: float = 0.5, depth: float = -2.0,
                    tilt: float = 0.3) -> list[np.ndarray]:
    """Closed circular translation path (camera returns to its start pose):
    exercises loop detection + correction. No yaw, constant tilt."""
    ct, st_ = np.cos(tilt), np.sin(tilt)
    R_tilt = np.array([[1.0, 0.0, 0.0], [0.0, ct, -st_], [0.0, st_, ct]])
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        C = np.array([radius * np.sin(a), radius * (1 - np.cos(a)), depth])
        R = R_tilt.T
        t = -R @ C
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return poses


class PointCloudRenderer:
    """Random 3D points rendered as Gaussian blobs (non-planar scene for the
    fundamental-matrix initialization branch)."""

    def __init__(self, K: np.ndarray, width: int, height: int,
                 n_points: int = 600, seed: int = 11,
                 depth_range=(2.0, 6.0), spread=2.5):
        rng = np.random.default_rng(seed)
        self.K = K.astype(np.float64)
        self.width = width
        self.height = height
        xy = rng.uniform(-spread, spread, size=(n_points, 2))
        z = rng.uniform(*depth_range, size=(n_points, 1))
        self.points = np.concatenate([xy, z], axis=1)
        self.intensity = rng.uniform(80, 255, size=n_points)

    def render(self, Tcw: np.ndarray, blob_sigma: float = 1.2) -> np.ndarray:
        R = Tcw[:3, :3]
        t = Tcw[:3, 3]
        Xc = self.points @ R.T + t
        vis = Xc[:, 2] > 0.1
        uvw = Xc @ self.K.T
        u = uvw[:, 0] / uvw[:, 2]
        v = uvw[:, 1] / uvw[:, 2]
        img = np.full((self.height, self.width), 20.0, dtype=np.float64)
        rad = int(np.ceil(3 * blob_sigma))
        for i in np.nonzero(vis)[0]:
            ui, vi = u[i], v[i]
            if not (rad <= ui < self.width - rad and rad <= vi < self.height - rad):
                continue
            x0, y0 = int(ui) - rad, int(vi) - rad
            xs = np.arange(x0, x0 + 2 * rad + 1)
            ys = np.arange(y0, y0 + 2 * rad + 1)
            gx = np.exp(-((xs - ui) ** 2) / (2 * blob_sigma ** 2))
            gy = np.exp(-((ys - vi) ** 2) / (2 * blob_sigma ** 2))
            img[y0:y0 + 2 * rad + 1, x0:x0 + 2 * rad + 1] += self.intensity[i] * np.outer(gy, gx)
        return np.clip(img, 0, 255).astype(np.float32)
