"""Pinhole camera model with radial-tangential distortion (the part of the
JAX package's utils/camera.py the slice needs).

`undistort_points` is the fixed-point inversion cv::undistortPoints uses
(reference Frame::UndistortKeyPoints); `compute_image_bounds` is the
reference's ComputeImageBounds.
"""

from __future__ import annotations

import torch


def project(X_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coords (..., 2), no distortion."""
    z = X_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * X_cam[..., 0] * inv_z + cx,
                        fy * X_cam[..., 1] * inv_z + cy], dim=-1)


def undistort_points(uv: torch.Tensor, fx, fy, cx, cy, k1, k2, p1, p2, k3,
                     iters: int = 8) -> torch.Tensor:
    """Pixel coords (..., 2) -> undistorted pixel coords (..., 2)."""
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def compute_image_bounds(width: int, height: int, fx, fy, cx, cy,
                         k1, k2, p1, p2, k3):
    """Undistorted image bounds from the 4 corners. Returns python floats
    (min_x, max_x, min_y, max_y)."""
    corners = torch.tensor([[0.0, 0.0], [width, 0.0], [0.0, height],
                            [width, height]], dtype=torch.float32)
    und = undistort_points(corners, fx, fy, cx, cy, k1, k2, p1, p2, k3)
    return (float(torch.minimum(und[0, 0], und[2, 0])),
            float(torch.maximum(und[1, 0], und[3, 0])),
            float(torch.minimum(und[0, 1], und[1, 1])),
            float(torch.maximum(und[2, 1], und[3, 1])))
