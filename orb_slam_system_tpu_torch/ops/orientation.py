"""IC-angle keypoint orientation (intensity centroid).

Port of orb_slam_system_tpu/ops/orientation.py (reference IC_Angle): moments
m01/m10 over a circular patch of radius 15 whose per-row extent is the umax
table of the reference constructor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HALF_PATCH = 15  # reference src/ORBextractor.cc:17


def _umax_table(half_patch: int = HALF_PATCH) -> np.ndarray:
    """Per-row half-width of the circular patch, built as the reference
    constructor does: lower quarter by rounding sqrt(r^2 - v^2), upper
    quarter mirrored to keep the circle symmetric."""
    umax = np.zeros(half_patch + 1, dtype=np.int32)
    vmax = int(np.floor(half_patch * np.sqrt(2.0) / 2.0 + 1))
    vmin = int(np.ceil(half_patch * np.sqrt(2.0) / 2.0))
    hp2 = half_patch * half_patch
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def moment_weights(half_patch: int = HALF_PATCH):
    """Constant weight matrices WX, WY (f32[P,P]), P = 2*half_patch+1, with
    m10 = sum(patch * WX), m01 = sum(patch * WY) over the circular mask."""
    umax = _umax_table(half_patch)
    P = 2 * half_patch + 1
    wx = np.zeros((P, P), dtype=np.float32)
    wy = np.zeros((P, P), dtype=np.float32)
    for dy in range(-half_patch, half_patch + 1):
        for dx in range(-half_patch, half_patch + 1):
            if abs(dx) <= int(umax[abs(dy)]):
                wx[dy + half_patch, dx + half_patch] = dx
                wy[dy + half_patch, dx + half_patch] = dy
    return wx, wy


def angles_from_moments(m: torch.Tensor) -> torch.Tensor:
    """m: f32[..., 2] = (m10, m01) -> angle radians in [0, 2pi)."""
    ang = torch.atan2(m[..., 1], m[..., 0])
    return torch.where(ang < 0, ang + 2.0 * math.pi, ang)


def patch_moments(patches: torch.Tensor) -> torch.Tensor:
    """patches: f32[B,N,31,31] (unblurred) -> (m10, m01) f32[B,N,2]."""
    wx, wy = moment_weights()
    w = torch.from_numpy(np.stack([wx, wy])).to(patches.device)
    return (patches[:, :, None] * w).sum(dim=(-2, -1))


def ic_angles(patches: torch.Tensor) -> torch.Tensor:
    """patches: f32[B,N,31,31] (unblurred level image) -> angle radians
    f32[B,N] in [0, 2pi)."""
    return angles_from_moments(patch_moments(patches))
