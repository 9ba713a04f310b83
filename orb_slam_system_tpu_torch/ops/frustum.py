"""Frustum visibility check + scale prediction for map points.

Port of orb_slam_system_tpu/ops/frustum.py (reference Frame::isInFrustum and
MapPoint::PredictScale) as one batched op over padded map-point arrays.
"""

from __future__ import annotations

import torch

VIEWING_COS_LIMIT = 0.5  # reference src/Tracking.cc:683 isInFrustum(pMP, 0.5)


def frustum_check(Xw, normals, min_dist, max_dist, pt_valid,
                  Tcw, fx, fy, cx, cy, min_x, max_x, min_y, max_y,
                  log_scale_factor, n_levels):
    """Batched isInFrustum. Xw, normals: f32[P,3]; min/max_dist: f32[P];
    Tcw: f32[4,4]. Returns dict with visible bool[P], proj_xy f32[P,2],
    pred_level i64[P], view_cos f32[P], dist f32[P]."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    Xc = Xw @ R.T + t
    z = Xc[:, 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * Xc[:, 0] * inv_z + cx
    v = fy * Xc[:, 1] * inv_z + cy
    in_img = (u >= min_x) & (u < max_x) & (v >= min_y) & (v < max_y)
    Ow = -R.T @ t
    PO = Xw - Ow[None, :]
    dist = torch.linalg.vector_norm(PO, dim=1)
    in_band = (dist >= min_dist) & (dist <= max_dist)
    view_cos = (PO * normals).sum(dim=1) / dist.clamp_min(1e-9)
    # PredictScale: level = ceil(log(maxDist / dist) / log(scaleFactor)).
    ratio = max_dist.clamp_min(1e-9) / dist.clamp_min(1e-9)
    level = torch.ceil(torch.log(ratio) / log_scale_factor).to(torch.int64)
    level = level.clamp(0, n_levels - 1)
    visible = (pt_valid & (z > 0.0) & in_img & in_band
               & (view_cos > VIEWING_COS_LIMIT))
    return {
        "visible": visible,
        "proj_xy": torch.stack([u, v], dim=1),
        "pred_level": level,
        "view_cos": view_cos,
        "dist": dist,
    }
