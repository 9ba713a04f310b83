"""Batched DLT triangulation.

Port of orb_slam_system_tpu/solvers/triangulate.py (reference
Initializer::Triangulate and the per-pair triangulation of
LocalMapping::CreateNewMapPoints): the 4x4 DLT system of every
correspondence is solved at once through a batched symmetric
eigendecomposition of A^T A (its smallest eigenvector is the smallest right
singular vector of A). The eigenvector's sign is the solver's choice; the
result does not depend on it (X = Xh[:3] / Xh[3]).
"""

from __future__ import annotations

import torch


def triangulate_dlt(uv1: torch.Tensor, uv2: torch.Tensor, P1: torch.Tensor,
                    P2: torch.Tensor):
    """uv1, uv2: f32[..., N, 2] pixel coords in images 1/2; P1, P2:
    f32[..., 3, 4] projection matrices (broadcast over the leading axes).
    Returns X f32[..., N, 3] and w_ok bool[..., N] (nondegenerate
    homogeneous scale)."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    x1, y1 = uv1[..., 0, None], uv1[..., 1, None]
    x2, y2 = uv2[..., 0, None], uv2[..., 1, None]
    A = torch.stack(torch.broadcast_tensors(
        x1 * P1[..., 2, :] - P1[..., 0, :],
        y1 * P1[..., 2, :] - P1[..., 1, :],
        x2 * P2[..., 2, :] - P2[..., 0, :],
        y2 * P2[..., 2, :] - P2[..., 1, :],
    ), dim=-2)                                           # [..., N, 4, 4]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)                     # ascending
    Xh = vecs[..., :, 0]                                 # [..., N, 4]
    w = Xh[..., 3]
    w_ok = w.abs() > 1e-9
    ws = torch.where(w_ok, w, torch.ones_like(w))
    return Xh[..., :3] / ws[..., None], w_ok
