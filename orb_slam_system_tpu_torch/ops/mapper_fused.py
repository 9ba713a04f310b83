"""Keyframe-insertion device programs: triangulation + fusion.

Port of orb_slam_system_tpu/ops/mapper_fused.py. The local mapper's
per-keyframe device work runs as two chained steps with ONE packed fetch:

  * `tri_step`: epipolar triangulation search against the M covisible
    neighbours (reference LocalMapping::CreateNewMapPoints +
    ORBmatcher::SearchForTriangulation), batched two-view DLT, all
    acceptance gates (parallax, cheirality, reprojection chi2, scale
    consistency) and the first-neighbour-wins claim per feature slot,
    returning an f32[N1, 6] block that stays on the device;
  * `fuse_step`: SearchInNeighbors fusion (reference SearchInNeighbors +
    ORBmatcher::Fuse) consuming that block: direction A projects the
    current keyframe's map points, including the just-accepted ones
    (their positions, normals and scale bands computed here from the
    block), into every fuse target; direction B projects the targets'
    point union into the current keyframe. Its packed output carries the
    tri block along, so the host fetches everything at once.

The host then creates the accepted points and applies the fuse merges
(arena bookkeeping stays host-side and authoritative).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.solvers.triangulate import triangulate_dlt

CHI2_MONO = 5.991


def _project_for_fuse(R, t, ctr, w, h, fx, fy, cx, cy,
                      pos, normal, mind, maxd, ok,
                      log_sf, scale_factors, radius_th):
    """Fuse-projection geometry over [T] cameras x [P] points (reference
    ORBmatcher::Fuse gates: in front, in the image, inside the
    scale-invariance distance band, viewing angle < 60 deg; predicted level
    and radius). mind/maxd are the pre-scaled 0.8*min_dist /
    max(1.2*max_dist, 1e-6) bands. Returns (proj f32[T,P,2], radius
    f32[T,P], lvl i64[T,P], good bool[T,P])."""
    L = scale_factors.shape[0]
    Xc = torch.einsum("tij,pj->tpi", R, pos) + t[:, None, :]     # [T,P,3]
    z = Xc[..., 2]
    good = ok[None, :] & (z > 0)
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    proj = Xc[..., :2] / zs[..., None]
    proj = proj * torch.tensor([fx, fy], dtype=pos.dtype, device=pos.device) \
        + torch.tensor([cx, cy], dtype=pos.dtype, device=pos.device)
    good &= ((proj[..., 0] >= 0) & (proj[..., 0] < w)
             & (proj[..., 1] >= 0) & (proj[..., 1] < h))
    PO = pos[None, :, :] - ctr[:, None, :]                        # [T,P,3]
    dist = torch.linalg.vector_norm(PO, dim=2)
    good &= (dist >= mind[None]) & (dist <= maxd[None])
    good &= (PO * normal[None]).sum(2) >= 0.5 * dist
    lvl = torch.ceil(torch.log((maxd[None] / 1.2).clamp_min(1e-9)
                               / dist.clamp_min(1e-9)) / log_sf)
    lvl = torch.nan_to_num(lvl, nan=0.0).clamp(0, L - 1).to(torch.int64)
    radius = radius_th * scale_factors[lvl]
    return proj, radius, lvl, good


def _tri_gates(xy1, oct1, nb_xy, nb_oct, idx2, X, okd,
               Tcw1, nb_Tcw, O1, nb_O, Kinv,
               fx, fy, cx, cy, inv_sigma2, scale_factors, ratio_factor):
    """The acceptance gates of CreateNewMapPoints over [M, N1]."""
    M, N1 = idx2.shape
    sel = idx2.clamp_min(0)
    uv1 = xy1                                                     # [N1,2]
    uv2 = nb_xy.gather(1, sel[..., None].expand(M, N1, 2))        # [M,N1,2]
    oct2 = nb_oct.gather(1, sel)                                  # [M,N1]
    ok = okd & (idx2 >= 0)
    # Ray parallax.
    ones1 = torch.ones((N1, 1), dtype=xy1.dtype, device=xy1.device)
    r1 = (torch.cat([uv1, ones1], 1) @ Kinv.T) @ Tcw1[:3, :3]     # [N1,3]
    onesM = torch.ones((M, N1, 1), dtype=xy1.dtype, device=xy1.device)
    r2 = (torch.cat([uv2, onesM], -1) @ Kinv.T) @ nb_Tcw[:, :3, :3]
    cosp = (r1[None] * r2).sum(-1) / (
        torch.linalg.vector_norm(r1, dim=-1)[None]
        * torch.linalg.vector_norm(r2, dim=-1)).clamp_min(1e-12)
    ok &= (cosp > 0) & (cosp < 0.9998)
    # Cheirality in both views.
    z1 = X @ Tcw1[2, :3] + Tcw1[2, 3]                             # [M,N1]
    z2 = (X * nb_Tcw[:, None, 2, :3]).sum(-1) + nb_Tcw[:, 2, 3][:, None]
    ok &= (z1 > 0) & (z2 > 0)
    # Reprojection chi2, view 1.
    Xc1 = X @ Tcw1[:3, :3].T + Tcw1[:3, 3]
    zs1 = torch.where(Xc1[..., 2].abs() < 1e-12,
                      torch.full_like(Xc1[..., 2], 1e-12), Xc1[..., 2])
    u1 = fx * Xc1[..., 0] / zs1 + cx
    v1 = fy * Xc1[..., 1] / zs1 + cy
    e1 = (uv1[None, :, 0] - u1) ** 2 + (uv1[None, :, 1] - v1) ** 2
    ok &= e1 * inv_sigma2[oct1][None] <= CHI2_MONO
    # Reprojection chi2, view 2.
    Xc2 = X @ nb_Tcw[:, :3, :3].transpose(1, 2) + nb_Tcw[:, None, :3, 3]
    zs2 = torch.where(Xc2[..., 2].abs() < 1e-12,
                      torch.full_like(Xc2[..., 2], 1e-12), Xc2[..., 2])
    u2 = fx * Xc2[..., 0] / zs2 + cx
    v2 = fy * Xc2[..., 1] / zs2 + cy
    e2 = (uv2[..., 0] - u2) ** 2 + (uv2[..., 1] - v2) ** 2
    ok &= e2 * inv_sigma2[oct2] <= CHI2_MONO
    # Scale consistency.
    d1 = torch.linalg.vector_norm(X - O1[None, None, :], dim=-1)
    d2 = torch.linalg.vector_norm(X - nb_O[:, None, :], dim=-1)
    ok &= (d1 > 0) & (d2 > 0)
    ratio_dist = d2 / d1.clamp_min(1e-12)
    ratio_oct = scale_factors[oct1][None] / scale_factors[oct2]
    ok &= ~((ratio_dist * ratio_factor < ratio_oct)
            | (ratio_dist > ratio_oct * ratio_factor))
    return ok


def tri_step(xy1, desc1, avail1, oct1, ang1,
             nb_xy, nb_desc, nb_avail, nb_oct, nb_ang,
             F12, epipole, nb_valid, P1, P2,
             Tcw1, nb_Tcw, O1, nb_O,
             Kinv, fx, fy, cx, cy,
             inv_sigma2, scale_factors, ratio_factor):
    """Triangulation search + DLT + gates + first-neighbour-wins claims.
    Returns an f32[N1, 6] block on the device: (accepted, winner_m, idx2,
    X, Y, Z) per feature slot."""
    N1 = xy1.shape[0]
    M = nb_xy.shape[0]
    idx2 = matching.search_for_triangulation_batch(
        xy1, desc1, avail1, oct1, ang1,
        nb_xy, nb_desc, nb_avail, nb_oct, nb_ang,
        F12, inv_sigma2, epipole, nb_valid)                      # [M,N1]
    sel = idx2.clamp_min(0)
    uv2 = nb_xy.gather(1, sel[..., None].expand(M, N1, 2))
    X, okd = triangulate_dlt(xy1, uv2, P1, P2)                   # [M,N1,3]
    ok = _tri_gates(xy1, oct1, nb_xy, nb_oct, idx2, X, okd,
                    Tcw1, nb_Tcw, O1, nb_O, Kinv,
                    fx, fy, cx, cy, inv_sigma2, scale_factors, ratio_factor)
    ok &= nb_valid[:, None]
    # First-neighbour-wins claim per slot (the sequential reference walks
    # the neighbours in covisibility order and skips claimed slots).
    m_rank = torch.where(ok, torch.arange(M, device=ok.device)[:, None],
                         torch.full_like(idx2, M))
    mwin = m_rank.amin(0)                                        # [N1]
    new_ok = mwin < M
    mw = torch.where(new_ok, mwin, torch.zeros_like(mwin))
    rows = torch.arange(N1, device=ok.device)
    idx2n = torch.where(new_ok, idx2[mw, rows], torch.full_like(mw, -1))
    f = torch.float32
    return torch.cat([new_ok[:, None].to(f), mwin[:, None].to(f),
                      idx2n[:, None].to(f), X[mw, rows].to(f)], dim=1)


def fuse_step(tri_block,
              xy1, desc1, valid1, oct1,
              Tcw1, O1, nb_O,
              fx, fy, cx, cy, w, h,
              scale_factors, log_sf,
              tg_xy, tg_desc, tg_valid, tg_oct, tg_R, tg_t, tg_ctr, tg_mask,
              A_pos, A_desc, A_mind, A_maxd, A_normal, A_ok,
              B_pos, B_desc, B_mind, B_maxd, B_normal, B_ok,
              radius_th=3.0):
    """Both fusion directions, consuming tri_step's block. Returns ONE
    packed f32 vector [N1*6 tri | T*(2*N1) direction-A idx | PB
    direction-B idx]."""
    N1 = xy1.shape[0]
    T = tg_xy.shape[0]
    new_ok = tri_block[:, 0] > 0.5
    mw = torch.where(new_ok, tri_block[:, 1],
                     torch.zeros_like(tri_block[:, 1])).to(torch.int64)
    Xn = tri_block[:, 3:6]
    # New-point attributes, as the arena computes them at creation (MapPoint
    # ctor + UpdateNormalAndDepth: band anchored at the creating keyframe's
    # viewpoint and octave; normal = mean unit ray of the 2 observations).
    L = scale_factors.shape[0]
    dist1 = torch.linalg.vector_norm(Xn - O1[None], dim=1).clamp_min(1e-9)
    maxd_n = dist1 * scale_factors[oct1]
    mind_n = maxd_n / scale_factors[L - 1]
    v1 = (Xn - O1[None]) / dist1[:, None]
    O2n = nb_O[mw]
    d2n = torch.linalg.vector_norm(Xn - O2n, dim=1).clamp_min(1e-9)
    v2 = (Xn - O2n) / d2n[:, None]
    normal_n = 0.5 * (v1 + v2)
    # Direction A: old bound points (slot-aligned) + the new points.
    posA = torch.cat([A_pos, Xn])
    descA = torch.cat([A_desc, desc1])
    mindA = torch.cat([A_mind, 0.8 * mind_n])
    maxdA = torch.cat([A_maxd, (1.2 * maxd_n).clamp_min(1e-6)])
    normalA = torch.cat([A_normal, normal_n])
    okA = torch.cat([A_ok, new_ok])
    projA, radA, lvlA, goodA = _project_for_fuse(
        tg_R, tg_t, tg_ctr, w, h, fx, fy, cx, cy,
        posA, normalA, mindA, maxdA, okA, log_sf, scale_factors, radius_th)
    goodA &= tg_mask[:, None]
    idxA = matching.search_by_projection_set_batch(
        projA, radA, lvlA, goodA, descA.expand(T, *descA.shape),
        tg_xy, tg_desc, tg_valid, tg_oct,
        torch.zeros(tg_valid.shape, dtype=torch.bool,
                    device=tg_valid.device))                     # [T,2*N1]
    # Direction B: the targets' point union into the current keyframe.
    projB, radB, lvlB, goodB = _project_for_fuse(
        Tcw1[None, :3, :3], Tcw1[None, :3, 3], O1[None], w, h,
        fx, fy, cx, cy, B_pos, B_normal, B_mind, B_maxd, B_ok,
        log_sf, scale_factors, radius_th)
    resB = matching.search_by_projection_set(
        projB[0], radB[0], lvlB[0], goodB[0], B_desc,
        xy1, desc1, valid1, oct1,
        torch.zeros(N1, dtype=torch.bool, device=xy1.device),
        max_dist=matching.TH_LOW)
    f = torch.float32
    return torch.cat([tri_block.reshape(-1), idxA.to(f).reshape(-1),
                      resB.idx2.to(f)])


def unpack_tri_fuse(buf: np.ndarray, N1: int, T: int, PA: int, PB: int,
                    do_fuse: bool = True):
    """Host split of the packed buffer (fuse_step's output, or tri_step's
    block alone when fusion was skipped). Returns
    (tri [N1,6], idxA i64[T,PA] or None, idxB i64[PB] or None)."""
    tri = buf[:N1 * 6].reshape(N1, 6)
    if not do_fuse:
        return tri, None, None
    off = N1 * 6
    idxA = buf[off:off + T * PA].reshape(T, PA).astype(np.int64)
    idxB = buf[off + T * PA:].astype(np.int64)
    return tri, idxA, idxB
