"""Guided descriptor matching.

Port of orb_slam_system_tpu/ops/matching.py (reference ORBmatcher). A search
is one Hamming distance matrix + a boolean candidate mask for the geometric
gating + best / second-best reductions + an optional rotation histogram.
Thresholds from the reference: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30.
The helpers work on the last axis, so a leading batch axis (the JAX
package's vmap, e.g. over a keyframe's neighbours) is written out as is.

Ties resolve as in the JAX package: argmin takes the first minimum; the
histogram's top 3 bins take the lower bin first (stable sort); duplicate
claims of one column keep the lowest distance, then the lowest row.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam_system_tpu_torch.ops.hamming import distance_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

_BIG = 1 << 20


class MatchResult(NamedTuple):
    idx2: torch.Tensor   # i64[..., N1] best index in set 2 (-1 if unmatched)
    dist: torch.Tensor   # i32[..., N1] Hamming distance of the match


def _masked_best2(D: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns (last axis).
    Returns (best_j, best_d, second_d)."""
    big = torch.full((), _BIG, dtype=D.dtype, device=D.device)
    Dm = torch.where(mask, D, big)
    best_j = Dm.argmin(dim=-1)           # first minimum, as jnp.argmin
    best_d = Dm.amin(dim=-1)
    cols = torch.arange(D.shape[-1], device=D.device)
    second_d = torch.where(cols == best_j[..., None], big, Dm).amin(dim=-1)
    return best_j, best_d, second_d


def _no_match(matched, best_j):
    return torch.where(matched, best_j, torch.full_like(best_j, -1))


def rotation_consistency(ang1: torch.Tensor, ang2_at_match: torch.Tensor,
                         matched: torch.Tensor) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 most popular
    of HISTO_LENGTH orientation bins, dropping bins 2/3 below 0.1x the max
    (reference ComputeThreeMaxima). Angles in radians."""
    rot = ang1 - ang2_at_match
    rot = torch.where(rot < 0, rot + 2 * math.pi, rot)
    bin_f = rot * (HISTO_LENGTH / (2 * math.pi))
    bins = (torch.round(bin_f).to(torch.int64) % HISTO_LENGTH).clamp(
        0, HISTO_LENGTH - 1)
    hist = torch.zeros(bins.shape[:-1] + (HISTO_LENGTH,), dtype=torch.int64,
                       device=bins.device)
    hist = hist.scatter_add(-1, bins, matched.to(torch.int64))
    top_vals, top_idx = torch.sort(hist, dim=-1, descending=True, stable=True)
    top = top_vals[..., :3, None].to(torch.float32)
    top_idx = top_idx[..., None]
    keep2 = top[..., 1, :] >= 0.1 * top[..., 0, :]
    keep3 = top[..., 2, :] >= 0.1 * top[..., 0, :]
    ok = ((bins == top_idx[..., 0, :])
          | ((bins == top_idx[..., 1, :]) & keep2)
          | ((bins == top_idx[..., 2, :]) & keep3))
    return matched & ok


def _dedupe_keep_best(best_j, best_d, matched, n2: int):
    """At most one match per column: keep the row with the min distance for
    each claimed column, then the lowest row among equal distances
    (reference vnMatches21 bookkeeping)."""
    dev = best_j.device
    lead = best_j.shape[:-1]
    d = torch.where(matched, best_d.to(torch.int64),
                    torch.full((), _BIG, dtype=torch.int64, device=dev))
    col_min = torch.full(lead + (n2,), _BIG, dtype=torch.int64, device=dev)
    col_min = col_min.scatter_reduce(-1, best_j, d, "amin", include_self=True)
    keep = matched & (best_d.to(torch.int64) <= col_min.gather(-1, best_j))
    rows = torch.arange(best_j.shape[-1], device=dev).expand_as(best_j)
    r = torch.where(keep, rows, torch.full((), 1 << 28, device=dev))
    col_row = torch.full(lead + (n2,), 1 << 28, dtype=torch.int64, device=dev)
    col_row = col_row.scatter_reduce(-1, best_j, r, "amin", include_self=True)
    return keep & (col_row.gather(-1, best_j) == rows)


def search_by_projection_local_map(proj_xy, radius, pred_level, pt_valid,
                                   desc_mp, xy2, desc2, valid2, oct2,
                                   already_matched2, nn_ratio: float = 0.8):
    """Track-local-map search (reference SearchByProjection(Frame,
    vector<MapPoint*>)): window r * scale^predLevel, levels
    [predLevel-1, predLevel], TH_HIGH, ratio best < 0.8 * second when best
    and second sit on the same level, skipping keypoints that already carry
    a map point. Returns MatchResult over the map points."""
    D = distance_matrix(desc_mp, desc2)
    dx = (xy2[None, :, 0] - proj_xy[:, None, 0]).abs()
    dy = (xy2[None, :, 1] - proj_xy[:, None, 1]).abs()
    in_window = (dx <= radius[:, None]) & (dy <= radius[:, None])
    lev_ok = ((oct2[None, :] >= pred_level[:, None] - 1)
              & (oct2[None, :] <= pred_level[:, None]))
    mask = (pt_valid[:, None] & valid2[None, :] & in_window & lev_ok
            & ~already_matched2[None, :])
    best_j, best_d, second_d = _masked_best2(D, mask)
    big = torch.full((), _BIG, dtype=D.dtype, device=D.device)
    cols = torch.arange(xy2.shape[0], device=D.device)[None, :]
    Dm2 = torch.where(cols == best_j[:, None], big, torch.where(mask, D, big))
    second_j = Dm2.argmin(dim=1)
    same_level = oct2[best_j] == oct2[second_j]
    ratio_ok = torch.where(
        same_level & (second_d < _BIG),
        best_d.to(torch.float32) < nn_ratio * second_d.to(torch.float32),
        torch.ones_like(same_level))
    matched = (best_d <= TH_HIGH) & ratio_ok & pt_valid
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    return MatchResult(_no_match(matched, best_j), best_d)


def search_for_initialization(xy1, desc1, valid1, oct1, ang1,
                              xy2, desc2, valid2, oct2, ang2,
                              prev_matched_xy):
    """Monocular-initialization window search (reference
    SearchForInitialization): level-0 keypoints only, a 100-pixel square
    window around the previous matched position, TH_LOW, best < 0.9 *
    second, one-to-one, rotation histogram. Returns MatchResult over set
    1."""
    D = distance_matrix(desc1, desc2)
    dx = (xy2[None, :, 0] - prev_matched_xy[:, None, 0]).abs()
    dy = (xy2[None, :, 1] - prev_matched_xy[:, None, 1]).abs()
    mask = (valid1[:, None] & valid2[None, :]
            & (oct1[:, None] == 0) & (oct2[None, :] == 0)
            & (dx <= 100) & (dy <= 100))
    best_j, best_d, second_d = _masked_best2(D, mask)
    matched = ((best_d <= TH_LOW)
               & (best_d.to(torch.float32) < 0.9 * second_d.to(torch.float32))
               & valid1)
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    matched = rotation_consistency(ang1, ang2[best_j], matched)
    return MatchResult(_no_match(matched, best_j), best_d)


def search_for_triangulation(xy1, desc1, avail1, oct1, ang1,
                             xy2, desc2, avail2, oct2, ang2,
                             F12, inv_sigma2_levels, epipole_xy):
    """Epipolar search for new map points between two keyframes (reference
    SearchForTriangulation): features without map points, TH_LOW,
    epipolar-line distance^2 < 3.84 sigma^2, kp2 at least 10 scale-units
    from the epipole, rotation histogram. F12 maps kp1 -> the epipolar line
    in image 2 (l2 = x1^T F12). Set 2 (and F12, epipole_xy) may carry a
    leading batch axis [M] of neighbour keyframes; set 1 broadcasts.
    Returns MatchResult over set 1 ([M, N1] when batched)."""
    D = distance_matrix(desc1, desc2)                        # [..., N1, N2]
    ones = torch.ones((xy1.shape[0], 1), dtype=xy1.dtype, device=xy1.device)
    lines2 = torch.cat([xy1, ones], dim=1) @ F12             # [..., N1, 3]
    a, b, c = lines2[..., 0:1], lines2[..., 1:2], lines2[..., 2:3]
    num = a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c
    dist2 = (num * num) / (a * a + b * b).clamp_min(1e-12)
    sigma2_2 = (1.0 / inv_sigma2_levels)[oct2]               # [..., N2]
    epi_ok = dist2 < 3.84 * sigma2_2[..., None, :]
    de = ((xy2 - epipole_xy[..., None, :]) ** 2).sum(-1)
    far = de >= 100.0 * sigma2_2
    mask = (avail1[:, None] & avail2[..., None, :] & epi_ok
            & far[..., None, :])
    best_j, best_d, _ = _masked_best2(D, mask)
    matched = (best_d <= TH_LOW) & avail1
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[-2])
    matched = rotation_consistency(ang1, ang2.gather(-1, best_j), matched)
    return MatchResult(_no_match(matched, best_j), best_d)


def search_for_triangulation_batch(xy1, desc1, avail1, oct1, ang1,
                                   xy2, desc2, avail2, oct2, ang2,
                                   F12, inv_sigma2_levels, epipole_xy,
                                   nb_valid):
    """search_for_triangulation over M neighbour keyframes at once (set-2
    arguments with a leading [M] axis); nb_valid masks padded neighbours.
    Returns idx2 [M, N1]."""
    res = search_for_triangulation(xy1, desc1, avail1, oct1, ang1,
                                   xy2, desc2, avail2, oct2, ang2,
                                   F12, inv_sigma2_levels, epipole_xy)
    return torch.where(nb_valid[:, None], res.idx2,
                       torch.full_like(res.idx2, -1))


def search_by_projection_set(proj_xy, radius, pred_level, pt_valid, desc_mp,
                             xy2, desc2, valid2, oct2, already_found2,
                             max_dist: int = TH_HIGH):
    """Projection search against a keypoint set with per-point predicted
    level band [l-1, l+1] and an exclusion set (reference
    SearchByProjection(Frame, KeyFrame, set) and ORBmatcher::Fuse's
    search). Every argument may carry the same leading batch axis.
    Returns MatchResult over the map points."""
    D = distance_matrix(desc_mp, desc2)
    dx = (xy2[..., None, :, 0] - proj_xy[..., :, None, 0]).abs()
    dy = (xy2[..., None, :, 1] - proj_xy[..., :, None, 1]).abs()
    in_window = (dx <= radius[..., None]) & (dy <= radius[..., None])
    lev_ok = ((oct2[..., None, :] >= pred_level[..., None] - 1)
              & (oct2[..., None, :] <= pred_level[..., None] + 1))
    mask = (pt_valid[..., None] & valid2[..., None, :] & in_window & lev_ok
            & ~already_found2[..., None, :])
    best_j, best_d, _ = _masked_best2(D, mask)
    matched = (best_d <= max_dist) & pt_valid
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[-2])
    return MatchResult(_no_match(matched, best_j), best_d)


def search_by_projection_set_batch(proj_xy, radius, pred_level, pt_valid,
                                   desc_mp, xy2, desc2, valid2, oct2,
                                   already_found2):
    """search_by_projection_set over M target keyframes (every argument
    with a leading [M] axis) with TH_LOW, as ORBmatcher::Fuse. Returns
    idx2 [M, P]."""
    return search_by_projection_set(proj_xy, radius, pred_level, pt_valid,
                                    desc_mp, xy2, desc2, valid2, oct2,
                                    already_found2, max_dist=TH_LOW).idx2


def search_by_node_id(desc1, valid1, ang1, node1, desc2, valid2, ang2, node2,
                      nn_ratio: float = 0.7):
    """BoW-node constrained matching (reference SearchByBoW): candidates
    under the same vocabulary node (-1 = none), ratio test, TH_LOW,
    one-to-one, rotation histogram. Set 1 may carry leading axes (set 2
    broadcasts). Returns MatchResult over set 1."""
    D = distance_matrix(desc1, desc2)
    mask = (valid1[..., :, None] & valid2[None, :]
            & (node1[..., :, None] >= 0)
            & (node1[..., :, None] == node2[None, :]))
    best_j, best_d, second_d = _masked_best2(D, mask)
    matched = ((best_d <= TH_LOW)
               & (best_d.to(torch.float32) < nn_ratio * second_d.to(torch.float32))
               & valid1)
    matched = _dedupe_keep_best(best_j, best_d, matched, desc2.shape[0])
    matched = rotation_consistency(ang1, ang2[best_j], matched)
    return MatchResult(_no_match(matched, best_j), best_d)

