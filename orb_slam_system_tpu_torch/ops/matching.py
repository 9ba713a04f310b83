"""Guided descriptor matching (the searches of the tracking step).

Port of orb_slam_system_tpu/ops/matching.py (reference ORBmatcher). A search
is one Hamming distance matrix + a boolean candidate mask for the geometric
gating + best / second-best reductions + an optional rotation histogram.
Thresholds from the reference: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30.

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
    idx2: torch.Tensor   # i64[N1] best index in set 2 (-1 if unmatched)
    dist: torch.Tensor   # i32[N1] Hamming distance of the match


def _masked_best2(D: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns.
    Returns (best_j, best_d, second_d)."""
    big = torch.full((), _BIG, dtype=D.dtype, device=D.device)
    Dm = torch.where(mask, D, big)
    best_j = Dm.argmin(dim=1)            # first minimum, as jnp.argmin
    best_d = Dm.amin(dim=1)
    cols = torch.arange(D.shape[1], device=D.device)[None, :]
    second_d = torch.where(cols == best_j[:, None], big, Dm).amin(dim=1)
    return best_j, best_d, second_d


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
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int64, device=bins.device)
    hist = hist.index_add(0, bins, matched.to(torch.int64))
    top_vals, top_idx = torch.sort(hist, descending=True, stable=True)
    top = top_vals[:3].to(torch.float32)
    keep2 = top[1] >= 0.1 * top[0]
    keep3 = top[2] >= 0.1 * top[0]
    ok = ((bins == top_idx[0])
          | ((bins == top_idx[1]) & keep2)
          | ((bins == top_idx[2]) & keep3))
    return matched & ok


def _dedupe_keep_best(best_j, best_d, matched, n2: int):
    """At most one match per column: keep the row with the min distance for
    each claimed column, then the lowest row among equal distances
    (reference vnMatches21 bookkeeping)."""
    dev = best_j.device
    d = torch.where(matched, best_d.to(torch.int64),
                    torch.full((), _BIG, dtype=torch.int64, device=dev))
    col_min = torch.full((n2,), _BIG, dtype=torch.int64, device=dev)
    col_min = col_min.scatter_reduce(0, best_j, d, "amin", include_self=True)
    keep = matched & (best_d.to(torch.int64) <= col_min[best_j])
    rows = torch.arange(best_j.shape[0], device=dev)
    r = torch.where(keep, rows, torch.full((), 1 << 28, device=dev))
    col_row = torch.full((n2,), 1 << 28, dtype=torch.int64, device=dev)
    col_row = col_row.scatter_reduce(0, best_j, r, "amin", include_self=True)
    return keep & (col_row[best_j] == rows)


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
    return MatchResult(torch.where(matched, best_j, torch.full_like(best_j, -1)),
                       best_d)
