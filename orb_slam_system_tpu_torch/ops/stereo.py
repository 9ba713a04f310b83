"""Rectified stereo matching and RGB-D pseudo-stereo.

Port of orb_slam_system_tpu/ops/stereo.py (reference
Frame::ComputeStereoMatches and ComputeStereoFromRGBD):

  * `stereo_match`: one masked Hamming match of the left keypoints against
    the right ones (row band |vL - vR| <= 2 scale(octR), octave band
    [octL - 1, octL + 1], disparity in [min_disp, max_disp], TH_HIGH gate),
    then a sub-pixel refinement by SAD over 11x11 windows on the left
    keypoint's pyramid level, slid +-5 px along the row, with a parabola
    fit, and the median-SAD outlier filter (1.5 * 1.4 * the median).
  * `rgbd_pseudo_stereo`: the depth at the raw keypoint pixel and the
    right-view u synthesized from the undistorted x.

The pyramid levels are the extractor's own (ORBExtractor.extract returns
them): the JAX package rebuilds both pyramids inside stereo_match and lets
XLA merge that work with the extractor's; here nothing is rebuilt. As in
the JAX package, every keypoint's windows are cut from every level and the
keypoint's own level is kept (an 8-level masked form).

The median-SAD filter takes the median over the matched keypoints only,
and the mean of the two middle values for an even count (jnp.nanmedian's
rule; the reference takes the upper middle). The JAX package writes
jnp.median over an array whose unmatched slots hold NaN, which is NaN as
soon as one slot is unmatched: there the filter never removes a match.
The port does not copy that (ROADMAP.md section 3).
"""

from __future__ import annotations

import torch

from orb_slam_system_tpu_torch.ops.hamming import distance_matrix
from orb_slam_system_tpu_torch.ops.matching import TH_HIGH, _masked_best2

SAD_W = 5         # reference window w = 5 (patch 11x11)
SAD_L = 5         # sliding range +-5 (reference L = 5)
SAD_FILTER = 1.5 * 1.4   # reference median-SAD factor
NO_MEDIAN = 1e9   # the median when no keypoint matched: the filter keeps all


def _gather_strip(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """[N, h, w] windows of img f32[H, W] with top-left (y0, x0), the start
    clamped so the window lies inside the image (the JAX gather's CLIP)."""
    H, W = img.shape
    x0 = x0.clamp(0, W - w)
    y0 = y0.clamp(0, H - h)
    rows = y0[:, None] + torch.arange(h, device=img.device)
    cols = x0[:, None] + torch.arange(w, device=img.device)
    return img[rows[:, :, None], cols[:, None, :]]


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of values[mask] (f32[N], bool[N]): the mean of the two middle
    values for an even count (jnp.nanmedian's rule), NO_MEDIAN when the mask
    is empty. Stays on the device: no boolean indexing."""
    n = mask.sum()
    srt = torch.where(mask, values, torch.full_like(values, float("inf"))).sort().values
    lo = srt[((n - 1) // 2).clamp_min(0)]
    hi = srt[(n // 2).clamp_max(values.shape[0] - 1)]
    return torch.where(n > 0, (lo + hi) * 0.5,
                       torch.full_like(lo, NO_MEDIAN))


def stereo_refine(levels_l, levels_r, xyL, octL, descL, validL, xyR, octR,
                  descR, validR, scale_factors, min_disp, max_disp):
    """The match and its SAD refinement, before the median filter.

    levels_l / levels_r: the two images' pyramids, lists of f32[Hl, Wl];
    xy*: f32[N, 2] level-0 keypoints; oct*: int[N]; desc*: int32[N, 8];
    valid*: bool[N]; scale_factors: f32[L] on the same device.
    Returns (matched bool[NL], u_best f32[NL], disparity f32[NL], best SAD
    f32[NL])."""
    NL = xyL.shape[0]
    dev = xyL.device
    octL = octL.to(torch.int64)
    octR = octR.to(torch.int64)
    D = distance_matrix(descL, descR)
    uL, vL = xyL[:, 0], xyL[:, 1]
    uR, vR = xyR[:, 0], xyR[:, 1]
    row_r = 2.0 * scale_factors[octR]
    row_ok = (vL[:, None] - vR[None, :]).abs() <= row_r[None, :]
    oct_ok = ((octR[None, :] >= octL[:, None] - 1)
              & (octR[None, :] <= octL[:, None] + 1))
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)
    mask = validL[:, None] & validR[None, :] & row_ok & oct_ok & disp_ok
    best_j, best_d, _ = _masked_best2(D, mask)
    coarse = (best_d <= TH_HIGH) & validL
    u_r0 = uR[best_j]
    # SAD refinement on the keypoint's pyramid level (reference
    # src/Frame.cc:527-575), in that level's pixels.
    w, L = SAD_W, SAD_L
    sf_l = scale_factors[octL]
    inv_scale = 1.0 / sf_l
    uL_s = uL * inv_scale
    vL_s = vL * inv_scale
    uR_s = u_r0 * inv_scale
    xL0 = torch.round(uL_s).to(torch.int64) - w
    yL0 = torch.round(vL_s).to(torch.int64) - w
    xR0 = torch.round(uR_s).to(torch.int64) - w - L
    sad = torch.zeros((NL, 2 * L + 1), dtype=torch.float32, device=dev)
    for lv, (img_l, img_r) in enumerate(zip(levels_l, levels_r)):
        patch = _gather_strip(img_l, xL0, yL0, 2 * w + 1, 2 * w + 1)
        strip = _gather_strip(img_r, xR0, yL0, 2 * w + 1, 2 * w + 1 + 2 * L)
        pl_n = patch - patch[:, w:w + 1, w:w + 1]   # normalized by the centre
        win = strip.unfold(2, 2 * w + 1, 1)          # [N, 11, 2L+1, 11]
        win = win - win[:, w:w + 1, :, w:w + 1]
        sads = (pl_n[:, :, None, :] - win).abs().sum((1, 3))
        sad = torch.where((octL == lv)[:, None], sads, sad)
    best_s = sad.argmin(1)                           # first minimum
    best_sad = sad.amin(1)
    interior = (best_s > 0) & (best_s < 2 * L)
    sm1 = sad.gather(1, (best_s - 1).clamp_min(0)[:, None])[:, 0]
    sp1 = sad.gather(1, (best_s + 1).clamp_max(2 * L)[:, None])[:, 0]
    denom = sm1 + sp1 - 2.0 * best_sad
    delta = torch.where(denom.abs() > 1e-9,
                        (sm1 - sp1) / (2.0 * denom.clamp_min(1e-9)),
                        torch.zeros_like(denom))
    delta_ok = (delta >= -1.0) & (delta <= 1.0) & interior
    # Back to level-0 pixels (reference :570).
    u_best = sf_l * (uR_s + (best_s.to(torch.float32) - L) + delta)
    disparity = uL - u_best
    disp_fine_ok = (disparity >= max(min_disp, 1e-3)) & (disparity <= max_disp)
    return coarse & delta_ok & disp_fine_ok, u_best, disparity, best_sad


def stereo_match(levels_l, levels_r, xyL, octL, descL, validL, xyR, octR,
                 descR, validR, scale_factors, bf, min_disp, max_disp):
    """Returns (u_right f32[NL], depth f32[NL]), -1 where a left keypoint
    has no match; arguments as stereo_refine's, bf the baseline times fx.
    The median-SAD filter (reference :595-617) drops matches whose SAD is
    above 1.5 * 1.4 * the median over the matched keypoints."""
    matched, u_best, disparity, best_sad = stereo_refine(
        levels_l, levels_r, xyL, octL, descL, validL, xyR, octR, descR,
        validR, scale_factors, min_disp, max_disp)
    med = masked_median(best_sad, matched)
    matched = matched & (best_sad <= SAD_FILTER * med)
    neg = torch.full_like(u_best, -1.0)
    depth = torch.where(matched, bf / disparity.clamp_min(1e-6), neg)
    return torch.where(matched, u_best, neg), depth


def rgbd_pseudo_stereo(depth_map, xy_raw, xy_und, valid, bf: float,
                       depth_factor: float):
    """Reference ComputeStereoFromRGBD: the depth at the RAW keypoint pixel
    times depth_factor; the right-view u from the UNDISTORTED x.
    depth_map: f32[H, W]. Returns (u_right f32[N], depth f32[N]), -1 where
    a keypoint has no depth."""
    H, W = depth_map.shape
    xi = torch.round(xy_raw[:, 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(xy_raw[:, 1]).to(torch.int64).clamp(0, H - 1)
    d = depth_map[yi, xi] * torch.tensor(depth_factor, dtype=torch.float32,
                                         device=depth_map.device)
    ok = valid & (d > 0)
    neg = torch.full_like(d, -1.0)
    u_r = torch.where(ok, xy_und[:, 0] - bf / d.clamp_min(1e-9), neg)
    return u_r, torch.where(ok, d, neg)
