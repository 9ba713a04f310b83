"""ORB feature extraction: pyramid -> FAST -> orientation -> rBRIEF.

Port of orb_slam_system_tpu/ops/extractor.py (reference
ORBextractor::operator()). All shapes are static: per-level keypoint
budgets come from the config (geometric split), padded slots carry a
validity bit, and keypoint coordinates come out in level-0 pixels.

Two routes gather the keypoints' patches from one all-level canvas, as in
the JAX package (its `_fused_gather` becomes the constructor argument
`fused_gather`):
  * fused (the default, the JAX package's TPU route): kernel B's describe
    mode goes from the canvas to the IC angle and the rBRIEF descriptor in
    one launch (gather, blur, moments, angle, tests); the blurred patch
    never reaches device memory;
  * unfused (the JAX package's route off the TPU, extractor.py:176-182):
    kernel D gathers the raw 43x43 patches, the IC angle comes from their
    31x31 centre, the blur runs as plain tensor ops and kernel C packs the
    descriptor.
Either way the card runs kernel A once for all levels (FAST score + NMS).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam_system_tpu_torch.config import ORBConfig
from orb_slam_system_tpu_torch.ops import fast as fast_ops
from orb_slam_system_tpu_torch.ops import pyramid as pyr_ops
from orb_slam_system_tpu_torch.ops.brief import PATCH_RADIUS, brief_pack
from orb_slam_system_tpu_torch.ops.orientation import HALF_PATCH, ic_angles
from orb_slam_system_tpu_torch.ops.patches import (blur_patches,
                                                   gather_blur_describe,
                                                   gather_patches)

EDGE_MARGIN = 19  # reference EDGE_THRESHOLD (src/ORBextractor.cc:18)


class FeatureSet(NamedTuple):
    """Batched, padded keypoint set (level-0 coordinates); the JAX
    package's FeatureSet fields, with descriptors as int32 bit patterns."""

    xy: torch.Tensor        # f32[B, N, 2] (x, y) in level-0 pixels
    response: torch.Tensor  # f32[B, N]
    angle: torch.Tensor     # f32[B, N] radians in [0, 2pi)
    octave: torch.Tensor    # i32[B, N]
    desc: torch.Tensor      # i32[B, N, 8]
    valid: torch.Tensor     # bool[B, N]

    @property
    def n_slots(self) -> int:
        return self.xy.shape[1]


class ORBExtractor:
    """Config-bound, shape-specialized ORB extractor (one per image size
    and feature budget). Runs on whatever device its input lies on."""

    def __init__(self, cfg: ORBConfig, height: int, width: int,
                 fused_gather: bool = True):
        self.cfg = cfg
        self.fused_gather = fused_gather
        budgets = cfg.per_level_features()
        total = sum(budgets)
        pad_total = ((total + 127) // 128) * 128
        budgets[0] += pad_total - total  # pad slack goes to level 0
        self.budgets = budgets
        self.n_slots = pad_total
        self.scales = np.asarray(cfg.level_scales(), dtype=np.float32)
        # All-level gather canvas: each reflect-padded level stacked at an
        # 8-aligned row offset, so ONE kernel-B launch gathers every level.
        shapes = pyr_ops.level_shapes(height, width, cfg.n_levels,
                                      cfg.scale_factor)
        offs, rows = [], 0
        for (h, _w) in shapes:
            offs.append(rows)
            rows += -(-(h + 6) // 8) * 8
        self._canvas_offs = offs
        self._canvas_rows = rows
        self._canvas_cols = width + 6

    def __call__(self, img: torch.Tensor) -> FeatureSet:
        """img: f32[B, H, W] grayscale in [0, 255]."""
        return self.extract(img)[0]

    def extract(self, img: torch.Tensor):
        """img: f32[B, H, W] grayscale in [0, 255] -> (FeatureSet, the
        pyramid levels f32[B, Hl, Wl] the keypoints were detected on; the
        stereo match refines on them)."""
        sel, canvas, xy_all, levels = self.detect(img)
        radius = PATCH_RADIUS + 3
        if self.fused_gather:
            _, ang, desc = gather_blur_describe(canvas, xy_all, radius)
        else:
            raw = gather_patches(canvas, xy_all, radius)
            c0 = radius - HALF_PATCH
            po = 2 * HALF_PATCH + 1
            ang = ic_angles(raw[:, :, c0:c0 + po, c0:c0 + po])
            desc = brief_pack(blur_patches(raw), ang)
        return FeatureSet(xy=sel["xy"], response=sel["response"], angle=ang,
                          octave=sel["octave"], desc=desc,
                          valid=sel["valid"]), levels

    def detect(self, img: torch.Tensor):
        """Pyramid, FAST + NMS and per-level selection, and the all-level
        canvas. Returns (dict of xy/response/octave/valid over all slots,
        canvas f32[B,R,C], canvas gather centres i32[B,N,2], the pyramid
        levels f32[B,Hl,Wl])."""
        cfg = self.cfg
        levels = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        B = img.shape[0]
        dev = img.device
        active = [l for l in range(len(levels)) if self.budgets[l] > 0]
        selections = fast_ops.select_keypoints_multi(
            fast_ops.fast_score_nms_levels([levels[l] for l in active],
                                           EDGE_MARGIN),
            [self.budgets[l] for l in active],
            ini_th=float(cfg.ini_th_fast),
            min_th=float(cfg.min_th_fast),
        )
        xs, resps, valids, octs, xy_gather = [], [], [], [], []
        for l, (xy_l, resp, valid) in zip(active, selections):
            # +3 for the reflect-pad blur halo, + the level's canvas row.
            shift = torch.tensor([3, 3 + self._canvas_offs[l]], device=dev)
            xy_gather.append(xy_l + shift)
            xs.append(xy_l.to(torch.float32) * float(self.scales[l]))
            resps.append(resp)
            valids.append(valid)
            octs.append(torch.full(resp.shape, l, dtype=torch.int32, device=dev))
        canvas = torch.zeros((B, self._canvas_rows, self._canvas_cols),
                             dtype=img.dtype, device=dev)
        for l, lvl in enumerate(levels):
            h, w = lvl.shape[1:]
            o = self._canvas_offs[l]
            canvas[:, o:o + h + 6, :w + 6] = F.pad(lvl, (3, 3, 3, 3),
                                                   mode="reflect")
        sel = {"xy": torch.cat(xs, dim=1), "response": torch.cat(resps, dim=1),
               "octave": torch.cat(octs, dim=1), "valid": torch.cat(valids, dim=1)}
        return sel, canvas, torch.cat(xy_gather, dim=1).to(torch.int32), levels
