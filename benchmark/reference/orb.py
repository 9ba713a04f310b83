"""Plain ORB extraction, frozen for the benchmark: the reference that the
program's keypoints, orientations and descriptors are judged against.

A copy of the extractor's plain PyTorch definition as the port's
bring-up fixed it (pyramid by cascaded two-tap bilinear resize, dense FAST-9
score with 3x3 non-maximum suppression, per-16-pixel-cell top-4 candidates
ranked cells-first then by response, per-level budgets from ORB-SLAM2's
geometric split, the intensity-centroid angle over the radius-15 circle,
a 7x7 sigma-2 Gaussian blur, and steered rBRIEF with the angle quantized
to 32 bins and bf16-rounded comparisons). It imports nothing of the
program and runs on whatever device its input is on.

`dtype` selects the arithmetic: float32 is the configuration's precision,
bfloat16 the control (the same definition one precision lower).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.brief_pattern import ORB_PATTERN

EDGE_MARGIN = 19        # ORB-SLAM2 EDGE_THRESHOLD
HALF_PATCH = 15         # IC-angle circle radius
PATCH_RADIUS = 18       # largest rotated test offset
GATHER_RADIUS = PATCH_RADIUS + 3   # 43x43 gathered, 37x37 after the blur
BLUR_TAPS = 7
N_BITS = 256
N_ANGLE_BINS = 32
CELL = 16
TOPK_PER_CELL = 4
CIRCLE = np.array([(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
                   (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3),
                   (-1, -3), (-2, -2), (-3, -1)], dtype=np.int32)
ARC_LEN = 9


class Features(NamedTuple):
    """One extraction over a batch: per slot, in level-0 pixels."""

    level_xy: torch.Tensor   # i64[B, N, 2] (x, y) on the keypoint's level
    xy: torch.Tensor         # f32[B, N, 2] level-0 pixels
    octave: torch.Tensor     # i64[B, N]
    angle: torch.Tensor      # f32[B, N] radians
    desc: torch.Tensor       # i32[B, N, 8]
    valid: torch.Tensor      # bool[B, N]
    canvas_floats_read: list  # per image: canvas floats in the slots' windows


def level_budgets(n_features: int, scale: float, n_levels: int) -> list:
    """ORB-SLAM2's geometric split of the budget over levels, the slack of
    the 128-slot padding on level 0."""
    factor = 1.0 / scale
    want = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    counts, total = [], 0
    for _ in range(n_levels - 1):
        c = int(round(want))
        counts.append(c)
        total += c
        want *= factor
    counts.append(max(n_features - total, 0))
    pad = ((sum(counts) + 127) // 128) * 128
    counts[0] += pad - sum(counts)
    return counts


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    return [(int(round(height / scale ** l)), int(round(width / scale ** l)))
            for l in range(n_levels)]


@functools.lru_cache(maxsize=None)
def _taps(n_out: int, n_in: int):
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0.0, n_in - 1)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (x - i0).astype(np.float32)
    w0 = np.float32(1.0) - f
    # Where both taps fall on the clamped edge, one weight (1 - f) + f.
    w0 = np.where(i1 != i0, w0, w0 + f).astype(np.float32)
    w1 = np.where(i1 != i0, f, np.float32(0.0)).astype(np.float32)
    return i0, i1, w0, w1


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = (torch.from_numpy(a).to(x.device)
                      for a in _taps(n_out, x.shape[dim]))
    shape = [1] * x.dim()
    shape[dim] = n_out
    return (x.index_select(dim, i0) * w0.to(x.dtype).reshape(shape)
            + x.index_select(dim, i1) * w1.to(x.dtype).reshape(shape))


def pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list:
    H, W = img.shape[1:]
    levels = [img]
    for h, w in level_shapes(H, W, n_levels, scale)[1:]:
        levels.append(_resize_axis(_resize_axis(levels[-1], h, 1), w, 2))
    return levels


def fast_nms(img: torch.Tensor, border: int) -> torch.Tensor:
    """Dense FAST-9 score (max over the 32 arcs of the arc's least
    ring-centre difference), zero at the border, then 3x3 NMS."""
    _, H, W = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(1, 2))
                        for dy, dx in CIRCLE])
    bright = ring - img[None]
    win = torch.cat([bright, bright[:ARC_LEN - 1]], dim=0).unfold(0, ARC_LEN, 1)
    score = torch.maximum(win.amin(dim=-1).amax(dim=0),
                          (-win.amax(dim=-1)).amax(dim=0))
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    zero = torch.zeros((), device=img.device, dtype=img.dtype)
    score = torch.where(inb[None], score, zero)
    pooled = F.max_pool2d(score[:, None].float(), 3, stride=1, padding=1)[:, 0]
    return torch.where(score.float() >= pooled, score.float(), zero.float())


def _select(score: torch.Tensor, n_max: int, ini_th: float, min_th: float):
    """Per-cell top-4 candidates, cells covered first, then the level's
    top n_max by that order (ties: lower index first)."""
    B, H, W = score.shape
    Hp, Wp = -(-H // CELL) * CELL, -(-W // CELL) * CELL
    s = F.pad(score, (0, Wp - W, 0, Hp - H))
    wc = Wp // CELL
    cells = s.reshape(B, Hp // CELL, CELL, wc, CELL).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, -1, CELL * CELL)
    strong = cells.amax(dim=-1, keepdim=True) > ini_th
    eligible = torch.where(strong, cells > ini_th, cells > min_th)
    dev = score.device
    remaining = torch.where(eligible, cells, torch.zeros((), device=dev))
    pos = torch.arange(CELL * CELL, device=dev)
    vals, idx = [], []
    for _ in range(TOPK_PER_CELL):
        m = remaining.amax(dim=-1)
        am = torch.where(remaining == m[..., None], pos,
                         torch.full((), 1 << 20, device=dev)).amin(dim=-1)
        vals.append(m)
        idx.append(am)
        remaining = torch.where(pos == am[..., None],
                                torch.full((), -float("inf"), device=dev),
                                remaining)
    vals, idx = torch.stack(vals, -1), torch.stack(idx, -1)
    rank = torch.arange(TOPK_PER_CELL, dtype=torch.float32, device=dev)
    key = torch.where(vals > 0.0, -rank * (vals.amax() + 1.0) + vals,
                      torch.full((), -float("inf"), device=dev)).reshape(B, -1)
    key_s, order = torch.sort(key, dim=-1, descending=True, stable=True)
    if n_max > key.shape[-1]:
        pad = n_max - key.shape[-1]
        key_s = F.pad(key_s, (0, pad), value=-float("inf"))
        order = F.pad(order, (0, pad), value=0)
    top, flat = key_s[..., :n_max], order[..., :n_max]
    cell_idx = flat // TOPK_PER_CELL
    in_cell = torch.gather(idx.reshape(B, -1), 1, flat)
    resp = torch.gather(vals.reshape(B, -1), 1, flat)
    py = (cell_idx // wc) * CELL + in_cell // CELL
    px = (cell_idx % wc) * CELL + in_cell % CELL
    valid = (resp > 0.0) & torch.isfinite(top)
    xy = torch.stack([px, py], dim=-1)
    return torch.where(valid[..., None], xy, torch.zeros_like(xy)), valid


def _gaussian(ksize: int = BLUR_TAPS, sigma: float = 2.0) -> list:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def _blur(p: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable blur, rows then columns, summed in tap order."""
    k = _gaussian()
    for dim in (2, 3):
        n = p.shape[dim] - (BLUR_TAPS - 1)
        out = p.narrow(dim, 0, n) * k[0]
        for i in range(1, BLUR_TAPS):
            out = out + p.narrow(dim, i, n) * k[i]
        p = out
    return p


@functools.lru_cache(maxsize=1)
def _moment_weights() -> np.ndarray:
    hp = HALF_PATCH
    umax = np.zeros(hp + 1, dtype=np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2.0 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2.0))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    P = 2 * hp + 1
    w = np.zeros((2, P, P), dtype=np.float32)
    for dy in range(-hp, hp + 1):
        for dx in range(-hp, hp + 1):
            if abs(dx) <= int(umax[abs(dy)]):
                w[0, dy + hp, dx + hp] = dx
                w[1, dy + hp, dx + hp] = dy
    return w


@functools.lru_cache(maxsize=1)
def _test_table() -> np.ndarray:
    """int64[32, 256, 4]: per angle bin and test, (x1, y1, x2, y2) in the
    37x37 blurred patch."""
    R = PATCH_RADIUS
    tab = np.zeros((N_ANGLE_BINS, N_BITS, 4), np.int64)
    pat = ORB_PATTERN.astype(np.float64)
    for a in range(N_ANGLE_BINS):
        th = 2 * np.pi * a / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for b in range(N_BITS):
            x1, y1, x2, y2 = pat[b]
            tab[a, b] = (int(round(x1 * ca - y1 * sa)) + R,
                         int(round(x1 * sa + y1 * ca)) + R,
                         int(round(x2 * ca - y2 * sa)) + R,
                         int(round(x2 * sa + y2 * ca)) + R)
    return tab


def _describe(blurred: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    B, N, P, _ = blurred.shape
    bins = torch.round(angle.float() * (N_ANGLE_BINS / (2 * math.pi))
                       ).to(torch.int64) % N_ANGLE_BINS
    tab = torch.from_numpy(_test_table()).to(blurred.device)[bins]
    i1 = (tab[..., 1] * P + tab[..., 0]).reshape(B, N * N_BITS)
    i2 = (tab[..., 3] * P + tab[..., 2]).reshape(B, N * N_BITS)
    rows = (torch.arange(N, device=blurred.device) * (P * P)
            ).repeat_interleave(N_BITS)
    src = blurred.reshape(B, N * P * P).to(torch.bfloat16)
    bits = (torch.gather(src, 1, i2 + rows) > torch.gather(src, 1, i1 + rows))
    words = (bits.reshape(B, N, 8, 32).to(torch.int64)
             << torch.arange(32, device=blurred.device)).sum(dim=-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def extract(img: torch.Tensor, n_features: int, scale: float, n_levels: int,
            ini_th: int, min_th: int, dtype=torch.float32) -> Features:
    """img: u8 or f32 [B, H, W] grayscale in [0, 255] -> Features."""
    x = img.to(torch.float32).to(dtype)
    B, H, W = x.shape
    levels = pyramid(x, n_levels, scale)
    budgets = level_budgets(n_features, scale, n_levels)
    offs, rows = [], 0
    for h, _w in level_shapes(H, W, n_levels, scale):
        offs.append(rows)
        rows += -(-(h + 6) // 8) * 8
    canvas = torch.zeros((B, rows, W + 6), dtype=dtype, device=x.device)
    lxy, xy0, octs, valids, centres = [], [], [], [], []
    for l, lvl in enumerate(levels):
        h, w = lvl.shape[1:]
        canvas[:, offs[l]:offs[l] + h + 6, :w + 6] = F.pad(
            lvl.float(), (3, 3, 3, 3), mode="reflect").to(dtype)
        if budgets[l] <= 0:
            continue
        xy_l, valid = _select(fast_nms(lvl, EDGE_MARGIN), budgets[l],
                              float(ini_th), float(min_th))
        lxy.append(xy_l)
        xy0.append(xy_l.to(torch.float32) * float(np.float32(scale ** l)))
        octs.append(torch.full(valid.shape, l, dtype=torch.int64, device=x.device))
        valids.append(valid)
        centres.append(xy_l + torch.tensor([3, 3 + offs[l]], device=x.device))
    centres = torch.cat(centres, dim=1)
    # Each slot's clipped 43x43 window of the canvas.
    Hc, Wc = canvas.shape[1:]
    P = 2 * GATHER_RADIUS + 1
    x0 = (centres[..., 0] - GATHER_RADIUS).clamp(0, Wc - P)
    y0 = (centres[..., 1] - GATHER_RADIUS).clamp(0, Hc - P)
    off = torch.arange(P, device=x.device)
    flat = ((y0[..., None] + off)[..., :, None] * Wc
            + (x0[..., None] + off)[..., None, :]).reshape(B, -1)
    patches = torch.gather(canvas.reshape(B, Hc * Wc), 1, flat).reshape(
        B, centres.shape[1], P, P)
    c0 = GATHER_RADIUS - HALF_PATCH
    core = patches[:, :, c0:c0 + 2 * HALF_PATCH + 1, c0:c0 + 2 * HALF_PATCH + 1]
    w = torch.from_numpy(_moment_weights()).to(x.device).to(dtype)
    mom = (core[:, :, None] * w).sum(dim=(-2, -1))
    ang = torch.atan2(mom[..., 1], mom[..., 0]).float()
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)
    desc = _describe(_blur(patches), ang)
    read = torch.zeros((B, Hc * Wc), dtype=torch.bool, device=x.device)
    read.scatter_(1, flat, True)
    return Features(level_xy=torch.cat(lxy, 1), xy=torch.cat(xy0, 1),
                    octave=torch.cat(octs, 1), angle=ang, desc=desc,
                    valid=torch.cat(valids, 1),
                    canvas_floats_read=[int(v) for v in read.sum(dim=1)])
