"""FAST corner score, NMS and spatially-uniform keypoint selection.

Port of orb_slam_system_tpu/ops/fast.py (reference
ORBextractor::ComputeKeyPointsOctTree + DistributeOctTree). The dense score
map is the exact FAST-9 threshold of every pixel (corner at t <=> score > t),
so one map serves both thresholds (20, then 7 in cells without a strong
corner) and the NMS. Selection ranks candidates per 16-pixel cell, then
takes a per-level top-n with cells covered first.

Kernel A (`fast_score_nms_levels`, csrc/fast_score_nms.cu) computes score +
border mask + 3x3 NMS for every pyramid level in one launch on the card;
`fast_score_map` and `nms3x3` are its plain PyTorch version, used for CPU
tensors. `tile_plan` is the kernel's grid: every level's 32x64 tiles on one
axis.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam_system_tpu_torch.utils import kernels

# Bresenham circle of radius 3: 16 (dy, dx) offsets in circular order
# (same circle OpenCV's FAST_9_16 uses).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: contiguous arc of >= 9 circle pixels
CELL = 16          # selection grid cell (pixels)
TOPK_PER_CELL = 4  # candidates kept per cell


def fast_score_map(img: torch.Tensor, border: int) -> torch.Tensor:
    """Dense FAST-9 corner score. img: f32[B,H,W] -> score f32[B,H,W].

    score(p) = max over the 32 (16 bright + 16 dark) circular arcs of length
    9 of the min ring-vs-center difference. Border pixels score 0."""
    _, H, W = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)),
                                   dims=(1, 2)) for dy, dx in CIRCLE])
    bright = ring - img[None]            # ring brighter than center
    # Circular windowed min/max of length 9 along the ring axis.
    ext = torch.cat([bright, bright[:ARC_LEN - 1]], dim=0)
    win = ext.unfold(0, ARC_LEN, 1)      # [16, B, H, W, 9]
    min_b = win.amin(dim=-1)
    min_d = -win.amax(dim=-1)            # min of the dark diffs (-bright)
    score = torch.maximum(min_b.amax(dim=0), min_d.amax(dim=0))
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    return torch.where(inb[None], score, torch.zeros((), device=img.device))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (-inf padding): keep pixels >= their
    neighborhood max. score: f32[B,H,W]."""
    pooled = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= pooled, score, torch.zeros((), device=score.device))


# Kernel A's tile and level table (csrc/fast_score_nms.cu).
TILE_H, TILE_W = 32, 64
MAX_LEVELS = 16


class TilePlan(NamedTuple):
    """Kernel A's grid over a list of level shapes: level l owns tiles
    first_tile[l] .. first_tile[l+1]-1, row-major with tiles_x[l] tiles to
    a row. first_pixel is the prefix of the levels' pixel counts (one
    image)."""

    tiles_x: tuple
    first_tile: tuple   # n_levels + 1 entries; the last is the tile count
    first_pixel: tuple  # n_levels + 1 entries


@functools.lru_cache(maxsize=None)
def tile_plan(shapes: tuple) -> TilePlan:
    """The tile plan for level shapes ((H, W), ...)."""
    tx = tuple(-(-w // TILE_W) for _h, w in shapes)
    first, pix = [0], [0]
    for t, (h, w) in zip(tx, shapes):
        first.append(first[-1] + t * -(-h // TILE_H))
        pix.append(pix[-1] + h * w)
    return TilePlan(tx, tuple(first), tuple(pix))


class _FastLevels(ctypes.Structure):
    """The C struct FastLevels, passed by value to kernel A."""

    _fields_ = [("src", ctypes.c_void_p * MAX_LEVELS),
                ("dst", ctypes.c_void_p * MAX_LEVELS),
                ("H", ctypes.c_int * MAX_LEVELS),
                ("W", ctypes.c_int * MAX_LEVELS),
                ("tiles_x", ctypes.c_int * MAX_LEVELS),
                ("first_tile", ctypes.c_int * (MAX_LEVELS + 1)),
                ("n_levels", ctypes.c_int),
                ("border", ctypes.c_int)]


def fast_score_nms_levels(levels, border: int) -> list:
    """[nms3x3(fast_score_map(l, border)) for l in levels]: one launch of
    kernel A over every level for CUDA tensors, the plain version for CPU
    tensors. levels: f32[B,Hl,Wl] each, one batch size; the outputs are
    contiguous per-level views of one allocation."""
    if all(l.is_cpu for l in levels):
        return [nms3x3(fast_score_map(l, border)) for l in levels]
    n = len(levels)
    if n > MAX_LEVELS:
        raise ValueError(f"fast_score_nms: {n} levels, at most {MAX_LEVELS}")
    B, dev = levels[0].shape[0], levels[0].get_device()
    shapes = []
    for i, l in enumerate(levels):
        kernels.check_cuda(l, f"fast_score_nms level {i}", torch.float32, 3)
        b, h, w = l.shape
        if b != B or l.get_device() != dev:
            raise ValueError(f"fast_score_nms: level {i} {tuple(l.shape)} on "
                             f"{l.device}, level 0 {tuple(levels[0].shape)} "
                             f"on {levels[0].device}")
        shapes.append((h, w))
    shapes = tuple(shapes)
    plan = tile_plan(shapes)
    flat = torch.empty(B * plan.first_pixel[-1], device=levels[0].device)
    outs = [flat.as_strided((B, h, w), (h * w, w, 1), B * o)
            for (h, w), o in zip(shapes, plan.first_pixel)]
    tab = _FastLevels()
    tab.src[:n] = [l.data_ptr() for l in levels]
    tab.dst[:n] = [o.data_ptr() for o in outs]
    tab.H[:n] = [h for h, _w in shapes]
    tab.W[:n] = [w for _h, w in shapes]
    tab.tiles_x[:n] = plan.tiles_x
    tab.first_tile[:n + 1] = plan.first_tile
    tab.n_levels = n
    tab.border = int(border)
    kernels.launch("orb_fast_score_nms", "fast_score_nms",
                   ctypes.addressof(tab), B)
    return outs


def fast_score_nms(img: torch.Tensor, border: int) -> torch.Tensor:
    """nms3x3(fast_score_map(img, border)) of one image batch: kernel A's
    one-level call on a CUDA tensor, the plain version on a CPU tensor."""
    return fast_score_nms_levels([img], border)[0]


def _cell_candidates(score, ini_th, min_th, cell, topk_per_cell):
    """NMS'd score map -> per-cell top-K candidates.

    Returns (vals f32[B,C,K], idx i64[B,C,K] in-cell flat position, hc, wc)."""
    B, H, W = score.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    s = F.pad(score, (0, Wp - W, 0, Hp - H))
    hc, wc = Hp // cell, Wp // cell
    cells = s.reshape(B, hc, cell, wc, cell).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, hc * wc, cell * cell)
    # Weak corners count only in cells with no strong corner.
    has_strong = cells.amax(dim=-1, keepdim=True) > ini_th
    eligible = torch.where(has_strong, cells > ini_th, cells > min_th)
    zero = torch.zeros((), device=score.device)
    remaining = torch.where(eligible, cells, zero)
    pos = torch.arange(cell * cell, device=score.device)
    big = torch.full((), 1 << 20, device=score.device, dtype=torch.int64)
    ninf = torch.full((), -float("inf"), device=score.device)
    vals_l, idx_l = [], []
    for _ in range(topk_per_cell):
        m = remaining.amax(dim=-1)                             # [B, C]
        # Lowest index among ties (lax.top_k's order).
        am = torch.where(remaining == m[..., None], pos, big).amin(dim=-1)
        vals_l.append(m)
        idx_l.append(am)
        remaining = torch.where(pos == am[..., None], ninf, remaining)
    return torch.stack(vals_l, -1), torch.stack(idx_l, -1), hc, wc


def _order_key(vals, topk_per_cell):
    """Global candidate ordering: cover cells first (rank 0 of every cell),
    then rank 1, etc.; inside a rank order by response."""
    rank = torch.arange(topk_per_cell, dtype=torch.float32,
                        device=vals.device).reshape((1,) * (vals.dim() - 1) + (-1,))
    smax = vals.amax() + 1.0
    return torch.where(vals > 0.0, -rank * smax + vals,
                       torch.full((), -float("inf"), device=vals.device))


def _top_n(key: torch.Tensor, n: int):
    """lax.top_k(key, n) over the last axis: descending, ties lower index
    first (a stable sort; torch.topk promises no tie order). When n exceeds
    the candidate count the result is padded with -inf keys (index 0) instead
    of failing."""
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    m = key.shape[-1]
    if n <= m:
        return vals[..., :n], idx[..., :n]
    pad = n - m
    vals = F.pad(vals, (0, pad), value=-float("inf"))
    idx = F.pad(idx, (0, pad), value=0)
    return vals, idx


def _decode_selection(flat_idx, top_vals, vals, idx, wc, cell, topk_per_cell):
    """Selected flat candidate indices -> (xy i64[B,n,2], resp, valid)."""
    B = flat_idx.shape[0]
    cell_idx = flat_idx // topk_per_cell
    in_cell = torch.gather(idx.reshape(B, -1), 1, flat_idx)
    resp = torch.gather(vals.reshape(B, -1), 1, flat_idx)
    py = (cell_idx // wc) * cell + in_cell // cell
    px = (cell_idx % wc) * cell + in_cell % cell
    valid = (resp > 0.0) & torch.isfinite(top_vals)
    xy = torch.stack([px, py], dim=-1)
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
    return xy, resp, valid


def select_keypoints_multi(scores, budgets, ini_th: float, min_th: float):
    """Per-level keypoint selection from NMS'd score maps (the TOPK_SELECT
    branch of the JAX package's select_keypoints_multi).

    scores: list of f32[B,Hl,Wl]; budgets: per-level n_max. Returns per-level
    lists (xy i64[B,n_l,2] as (x, y), resp f32[B,n_l], valid bool[B,n_l])."""
    out = []
    for s, n_max in zip(scores, budgets):
        vals, idx, _, wc = _cell_candidates(s, ini_th, min_th, CELL,
                                            TOPK_PER_CELL)
        key = _order_key(vals, TOPK_PER_CELL).reshape(s.shape[0], -1)
        top_vals, flat_idx = _top_n(key, n_max)
        out.append(_decode_selection(flat_idx, top_vals, vals, idx, wc, CELL,
                                     TOPK_PER_CELL))
    return out
